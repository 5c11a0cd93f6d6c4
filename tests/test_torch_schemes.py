"""The port's iteration-scheme API (Context fsIterScheme,
set_fs_iter_scheme, get_fs_iter_scheme_properties) and one JAX params
dict driving all three schemes through convert.params_from_numpy."""
import dataclasses
import types

import numpy as np
import pytest
import torch

from lightweaver_tpu_torch.context import Context, build_iteration_fn
from lightweaver_tpu_torch.convert import params_from_numpy
from lightweaver_tpu_torch.ops import fused as tfused
from lightweaver_tpu_torch.ops import gamma as tgamma
from lightweaver_tpu_torch.problems import falc_interpolated, h6ca_context

from tests.test_torch_slice import _compare_iteration, pair  # noqa: F401

SCHEMES = ('mali_full_precond', 'mali_full_precond_pallas',
           'mali_full_precond_fused')

# one intra-op thread per process: the tier-1 run has six pytest workers
torch.set_num_threads(1)


@pytest.fixture(scope='module')
def small():
    return h6ca_context(falc_interpolated(12), 2, device='cpu')


def _name(ctx):
    return ctx.get_fs_iter_scheme_properties()['name']


def test_scheme_names_and_aliases(small):
    """The JAX package's names; the reference's per-SIMD suffixes alias
    their base scheme; the properties keep the reference's keys."""
    assert _name(small) == 'mali_full_precond'
    props = small.get_fs_iter_scheme_properties()
    assert props == {'name': 'mali_full_precond', 'Ndim': 1,
                     'dimensionSpecific': False,
                     'respectsFormalSolver': True,
                     'defaultPerAtomStorage': True,
                     'defaultWlaGijStorage': True}
    for name, base in (('mali_full_precond_pallas', SCHEMES[1]),
                       ('mali_full_precond_fused_AVX2', SCHEMES[2]),
                       ('mali_full_precond_pallas_SSE2', SCHEMES[1]),
                       ('mali_full_precond_AVX512', SCHEMES[0]),
                       ('mali_full_precond_scalar', SCHEMES[0])):
        small.set_fs_iter_scheme(name)
        assert _name(small) == base
        assert small._iter_fn is not None and small._params is None
    small.set_fs_iter_scheme('mali_full_precond')


def test_scheme_selects_the_iteration(small):
    """The Context argument and the setter select the same iteration: its
    packed kernel input is the scheme's."""
    ctx = Context(small.atmos, small.spect, small.eqPops, device='cpu',
                  fsIterScheme='mali_full_precond_fused')
    assert _name(ctx) == SCHEMES[2]
    ctx.formal_sol_gamma_matrices()
    assert ctx._params['pack']['phiP'].shape[0] == 2
    ctx.set_fs_iter_scheme('mali_full_precond_pallas')
    ctx.formal_sol_gamma_matrices()
    table = ctx._params['pack']
    assert [sum(g.ai == ai for g in table.groups) for ai in range(2)] == \
        [10, 3]
    ctx.set_fs_iter_scheme('mali_full_precond')
    ctx.formal_sol_gamma_matrices()
    assert ctx._params['pack'] is None


def test_unknown_scheme_raises(small):
    with pytest.raises(ValueError, match='Unknown iteration scheme'):
        small.set_fs_iter_scheme('nonsense')
    with pytest.raises(ValueError, match='Unknown iteration scheme'):
        Context(small.atmos, small.spect, small.eqPops, device='cpu',
                fsIterScheme='mali_full_precond_cuda')
    assert _name(small) == 'mali_full_precond'


def test_unsupported_configuration_raises(small, monkeypatch):
    """No silent fallback: a configuration outside a scheme's kernel
    raises and leaves the scheme as it was.  A line group above the
    kernel's bound (Ca II's two-line groups against a bound of 1), and a
    float16 working dtype (float64 and float32 instances are built).  The
    float32 state is in both kernel schemes."""
    with monkeypatch.context() as m:
        m.setattr(tgamma, 'KMAX', 1)
        with pytest.raises(ValueError, match='does not support'):
            small.set_fs_iter_scheme('mali_full_precond_pallas')
    with monkeypatch.context() as m:
        m.setattr(small.cfg, 'dtype', torch.float16)
        for scheme in SCHEMES[1:]:
            with pytest.raises(ValueError, match='does not support'):
                small.set_fs_iter_scheme(scheme)
    assert _name(small) == 'mali_full_precond'
    f32 = types.SimpleNamespace(dtype=torch.float32, hprd=False,
                                activeAtoms=small.cfg.activeAtoms)
    assert tgamma.gamma_scheme_supported(f32)
    assert tfused.fused_scheme_supported(f32)


@pytest.mark.parametrize('scheme', SCHEMES[1:])
def test_kernel_schemes_refuse_dense_gamma(small, scheme):
    """As the JAX package's pallas_scheme_supported and
    fused_scheme_supported: dense Gamma raises with their message, from
    set_fs_iter_scheme (the scheme stays the default) and at construction;
    no fallback."""
    dense = Context(small.atmos, small.spect, small.eqPops, device='cpu',
                    gammaMode='dense')
    with pytest.raises(ValueError, match='factored Gamma'):
        dense.set_fs_iter_scheme(scheme)
    assert _name(dense) == 'mali_full_precond'
    with pytest.raises(ValueError, match='factored Gamma'):
        Context(small.atmos, small.spect, small.eqPops, device='cpu',
                gammaMode='dense', fsIterScheme=scheme)


def test_one_jax_params_dict_drives_every_scheme(pair):  # noqa: F811
    """params_from_numpy carries one JAX params dict unchanged into each
    scheme's iteration; each matches the JAX iteration at the slice
    test's tolerances."""
    jctx, tctx = pair
    tparams = params_from_numpy(jctx.build_params(), tctx.cfg)
    outs = {s: build_iteration_fn(dataclasses.replace(
        tctx.cfg, fsIterScheme=s))(tparams) for s in SCHEMES}
    assert 'pack' not in tparams
    ju = jctx.formal_sol_gamma_matrices()
    for s in SCHEMES:
        _compare_iteration(outs[s], jctx, ju)
    np.testing.assert_array_equal(outs[SCHEMES[0]]['J'],
                                  outs[SCHEMES[1]]['J'])
