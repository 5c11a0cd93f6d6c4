"""The line Gamma kernel's plain version (ops/gamma.py) and the port's
'mali_full_precond_pallas' scheme, against the JAX package.

The JAX kernel lightweaver_tpu/ops/pallas_gamma.py:group_gamma_rates runs
in Pallas interpret mode on the CPU, as the JAX package's own tests run
it.  It takes S and chiTot where the port takes srcNum; the test forms
srcNum = S * chiTot in numpy, the same product the JAX kernel forms, so
both see one value.  Its lambda blocks are 16 rows aligned to the global
grid, the port's 8 rows of the window: G4 is compared summed over blocks.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import lightweaver_tpu.rh_atoms as jatoms
from lightweaver_tpu.atomic_set import RadiativeSet as JRadiativeSet
from lightweaver_tpu.context import Context as JContext
from lightweaver_tpu.ops.pallas_gamma import \
    group_gamma_rates as j_group_gamma_rates
from lightweaver_tpu.ops.pallas_gamma import line_groups as j_line_groups
from lightweaver_tpu_torch.context import build_iteration_fn
from lightweaver_tpu_torch.convert import params_from_numpy
from lightweaver_tpu_torch.ops import gamma as tgamma
from lightweaver_tpu_torch.problems import (falc_interpolated, h6ca_context,
                                            random_line_group)

from tests.test_torch_slice import (NRAYS, NSPACE, _jax_falc_interpolated,
                                    relerr)

PALLAS = 'mali_full_precond_pallas'

# one intra-op thread per process: the tier-1 run has six pytest workers
torch.set_num_threads(1)


def _jax_layout(x):
    """Port ray layout [2, NL, Nmu, Nk] -> the JAX kernel's [NL, 2Nmu, Nk]
    (md = mu*2 + d)."""
    x = np.moveaxis(x, 0, 2)
    return x.reshape(x.shape[0], -1, x.shape[-1])


@pytest.mark.parametrize('K', [1, 3])
def test_plain_group_kernel_matches_jax(K):
    """K = 1, and K = 3 with three pair moments and rho != 1: block-summed
    G4, PPB and PairPPB to 1e-12 of each output's maximum (the two sum
    the same terms in another order)."""
    Nlam, Nmu, Nk, row0, Wu = 64, 2, 12, 16, 32
    g = random_line_group(K, Nlam, Nmu, Nk, row0=row0, Wu=Wu, seed=K)
    levels = g.pop('levels')
    assert g.pop('row0') == row0
    rng = np.random.default_rng(10 + K)
    chiTot = rng.uniform(0.5, 2.0, g['srcNum'].shape)
    S = g['srcNum'] / chiTot
    g['srcNum'] = S * chiTot
    ts = [type('T', (), {'i': i, 'j': j}) for i, j in levels]
    st = tgamma.group_statics(ts)

    ours = tgamma.group_gamma_rates(
        **{k: torch.as_tensor(v) for k, v in g.items()}, st=st, row0=row0)
    M2 = 2 * Nmu
    phiJ = np.moveaxis(g['phi'], 1, 3).reshape(K, Wu, M2, Nk)
    ref = j_group_gamma_rates(
        phiJ, g['rho'], *(_jax_layout(g[k]) for k in
                          ('Psi', 'IeffBase', 'I')),
        _jax_layout(S), _jax_layout(chiTot), g['chiCL'], g['UCL'],
        g['etaC'], g['n'], g['coef'], g['wphi'],
        wmuHalf=tuple(g['wmuHalf']), levels=tuple(levels),
        signs=tuple(tuple((float(a), float(b)) for a, b in row)
                    for row in st.signs),
        uIn=tuple(tuple((float(a), float(b)) for a, b in row)
                  for row in st.uIn),
        alignedNblue=row0)
    G4, PPB, PairPPB = (np.asarray(x) for x in ref)
    np.testing.assert_allclose(ours[0].sum(dim=2).numpy() / np.abs(G4).max(),
                               G4.sum(axis=2) / np.abs(G4).max(), rtol=0,
                               atol=1e-12)
    for a, b in ((ours[1], PPB), (ours[2], PairPPB)):
        scale = max(np.abs(b).max(), 1e-300)
        np.testing.assert_allclose(a.numpy() / scale, b / scale, rtol=0,
                                   atol=1e-12)


@pytest.fixture(scope='module')
def ctx():
    """The slice test's 30-depth, 3-ray problem after two MALI steps."""
    c = h6ca_context(falc_interpolated(NSPACE), NRAYS, device='cpu')
    for _ in range(2):
        c.formal_sol_gamma_matrices()
        c.stat_equil()
    return c


def test_line_groups_match_jax(ctx):
    """The same groups as the JAX helper; on falc_h6ca ten one-line H
    groups and the Ca II groups {0-3, 0-4}, {1-4, 2-4}, {1-3}."""
    H, Ca = ctx.activeAtoms
    for a in (H, Ca):
        assert tgamma.line_groups(a) == j_line_groups(a)
    assert [len(g) for g in tgamma.line_groups(H)] == [1] * 10
    assert sorted(tuple((Ca.trans[t].i, Ca.trans[t].j) for t in g)
                  for g in tgamma.line_groups(Ca)) == \
        [((0, 3), (0, 4)), ((1, 3),), ((1, 4), (2, 4))]


def _compare(out, ref, tol, floorRel, keys=('J', 'I', 'dJ')):
    for ai in range(2):
        e = relerr(out['Gamma'][ai], ref['Gamma'][ai], floorRel)
        assert e < tol, ('Gamma', ai, e)
        for key in ('Rij', 'Rji'):
            for ti, x in enumerate(out[key][ai]):
                e = relerr(x, ref[key][ai][ti], floorRel)
                assert e < tol, (key, ai, ti, e)
    for key in keys:
        e = relerr(out[key], ref[key], floorRel)
        assert e < tol, (key, e)


def test_pallas_scheme_matches_default(ctx):
    """The scheme's iteration against the default scheme on the same
    params: the line kernel sums the same products in another order.
    Gamma/Rij/Rji/J/I/dJ agree to 1e-12 relative above a floor of 1e-6
    of each array's maximum (1.9e-13 measured).  Below it sit Gamma
    entries that are differences of far larger terms; there the two
    differ by rounding of the large terms (5e-18 of the maximum measured,
    2.6e-11 relative at an entry 1e-9 of the maximum)."""
    params = ctx.build_params()
    outs = {}
    for scheme in ('mali_full_precond', PALLAS):
        cfg = dataclasses.replace(ctx.cfg, fsIterScheme=scheme)
        outs[scheme] = build_iteration_fn(cfg)({**params, 'pack': None})
    _compare(outs[PALLAS], outs['mali_full_precond'], 1e-12, 1e-6)


@pytest.mark.slow
def test_pallas_iteration_matches_jax_pallas_scheme():
    """One iteration of the port's scheme against the JAX package's
    iteration under the same scheme name (interpret mode), on the same
    params: the tolerances of test_torch_slice's comparison."""
    atmos = _jax_falc_interpolated(NSPACE)
    atmos.quadrature(NRAYS)
    rs = JRadiativeSet([jatoms.H_6_atom(), jatoms.CaII_atom()])
    rs.set_active('H', 'Ca')
    spect = rs.compute_wavelength_grid()
    jctx = JContext(atmos, spect, rs.compute_eq_pops(atmos),
                    fsIterScheme=PALLAS)
    tctx = h6ca_context(falc_interpolated(NSPACE), NRAYS, device='cpu')
    tctx.set_fs_iter_scheme(PALLAS)
    for _ in range(2):
        jctx.formal_sol_gamma_matrices()
        jctx.stat_equil()
    out = tctx._iter_fn(params_from_numpy(jctx.build_params(), tctx.cfg))
    ju = jctx.formal_sol_gamma_matrices()
    ref = {'Gamma': jctx._Gamma, 'Rij': jctx._Rij, 'Rji': jctx._Rji,
           'dJ': ju.dJMax}
    _compare(out, ref, 1e-10, 1e-10, keys=('dJ',))
    for key, r in (('J', jctx.J), ('I', jctx.I)):
        ours, r = np.asarray(out[key]), np.asarray(r)
        e = (np.abs(ours - r).max(axis=1) / np.abs(r).max(axis=1)).max()
        assert e < 1e-9, (key, e)
    assert jax.default_backend() == 'cpu'
