"""Hybrid PRD in the port's Context against the JAX package.

The small problem of tests/test_torch_prd_context.py with a 0-5 km/s
outflow ramp and hprd=True: each PRD line's rho is read in the comoving
frame of every ray (linear interpolation at the Doppler-shifted window
position), and the scattering integral takes the rest-frame mean
intensity JRest.  Same records and bars as that file; JRest is held per
wavelength like J.  The kernel schemes do not cover hybrid PRD and refuse
it.
"""
import numpy as np
import pytest
import torch

from lightweaver_tpu_torch.context import build_iteration_fn
from lightweaver_tpu_torch.convert import params_from_numpy

from tests.test_torch_prd_context import (SCHEMES, compare_iteration,
                                          compare_redistribute,
                                          compare_subset_stage, h6_pair,
                                          per_wavelength, stepped)

# one intra-op thread per process: the tier-1 run has six pytest workers
torch.set_num_threads(1)


@pytest.fixture(scope='module')
def hprd():
    return stepped(hprd=True)


def test_hprd_coefficients_are_direction_major(hprd):
    """The port's own hprdI0/hprdFrac params and those carried across
    from the JAX params: the same tensors, [2, W, Nmu, Nk], d = 0 the
    JAX package's mu-sign index 0; vlosMu as the JAX one."""
    jctx, tctx, rec = hprd
    ours = tctx.build_params()
    carried = params_from_numpy(rec['paramsPre'], device='cpu')
    np.testing.assert_array_equal(ours['vlosMu'], carried['vlosMu'])
    for ai, ti, a, t in tctx._prd_lines():
        i0, frac = jctx.cfg.hprdCoeffs[(ai, ti)]
        for key, ref in (('hprdI0', i0), ('hprdFrac', frac)):
            x = ours[key][ai][ti]
            assert x.shape == (2, t.W, tctx.cfg.Nmu, tctx.cfg.Nk)
            assert torch.equal(x, carried[key][ai][ti])
            np.testing.assert_array_equal(x.numpy(), np.moveaxis(ref, 2, 0))
        assert ours['hprdI0'][ai][ti].dtype == torch.int64


def test_hprd_subset_stage_matches_jax(hprd):
    jctx, tctx, rec = hprd
    compare_subset_stage(jctx, tctx, rec['paramsPre'])


def test_hprd_redistribute_matches_jax(hprd):
    _, tctx, rec = hprd
    compare_redistribute(tctx, rec['redistributed'], hprd=True)


def test_hprd_iteration_matches_jax(hprd):
    """One MALI iteration of the default scheme with the comoving-frame
    rho, and its rest-frame JRest, against the JAX iteration."""
    _, tctx, rec = hprd
    out = build_iteration_fn(tctx.cfg)(params_from_numpy(rec['paramsPost'],
                                                         tctx.cfg))
    compare_iteration(out, rec['iteration'])
    assert out['JRest'].shape == (len(tctx.cfg.prdIdxs), tctx.cfg.Nk)
    assert per_wavelength(out['JRest'], rec['iteration']['JRest']) < 1e-9


@pytest.mark.parametrize('scheme', SCHEMES[1:])
def test_kernel_schemes_refuse_hprd(scheme):
    """As the JAX package's pallas_scheme_supported and
    fused_scheme_supported: ValueError, and the scheme stays the
    default; no fallback."""
    _, tctx = h6_pair(hprd=True)
    assert tctx.cfg.hprd
    with pytest.raises(ValueError, match='hybrid PRD'):
        tctx.set_fs_iter_scheme(scheme)
    assert tctx.cfg.fsIterScheme == SCHEMES[0]
    with pytest.raises(ValueError, match='hybrid PRD'):
        type(tctx)(tctx.atmos, tctx.spect, tctx.eqPops, hprd=True,
                   fsIterScheme=scheme, device='cpu')
