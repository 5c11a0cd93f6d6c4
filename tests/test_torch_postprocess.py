"""depthData and utils (postprocess, wavelength) of the port against the
JAX package's.

The shared state: FAL-C decimated to 24 depths, 3 rays, H 6-level + Ca II
with Ca II active; the JAX Context takes three MALI steps and stat_equil,
and its J and populations go into the port's Context.  Then both take one
MALI step with depthData.fill = True, the port under each of its three
schemes:

- chi, eta and I [Nlam, Nmu, 2, Nk] against the JAX capture, per
  wavelength (max over the row over the row's maximum): chi and eta to
  1e-12 (measured 7.8e-14, 4.7e-14), I to 1e-9 (tests/test_torch_slice.py's
  bar; XLA's and torch's exp differ in the last ulps; measured 5.8e-12).
  The sweep path recovers eta from srcNum - sca J, as the JAX package's
  sweep-kernel path does; the JAX Context here takes eta from its gather,
  so eta also differs by the subtraction's rounding.  The fused scheme
  rebuilds chi and eta with gather.
- the four postprocess functions on the port's capture against the JAX
  ones on the JAX capture: compute_wavelength_edges exactly,
  compute_contribution_fn per wavelength to 1e-10 (measured 1.1e-12),
  compute_radiative_losses to 1e-12 of each wavelength's maximum of the
  angle-integrated chi S (its chi (S - I) cancels where the lines are
  thick; measured 1.8e-15), integrate_line_losses on the Ca II lines
  (1e-8 relative).

Then: tests/test_utils.py's two physical oracles on the port at 30 depths
(60 MALI steps from LTE, then a filled one); the wavelength conversions
against the JAX ones and their oracles; depthData off (the default)
captures nothing, and prd_redistribute with it filled takes the full-grid
MALI step as the JAX Context does.
"""
import numpy as np
import pytest
import torch

import lightweaver_tpu.utils as jutils
import lightweaver_tpu_torch.utils as tutils
from lightweaver_tpu_torch import context as tcontext
from lightweaver_tpu_torch.problems import falc_decimated, h6mg_context

from tests.test_torch_context_options import jax_context, port_context
from tests.test_torch_hprd_f32 import per_row

SCHEMES = ('mali_full_precond', 'mali_full_precond_pallas',
           'mali_full_precond_fused')

# one intra-op thread per process: the tier-1 run has six pytest workers
torch.set_num_threads(1)


def _np(x):
    return np.asarray(x, np.float64)


@pytest.fixture(scope='module')
def shared():
    """The JAX Context three steps deep, then filled by one more; the
    port's Context per scheme from the same J and populations, filled by
    one step."""
    jctx = jax_context(active=('Ca',))
    for _ in range(3):
        jctx.formal_sol_gamma_matrices()
        jctx.stat_equil()
    J = _np(jctx.J)
    pops = [_np(st['n']) for st in jctx.popsState]
    jctx.depthData.fill = True
    jctx.formal_sol_gamma_matrices()
    ports = {}
    for scheme in SCHEMES:
        tctx = port_context(active=('Ca',), fsIterScheme=scheme)
        assert tctx.depthData.chi is None
        tctx.J = torch.tensor(J)
        for st, n in zip(tctx.popsState, pops):
            st['n'] = torch.tensor(n)
        tctx.depthData.fill = True
        tctx.formal_sol_gamma_matrices()
        ports[scheme] = tctx
    return jctx, ports


@pytest.mark.parametrize('scheme', SCHEMES)
def test_depth_data_matches_jax(shared, scheme):
    jctx, ports = shared
    tctx = ports[scheme]
    cfg = tctx.cfg
    for key, bar in (('chi', 1e-12), ('eta', 1e-12), ('I', 1e-9)):
        x = getattr(tctx.depthData, key)
        assert isinstance(x, torch.Tensor) and x.device == tctx.device
        assert tuple(x.shape) == (cfg.Nlam, cfg.Nmu, 2, cfg.Nk)
        e = per_row(x, getattr(jctx.depthData, key)).max()
        assert e < bar, (key, e)


@pytest.mark.parametrize('scheme', SCHEMES)
def test_postprocess_matches_jax(shared, scheme):
    jctx, ports = shared
    tctx = ports[scheme]
    np.testing.assert_array_equal(tutils.compute_wavelength_edges(tctx),
                                  jutils.compute_wavelength_edges(jctx))
    np.testing.assert_array_equal(tutils.compute_height_edges(tctx),
                                  jutils.compute_height_edges(jctx))
    for mu in (0, -1):
        for outgoing in (True, False):
            ours = tutils.compute_contribution_fn(tctx, mu, outgoing)
            ref = jutils.compute_contribution_fn(jctx, mu, outgoing)
            assert np.all(np.isfinite(ours))
            assert per_row(ours, ref).max() < 1e-10, (mu, outgoing)
    loss = tutils.compute_radiative_losses(tctx)
    ref = jutils.compute_radiative_losses(jctx)
    chiS = np.einsum('lmdk,m->lk', _np(jctx.depthData.eta)
                     + (_np(jctx.bgSca) * _np(jctx.J))[:, None, None, :],
                     np.asarray(jctx.atmos.wmu))
    assert loss.shape == ref.shape == (tctx.cfg.Nlam, tctx.cfg.Nk)
    e = (np.abs(loss - ref).max(axis=1) / np.abs(chiS).max(axis=1)).max()
    assert e < 1e-12, e
    lines = tctx.activeAtoms[0].model.lines
    jlines = jctx.activeAtoms[0].model.lines
    ours = tutils.integrate_line_losses(tctx, loss, lines, extendGridNm=0.1)
    ref = jutils.integrate_line_losses(jctx, ref, jlines, extendGridNm=0.1)
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o, r, rtol=1e-8,
                                   atol=1e-8 * np.abs(r).max())


def test_depth_data_off_captures_nothing(monkeypatch):
    """With fill False (the default) no MALI step forms the capture: the
    fused scheme's per-step cost does not move."""
    ctx = port_context(active=('Ca',), fsIterScheme=SCHEMES[2])

    def refuse(*args):
        raise AssertionError('depth_data ran without depthData.fill')
    monkeypatch.setattr(tcontext, 'depth_data', refuse)
    ctx.formal_sol_gamma_matrices()
    assert ctx.depthData.chi is None and ctx.depthData.I is None


def test_filled_prd_redistribute_takes_the_full_grid(monkeypatch):
    """prd_redistribute while depthData is filled re-solves on the full
    grid (the JAX Context's branch): bit for bit prdFsMode='full', the
    subset solve never called, the capture refreshed."""
    from tests.test_torch_prd_context import NRAYS, NSPACE
    from lightweaver_tpu_torch.problems import falc_interpolated
    ctxs = []
    for fill in (True, False):
        ctx = h6mg_context(falc_interpolated(NSPACE), NRAYS, device='cpu')
        ctx.formal_sol_gamma_matrices()
        ctx.stat_equil()
        ctx.depthData.fill = fill
        ctx.prdFsMode = 'subset' if fill else 'full'
        ctxs.append(ctx)
    filled, full = ctxs
    assert filled.depthData.chi is None

    def refuse():
        raise AssertionError('the subset solve ran')
    monkeypatch.setattr(filled, '_prd_subset_fs', refuse)
    u1 = filled.prd_redistribute(maxIter=2)
    u2 = full.prd_redistribute(maxIter=2)
    assert u1.NprdSubIter == u2.NprdSubIter
    assert torch.equal(filled.J, full.J)
    for ai, ti, a, t in filled._prd_lines():
        assert torch.equal(filled.rhoPrd[ai][ti], full.rhoPrd[ai][ti])
    assert filled.depthData.chi is not None
    assert full.depthData.chi is None


@pytest.fixture(scope='module')
def converged():
    """tests/test_utils.py's converged_ctx on the port: FAL-C at 30
    depths, 3 rays, Ca II active, 60 MALI steps (stat_equil from the
    fourth), then one filled step."""
    atmos = falc_decimated(30)
    atmos.quadrature(3)
    from lightweaver_tpu_torch import CaII_atom, H_6_atom, RadiativeSet
    rs = RadiativeSet([H_6_atom(), CaII_atom()])
    rs.set_active('Ca')
    spect = rs.compute_wavelength_grid()
    ctx = tcontext.Context(atmos, spect, rs.compute_eq_pops(atmos),
                           device='cpu')
    for it in range(60):
        ctx.formal_sol_gamma_matrices()
        if it >= 3:
            ctx.stat_equil()
    ctx.depthData.fill = True
    ctx.formal_sol_gamma_matrices()
    return ctx


def test_contribution_fn_oracle(converged):
    """Finite and non-negative; the continuum (500 nm) forms deeper than
    the Ca II K core."""
    ctx = converged
    cfn = tutils.compute_contribution_fn(ctx, mu=-1)
    assert cfn.shape == (ctx.cfg.Nlam, ctx.cfg.Nk)
    assert np.all(np.isfinite(cfn)) and np.all(cfn >= 0)
    lam = np.asarray(ctx.spect.wavelength)
    core = np.argmin(np.abs(lam - 393.48))
    cont = np.argmin(np.abs(lam - 500.0))
    h = np.asarray(ctx.atmos.height)
    assert h[np.argmax(cfn[core])] > h[np.argmax(cfn[cont])]


def test_radiative_losses_oracle(converged):
    """Finite; at the optically thick Ca II K core the deep layers are in
    detailed balance, S within 1% of I."""
    ctx = converged
    loss = tutils.compute_radiative_losses(ctx)
    assert loss.shape == (ctx.cfg.Nlam, ctx.cfg.Nk)
    assert np.all(np.isfinite(loss))
    chi = ctx.depthData.chi.numpy()
    S = (ctx.depthData.eta.numpy()
         + (ctx.bgSca.numpy() * ctx.J.numpy())[:, None, None, :]) / chi
    I = ctx.depthData.I.numpy()
    lam = np.asarray(ctx.spect.wavelength)
    core = np.argmin(np.abs(lam - 393.48))
    rel = np.abs(S - I)[core, :, :, -3:-1] / S[core, :, :, -3:-1]
    assert rel.max() < 0.01


def test_wavelength_conversions():
    """The JAX package's functions and tests/test_utils.py's oracles."""
    lam = np.linspace(300.0, 1000.0, 64)
    np.testing.assert_array_equal(tutils.vac_to_air(lam),
                                  jutils.vac_to_air(lam))
    np.testing.assert_array_equal(tutils.air_to_vac(lam),
                                  jutils.air_to_vac(lam))
    assert np.allclose(tutils.air_to_vac(tutils.vac_to_air(lam)), lam,
                       rtol=1e-10)
    # Ca II K: vacuum 393.4776 nm -> air 393.3663 nm (NIST)
    assert abs(tutils.vac_to_air(393.4776) - 393.3663) < 1e-3
    assert np.all(tutils.vac_to_air(lam) < lam)
    I_nu = 1e-8
    I_ang = tutils.convert_specific_intensity(500.0, I_nu, 'erg/s/cm2/sr/A')
    assert np.isclose(I_ang, I_nu * 2.99792458e8 / (500e-9) ** 2 * 1e3
                      * 1e-10, rtol=1e-12)
    for unit in ('W/m2/sr/nm', 'kW/m2/sr/nm', 'erg/s/cm2/sr/Hz'):
        assert (tutils.convert_specific_intensity(lam, I_nu, unit)
                == jutils.convert_specific_intensity(lam, I_nu, unit)).all()
    with pytest.raises(ValueError, match='Unsupported unit'):
        tutils.convert_specific_intensity(lam, I_nu, 'furlong')
