"""The Context options of the JAX package on one device, in the port.

FAL-C decimated to 24 depths (tests/test_gamma_modes.py's decimation), 3
rays, H 6-level + Ca II; the JAX Contexts run the default scheme.  Unless
stated, Gamma and the rates are held to 1e-10 relative above a floor of
1e-10 of each array's maximum, J and I to 1e-9 of each wavelength's
maximum (the bars of tests/test_torch_slice.py, whose docstring says why
J and I need the wider one).

- gammaMode='dense' (the non-factored branch of gamma_rates): dense equals
  factored on the port's own state after three MALI steps (1e-12 of each
  array's maximum in float64, 3e-5 in the f32 state: the bars of
  tests/test_gamma_modes.py), also on a small 2D slab; the port's dense
  iteration equals the JAX one on the JAX params (f64).
- accumDtype=float32, with the float32 and the float64 state: one
  iteration on the JAX params against the JAX Context given the same, by
  the rule of tests/test_torch_hprd_f32.py (err(port, JAX f64) <= 2
  err(JAX, JAX f64) + 32 float32 ulps, J and I per wavelength); J, Gamma
  and the rates come out float32 as in the JAX Context.  The sweep's J is
  summed in float64 and then cast, the JAX one in float32.
- initSol=InitialSolution.Zero starts from eqPops' populations as Lte
  does (bit for bit in the port) and matches the JAX Context.
- backgroundProvider: a provider doubling the background scattering
  (chi += sca, sca *= 2), against the JAX Context given the same one,
  before and after update_deps on a 1% hotter atmosphere.
- Detailed atoms: H 6 active with a detailed (fixed-population) Ca II.
- LineProfileState: tests/test_line_profile_protocol.py's two oracles on
  the port (a subclass forwarding to the default Voigt callback is bit for
  bit the stock line; a Gaussian subclass is exp(-v^2)/(sqrt(pi) vBroad)).
- The surface: the accessors, recurrenceMode (its names, its refusals, its
  lightweaverrc key and its state_dict round trip) and the exports.
"""
import copy
import dataclasses
import pickle
from dataclasses import dataclass

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import lightweaver_tpu.rh_atoms as jatoms
from lightweaver_tpu.atmosphere import Atmosphere as JAtmosphere
from lightweaver_tpu.atomic_set import RadiativeSet as JRadiativeSet
from lightweaver_tpu.background import basic_background as j_background
from lightweaver_tpu.context import Context as JContext
from lightweaver_tpu.context import build_iteration_fn as j_build_iteration_fn
from lightweaver_tpu.fal import Falc82 as JFalc82
from lightweaver_tpu.utils import InitialSolution as JInitialSolution
import lightweaver_tpu_torch as tlw
from lightweaver_tpu_torch import config as tconfig
from lightweaver_tpu_torch import rh_atoms as tatoms
from lightweaver_tpu_torch.atomic_model import (LineProfileResult,
                                                LineProfileState, VoigtLine)
from lightweaver_tpu_torch.atomic_set import RadiativeSet
from lightweaver_tpu_torch.background import basic_background
from lightweaver_tpu_torch.context import Context, build_iteration_fn
from lightweaver_tpu_torch.convert import params_from_numpy
from lightweaver_tpu_torch.problems import falc_decimated, slab_2d_atmos

from tests.test_api_surface import REFERENCE_EXPORTS
from tests.test_torch_2d_context import port_context as port_context_2d
from tests.test_torch_hprd_f32 import assert_rule, per_row, rel, to_f64
from tests.test_torch_slice import relerr

NSPACE, NRAYS = 24, 3

# one intra-op thread per process: the tier-1 run has six pytest workers
torch.set_num_threads(1)


def jax_context(active=('H', 'Ca'), detailed=(), **kw):
    full = JFalc82()
    idx = np.unique(np.linspace(0, 81, NSPACE).astype(int))
    atmos = JAtmosphere(height=full.height[idx],
                        temperature=full.temperature[idx],
                        vlos=full.vlos[idx], vturb=full.vturb[idx],
                        ne=full.ne[idx], nHTot=full.nHTot[idx])
    atmos.quadrature(NRAYS)
    rs = JRadiativeSet([jatoms.H_6_atom(), jatoms.CaII_atom()])
    rs.set_active(*active)
    if detailed:
        rs.set_detailed_static(*detailed)
    spect = rs.compute_wavelength_grid()
    return JContext(atmos, spect, rs.compute_eq_pops(atmos), **kw)


def port_context(active=('H', 'Ca'), detailed=(), ca=None, **kw):
    atmos = falc_decimated(NSPACE)
    atmos.quadrature(NRAYS)
    rs = RadiativeSet([tatoms.H_6_atom(),
                       tatoms.CaII_atom() if ca is None else ca])
    rs.set_active(*active)
    if detailed:
        rs.set_detailed_static(*detailed)
    spect = rs.compute_wavelength_grid()
    return Context(atmos, spect, rs.compute_eq_pops(atmos), device='cpu',
                   **kw)


def compare(out, ref, Natoms):
    """out (the port's iteration output) against ref ({'Gamma', 'Rij',
    'Rji', 'J', 'I'}) at the module docstring's bars."""
    for ai in range(Natoms):
        e = relerr(out['Gamma'][ai], ref['Gamma'][ai])
        assert e < 1e-10, ('Gamma', ai, e)
        for key in ('Rij', 'Rji'):
            for ti, x in enumerate(out[key][ai]):
                e = relerr(x, ref[key][ai][ti])
                assert e < 1e-10, (key, ai, ti, e)
    for key in ('J', 'I'):
        e = per_row(out[key], ref[key]).max()
        assert e < 1e-9, (key, e)


def context_state(ctx):
    return {'Gamma': ctx._Gamma, 'Rij': ctx._Rij, 'Rji': ctx._Rji,
            'J': ctx.J, 'I': ctx.I}


def stepped(ctx, n=3):
    for _ in range(n):
        ctx.formal_sol_gamma_matrices()
        ctx.stat_equil()
    return ctx


# ---- dense Gamma ---------------------------------------------------------
def scaled_close(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() <= tol * np.abs(b).max()


def assert_dense_matches_factored(ctx, tol):
    """Both modes' iterations on the Context's current params
    (tests/test_gamma_modes.py's comparison: J, Gamma and the rates to
    ``tol`` of each array's maximum)."""
    params = dict(ctx._params)
    outs = {mode: build_iteration_fn(dataclasses.replace(
        ctx.cfg, gammaMode=mode))(params) for mode in ('factored', 'dense')}
    f, d = outs['factored'], outs['dense']
    assert scaled_close(f['J'], d['J'], tol)
    for ai in range(len(f['Gamma'])):
        assert scaled_close(f['Gamma'][ai], d['Gamma'][ai], tol), ai
        for key in ('Rij', 'Rji'):
            for ti, x in enumerate(f[key][ai]):
                assert scaled_close(x, d[key][ai][ti], tol), (key, ai, ti)


@pytest.mark.parametrize('dtype, tol', [(torch.float64, 1e-12),
                                        (torch.float32, 3e-5)],
                         ids=['f64', 'f32'])
def test_dense_matches_factored(dtype, tol):
    """A dense Context, three MALI steps deep; then each mode's iteration
    on its params."""
    ctx = stepped(port_context(gammaMode='dense', dtype=dtype))
    assert ctx.cfg.gammaMode == 'dense'
    ctx.formal_sol_gamma_matrices()
    assert_dense_matches_factored(ctx, tol)


def test_dense_matches_factored_on_2d():
    """The JAX Context takes dense Gamma on a 2D atmosphere, and so does
    the port: a 12 x 4 periodic slab with Ca II active, one step deep."""
    ctx = port_context_2d(slab_2d_atmos(12, 4, periodic=True),
                          gammaMode='dense')
    stepped(ctx, 1)
    ctx.formal_sol_gamma_matrices()
    assert_dense_matches_factored(ctx, 1e-12)


def test_dense_matches_jax():
    """The port's dense iteration on the JAX params against the JAX dense
    iteration, three MALI steps from LTE (the JAX Context takes gammaMode
    through its IterConfig, the port's also as an argument)."""
    jctx = jax_context()
    jctx._swap_cfg(gammaMode='dense')
    stepped(jctx)
    assert jctx.cfg.gammaMode == 'dense'
    jparams = jctx.build_params()
    ref = jctx._iter_fn(jparams)   # the Context's compiled step
    tctx = port_context(gammaMode='dense')
    out = build_iteration_fn(tctx.cfg)(params_from_numpy(jparams, tctx.cfg))
    compare(out, ref, 2)


# ---- accumDtype=float32 --------------------------------------------------
@pytest.mark.parametrize('dtype', ['float32', 'float64'])
def test_accum_f32_matches_jax_by_the_rule(dtype):
    """One iteration on the JAX params of a Context given accumDtype =
    float32 (two MALI steps deep) against the JAX Context given the same,
    both held to the float64 iteration on those params cast to float64
    (module docstring); then the port's Context steps with it."""
    jctx = stepped(jax_context(dtype=getattr(jnp, dtype),
                               accumDtype=jnp.float32), 2)
    assert jctx.J.dtype == jnp.float32
    jparams = jctx.build_params()
    ref = jctx._iter_fn(jparams)   # the Context's compiled step
    truth = jax.jit(j_build_iteration_fn(dataclasses.replace(
        jctx.cfg, dtype=jnp.float64, accumDtype=jnp.float64)))(
            to_f64(jparams))
    tctx = port_context(dtype=getattr(torch, dtype),
                        accumDtype=torch.float32)
    out = build_iteration_fn(tctx.cfg)(params_from_numpy(jparams, tctx.cfg))
    assert out['J'].dtype == torch.float32
    for key in ('J', 'I'):
        assert_rule(out[key], ref[key], truth[key], per_row, key)
    for ai in range(2):
        assert out['Gamma'][ai].dtype == torch.float32
        assert_rule(out['Gamma'][ai], ref['Gamma'][ai], truth['Gamma'][ai],
                    rel, ('Gamma', ai))
        for key in ('Rij', 'Rji'):
            for ti, x in enumerate(out[key][ai]):
                assert x.dtype == torch.float32
                assert_rule(x, ref[key][ai][ti], truth[key][ai][ti], rel,
                            (key, ai, ti))
    u = stepped(tctx, 2).formal_sol_gamma_matrices()
    assert tctx.J.dtype == torch.float32 and np.isfinite(float(u.dJMax))
    assert all(torch.isfinite(st['n']).all() for st in tctx.popsState)


# ---- initSol, backgroundProvider, detailed atoms -------------------------
def test_init_sol_zero_is_lte_and_matches_jax():
    zero = port_context(initSol=tlw.InitialSolution.Zero)
    lte = port_context(initSol=tlw.InitialSolution.Lte)
    for a, b in zip(zero.popsState, lte.popsState):
        assert torch.equal(a['n'], b['n'])
    for ctx in (zero, lte):
        ctx.formal_sol_gamma_matrices()
    assert torch.equal(zero.J, lte.J)
    jctx = jax_context(initSol=JInitialSolution.Zero)
    for st, jst in zip(zero.popsState, jctx.popsState):
        np.testing.assert_array_equal(st['n'].numpy(), np.asarray(jst['n']))
    jctx.formal_sol_gamma_matrices()
    compare(context_state(zero), context_state(jctx), 2)


def doubled_scattering(background, calls):
    def provider(spect, atmos, eqPops, radSet):
        calls.append(1)
        bg = background(spect, atmos, eqPops, radSet)
        bg.chi = bg.chi + bg.sca
        bg.sca = 2.0 * bg.sca
        return bg
    return provider


def test_background_provider_matches_jax_through_update_deps():
    """The provider is the Context's background at construction and again
    in update_deps (it is called once each time); one MALI step against
    the JAX Context with the same provider before and after update_deps on
    a 1% hotter atmosphere."""
    calls, jcalls = [], []
    tctx = port_context(backgroundProvider=doubled_scattering(
        basic_background, calls))
    jctx = jax_context(backgroundProvider=doubled_scattering(
        j_background, jcalls))
    assert calls == [1] and tctx.backgroundProvider is not None
    plain = basic_background(tctx.spect, tctx.atmos, tctx.eqPops,
                             tctx.spect.radSet)
    np.testing.assert_array_equal(tctx.bgSca.numpy(), 2.0 * plain.sca)
    np.testing.assert_array_equal(tctx.bgSca.numpy(), np.asarray(jctx.bgSca))
    for step in range(2):
        if step:
            for ctx in (tctx, jctx):
                ctx.atmos.temperature[:] *= 1.01
                ctx.update_deps()
            assert calls == [1, 1]
        tctx.formal_sol_gamma_matrices()
        jctx.formal_sol_gamma_matrices()
        compare(context_state(tctx), context_state(jctx), 2)
    np.testing.assert_allclose(tctx.bgChi.numpy(), np.asarray(jctx.bgChi),
                               rtol=1e-14)
    # as in the JAX package, state_dict does not carry the provider
    assert 'backgroundProvider' not in tctx.state_dict()['kwargs']


def test_detailed_atom_matches_jax():
    """H 6 active with Ca II detailed (fixed populations, its lines and
    continua in every opacity sum): one MALI step and stat_equil."""
    tctx = port_context(active=('H',), detailed=('Ca',))
    jctx = jax_context(active=('H',), detailed=('Ca',))
    assert len(tctx.detailedAtoms) == 1 and len(tctx.activeAtoms) == 1
    for ctx in (tctx, jctx):
        ctx.formal_sol_gamma_matrices()
    compare(context_state(tctx), context_state(jctx), 1)
    for ctx in (tctx, jctx):
        ctx.stat_equil()
    e = relerr(tctx.popsState[0]['n'], jctx.popsState[0]['n'])
    assert e < 1e-9, e


# ---- LineProfileState ----------------------------------------------------
@dataclass
class ForwardingLine(VoigtLine):
    """Uses the protocol but defers to the default Voigt callback."""

    def compute_phi(self, state: LineProfileState) -> LineProfileResult:
        vBroad = (self.atom.vBroad(state.atmos) if state.vBroad is None
                  else state.vBroad)
        aDamp, Qelast = self.damping(state.atmos, state.eqPops,
                                     vBroad=vBroad)
        return LineProfileResult(phi=state.default_voigt_callback(
            aDamp, vBroad), aDamp=aDamp, Qelast=Qelast)


@dataclass
class GaussianLine(VoigtLine):
    """Pure Doppler core: the default callback with a = 0."""

    def compute_phi(self, state: LineProfileState) -> LineProfileResult:
        vBroad = (self.atom.vBroad(state.atmos) if state.vBroad is None
                  else state.vBroad)
        aDamp, Qelast = self.damping(state.atmos, state.eqPops,
                                     vBroad=vBroad)
        phi = state.default_voigt_callback(np.zeros_like(aDamp), vBroad)
        return LineProfileResult(phi=phi, aDamp=np.zeros_like(aDamp),
                                 Qelast=Qelast)


def ca_with(cls):
    """Ca II with every line of class ``cls``
    (tests/test_line_profile_protocol.py's _swap_line_class)."""
    atom = copy.deepcopy(tatoms.CaII_atom())
    atom.lines = [cls(**{k: getattr(l, k)
                         for k in ('i', 'j', 'f', 'type', 'quadrature',
                                   'broadening', 'gLandeEff')})
                  for l in atom.lines]
    for l in atom.lines:
        l.setup(atom)
    return atom


def test_forwarding_profile_is_the_stock_voigt():
    ref = port_context(active=('Ca',))
    fwd = port_context(active=('Ca',), ca=ca_with(ForwardingLine))
    for tRef, tFwd in zip(ref.phi[0], fwd.phi[0]):
        assert (tRef is None) == (tFwd is None)
        if tRef is not None:
            assert torch.equal(tRef, tFwd)
    u1 = ref.formal_sol_gamma_matrices()
    u2 = fwd.formal_sol_gamma_matrices()
    assert torch.equal(ref.I, fwd.I) and float(u1.dJMax) == float(u2.dJMax)


def test_gaussian_profile_is_zero_damping():
    """phi = exp(-v^2) / (sqrt(pi) vBroad) at v = (Delta lambda c/lambda0
    +/- vlos mu) / vBroad (1e-10 relative, 1e-12 of the peak absolute),
    aDamp stored as 0 for PRD, and the iteration runs on it."""
    from lightweaver_tpu_torch import constants as Const
    gau = port_context(active=('Ca',), ca=ca_with(GaussianLine))
    atmos = gau.atmos
    a = gau.cfg.activeAtoms[0]
    vBroad = a.model.vBroad(atmos)
    vlosMu = np.asarray(atmos.vlos_mu())
    s = np.array([-1.0, 1.0])
    found = 0
    for t, phi, ad in zip(a.trans, gau.phi[0], gau.aDamp[0]):
        if not t.isLine:
            continue
        found += 1
        vBase = (t.wavelength - t.lambda0) * Const.CLight / t.lambda0
        v = ((vBase[:, None, None, None]
              + s[None, None, :, None] * vlosMu[None, :, None, :])
             / vBroad[None, None, None, :])
        expect = np.exp(-v * v) / (np.sqrt(np.pi) * vBroad)
        # the Faddeeva approximation's far wings sit ~1e-16 of the peak
        # off the Gaussian's underflowing tail
        np.testing.assert_allclose(phi.numpy(), expect, rtol=1e-10,
                                   atol=1e-12 * expect.max())
        assert np.all(ad == 0.0)
    assert found == len(a.model.lines)
    stepped(gau, 4)
    assert torch.isfinite(gau.I).all()


# ---- the surface ---------------------------------------------------------
def test_exports_are_the_reference_ones():
    missing = [n for n in REFERENCE_EXPORTS if not hasattr(tlw, n)]
    assert missing == []
    assert tlw.nr_post_update is Context.nr_post_update
    assert (tlw.Layout, tlw.read_multi_atmos, tlw.voigt_H) is not None
    from pathlib import Path
    assert (Path(tlw.get_data_path()) / 'falc82.npz').is_file()
    assert tlw.get_default_molecule_path() == tlw.get_data_path()


def test_accessors():
    ctx = port_context(active=('Ca',))
    assert ctx.Nthreads == 1
    ctx.Nthreads = 8
    assert ctx.Nthreads == 1
    assert ctx.hprd is False
    stepped(ctx, 1)
    pops = ctx.activePops
    assert list(pops) == ['Ca'] and isinstance(pops['Ca'], np.ndarray)
    np.testing.assert_array_equal(pops['Ca'], ctx.popsState[0]['n'].numpy())
    state = ctx.eqPops.atomicPops[ctx.activeAtoms[0].model.element]
    state.pops = np.zeros_like(state.nStar)
    ctx.sync_pops_to_eqPops()
    np.testing.assert_array_equal(state.pops, pops['Ca'])


@pytest.mark.parametrize('mode', ['scan', 'parallel', 'blocked', 'pallas'])
def test_recurrence_modes_run_the_sweep(mode):
    """Every name of the JAX package runs the port's sweep: one MALI step
    equals the default's bit for bit; state_dict and pickle carry the
    name."""
    ref = port_context(active=('Ca',))
    ctx = port_context(active=('Ca',), recurrenceMode=mode)
    assert ctx.cfg.recurrenceMode == mode
    for c in (ref, ctx):
        c.formal_sol_gamma_matrices()
    assert torch.equal(ref.J, ctx.J)
    assert ctx.state_dict()['kwargs']['recurrenceMode'] == mode
    back = pickle.loads(pickle.dumps(ctx))
    assert back.cfg.recurrenceMode == mode
    assert torch.equal(back.J, ctx.J)


def test_recurrence_mode_refusals_and_rc_key(monkeypatch):
    """'pallas' off 1D Bezier-3 raises, as in the JAX Context, an unknown
    name raises, and lightweaverrc's RecurrenceMode is the default."""
    with pytest.raises(ValueError, match="recurrenceMode='pallas'"):
        port_context(active=('Ca',), recurrenceMode='pallas',
                     formalSolver='piecewise_linear_1d')
    with pytest.raises(ValueError, match="recurrenceMode='pallas'"):
        port_context_2d(slab_2d_atmos(6, 4, periodic=True),
                        recurrenceMode='pallas')
    with pytest.raises(ValueError, match='Unknown recurrence mode'):
        port_context(active=('Ca',), recurrenceMode='sequential')
    monkeypatch.setitem(tconfig.params, 'RecurrenceMode', 'blocked')
    assert port_context(active=('Ca',)).cfg.recurrenceMode == 'blocked'
