"""The whole ported slice against the JAX package on a reduced FAL-C.

FAL-C interpolated to 30 depths the way bench.py builds FALC-500, 3 rays,
H 6-level + Ca II active.  The JAX Context runs the Pallas depth sweep
(recurrenceMode='pallas', interpret mode on the CPU), the repo's fast
path; its params go through params_from_numpy into the port's iteration
function, so both sides see identical inputs.

Gamma, Rij, Rji and dJ agree to 1e-10 relative with a floor of 1e-10 of
each array's maximum (the Kogge-Stone prefix of the Pallas sweep reorders
the depth recurrence's sums; Gamma's diagonal and IeffBar are differences
of nearly equal terms).  The populations after stat_equil agree to 1e-9:
the solve amplifies Gamma's ~1e-11 differences ~40x (4.4e-10 measured;
the JAX package's own pallas-vs-XLA test holds them to 1e-9).  J
and I span tens of decades over wavelength and depth; where they are
1e-5 of their wavelength's maximum (the optically thick deep UV near the
top) XLA's exp and the port's differ in the last ulps of exp(-dtau), and
the depth recurrence carries that along the ray.  J and I are held to
1e-9 of the maximum over depth (J) or angle (I) at each wavelength, as
the golden hPRD test normalises them (1.3e-10 measured).
"""
import numpy as np
import pytest
import torch

import jax
import lightweaver_tpu.rh_atoms as jatoms
from lightweaver_tpu.atmosphere import Atmosphere as JAtmosphere
from lightweaver_tpu.atomic_set import RadiativeSet as JRadiativeSet
from lightweaver_tpu.context import Context as JContext
from lightweaver_tpu.context import _cast_params_to_working
from lightweaver_tpu.context import build_iteration_fn as j_build_iteration_fn
from lightweaver_tpu.fal import Falc82 as JFalc82
from lightweaver_tpu_torch import ExplodingMatrixError
from lightweaver_tpu_torch.context import Context
from lightweaver_tpu_torch.convert import params_from_numpy
from lightweaver_tpu_torch.problems import falc_interpolated, h6ca_context

NSPACE, NRAYS = 30, 3

# one intra-op thread per process: the tier-1 run has six pytest workers
torch.set_num_threads(1)


def relerr(ours, ref, floorRel=1e-10):
    ours = np.asarray(ours)
    ref = np.asarray(ref)
    floor = np.abs(ref).max() * floorRel
    return (np.abs(ours - ref) / np.maximum(np.abs(ref), floor)).max()


def _jax_falc_interpolated(Nspace):
    """bench.py:40-68's interpolation, on the JAX package's classes."""
    full = JFalc82()
    cm = np.log10(full.cmass)
    cmNew = np.linspace(cm[0], cm[-1], Nspace)

    def interp(y, logY=False):
        if logY:
            return 10 ** np.interp(cmNew, cm, np.log10(y))
        return np.interp(cmNew, cm, y)
    return JAtmosphere(height=interp(full.height),
                       temperature=interp(full.temperature, logY=True),
                       vlos=np.zeros(Nspace), vturb=interp(full.vturb),
                       ne=interp(full.ne, logY=True),
                       nHTot=interp(full.nHTot, logY=True))


@pytest.fixture(scope='module')
def pair():
    atmos = _jax_falc_interpolated(NSPACE)
    atmos.quadrature(NRAYS)
    rs = JRadiativeSet([jatoms.H_6_atom(), jatoms.CaII_atom()])
    rs.set_active('H', 'Ca')
    spect = rs.compute_wavelength_grid()
    eqPops = rs.compute_eq_pops(atmos)
    jctx = JContext(atmos, spect, eqPops, recurrenceMode='pallas')
    tctx = h6ca_context(falc_interpolated(NSPACE), NRAYS, device='cpu')
    return jctx, tctx


def test_problem_matches_bench_interpolation(pair):
    jctx, tctx = pair
    for name in ('height', 'temperature', 'vlos', 'vturb', 'ne', 'nHTot'):
        np.testing.assert_array_equal(getattr(tctx.atmos, name),
                                      getattr(jctx.atmos, name))
    np.testing.assert_array_equal(tctx.spect.wavelength,
                                  jctx.spect.wavelength)


def test_gather_stage_matches_jax(pair):
    """The gather stage against the JAX sweep-path gather closure (which
    emits the padded direction-major kernel layout): same segment sums
    in the same order, 1e-13 relative."""
    jctx, tctx = pair
    jparams = jctx.build_params()
    jit = j_build_iteration_fn(jctx.cfg)
    jp = _cast_params_to_working(jparams, jctx.dtype)
    scaJ = np.asarray(jp['bgSca']) * np.asarray(jp['J'])
    jchi, jsrc = jax.jit(jit.gather)(jp, scaJ)
    Nlam, Nk = jctx.cfg.Nlam, jctx.cfg.Nk
    tparams = params_from_numpy(jparams, tctx.cfg)
    chi, src = tctx._iter_fn.gather(tparams, torch.as_tensor(scaJ))
    assert chi.shape == (2, Nlam, NRAYS, Nk)
    for ours, ref in ((chi, jchi), (src, jsrc)):
        ref = np.asarray(ref)[:, :Nlam, :, :Nk]
        assert relerr(ours, ref, floorRel=1e-300) < 1e-13


def _compare_iteration(out, jctx, ju):
    for ai in range(2):
        e = relerr(out['Gamma'][ai], jctx._Gamma[ai])
        assert e < 1e-10, ('Gamma', ai, e)
        for ti in range(len(jctx.activeAtoms[ai].trans)):
            for key, ref in (('Rij', jctx._Rij), ('Rji', jctx._Rji)):
                e = relerr(out[key][ai][ti], ref[ai][ti])
                assert e < 1e-10, (key, ai, ti, e)
    for key, ref in (('J', jctx.J), ('I', jctx.I)):
        ours, ref = np.asarray(out[key]), np.asarray(ref)
        e = (np.abs(ours - ref).max(axis=1) / np.abs(ref).max(axis=1)).max()
        assert e < 1e-9, (key, e)
    assert relerr(out['dJ'], ju.dJMax) < 1e-10


def test_iterations_match_jax_pallas_path(pair):
    """Three MALI iterations + stat_equil, each fed the JAX state."""
    jctx, tctx = pair
    for it in range(3):
        jparams = jctx.build_params()
        tparams = params_from_numpy(jparams, tctx.cfg)
        out = tctx._iter_fn(tparams)
        ju = jctx.formal_sol_gamma_matrices()
        _compare_iteration(out, jctx, ju)

        # the port's stat_equil on the same Gamma and populations
        tctx._Gamma = out['Gamma']
        for ai, st in enumerate(tctx.popsState):
            st['n'] = tparams['pops'][ai]
        jup = jctx.stat_equil()
        tup = tctx.stat_equil()
        for ai in range(2):
            e = relerr(tctx.popsState[ai]['n'], jctx.popsState[ai]['n'])
            assert e < 1e-9, ('pops', it, ai, e)
        np.testing.assert_allclose(tup.dPops, jup.dPops, rtol=1e-8,
                                   atol=1e-14)


def test_stages_compose_to_the_iteration(pair):
    """gather -> formal_solve -> gamma_rates is exactly the iteration."""
    _, tctx = pair
    params = tctx.build_params()
    out = tctx._iter_fn(params)
    it = tctx._iter_fn
    scaJ = params['bgSca'] * params['J']
    chi, src = it.gather(params, scaJ)
    I, Psi, IeffBase, moments = it.formal_solve(params, chi, src)
    Gamma, Rij, Rji = it.gamma_rates(params, I, Psi, IeffBase, src, moments)
    assert torch.equal(out['J'], moments['J'])
    assert torch.equal(out['I'], I[1, :, :, 0])
    for ai in range(2):
        assert torch.equal(out['Gamma'][ai], Gamma[ai])


def test_singular_gamma_raises_exploding_matrix():
    """As tests/test_error_surfacing.py pins for the JAX package."""
    ctx = h6ca_context(falc_interpolated(12), 2, device='cpu')
    ctx.formal_sol_gamma_matrices()
    ctx._Gamma[0] = torch.zeros_like(ctx._Gamma[0])
    with pytest.raises(ExplodingMatrixError):
        ctx.stat_equil()


@pytest.fixture(scope='module')
def small_inputs():
    ctx = h6ca_context(falc_interpolated(12), 2, device='cpu')
    return ctx.atmos, ctx.spect, ctx.eqPops


@pytest.mark.parametrize('option', [
    {'formalSolver': 'piecewise_linear_2d'},
    {'gammaMode': 'sparse'},
    pytest.param({'dtype': torch.float16}, id='float16'),
    {'accumDtype': torch.float16},
    {'gammaAccum': 'pairwise'},
], ids=lambda o: next(iter(o)))
def test_options_outside_the_slice_raise(small_inputs, option):
    """Each option outside the port raises ValueError at construction:
    names no package has (a gamma mode, a gamma accumulation), a 2D
    solver on a 1D atmosphere and float16.  Dense Gamma, accumDtype
    float32, hybrid PRD with the float32 state and every initSol are in
    the port (tests/test_torch_context_options.py,
    tests/test_torch_hprd_f32.py)."""
    with pytest.raises(ValueError, match='does not support'):
        Context(*small_inputs, device='cpu', **option)


def test_nr_h_only_without_hydrogen_active_raises():
    """Charge conservation couples hydrogen: with H passive the NR step of
    stat_equil raises ValueError, as in the JAX package."""
    from lightweaver_tpu_torch.problems import timedep_context
    ctx = timedep_context(device='cpu', atmos=falc_interpolated(12),
                          Nrays=2)
    ctx = Context(ctx.atmos, ctx.spect, ctx.eqPops, conserveCharge=True,
                  nrHOnly=True, device='cpu')
    ctx.formal_sol_gamma_matrices()
    with pytest.raises(ValueError, match='without Hydrogen active'):
        ctx.stat_equil()
