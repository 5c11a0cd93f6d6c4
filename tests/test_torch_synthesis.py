"""Spectrum synthesis from a converged state, port against the JAX
package: the Lambda step formal_sol under each iteration scheme,
state_dict / pickling / construct_from_state_dict_with, and compute_rays.

The problem: FAL-C interpolated to 12 depths, 2 rays, H 6-level + Ca II
with Ca II active (546 wavelengths).  Both Contexts start from the same
state (the JAX Context's J and populations after two MALI steps are
copied into the port's), so each comparison isolates the function under
test.  Bars: Gamma, Rij, Rji and dJ 1e-10, J and I 1e-9 of each
wavelength's maximum (the slice test's); compute_rays' spectra 1e-9 of
their maximum.
"""
import pickle

import numpy as np
import pytest
import torch

import lightweaver_tpu.rh_atoms as jatoms
from lightweaver_tpu.atomic_set import RadiativeSet as JRadiativeSet
from lightweaver_tpu.context import Context as JContext
from lightweaver_tpu_torch.context import Context
from lightweaver_tpu_torch.convert import params_from_numpy
from lightweaver_tpu_torch.problems import (falc_decimated, falc_interpolated,
                                            timedep_context)

from tests.test_torch_slice import _jax_falc_interpolated, relerr

SCHEMES = ('mali_full_precond', 'mali_full_precond_pallas',
           'mali_full_precond_fused')
NSPACE, NRAYS = 12, 2

# one intra-op thread per process: the tier-1 run has six pytest workers
torch.set_num_threads(1)


def _rel(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    return np.abs(ours - ref).max() / np.abs(ref).max()


def _row_rel(ours, ref):
    """max over rows of max |ours - ref| / max |ref| along the row."""
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    return (np.abs(ours - ref).max(axis=1) / np.abs(ref).max(axis=1)).max()


def _set_state(tctx, J, pops):
    """J and the active populations (numpy or jax arrays) into the port's
    Context."""
    tctx.J = torch.tensor(np.asarray(J), dtype=torch.float64)
    for st, n in zip(tctx.popsState, pops):
        st['n'] = torch.tensor(np.asarray(n), dtype=torch.float64)


def _take_state(tctx, jctx):
    """The JAX Context's J and populations into the port's Context."""
    _set_state(tctx, jctx.J, [st['n'] for st in jctx.popsState])


def _compare_step(out, jctx, ju):
    """The slice test's bars on one step of every active atom: Gamma, Rij,
    Rji and dJ 1e-10 (floor 1e-10 of the maximum), J and I 1e-9 of each
    wavelength's maximum."""
    for ai, a in enumerate(jctx.activeAtoms):
        assert relerr(out['Gamma'][ai], jctx._Gamma[ai]) < 1e-10, ai
        for ti in range(len(a.trans)):
            for key, ref in (('Rij', jctx._Rij), ('Rji', jctx._Rji)):
                err = relerr(out[key][ai][ti], ref[ai][ti])
                assert err < 1e-10, (key, ti, err)
    assert _row_rel(out['J'], jctx.J) < 1e-9
    assert _row_rel(out['I'], jctx.I) < 1e-9
    assert relerr(out['dJ'], ju.dJMax) < 1e-10


@pytest.fixture(scope='module')
def pair():
    """The JAX Context after two MALI steps and stat_equil, and the port's
    Context of the same problem."""
    atmos = _jax_falc_interpolated(NSPACE)
    atmos.quadrature(NRAYS)
    rs = JRadiativeSet([jatoms.H_6_atom(), jatoms.CaII_atom()])
    rs.set_active('Ca')
    spect = rs.compute_wavelength_grid()
    jctx = JContext(atmos, spect, rs.compute_eq_pops(atmos))
    for _ in range(2):
        jctx.formal_sol_gamma_matrices()
        jctx.stat_equil()
    tctx = timedep_context(device='cpu', atmos=falc_interpolated(NSPACE),
                           Nrays=NRAYS)
    return jctx, tctx


def test_formal_sol_matches_jax_under_each_scheme(pair):
    """The Lambda step (Psi = 0, IeffBase = I, on the moments path PsiBar
    = 0 and IeffSrcBar = IBar) of the port's iteration under each scheme,
    fed the JAX Context's params, against the JAX formal_sol; then
    Context.formal_sol from the same state."""
    jctx, tctx = pair
    jparams = jctx.build_params()
    ju = jctx.formal_sol()
    tparams = params_from_numpy(jparams, tctx.cfg)
    for scheme in SCHEMES:
        tctx.set_fs_iter_scheme(scheme)
        _compare_step(tctx._iter_fn(tparams, lambdaIterate=True), jctx, ju)
        _set_state(tctx, jparams['J'], jparams['pops'])
        tu = tctx.formal_sol()
        assert tu.updatedJ
        _compare_step({'Gamma': tctx._Gamma, 'Rij': tctx._Rij,
                       'Rji': tctx._Rji, 'J': tctx.J, 'I': tctx.I,
                       'dJ': tu.dJMax}, jctx, ju)
    tctx.set_fs_iter_scheme('mali_full_precond')


def test_lambda_step_differs_from_the_mali_step(pair):
    """formal_sol drops the operator: its Gamma is not the MALI step's,
    its J is (both solve the same rays)."""
    _, tctx = pair
    tctx.formal_sol_gamma_matrices()
    J, G = tctx.J, tctx._Gamma[0]
    tctx.J = torch.zeros_like(J)
    tctx.formal_sol_gamma_matrices()
    Jm, Gm = tctx.J, tctx._Gamma[0]
    tctx.J = torch.zeros_like(J)
    tctx.formal_sol()
    assert torch.equal(tctx.J, Jm)
    assert not torch.allclose(tctx._Gamma[0], Gm, rtol=1e-6)


def test_state_dict_is_host_numpy(pair):
    """Every array of the state dict is a host numpy copy; kwargs name
    the solver, the options (recurrenceMode too, as in the JAX package)
    and the device."""
    _, tctx = pair
    st = tctx.state_dict()
    for key in ('J', 'I'):
        assert isinstance(st[key], np.ndarray)
        np.testing.assert_array_equal(st[key], getattr(tctx, key).numpy())
    assert all(isinstance(x, np.ndarray) for x in st['pops'] + st['nStar'])
    assert st['kwargs'] == {'conserveCharge': False, 'hprd': False,
                            'formalSolver': 'piecewise_bezier3_1d',
                            'interpFn2d': 'interp_linear_2d',
                            'recurrenceMode': 'scan',
                            'accelerateScattering': False,
                            'device': 'cpu'}
    st['J'][0, 0] += 1.0
    assert tctx.J[0, 0] != st['J'][0, 0]


def _iterate(ctx, n, start=0):
    for it in range(start, start + n):
        ctx.formal_sol_gamma_matrices()
        if it >= 3:
            ctx.stat_equil()


@pytest.mark.parametrize('solver', ['piecewise_bezier3_1d',
                                    'piecewise_besser_1d'])
def test_pickle_resume_matches_uninterrupted(solver):
    """tests/test_pickle_context.py's oracle on the port (FAL-C at 20
    depths, 3 rays, Ca II active): pickle at step 12, load, and the
    resumed run matches the uninterrupted one after 30 steps to 5e-12; the
    solver survives the pickle."""
    def setup():
        ctx = timedep_context(device='cpu', atmos=falc_decimated(20),
                              Nrays=3)
        ctx.set_formal_solver(solver)
        return ctx
    ref = setup()
    _iterate(ref, 30)
    half = setup()
    _iterate(half, 12)
    resumed = pickle.loads(pickle.dumps(half))
    assert isinstance(resumed, Context)
    assert resumed.cfg.formalSolver == solver
    assert resumed.device == torch.device('cpu')
    assert torch.equal(resumed.J, half.J)
    assert torch.equal(resumed.I, half.I)
    assert torch.equal(resumed.popsState[0]['n'], half.popsState[0]['n'])
    _iterate(resumed, 18, start=12)
    np.testing.assert_allclose(resumed.popsState[0]['n'].numpy(),
                               ref.popsState[0]['n'].numpy(), rtol=5e-12)
    np.testing.assert_allclose(resumed.J.numpy(), ref.J.numpy(), rtol=5e-12)


def test_f32_state_comes_back_float64():
    """As in the JAX package, the state dict does not keep the working
    dtype: a float32 Context is rebuilt float64, with its J and
    populations."""
    ctx = timedep_context(device='cpu', dtype=torch.float32,
                          atmos=falc_interpolated(NSPACE), Nrays=NRAYS)
    ctx.formal_sol_gamma_matrices()
    back = pickle.loads(pickle.dumps(ctx))
    assert ctx.dtype == torch.float32 and back.dtype == torch.float64
    assert torch.equal(back.J, ctx.J)
    assert torch.equal(back.I, ctx.I.double())


def test_construct_onto_a_coarser_grid_matches_jax(pair):
    """construct_from_state_dict_with onto every third wavelength: J
    interpolated per depth and the populations copied as the JAX package
    does (1e-15), then formal_sol on both (J and I 1e-9)."""
    jctx, tctx = pair
    _take_state(tctx, jctx)
    jsub = jctx.spect.subset_configuration(jctx.spect.wavelength[::3])
    tsub = tctx.spect.subset_configuration(tctx.spect.wavelength[::3])
    jnew = JContext.construct_from_state_dict_with(jctx.state_dict(),
                                                   spect=jsub)
    tnew = Context.construct_from_state_dict_with(tctx.state_dict(),
                                                  spect=tsub)
    assert tnew.cfg.Nlam == jnew.cfg.Nlam == len(jsub.wavelength)
    assert _rel(tnew.J, jnew.J) < 1e-15
    for st, jst in zip(tnew.popsState, jnew.popsState):
        assert _rel(st['n'], jst['n']) < 1e-15
    jnew.formal_sol()
    tnew.formal_sol()
    assert _row_rel(tnew.J, jnew.J) < 1e-9
    assert _row_rel(tnew.I, jnew.I) < 1e-9


@pytest.mark.parametrize('stokes', [False, True])
def test_compute_rays_matches_jax(pair, stokes):
    """compute_rays on a subset of the wavelengths (every fifth row of
    Ca II K's window and of the far wing) at mu = 1 and 0.5 against the
    JAX package's: 1e-9 of the spectrum's maximum; with stokes=True the
    unmagnetised atmosphere's Q, U and V are zero on both sides."""
    jctx, tctx = pair
    _take_state(tctx, jctx)
    lam = np.concatenate([np.linspace(392.8, 393.9, 23),
                          np.linspace(500.0, 800.0, 7)])
    ours = tctx.compute_rays(lam, mus=[1.0, 0.5], stokes=stokes)
    ref = np.asarray(jctx.compute_rays(lam, mus=[1.0, 0.5], stokes=stokes))
    assert ours.shape == ref.shape == ((4, 30, 2) if stokes else (30, 2))
    assert isinstance(ours, np.ndarray) and np.isfinite(ours).all()
    if stokes:
        assert not ours[1:].any() and not ref[1:].any()
        ours, ref = ours[0], ref[0]
    assert _rel(ours, ref) < 1e-9


@pytest.mark.slow
def test_compute_rays_refine_prd_matches_jax():
    """compute_rays(refinePrd=True) on falc_h6mg (FAL-C at 12 depths, 2
    rays, H 6 + Mg II active, PRD) from the JAX Context's state after
    three MALI steps with prd_redistribute, over Mg II k on the Context's
    own rays: the ray Context's MALI step and prd_redistribute(maxIter=
    100) before its formal solution, against the JAX package's (1e-9 of
    the maximum; ~70 s on the CPU)."""
    from lightweaver_tpu_torch.problems import h6mg_context
    atmos = _jax_falc_interpolated(NSPACE)
    atmos.quadrature(NRAYS)
    rs = JRadiativeSet([jatoms.H_6_atom(), jatoms.MgII_atom()])
    rs.set_active('H', 'Mg')
    jctx = JContext(atmos, rs.compute_wavelength_grid(),
                    rs.compute_eq_pops(atmos))
    for _ in range(3):
        jctx.formal_sol_gamma_matrices()
        jctx.stat_equil()
        jctx.prd_redistribute(maxIter=2)
    tctx = h6mg_context(falc_interpolated(NSPACE), NRAYS, device='cpu')
    _take_state(tctx, jctx)
    for ai, ti, _, _ in tctx._prd_lines():
        tctx.rhoPrd[ai][ti] = torch.tensor(np.asarray(jctx.rhoPrd[ai][ti]))
    lam = np.linspace(279.4, 280.5, 40)
    ours = tctx.compute_rays(lam, refinePrd=True)
    ref = np.asarray(jctx.compute_rays(lam, refinePrd=True))
    assert np.isfinite(ours).all()
    assert _rel(ours, ref) < 1e-9
    assert _rel(tctx.compute_rays(lam), ref) > 1e-3
