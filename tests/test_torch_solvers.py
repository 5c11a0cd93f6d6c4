"""The three 1D formal solvers of the port (piecewise linear, cubic
Bezier, BESSER) against the JAX package's, from the per-point
coefficients to one MALI step of a Context.

On the CPU the sweep wrapper runs its plain version, which for every
solver is ops/formal_solver.py:formal_sol_1d; its 'sequential' order is
the JAX package's lax.scan, its 'chunked' order the CUDA kernel's.  The
bars: 1e-11 of each output's maximum in float64 against the JAX solver
(XLA's exp and torch's differ in the last ulps, carried along the depth
chain).  In float32, where the port keeps the JAX formulas for linear and
BESSER but the two exps differ by an ulp that the formulas' cancellations
magnify (BESSER's middle branch near t = 0.14 loses ~3 digits), the port
must be as close to the float64 result as the JAX package's float32
result is: err(port f32, f64) <= 2 err(JAX f32, f64) + 32 float32 ulps of
the maximum (the rule that holds the port's float32 kernels).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import lightweaver_tpu.rh_atoms as jatoms
from lightweaver_tpu.atomic_set import RadiativeSet as JRadiativeSet
from lightweaver_tpu.context import Context as JContext
from lightweaver_tpu.ops import formal_solver as jfs
from lightweaver_tpu_torch.context import Context
from lightweaver_tpu_torch.convert import params_from_numpy
from lightweaver_tpu_torch.ops import formal_solver as tfs
from lightweaver_tpu_torch.ops import sweep as tsweep
from lightweaver_tpu_torch.problems import (falc_interpolated, h6ca_context,
                                            random_rays)

from tests.test_torch_slice import _compare_iteration, _jax_falc_interpolated

SOLVERS = tfs.SOLVER_NAMES_1D
F32_BAR = 32 * np.finfo(np.float32).eps

# one intra-op thread per process: the tier-1 run has six pytest workers
torch.set_num_threads(1)


def _rel(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    return np.abs(ours - ref).max() / np.abs(ref).max()


def _f32_rule(ours, ref, truth):
    """err(ours, truth) <= 2 err(ref, truth) + F32_BAR, each relative to
    the maximum of the float64 truth."""
    assert _rel(ours, truth) <= 2.0 * _rel(ref, truth) + F32_BAR


def _problem(B=24, N=40, seed=0):
    """Random rays spanning six decades of opacity and four of source
    function, as numpy arrays (chi, S, height, muz, I_upw)."""
    rng = np.random.default_rng(seed)
    chi = 10 ** rng.uniform(-8, -2, (B, N))
    S = 10 ** rng.uniform(-2, 2, (B, N))
    h = np.sort(rng.uniform(0, 1e6, N))[::-1].copy()
    return chi, S, h, rng.uniform(0.05, 1.0, B), rng.uniform(0.0, 1.0, B)


def test_solver_names_match_jax():
    assert tfs.SOLVER_NAMES_1D == jfs.SOLVER_NAMES_1D
    assert tsweep.SOLVER_CODES == {'piecewise_linear_1d': 0,
                                   'piecewise_bezier3_1d': 1,
                                   'piecewise_besser_1d': 2}


@pytest.mark.parametrize('dtype', [np.float64, np.float32])
def test_besser_helpers_match_jax(dtype):
    """besser_control_point (every branch: monotonic, the clamps of both
    control points, an extremum; no exp, so 1e-15 in float64) and
    besser_coeffs (both sides of the Taylor branch at t = 0.14, past the
    exp cap at t = 200; 1e-12 in float64: the middle branch's
    cancellation near t = 0.14 magnifies the last-ulp differences of XLA's
    exp and torch's ~100 times).  float32: the rule of _f32_rule."""
    rng = np.random.default_rng(1)
    n = 4000
    args = [rng.uniform(0.1, 2.0, n), rng.uniform(0.1, 2.0, n)] + [
        rng.uniform(-1.0, 1.0, n) for _ in range(3)]
    t = np.concatenate([10 ** rng.uniform(-4, 3, n), [0.14, 0.1399, 250.0]])
    cases = ((tfs.besser_control_point, jfs.besser_control_point, args,
              1e-15),
             (tfs.besser_coeffs, jfs.besser_coeffs, [t], 1e-12))
    for ours_fn, ref_fn, xs, bar in cases:
        xsD = [x.astype(dtype) for x in xs]
        ours = ours_fn(*map(torch.tensor, xsD))
        ref = ref_fn(*map(jnp.asarray, xsD))
        truth = ref_fn(*map(jnp.asarray, xs))
        if ours_fn is tfs.besser_control_point:
            ours, ref, truth = [ours], [ref], [truth]
        for o, r, tr in zip(ours, ref, truth):
            assert o.dtype == torch.from_numpy(xsD[0]).dtype
            if dtype == np.float64:
                assert _rel(o.numpy(), r) < bar
            else:
                _f32_rule(o.numpy(), r, tr)


@pytest.mark.parametrize('dtype', [np.float64, np.float32])
@pytest.mark.parametrize('solver', ['piecewise_linear_1d',
                                    'piecewise_besser_1d'])
def test_coefficients_match_jax(solver, dtype):
    """The affine coefficients (A, b, psiN, bNL) of the linear and BESSER
    steps: the same formulas as the JAX package's, 1e-11 of the maximum in
    float64, the rule of _f32_rule in float32."""
    chi, S, h, muz, _ = _problem()
    ds = np.abs(h[1:] - h[:-1])[None, :] / muz[:, None]
    xs = [chi, S, ds]
    xsD = [x.astype(dtype) for x in xs]
    ref = jfs._COEFF_FNS[solver](*map(jnp.asarray, xsD))
    ours = tfs._COEFF_FNS[solver](*map(torch.tensor, xsD))
    truth = jfs._COEFF_FNS[solver](*map(jnp.asarray, xs))
    for o, r, tr in zip(ours, ref, truth):
        if dtype == np.float64:
            assert _rel(o.numpy(), r) < 1e-11
        else:
            _f32_rule(o.numpy(), r, tr)


@pytest.mark.parametrize('solver, dtype', [
    (s, d) for s in SOLVERS for d in (np.float64, np.float32)
    if (s, d) != ('piecewise_bezier3_1d', np.float32)])
@pytest.mark.parametrize('to_obs', [True, False])
def test_formal_sol_1d_matches_jax(solver, to_obs, dtype):
    """I, Psi and IeffBase of each solver in the 'sequential' order
    against the JAX package's scan: 1e-11 of the maximum in float64, the
    rule of _f32_rule in float32.  Bezier-3 in float32 takes its weights
    from power series on 5e-2 <= dtau < 1 where the JAX package keeps the
    closed forms (ops/formal_solver.py:B3_SERIES), so it is held in float64
    only."""
    xs = _problem()
    xsD = [x.astype(dtype) for x in xs]
    ref = jfs.formal_sol_1d(*map(jnp.asarray, xsD), to_obs=to_obs,
                            method=solver)
    ours = tfs.formal_sol_1d(*map(torch.tensor, xsD), to_obs=to_obs,
                             method=solver, mode='sequential')
    truth = jfs.formal_sol_1d(*map(jnp.asarray, xs), to_obs=to_obs,
                              method=solver)
    for o, r, tr in zip(ours, ref, truth):
        if dtype == np.float64:
            assert _rel(o.numpy(), r) < 1e-11
        else:
            _f32_rule(o.numpy(), r, tr)


@pytest.mark.parametrize('solver', SOLVERS)
def test_chunked_order_matches_sequential(solver):
    """'chunked' (the kernel's 32-depth scan) and 'sequential' sum the
    same recurrence in two orders: 1e-13 of the maximum, at N = 100 (four
    chunks, the last one partial)."""
    args = [torch.tensor(x) for x in _problem(B=8, N=100, seed=2)]
    seq = tfs.formal_sol_1d(*args, method=solver, mode='sequential')
    chk = tfs.formal_sol_1d(*args, method=solver, mode='chunked')
    for a, b in zip(chk, seq):
        assert _rel(a.numpy(), b.numpy()) < 1e-13
    with pytest.raises(ValueError, match='unknown 1D formal solver'):
        tfs.formal_sol_1d(*args, method='piecewise_linear_2d')


@pytest.mark.parametrize('solver', SOLVERS)
def test_constant_source_function(solver):
    """S = const, zero incident intensity: I = S (1 - exp(-tau)) (the
    oracle of tests/test_formal_solver.py)."""
    N, B = 160, 3
    height = np.linspace(1e6, 0.0, N)
    chi = np.full((B, N), 1e-5)
    S = np.full((B, N), 7.3e-9)
    muz = np.array([1.0, 0.5, 0.3])
    I, _, _ = tfs.formal_sol_1d(*map(torch.tensor, (chi, S, height, muz,
                                                    np.zeros(B))),
                                to_obs=False, method=solver)
    tau = chi[:, 0][:, None] * (height[0] - height)[None, :] / muz[:, None]
    np.testing.assert_allclose(I.numpy(), S * (1.0 - np.exp(-tau)),
                               rtol=1e-6, atol=1e-18)


@pytest.mark.parametrize('solver', SOLVERS)
def test_optically_thick_saturates_to_S(solver):
    """An optically thick slab: the emergent I is S and deep Psi* ~ 1/chi
    (the oracle of tests/test_formal_solver.py)."""
    N = 120
    height = np.linspace(1e6, 0.0, N)
    I, Psi, _ = tfs.formal_sol_1d(
        *map(torch.tensor, (np.full((1, N), 1.0), np.full((1, N), 4.2e-9),
                            height, np.array([0.9]), np.array([0.0]))),
        to_obs=True, method=solver)
    np.testing.assert_allclose(float(I[0, 0]), 4.2e-9, rtol=1e-10)
    np.testing.assert_allclose(float(Psi[0, N // 2]), 1.0, rtol=1e-2)


@pytest.mark.parametrize('solver', SOLVERS)
def test_sweep_plain_matches_jax(solver):
    """formal_solve_sweep_plain(solver=...) on random rays: each direction
    against the JAX package's formal_sol_1d of that solver, and the
    moments against the wmu/2 sums of the JAX rays: 1e-10 of the maximum,
    the bar of tests/test_torch_ops.py's sweep test (on these rough rays
    the Bezier-3 weights carry XLA's exp's last ulps through the Steffen
    limiter to 3.6e-11)."""
    c = random_rays(6, 3, 30, seed=11)
    ours = tsweep.formal_solve_sweep(
        **{k: torch.tensor(v) for k, v in c.items()}, solver=solver)
    S = c['srcNum'] / c['chi']
    muzB = np.broadcast_to(c['muz'], (6, 3)).reshape(-1)
    rays = []
    for d, toObs, Iupw in ((0, False, c['IupwD']), (1, True, c['IupwU'])):
        out = jfs.formal_sol_1d(
            jnp.asarray(c['chi'][d].reshape(-1, 30)),
            jnp.asarray(S[d].reshape(-1, 30)), jnp.asarray(c['height']),
            jnp.asarray(muzB), jnp.asarray(Iupw.reshape(-1)), to_obs=toObs,
            method=solver)
        rays.append([np.asarray(x).reshape(6, 3, 30) for x in out])
    I, Psi, IeffB = (np.stack([r[i] for r in rays]) for i in range(3))
    for o, r in zip(ours[:3], (I, Psi, IeffB)):
        assert _rel(o.numpy(), r) < 1e-10
    w = 0.5 * c['wmu'][None, None, :, None]
    refs = {'J': I, 'PsiBar': Psi, 'IeffSrcBar': IeffB + Psi * c['srcNum']}
    for name, x in refs.items():
        assert _rel(ours[3][name].numpy(), (x * w).sum(axis=(0, 2))) < 1e-10


NSPACE, NRAYS = 12, 2


@pytest.fixture(scope='module')
def jax_ctx():
    """The JAX Context of a 12-depth FAL-C with H 6-level + Ca II active,
    2 rays (the port's problems.falc_interpolated, on JAX classes)."""
    atmos = _jax_falc_interpolated(NSPACE)
    atmos.quadrature(NRAYS)
    rs = JRadiativeSet([jatoms.H_6_atom(), jatoms.CaII_atom()])
    rs.set_active('H', 'Ca')
    spect = rs.compute_wavelength_grid()
    return JContext(atmos, spect, rs.compute_eq_pops(atmos))


@pytest.mark.parametrize('solver', ['piecewise_linear_1d',
                                    'piecewise_besser_1d'])
def test_mali_step_matches_jax(jax_ctx, solver):
    """One MALI step and stat_equil under the linear and BESSER solvers:
    the port's iteration on the JAX Context's params against the JAX
    step after set_formal_solver (Gamma, Rij, Rji and dJ 1e-10; J and I
    1e-9 of each wavelength's maximum: the slice test's bars), under
    each scheme that takes the solver; then the port's Context steps on
    its own and agrees with the JAX one likewise."""
    jctx = jax_ctx
    jctx.set_formal_solver(solver)
    tctx = h6ca_context(falc_interpolated(NSPACE), NRAYS, device='cpu')
    tctx.set_formal_solver(solver)
    jparams = jctx.build_params()
    tparams = params_from_numpy(jparams, tctx.cfg)
    outs = [tctx._iter_fn(tparams)]
    tctx.set_fs_iter_scheme('mali_full_precond_pallas')
    outs.append(tctx._iter_fn(tparams))
    ju = jctx.formal_sol_gamma_matrices()
    for out in outs:
        _compare_iteration(out, jctx, ju)

    # the port's Context from the same state, one step and stat_equil
    tctx.J = tparams['J']
    for st, n in zip(tctx.popsState, tparams['pops']):
        st['n'] = n
    tu = tctx.formal_sol_gamma_matrices()
    _compare_iteration({'Gamma': tctx._Gamma, 'Rij': tctx._Rij,
                        'Rji': tctx._Rji, 'J': tctx.J, 'I': tctx.I,
                        'dJ': tu.dJMax}, jctx, ju)
    jctx.stat_equil()
    tctx.stat_equil()
    for st, jst in zip(tctx.popsState, jctx.popsState):
        assert _rel(st['n'].numpy(), jst['n']) < 1e-9
    jctx.set_formal_solver('piecewise_bezier3_1d')


@pytest.fixture(scope='module')
def small():
    return h6ca_context(falc_interpolated(NSPACE), NRAYS, device='cpu')


def test_set_formal_solver_rebuilds_its_caches(small):
    """set_formal_solver swaps the solver of every later sweep and drops
    everything built from the old config (the iteration function, the
    cached params with the scheme's packed input, the PRD subset
    function), so the next step's I is the new solver's; unknown and 2D
    names raise and leave the solver as it was (the JAX package's
    test_context_solver_swap)."""
    ctx = small
    ctx.set_fs_iter_scheme('mali_full_precond_pallas')
    ctx.formal_sol_gamma_matrices()
    Ibez = ctx.I.clone()
    oldFn, oldParams = ctx._iter_fn, ctx._params
    assert oldParams['pack'] is not None
    ctx._prd_fs_fn = object()
    ctx.set_formal_solver('piecewise_linear_1d')
    assert ctx.cfg.formalSolver == 'piecewise_linear_1d'
    assert ctx._iter_fn is not oldFn and ctx._params is None
    assert ctx._prd_fs_fn is None
    assert ctx.cfg.fsIterScheme == 'mali_full_precond_pallas'
    ctx.J = torch.zeros_like(ctx.J)
    ctx.formal_sol_gamma_matrices()
    Ilin = ctx.I.clone()
    assert not torch.equal(Ibez, Ilin)
    assert torch.isfinite(Ilin).all() and (Ilin > 0).all()
    assert 0.5 < (Ilin.max() / Ibez.max()).item() < 2.0
    for bad in ('nope', 'piecewise_linear_2d', 'piecewise_besser_2d'):
        with pytest.raises(ValueError, match='Unknown formal solver'):
            ctx.set_formal_solver(bad)
    assert ctx.cfg.formalSolver == 'piecewise_linear_1d'
    ctx.set_formal_solver('piecewise_bezier3_1d')
    ctx.set_fs_iter_scheme('mali_full_precond')


def test_fused_refuses_other_solvers(small):
    """The fused kernel is Bezier-3 only, as the JAX package's: a linear
    or BESSER Context refuses the fused scheme at construction and in
    set_fs_iter_scheme with the JAX package's message, and a fused
    Context refuses set_formal_solver to them; the scheme and solver stay
    as they were."""
    msg = ("mali_full_precond_fused does not support this configuration "
           r"\(needs 1D, factored Gamma, no hPRD, "
           "formalSolver='piecewise_bezier3_1d'")
    for solver in ('piecewise_linear_1d', 'piecewise_besser_1d'):
        with pytest.raises(ValueError, match=msg):
            Context(small.atmos, small.spect, small.eqPops, device='cpu',
                    formalSolver=solver,
                    fsIterScheme='mali_full_precond_fused')
        ctx = Context(small.atmos, small.spect, small.eqPops, device='cpu',
                      formalSolver=solver)
        with pytest.raises(ValueError, match=msg):
            ctx.set_fs_iter_scheme('mali_full_precond_fused')
        assert ctx.cfg.fsIterScheme == 'mali_full_precond'
        fused = Context(small.atmos, small.spect, small.eqPops,
                        device='cpu', fsIterScheme='mali_full_precond_fused')
        with pytest.raises(ValueError, match=msg):
            fused.set_formal_solver(solver)
        assert fused.cfg.formalSolver == 'piecewise_bezier3_1d'
