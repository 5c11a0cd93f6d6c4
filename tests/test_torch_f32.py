"""The float32 state (mixed precision) of the port against the JAX package's.

FAL-C decimated to 24 depths (tests/test_mixed_precision.py's decimation),
3 rays, H 6-level + Ca II active.  A JAX Context with dtype=float32
(accumDtype float64, chosen automatically) takes three MALI steps; its
params go through params_from_numpy into the port's float32 iteration
under each scheme and into the JAX float32 iteration of the same scheme,
whose Pallas kernels run in interpret mode on the CPU (the sweep under
recurrenceMode='pallas', the line Gamma kernel, the fused lambda step).

The bars against the JAX float32 iteration are the distances between the
JAX float32 and float64 iterations on this state (measured: J 2.6e-4, I
4.1e-3, Gamma 2.1e-6, Rij 7.7e-5, Rji 3.4e-5): J <= 3e-4, I <= 5e-3,
Gamma <= 2e-5, Rij/Rji <= 3e-4 of each array's maximum.  Nearly all of
that distance is the JAX float32 Bezier-3 weights' cancellation (alpha
dt^3 = 6 - e^-dt (...) ~ dt^4 / 4 near the Taylor switch at dt = 5e-2),
which the port's float32 sweep avoids by summing the weights' power
series on 5e-2 <= dt < 1 (ops/formal_solver.py:B3_SERIES, and the same
in csrc/bezier3.cuh).  So the port's float32 iteration is also held
against the JAX float64 one on the same params, at float32 rounding
(measured: J 3.1e-7, I 6.7e-7, Gamma 2.2e-8, Rij 4.0e-7, Rji 5.4e-7):
J, I, Rij, Rji <= 3e-6, Gamma <= 3e-7.

dJ: XLA on the CPU, like the TPU, flushes float32 subnormals to zero.
Here that zeroes subnormal emissivities in a few ultraviolet rows whose
source function is normal, so the JAX float32 dJ reads 125.7 where the
float64 one reads 4.06.  PyTorch (and the CUDA kernels, built without
-ftz) keep IEEE gradual underflow; with torch.set_flush_denormal(True)
the port reproduces the JAX float32 dJ to 1e-3, without it the float64
one to 2e-3.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import lightweaver_tpu.rh_atoms as jatoms
from lightweaver_tpu.atmosphere import Atmosphere as JAtmosphere
from lightweaver_tpu.atomic_set import RadiativeSet as JRadiativeSet
from lightweaver_tpu.context import Context as JContext
from lightweaver_tpu.context import _sum_lam_blocked as j_sum_lam_blocked
from lightweaver_tpu.context import _sum_lmd_split as j_sum_lmd_split
from lightweaver_tpu.context import build_iteration_fn as j_build_iteration_fn
from lightweaver_tpu.fal import Falc82 as JFalc82
from lightweaver_tpu_torch import config as tconfig
from lightweaver_tpu_torch import iterate_ctx_se
from lightweaver_tpu_torch.context import (Context, _sum_lam_blocked,
                                           _sum_lmd_split, build_iteration_fn)
from lightweaver_tpu_torch.convert import params_from_numpy
from lightweaver_tpu_torch.ops import sweep as tsweep
from lightweaver_tpu_torch.problems import (falc_decimated, h6ca_context,
                                            mixed_precision_context,
                                            random_rays)

NSPACE, NRAYS = 24, 3
SCHEMES = ('mali_full_precond', 'mali_full_precond_pallas',
           'mali_full_precond_fused')
# the JAX configuration of each scheme: the default one with the Pallas
# sweep kernel, the other two with their own kernels
JAX_SCHEME = {SCHEMES[0]: {'recurrenceMode': 'pallas'},
              SCHEMES[1]: {'fsIterScheme': SCHEMES[1]},
              SCHEMES[2]: {'fsIterScheme': SCHEMES[2]}}
BARS = {'J': 3e-4, 'I': 5e-3, 'Gamma': 2e-5, 'Rij': 3e-4, 'Rji': 3e-4}

# one intra-op thread per process: the tier-1 run has six pytest workers
torch.set_num_threads(1)


def _jax_falc_decimated(Nspace):
    full = JFalc82()
    idx = np.unique(np.linspace(0, 81, Nspace).astype(int))
    return JAtmosphere(height=full.height[idx],
                       temperature=full.temperature[idx],
                       vlos=full.vlos[idx], vturb=full.vturb[idx],
                       ne=full.ne[idx], nHTot=full.nHTot[idx])


def rel(ours, ref):
    """max |ours - ref| / max |ref|."""
    ours = np.asarray(ours, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(ours - ref).max() / np.abs(ref).max()


@pytest.fixture(scope='module')
def state():
    """The JAX float32 Context after three MALI steps, its params, and the
    port's float32 Context of the same problem on the CPU."""
    atmos = _jax_falc_decimated(NSPACE)
    atmos.quadrature(NRAYS)
    rs = JRadiativeSet([jatoms.H_6_atom(), jatoms.CaII_atom()])
    rs.set_active('H', 'Ca')
    spect = rs.compute_wavelength_grid()
    jctx = JContext(atmos, spect, rs.compute_eq_pops(atmos),
                    dtype=jnp.float32)
    assert jctx.accumDtype == jnp.float64
    for _ in range(3):
        jctx.formal_sol_gamma_matrices()
        jctx.stat_equil()
    tctx = h6ca_context(falc_decimated(NSPACE), NRAYS, device='cpu',
                        dtype=torch.float32)
    return jctx, tctx, jctx.build_params()


def jax_iteration(jctx, jparams, **changes):
    return jax.jit(j_build_iteration_fn(
        dataclasses.replace(jctx.cfg, **changes)))(jparams)


def port_iteration(tctx, jparams, **changes):
    cfg = dataclasses.replace(tctx.cfg, **changes)
    return build_iteration_fn(cfg)(params_from_numpy(jparams, cfg))


def flush_denormals(fn):
    """fn() with float32 subnormals flushed to zero, as XLA computes."""
    torch.set_flush_denormal(True)
    try:
        return fn()
    finally:
        torch.set_flush_denormal(False)


def compare(out, ref, bars=BARS):
    errs = {'J': rel(out['J'], ref['J']), 'I': rel(out['I'], ref['I'])}
    for ai in range(len(ref['Gamma'])):
        errs[f'Gamma{ai}'] = rel(out['Gamma'][ai], ref['Gamma'][ai])
        for key in ('Rij', 'Rji'):
            for ti, x in enumerate(out[key][ai]):
                errs[f'{key}{ai}.{ti}'] = rel(x, ref[key][ai][ti])
    bad = {k: e for k, e in errs.items()
           if not e <= bars[k.rstrip('0123456789.')]}
    assert not bad, bad


@pytest.mark.parametrize('scheme', SCHEMES)
def test_iteration_matches_jax_f32(state, scheme):
    """One MALI iteration of the port's float32 state under each scheme
    against the JAX float32 iteration of that scheme, on the same params,
    at the bars of the module docstring; dJ with subnormals flushed as XLA
    flushes them, to 1e-3."""
    jctx, tctx, jparams = state
    ref = jax_iteration(jctx, jparams, **JAX_SCHEME[scheme])
    out = port_iteration(tctx, jparams, fsIterScheme=scheme)
    compare(out, ref)
    ftz = flush_denormals(lambda: port_iteration(tctx, jparams,
                                                 fsIterScheme=scheme))
    np.testing.assert_allclose(float(ftz['dJ']), float(ref['dJ']), rtol=1e-3)


BARS_F64 = {'J': 3e-6, 'I': 3e-6, 'Gamma': 3e-7, 'Rij': 3e-6, 'Rji': 3e-6}


@pytest.fixture(scope='module')
def jax_f64(state):
    """The JAX float64 iteration on the float32 state's params (the same
    float32-representable values in float64)."""
    jctx, _, jparams = state
    j64 = jax.tree_util.tree_map(
        lambda x: (jnp.asarray(x, jnp.float64)
                   if getattr(x, 'dtype', None) == jnp.float32 else x),
        jparams)
    return jax_iteration(jctx, j64, dtype=jnp.float64, recurrenceMode='scan')


@pytest.mark.parametrize('scheme', SCHEMES)
def test_iteration_is_the_f64_one_to_f32_rounding(state, jax_f64, scheme):
    """With the Bezier-3 weights free of cancellation, the port's float32
    iteration under each scheme is the JAX float64 iteration on the same
    params to float32 rounding (module docstring's BARS_F64)."""
    _, tctx, jparams = state
    compare(port_iteration(tctx, jparams, fsIterScheme=scheme), jax_f64,
            BARS_F64)


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_bezier3_weights_in_f32_do_not_cancel(dtype):
    """The weights on 5e-2 <= dt < 1: float32 (power series) within 1e-6
    of the float64 closed forms, where float32 closed forms lose > 1e-2
    of alpha near 5e-2; float64 keeps the closed forms exactly, and the
    series agrees with them to 3e-9, below float32 resolution (the float64
    closed forms themselves cancel to ~1e-9 near 5e-2)."""
    from lightweaver_tpu_torch.ops import formal_solver as fs
    dt64 = torch.linspace(5e-2, 1.0 - 1e-6, 4001, dtype=torch.float64)
    ref = fs.bezier3_coeffs(dt64)
    ours = fs.bezier3_coeffs(dt64.to(dtype))
    if dtype == torch.float64:
        for c, x in zip(fs.B3_SERIES, ref[:4]):
            np.testing.assert_allclose(fs._b3_series(c, dt64), x, rtol=3e-9)
        return
    # the float32 inputs exactly, in float64
    ref = fs.bezier3_coeffs(dt64.to(dtype).double())
    for x, r in zip(ours, ref):
        assert x.dtype == torch.float32
        assert rel(x, r) < 1e-6 and ((x.double() - r) / r).abs().max() < 1e-6
    dt32 = dt64.to(dtype)
    e = torch.exp(-dt32)
    closed = (6.0 - e * (6.0 + 6.0 * dt32 + 3.0 * dt32 ** 2 + dt32 ** 3)) \
        / dt32 ** 3
    assert ((closed.double() - ref[0]) / ref[0]).abs().max() > 1e-2


def test_dJ_without_flushing_is_the_f64_one(state, jax_f64):
    """Without flushing, the float32 state's dJ is the float64 state's
    (4.06 on this state) to 2e-3, and far from the flushed 125.7: the
    difference between the two is the flush, not the algorithm."""
    _, tctx, jparams = state
    ref64 = jax_f64
    out = port_iteration(tctx, jparams)
    ftz = flush_denormals(lambda: port_iteration(tctx, jparams))
    np.testing.assert_allclose(float(out['dJ']), float(ref64['dJ']),
                               rtol=2e-3)
    assert float(ftz['dJ']) > 10 * float(out['dJ'])


def test_blocked_gamma_accum_matches_jax(state):
    """gammaAccum='blocked' (float32 partials of 32 lambda rows, their sum
    in float64) against the JAX blocked iteration at the same bars; and
    within 5e-6 of the exact accumulation on the same state (the JAX
    package's test_gamma_accum bar), without being it."""
    jctx, tctx, jparams = state
    ref = jax_iteration(jctx, jparams, gammaAccum='blocked')
    out = port_iteration(tctx, jparams, gammaAccum='blocked')
    compare(out, ref)
    exact = port_iteration(tctx, jparams)
    for ai in range(2):
        assert rel(out['Gamma'][ai], exact['Gamma'][ai]) < 5e-6
        assert not torch.equal(out['Gamma'][ai], exact['Gamma'][ai])
        for key in ('Rij', 'Rji'):
            for x, y in zip(out[key][ai], exact[key][ai]):
                assert rel(x, y) < 5e-6


def test_f32_state_keeps_j_gamma_and_rates_in_f64():
    """Under the float32 state J, Gamma, Rij and Rji are float64, the ray
    tensors and the emergent I float32, the Context's state float64."""
    ctx = h6ca_context(falc_decimated(12), 2, device='cpu',
                       dtype=torch.float32)
    assert ctx.dtype == torch.float32 and ctx.accumDtype == torch.float64
    params = ctx.build_params()
    scaJ = params['bgSca'] * params['J']
    chi, src = ctx._iter_fn.gather(params, scaJ.float())
    I, Psi, IeffBase, moments = ctx._iter_fn.formal_solve(params, chi, src)
    assert {x.dtype for x in (chi, src, I, Psi, IeffBase)} == {torch.float32}
    assert moments['J'].dtype == torch.float64
    ctx.formal_sol_gamma_matrices()
    ctx.stat_equil()
    assert ctx.J.dtype == torch.float64 and ctx.I.dtype == torch.float32
    for ai in range(2):
        assert ctx._Gamma[ai].dtype == torch.float64
        assert {x.dtype for x in ctx._Rij[ai] + ctx._Rji[ai]} == {
            torch.float64}
        assert ctx.popsState[ai]['n'].dtype == torch.float64
    assert ctx.bgChi.dtype == torch.float64
    assert ctx.phi[0][ctx.activeAtoms[0].trans.index(
        next(t for t in ctx.activeAtoms[0].trans if t.isLine))].dtype \
        == torch.float32


@pytest.mark.parametrize('Nk', [12, 40])
def test_plain_sweep_j_is_the_f64_sum_of_its_f32_products(Nk):
    """The plain sweep's J in float32 is the float64 sum of its own float32
    products w I (in the kernel's order: mu ascending within a direction,
    then down + up) to 1e-13, and IBar the float32 sum."""
    c = {k: torch.tensor(v, dtype=torch.float32)
         for k, v in random_rays(6, 4, Nk, seed=Nk).items()}
    I, _, _, mom = tsweep.formal_solve_sweep(**c)
    w = 0.5 * c['wmu']
    own = [sum((w[m] * I[d, :, m]).double() for m in range(4))
           for d in range(2)]
    ref = own[0] + own[1]
    assert mom['J'].dtype == torch.float64
    np.testing.assert_allclose(mom['J'], ref, rtol=1e-13, atol=0)
    assert mom['IBar'].dtype == torch.float32
    np.testing.assert_allclose(mom['IBar'], ref, rtol=1e-6)


def _adversarial_rows(W=4096, Nk=6):
    """[W, Nk] float32 rows: one of 1.0 alone in the first block of 32,
    then W - 32 rows of 2^-26, below float32's resolution at 1 (a
    sequential float32 sum drops them all, 6e-5 of the total); every
    block sum is exact in float32 in any order."""
    x = np.full((W, Nk), 2.0 ** -26, np.float32)
    x[:32] = 0.0
    x[0] = 1.0
    return x


def test_adversarial_rows_defeat_a_float32_sum():
    x = _adversarial_rows()
    exact = x.astype(np.float64).sum(axis=0)
    sequential = np.cumsum(x, axis=0, dtype=np.float32)[-1]
    assert ((exact - sequential) / exact).min() >= 1e-5


def test_sum_lam_blocked_matches_jax():
    """Float32 partials of 32 rows summed in float64: the JAX function's
    result, and the exact sum, to 1e-7."""
    x = _adversarial_rows()
    ours = _sum_lam_blocked(torch.as_tensor(x), torch.float64)
    ref = np.asarray(j_sum_lam_blocked(jnp.asarray(x), jnp.float64))
    assert ours.dtype == torch.float64
    np.testing.assert_allclose(ours, ref, rtol=1e-7, atol=0)
    np.testing.assert_allclose(ours, x.astype(np.float64).sum(axis=0),
                               rtol=1e-7, atol=0)


@pytest.mark.parametrize('blocked', [False, True])
def test_sum_lmd_split_matches_jax(blocked):
    """The (up/down, mu) contraction in float32, the lambda sum in float64
    (blocked: float32 partials of 32 rows): the JAX function's result on
    the adversarial rows spread over 2 x Nmu rays (the JAX layout
    [W, Nmu, 2, Nk], the port's [2, W, Nmu, Nk]), and the exact sum, to
    1e-7."""
    rows = _adversarial_rows()
    W, Nk = rows.shape
    Nmu = 3
    x = np.broadcast_to(rows[None, :, None, :], (2, W, Nmu, Nk)).copy()
    wmu = np.full(Nmu, 0.5, np.float32)
    wla = np.ones((W, Nk))
    ours = _sum_lmd_split(torch.as_tensor(x), torch.as_tensor(wla),
                          torch.as_tensor(wmu, dtype=torch.float64),
                          torch.as_tensor(wmu), torch.float64, blocked)
    ref = np.asarray(j_sum_lmd_split(
        jnp.asarray(np.moveaxis(x, 0, 2)), jnp.asarray(wla),
        jnp.asarray(wmu, jnp.float64), jnp.asarray(wmu), jnp.float64,
        blocked=blocked))
    assert ours.dtype == torch.float64
    np.testing.assert_allclose(ours, ref, rtol=1e-7, atol=0)
    np.testing.assert_allclose(
        ours, 2 * Nmu * 0.5 * rows.astype(np.float64).sum(axis=0),
        rtol=1e-7, atol=0)


def test_context_defaults_to_the_card():
    """A Context, h6ca_context or mixed-precision Context built without a
    device asks for the card; where there is none it raises at once."""
    if torch.cuda.is_available():
        pytest.skip('checks the behaviour without a CUDA device')
    ctx = h6ca_context(falc_decimated(12), 2, device='cpu')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Context(ctx.atmos, ctx.spect, ctx.eqPops)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        h6ca_context(falc_decimated(12), 2)


@pytest.mark.parametrize('rc, expected', [
    ({}, (torch.float64, 'exact')),
    ({'Precision': 'mixed'}, (torch.float32, 'exact')),
    ({'Precision': 'mixed', 'GammaAccum': 'blocked'},
     (torch.float32, 'blocked')),
], ids=['defaults', 'mixed', 'mixed-blocked'])
def test_lightweaverrc_selects_the_precision(monkeypatch, rc, expected):
    """lightweaverrc Precision: mixed (config.params) selects the float32
    state with accumDtype float64; config.params' GammaAccum, which the
    Context reads as the JAX one does, the lambda reduction."""
    for key, value in rc.items():
        monkeypatch.setitem(tconfig.params, key, value)
    ctx = h6ca_context(falc_decimated(12), 2, device='cpu')
    assert (ctx.dtype, ctx.cfg.gammaAccum) == expected
    assert ctx.accumDtype == ctx.cfg.accumDtype == torch.float64
    assert ctx.cfg.dtype == ctx.dtype


def test_params_from_numpy_takes_the_cfg_dtypes(state):
    """The JAX float32 params in the port's float32 cfg: the state float64
    (exactly the JAX float32 values), the profiles float32."""
    jctx, tctx, jparams = state
    p = params_from_numpy(jparams, tctx.cfg)
    assert p['J'].dtype == p['bgChi'].dtype == torch.float64
    assert p['pops'][0].dtype == p['C'][0].dtype == torch.float64
    np.testing.assert_array_equal(p['pops'][1].float(),
                                  np.asarray(jparams['pops'][1]))
    ai, ti = 1, next(ti for ti, t in enumerate(jctx.activeAtoms[1].trans)
                     if t.isLine)
    assert p['phi'][ai][ti].dtype == p['wphi'][ai][ti].dtype == torch.float32
    np.testing.assert_array_equal(
        p['phi'][ai][ti], np.moveaxis(np.asarray(jparams['phi'][ai][ti]),
                                      2, 0))


@pytest.mark.slow
def test_f32_converges_on_the_mixed_precision_problem():
    """The port's float32 state converges on tests/test_mixed_precision.py's
    problem (40 depths, 3 rays, Ca II active) within 600 iterations, as
    the JAX float32 state does (408 iterations on the CPU), at JTol 5e-3
    and popsTol 1e-3; the emergent intensity is finite and positive."""
    ctx = mixed_precision_context(device='cpu', dtype=torch.float32)
    nIter = iterate_ctx_se(ctx, NmaxIter=600, quiet=True)
    assert nIter < 600
    assert torch.isfinite(ctx.I).all() and (ctx.I > 0).all()
