"""Context.iterate_on_device and the device Ng of the port against the JAX
package.

- device_ng_init / device_ng_accelerate against the JAX package's on
  random iterates, Norder 0, 2 and 3, across the Ndelay / Nperiod
  thresholds, and with a non-finite least-squares solve: each call is fed the JAX ring buffer, so
  every call is compared on identical inputs (an extrapolation every step
  amplifies the last bits of the previous one), at 1e-12.
- iterate_on_device against the JAX package's iterate_on_device for a
  fixed number of iterations with zero tolerances (neither loop stops
  early; both run the same iterations) on small problems: FAL-C at 12
  depths, 2 rays, H 6 + Ca II with Ca II active (the plain loop, Ng and
  the float32 state); H 6 active with PRD (30 depths, 3 rays) and hybrid
  PRD (24 depths under an 8 km/s outflow); and a 10 x 4 2D slab (CRD).
  The iteration counts are equal; populations are compared per depth
  (each depth's error over its largest population), J and rho per row
  (each row's error over its largest value), dJ and dPops relatively.
  The bars are set from the measured errors (in each case's entry) with
  a margin of about 10x.
- A converging run (default tolerances) takes the JAX loop's iteration
  count.
- Port-only: a non-finite state raises ExplodingMatrixError and writes
  nothing back; update_deps and set_fs_iter_scheme drop the prepared
  state; PRD on a 2D atmosphere raises; the body of one iteration copies
  nothing from the host and reads nothing back (the CPU cannot trap
  synchronisation, so the Python-level host transfers are trapped
  instead: chip_smoke phase 17 runs the same body under
  torch.cuda.set_sync_debug_mode('error')).
- The JAX package's four tests/test_on_device_loop.py cases on the port,
  against its own host-driven loop (slow).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import lightweaver_tpu.rh_atoms as jatoms
from lightweaver_tpu.atmosphere import Atmosphere as JAtmosphere
from lightweaver_tpu.atomic_set import RadiativeSet as JRadiativeSet
from lightweaver_tpu.context import Context as JContext
from lightweaver_tpu.ops import ng as jng
from lightweaver_tpu.ops.ng import NgOptions as JNgOptions
from lightweaver_tpu_torch import rh_atoms as tatoms
from lightweaver_tpu_torch.atmosphere import Atmosphere
from lightweaver_tpu_torch.atomic_set import RadiativeSet
from lightweaver_tpu_torch.context import Context, DeviceLoop
from lightweaver_tpu_torch.fal import Falc82
from lightweaver_tpu_torch.iterate_ctx import iterate_ctx_se
from lightweaver_tpu_torch.ops import ng as tng
from lightweaver_tpu_torch.ops.ng import NgOptions
from lightweaver_tpu_torch.problems import slab_2d_atmos
from lightweaver_tpu_torch.utils import ExplodingMatrixError

from tests.test_torch_2d_context import jax_atmos

# one intra-op thread per process: the tier-1 run has six pytest workers
torch.set_num_threads(1)


# ---- device Ng -----------------------------------------------------------
NG_CASES = [(0, 0, 0), (2, 3, 5), (2, 1, 0), (3, 2, 4), (3, 1, 5)]
NG_CALLS = 8


@pytest.mark.parametrize('opts', NG_CASES, ids=lambda o: 'ng%d%d%d' % o)
def test_device_ng_matches_jax(opts):
    """NG_CALLS calls from device_ng_init on iterates within 0.2 * 0.6^s
    of a random start, each fed the JAX ring buffer and count: the ring
    buffer, the returned iterate and dMax within 1e-12, the extrapolating
    calls where the JAX ones extrapolate (Ndelay = max(Ndelay, Nperiod +
    2)).  Past NG_CALLS, extrapolating at every call (Nperiod = 1) makes
    the stored iterates nearly collinear: the least-squares matrix's
    condition number passes 1e5 and grows tenfold a call, and the two
    packages' last bits differ by as much from an extended-precision
    solve as from each other."""
    No, Np, Nd = opts
    rng = np.random.default_rng(7 + No)
    L = 60
    x0 = rng.uniform(1.0, 2.0, L)
    jh, jc = jng.device_ng_init(jnp.asarray(x0), No)
    th, tc = tng.device_ng_init(torch.as_tensor(x0), No)
    assert tc == int(jc) == 1
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    accelerated = 0
    for s in range(NG_CALLS):
        x = x0 * (1.0 + 0.2 * 0.6 ** s * rng.uniform(-1.0, 1.0, L))
        th = torch.tensor(np.asarray(jh))
        tc = int(jc)
        jh, jc, js, jd = jng.device_ng_accelerate(jh, jc, jnp.asarray(x),
                                                  No, Np, Nd)
        th, tc, ts, td = tng.device_ng_accelerate(th, tc, torch.as_tensor(x),
                                                  No, Np, Nd)
        assert int(tc) == int(jc)
        scale = np.abs(x).max()
        assert np.abs(ts.numpy() - np.asarray(js)).max() <= 1e-12 * scale
        assert np.abs(th.numpy() - np.asarray(jh)).max() <= 1e-12 * scale
        # dMax = max |cur - old| / |cur|: the hist's error over the
        # smallest |cur|
        cur = np.abs(np.asarray(jh)[int(jc - 1) % len(jh)]).min()
        assert abs(float(td) - float(jd)) <= 1e-12 * scale / cur
        accelerated += not np.array_equal(np.asarray(js), x)
    Nd = max(Nd, max(Np, 1) + 2)
    expect = 0 if No == 0 else len([c for c in range(2, NG_CALLS + 2)
                                    if c >= Nd
                                    and (c - Nd) % max(Np, 1) == 0])
    assert accelerated == expect


def test_device_ng_keeps_the_iterate_on_a_non_finite_solve():
    """A zero in the iterate makes the weights infinite and the
    extrapolation NaN: the plain iterate comes back (and is stored), as
    in the JAX package."""
    rng = np.random.default_rng(3)
    L, No = 20, 2
    h, c = tng.device_ng_init(torch.as_tensor(rng.uniform(1, 2, L)), No)
    jh, jc = jng.device_ng_init(jnp.asarray(h[0].numpy()), No)
    for s in range(4):
        x = rng.uniform(1, 2, L)
        if s == 3:
            x[5] = 0.0
        h, c, sol, d = tng.device_ng_accelerate(h, c, torch.as_tensor(x),
                                                No, 1, 0)
        jh, jc, js, jd = jng.device_ng_accelerate(jh, jc, jnp.asarray(x),
                                                  No, 1, 0)
    np.testing.assert_array_equal(sol.numpy(), x)
    np.testing.assert_array_equal(np.asarray(js), x)
    np.testing.assert_array_equal(h[(c - 1) % (No + 2)].numpy(), x)
    assert float(d) == pytest.approx(float(jd), rel=1e-12)


# ---- the problems ---------------------------------------------------------
def falc_arrays(kind):
    """The FAL-C arrays of a 1D problem: 'interp12' (bench.py's
    interpolation at 12 depths), 'dec30' (30 of its depths) or
    'dec24_outflow' (24 depths, vlos from 8 km/s at the top to 0)."""
    full = Falc82()
    if kind == 'interp12':
        cm = np.log10(full.cmass)
        cmNew = np.linspace(cm[0], cm[-1], 12)

        def interp(y, logY=False):
            if logY:
                return 10 ** np.interp(cmNew, cm, np.log10(y))
            return np.interp(cmNew, cm, y)
        return dict(height=interp(full.height),
                    temperature=interp(full.temperature, logY=True),
                    vlos=np.zeros(12), vturb=interp(full.vturb),
                    ne=interp(full.ne, logY=True),
                    nHTot=interp(full.nHTot, logY=True))
    N = 30 if kind == 'dec30' else 24
    idx = np.unique(np.linspace(0, 81, N).astype(int))
    vlos = (full.vlos[idx] if kind == 'dec30'
            else 8e3 * np.linspace(0.0, 1.0, len(idx))[::-1])
    return dict(height=full.height[idx], temperature=full.temperature[idx],
                vlos=vlos, vturb=full.vturb[idx], ne=full.ne[idx],
                nHTot=full.nHTot[idx])


PROBLEMS = {
    # name: (atmosphere, rays, atoms, active, Context options)
    'ca': ('interp12', 2, ('H_6_atom', 'CaII_atom'), ('Ca',), {}),
    'h_prd': ('dec30', 3, ('H_6_atom',), ('H',),
              {'accelerateScattering': True}),
    'h_hprd': ('dec24_outflow', 3, ('H_6_atom',), ('H',),
               {'accelerateScattering': True, 'hprd': True}),
    'slab': ('slab', 3, ('H_6_atom', 'CaII_atom'), ('Ca',), {}),
}


def contexts(name, jaxOptions=None, portOptions=None):
    """(JAX Context, port Context on the CPU) of problem ``name``, each
    with its extra options."""
    kind, rays, atoms, active, kw = PROBLEMS[name]
    if kind == 'slab':
        tAtmos = slab_2d_atmos(10, 4, quadrature=rays)
        jAtmos = jax_atmos(tAtmos, quadrature=rays)
    else:
        arrays = falc_arrays(kind)
        tAtmos, jAtmos = Atmosphere(**arrays), JAtmosphere(**arrays)
        tAtmos.quadrature(rays)
        jAtmos.quadrature(rays)
    jrs = JRadiativeSet([getattr(jatoms, a)() for a in atoms])
    jrs.set_active(*active)
    trs = RadiativeSet([getattr(tatoms, a)() for a in atoms])
    trs.set_active(*active)
    jctx = JContext(jAtmos, jrs.compute_wavelength_grid(),
                    jrs.compute_eq_pops(jAtmos), **kw, **(jaxOptions or {}))
    tctx = Context(tAtmos, trs.compute_wavelength_grid(),
                   trs.compute_eq_pops(tAtmos), device='cpu', **kw,
                   **(portOptions or {}))
    return jctx, tctx


def depth_err(ours, ref):
    """max over depths of max |ours - ref| over the levels, over the
    depth's largest |ref|."""
    ours = np.asarray(ours, np.float64)
    ref = np.asarray(ref, np.float64)
    return (np.abs(ours - ref).max(axis=0) / np.abs(ref).max(axis=0)).max()


def row_err(ours, ref):
    """max over rows of max |ours - ref| over the row's largest |ref|."""
    ours = np.asarray(ours, np.float64).reshape(len(ref), -1)
    ref = np.asarray(ref, np.float64).reshape(len(ref), -1)
    return (np.abs(ours - ref).max(axis=1) / np.abs(ref).max(axis=1)).max()


def rel(ours, ref):
    return abs(ours - ref) / abs(ref)


# name: (problem, iterate_on_device options, bars (pops, J, rho, dJ and
# dPops)); the errors measured are in the comments
LOOP_CASES = {
    # 12 iterations: pops 1.1e-12, J 9.1e-13, dJ 8.0e-13, dPops 4.5e-11
    'plain': ('ca', {'NmaxIter': 12}, (1e-11, 1e-11, None, 5e-10)),
    # 24 iterations, Ng(2, 3, 14) extrapolating at the 14th, 17th and
    # 20th solves (an earlier Ndelay swings the 12-depth start's
    # populations by decades, tests/test_torch_ng.py): pops 3.4e-10, J
    # 1.9e-11, dJ 6.6e-11, dPops 1.5e-8
    'ng': ('ca', {'NmaxIter': 24, 'ngOptions': (2, 3, 14)},
           (5e-9, 5e-10, None, 2e-7)),
    # 8 iterations, 3 PRD sub-iterations in each of the last 5: pops
    # 2.6e-12, J 3.0e-12, rho 3.2e-11, dJ 1.8e-12, dPops 3.9e-12
    'prd': ('h_prd', {'NmaxIter': 8, 'prd': True, 'maxPrdSubIter': 3,
                      'prdTol': 0.0}, (3e-11, 3e-11, 3e-10, 1e-10)),
    # the same under hybrid PRD: pops 1.2e-12, J 2.8e-12, JRest 2.3e-12,
    # rho 1.2e-11, dJ 1.3e-11, dPops 5.6e-13
    'hprd': ('h_hprd', {'NmaxIter': 8, 'prd': True, 'maxPrdSubIter': 3,
                        'prdTol': 0.0}, (1e-11, 3e-11, 1e-10, 1e-10)),
    # 6 iterations on the 10 x 4 slab: pops 1.4e-12, J 2.6e-13, dJ
    # 1.2e-11, dPops 1.2e-10
    '2d': ('slab', {'NmaxIter': 6}, (1.5e-11, 3e-12, None, 1e-9)),
}


def ng_options(opts, cls):
    opts = dict(opts)
    if 'ngOptions' in opts:
        opts['ngOptions'] = cls(*opts['ngOptions'])
    return opts


@pytest.mark.parametrize('name', sorted(LOOP_CASES))
def test_iterate_on_device_matches_jax(name):
    problem, opts, (popsBar, JBar, rhoBar, dBar) = LOOP_CASES[name]
    jctx, tctx = contexts(problem)
    jres = jctx.iterate_on_device(JTol=0.0, popsTol=0.0,
                                  **ng_options(opts, JNgOptions))
    tres = tctx.iterate_on_device(JTol=0.0, popsTol=0.0,
                                  **ng_options(opts, NgOptions))
    assert tres[0] == jres[0] == opts['NmaxIter']
    errs = {'pops': max(depth_err(t['n'], j['n']) for t, j in
                        zip(tctx.popsState, jctx.popsState)),
            'J': row_err(tctx.J, jctx.J),
            'dJ': rel(tres[1], jres[1]), 'dPops': rel(tres[2], jres[2])}
    if rhoBar is not None:
        errs['rho'] = max(row_err(tctx.rhoPrd[ai][ti], jctx.rhoPrd[ai][ti])
                          for ai, ti, a, t in tctx._prd_lines())
        # a real departure from complete redistribution
        assert max(np.abs(np.asarray(jctx.rhoPrd[ai][ti]) - 1.0).max()
                   for ai, ti, a, t in tctx._prd_lines()) > 0.1
        assert errs['rho'] < rhoBar, errs
    if tctx.cfg.hprd:
        errs['JRest'] = row_err(tctx.JRest, jctx.JRest)
        assert errs['JRest'] < JBar, errs
    assert errs['pops'] < popsBar, errs
    assert errs['J'] < JBar, errs
    assert errs['dJ'] < dBar and errs['dPops'] < dBar, errs


def test_f32_loop_matches_jax_by_the_rule():
    """10 iterations of the float32 state on problem 'ca' (the JAX loop
    keeps float32 populations, the port float64 ones, its state): each
    package's distance from the port's float64 loop, populations per
    depth and J per row, dJ and dPops relatively, by the float32 rule
    err(port f32, f64) <= 2 err(JAX f32, f64) + 32 float32 ulps.
    Measured: pops 2.8e-4 against 3.9e-4, J 2.5e-4 against 3.2e-4, dJ
    1.2e-6 against 1.4e-5, dPops 6.4e-5 against 8.6e-4."""
    jctx, tctx = contexts('ca', {'dtype': jnp.float32},
                          {'dtype': torch.float32})
    _, t64 = contexts('ca')
    jres = jctx.iterate_on_device(NmaxIter=10, JTol=0.0, popsTol=0.0)
    # XLA flushes float32 subnormals to zero, torch does not
    torch.set_flush_denormal(True)
    try:
        tres = tctx.iterate_on_device(NmaxIter=10, JTol=0.0, popsTol=0.0)
    finally:
        torch.set_flush_denormal(False)
    ref = t64.iterate_on_device(NmaxIter=10, JTol=0.0, popsTol=0.0)
    assert tres[0] == jres[0] == ref[0] == 10
    assert tctx.popsState[0]['n'].dtype == torch.float64
    ulps = 32 * np.finfo(np.float32).eps
    pairs = {'pops': (tctx.popsState[0]['n'], jctx.popsState[0]['n'],
                      t64.popsState[0]['n'], depth_err),
             'J': (tctx.J, jctx.J, t64.J, row_err),
             'dJ': (tres[1], jres[1], ref[1], rel),
             'dPops': (tres[2], jres[2], ref[2], rel)}
    for key, (ours, theirs, f64, err) in pairs.items():
        mine, jax32 = err(ours, f64), err(np.asarray(theirs), f64)
        assert mine <= 2 * jax32 + ulps, (key, mine, jax32)


def test_converging_count_equals_jax():
    """The plain loop to convergence (JTol 5e-3, popsTol 1e-3): the same
    iteration count as the JAX loop, populations within 1e-9 per depth."""
    jctx, tctx = contexts('ca')
    jres = jctx.iterate_on_device(NmaxIter=300)
    tres = tctx.iterate_on_device(NmaxIter=300)
    assert tres[0] == jres[0] < 300
    assert tres[1] < 5e-3 and tres[2] < 1e-3
    assert max(depth_err(t['n'], j['n']) for t, j in
               zip(tctx.popsState, jctx.popsState)) < 1e-9


# ---- the port alone --------------------------------------------------------
def port_context(problem, **options):
    kind, rays, atoms, active, kw = PROBLEMS[problem]
    if kind == 'slab':
        atmos = slab_2d_atmos(10, 4, quadrature=rays)
    else:
        atmos = Atmosphere(**falc_arrays(kind))
        atmos.quadrature(rays)
    rs = RadiativeSet([getattr(tatoms, a)() for a in atoms])
    rs.set_active(*active)
    return Context(atmos, rs.compute_wavelength_grid(),
                   rs.compute_eq_pops(atmos), device='cpu',
                   **dict(kw, **options))


def test_non_finite_state_raises_and_writes_nothing():
    """A NaN population poisons the step: dJ and dPops are NaN, the
    stopping test (>=) fails at the first iteration past the warm-up, and
    ExplodingMatrixError is raised before anything is written back."""
    ctx = port_context('ca')
    n = ctx.popsState[0]['n'].clone()
    n[2, 5] = float('nan')
    ctx.popsState[0]['n'] = n
    J = ctx.J
    with pytest.raises(ExplodingMatrixError,
                       match='Non-finite populations for atom Ca in '
                             'iterate_on_device after 4 iterations'):
        ctx.iterate_on_device(NmaxIter=20)
    assert ctx.J is J and ctx.popsState[0]['n'] is n


def test_prepared_state_is_cached_and_dropped():
    """One DeviceLoop per option set, kept across calls; update_deps and
    set_fs_iter_scheme (every path that drops the cached params) drop
    it too."""
    ctx = port_context('ca')
    ctx.iterate_on_device(NmaxIter=1)
    loop = ctx._odRunnerCache[1]
    assert isinstance(loop, DeviceLoop)
    ctx.iterate_on_device(NmaxIter=2)
    assert ctx._odRunnerCache[1] is loop
    ctx.iterate_on_device(NmaxIter=1, Nscatter=0)
    assert ctx._odRunnerCache[1] is not loop
    for drop in (ctx.update_deps,
                 lambda: ctx.set_fs_iter_scheme('mali_full_precond_fused'),
                 lambda: ctx.set_formal_solver('piecewise_bezier3_1d')):
        loop = ctx._odRunnerCache[1]
        drop()
        assert ctx._odRunnerCache is None
        ctx.iterate_on_device(NmaxIter=1)
        assert ctx._odRunnerCache[1] is not loop
        assert ctx._odRunnerCache[1].iterFn is ctx._iter_fn


def test_prd_on_2d_raises():
    """PRD needs a 1D atmosphere, as in the JAX package; the CRD loop on
    the same 2D Context runs (test_iterate_on_device_matches_jax[2d])."""
    atmos = slab_2d_atmos(10, 4, quadrature=3)
    rs = RadiativeSet([tatoms.H_6_atom()])
    rs.set_active('H')
    ctx = Context(atmos, rs.compute_wavelength_grid(),
                  rs.compute_eq_pops(atmos), device='cpu')
    assert ctx._prd_lines()
    with pytest.raises(ValueError, match='on-device PRD needs a 1D'):
        ctx.iterate_on_device(NmaxIter=2, prd=True)


_HOST = [(torch, 'tensor'), (torch, 'as_tensor'), (torch, 'from_numpy'),
         (torch.Tensor, 'item'), (torch.Tensor, 'cpu'),
         (torch.Tensor, 'numpy'), (torch.Tensor, 'tolist'),
         (torch.Tensor, '__bool__'), (torch.Tensor, '__float__'),
         (torch.Tensor, '__int__')]


@pytest.mark.parametrize('case', [
    ('ca', 'mali_full_precond', (2, 3, 4), False),
    ('h_prd', 'mali_full_precond', (2, 3, 4), True),
    ('h_prd', 'mali_full_precond_pallas', (2, 3, 4), True),
    ('h_prd', 'mali_full_precond_fused', (2, 3, 4), True),
    ('h_hprd', 'mali_full_precond', (0, 0, 0), True)],
    ids=['default-ng', 'default-prd', 'pallas-prd', 'fused-prd', 'hprd'])
def test_step_copies_nothing_from_the_host(monkeypatch, case):
    """One body past the warm-up (its statistical-equilibrium solve, Ng's
    first extrapolation, 3 PRD sub-iterations) with every Python-level
    host transfer (torch.tensor / as_tensor / from_numpy, item, cpu,
    numpy, tolist, bool / float / int of a tensor) made to raise: the
    constants are all built before the loop."""
    problem, scheme, ng, prd = case
    ctx = port_context(problem, fsIterScheme=scheme)
    loop = DeviceLoop(ctx, 0, NgOptions(*ng), prd, 3, 0.0)
    s = loop.start()
    # Ng's count at its first extrapolation
    s['cnt'] = 4

    def trap(*args, **kwargs):
        raise AssertionError('a host transfer inside the loop body')
    for owner, name in _HOST:
        monkeypatch.setattr(owner, name, trap)
    s = loop.step(s, more=lambda flag: True)
    monkeypatch.undo()
    assert s['it'] == 1 and s['cnt'] == 5
    assert loop.reads == 0
    assert all(torch.isfinite(n).all() for n in s['pops'])


# ---- tests/test_on_device_loop.py on the port ---------------------------------
def _setup(**kwargs):
    full = Falc82()
    idx = np.unique(np.linspace(0, 81, 25).astype(int))
    atmos = Atmosphere(height=full.height[idx],
                       temperature=full.temperature[idx],
                       vlos=full.vlos[idx], vturb=full.vturb[idx],
                       ne=full.ne[idx], nHTot=full.nHTot[idx])
    atmos.quadrature(3)
    rs = RadiativeSet([tatoms.H_6_atom(), tatoms.CaII_atom()])
    rs.set_active('Ca')
    spect = rs.compute_wavelength_grid()
    eqPops = rs.compute_eq_pops(atmos)
    return Context(atmos, spect, eqPops, device='cpu', **kwargs)


def _host_loop(ctx, NmaxIter=400):
    for it in range(NmaxIter):
        ju = ctx.formal_sol_gamma_matrices()
        if it < 3:
            continue
        pu = ctx.stat_equil()
        if float(ju.dJMax) < 5e-3 and pu.dPopsMax < 1e-3:
            break
    return it + 1


@pytest.mark.slow
def test_on_device_loop_converges_and_matches_host():
    ctx = _setup()
    nIter, dJ, dPops = ctx.iterate_on_device(NmaxIter=400)
    assert nIter < 400
    assert dJ < 5e-3 and dPops < 1e-3
    ctx2 = _setup()
    _host_loop(ctx2)
    nDev = ctx.popsState[0]['n'].numpy()
    nHost = ctx2.popsState[0]['n'].numpy()
    # same fixed point to within the convergence tolerance
    assert np.abs(nDev / nHost - 1.0).max() < 5e-3


@pytest.mark.slow
def test_on_device_ng_matches_host_ng():
    """On-device Ng reproduces the host Ng class: same iteration count
    and populations."""
    ng = NgOptions(Norder=2, Nperiod=5, Ndelay=8)
    ctxD = _setup()
    nIterDev, dJ, dPops = ctxD.iterate_on_device(NmaxIter=400, ngOptions=ng)
    assert dJ < 5e-3 and dPops < 1e-3
    ctxH = _setup(ngOptions=ng)
    nIterHost = _host_loop(ctxH)
    assert nIterDev == nIterHost
    np.testing.assert_allclose(ctxD.popsState[0]['n'].numpy(),
                               ctxH.popsState[0]['n'].numpy(), rtol=1e-7)
    # Ng must actually help on this problem: fewer iterations than no-Ng
    nIterNoNg, _, _ = _setup().iterate_on_device(NmaxIter=400)
    assert nIterDev < nIterNoNg


def _prd_setup(Nspace, vlos=None, **kwargs):
    full = Falc82()
    idx = np.unique(np.linspace(0, 81, Nspace).astype(int))
    atmos = Atmosphere(height=full.height[idx],
                       temperature=full.temperature[idx],
                       vlos=full.vlos[idx] if vlos is None else vlos,
                       vturb=full.vturb[idx], ne=full.ne[idx],
                       nHTot=full.nHTot[idx])
    atmos.quadrature(3)
    rs = RadiativeSet([tatoms.H_6_atom()])
    rs.set_active('H')
    spect = rs.compute_wavelength_grid()
    eqPops = rs.compute_eq_pops(atmos)
    return Context(atmos, spect, eqPops, device='cpu',
                   accelerateScattering=True, **kwargs)


@pytest.mark.slow
@pytest.mark.parametrize('hprd', [False, True], ids=['prd', 'hprd'])
def test_on_device_prd_matches_host_prd(hprd):
    """iterate_on_device(prd=True) lands on the host loop's PRD fixed
    point (same schedule, same tracking-only Ng); the hybrid variant (24
    depths under an 8 km/s outflow) tracks JRest through the loop."""
    if hprd:
        vlos = 8e3 * np.linspace(0.0, 1.0, 24)[::-1]
        setup = lambda: _prd_setup(24, vlos, hprd=True)  # noqa: E731
        sub, tol = 6, 1e-3
    else:
        setup = lambda: _prd_setup(30)  # noqa: E731
        sub, tol = 10, 2e-4
    ctxD = setup()
    nIterDev, dJ, dPops = ctxD.iterate_on_device(
        NmaxIter=300, prd=True, maxPrdSubIter=sub, prdTol=tol)
    assert dJ < 5e-3 and dPops < 1e-3
    ai, ti, a, t = ctxD._prd_lines()[0]
    rhoDev = ctxD.rhoPrd[ai][ti].numpy()
    assert np.all(np.isfinite(rhoDev)) and np.all(rhoDev > 0)
    if hprd:
        assert ctxD.JRest is not None
        assert torch.isfinite(ctxD.JRest).all()
    else:
        assert np.abs(rhoDev - 1.0).max() > 0.1     # real PRD departure
    ctxH = setup()
    nIterHost = iterate_ctx_se(ctxH, prd=True, NmaxIter=300, quiet=True,
                               maxPrdSubIter=sub, prdIterTol=tol)
    assert abs(nIterDev - nIterHost) <= 2, (nIterDev, nIterHost)
    nDev = ctxD.popsState[0]['n'].numpy()
    nHost = ctxH.popsState[0]['n'].numpy()
    assert np.abs(nDev / nHost - 1.0).max() < 5e-3
    assert np.abs(rhoDev - ctxH.rhoPrd[ai][ti].numpy()).max() < 1e-3
