"""The port's x-sharded 2D sweep and Context (parallel/xshard2d.py,
Context(mesh=)) against the unsharded port and the JAX package's
x-sharded runs, on the CPU.

A module fixture spawns 4 gloo ranks (tests/torch_dist_cases.py: one
thread each, a file:// rendezvous under tmp_path, a deadline of its own)
for the sweep cases and 4 for the Context, while this process computes
the references.

- The sweep (tests/test_xshard2d.py): every periodic case (mu signs,
  interp and along-ray schemes: 12) and callable-x-boundary case (8),
  and the vertical ray, through formal_sol_2d_xsharded on 4 ranks of 4
  columns, gathered: within 1e-12 of the port's formal_sol_2d (I and
  IeffBase relative to their maximum, Psi too; 1.7e-15 measured: the
  sharded ring closure reassociates the affine compositions) and within
  1e-10 of the JAX package's formal_sol_2d_xsharded (its traced form
  under jax.jit; the port's and XLA's exp differ in the last ulps);
  single-column shards raise.
- The Context (tests/test_context_2d_xsharded.py's problem: FAL-C at 16
  depths, 8 columns, x-perturbed temperature, Ca II active, 3 rays) on 4
  ranks of 2 columns, 3 MALI steps each followed by stat_equil, periodic
  (linear; BESSER interp and along-ray) and with callable x boundaries
  (BESSER): J after the first step within 1e-12 of the unsharded Context,
  and after 3 steps pops, J and I within 1e-8 (5e-10 measured: the early
  steps' stat_equil amplify the sweep's reassociation); the BESSER runs
  against the JAX package's x-sharded Context (pops 1e-8, J and I per
  wavelength 1e-9).  A 1D atmosphere and an Nx the ranks do not divide
  raise.  Slow: the periodic Context (linear) converged, sharded against
  unsharded in the same iteration count (the JAX test's bars, pops 1e-9,
  J and I 1e-8).
"""
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh
from lightweaver_tpu.ops.formal_solver2d import \
    build_geometry_2d as j_build_geometry_2d
from lightweaver_tpu.parallel.xshard2d import \
    formal_sol_2d_xsharded_traced as j_formal_sol_2d_xsharded_traced
from lightweaver_tpu.parallel.xshard2d import \
    prep_xshard_geometry as j_prep_xshard_geometry
from lightweaver_tpu_torch.ops.formal_solver2d import (build_geometry_2d,
                                                       formal_sol_2d)

import torch_dist_cases as tc

from tests.test_torch_2d_context import jax_atmos, jax_context, row_err

# one intra-op thread per process: the tier-1 run has six pytest workers
torch.set_num_threads(1)

CASES = [c[0] for c in tc.xshard_cases()]
JAX_CTX_CASES = ('periodic_besser', 'callable_besser')


def _xmesh():
    return Mesh(np.asarray(jax.devices()[:4]), axis_names=('x',))


def _sweep_port(case):
    """The port's formal_sol_2d of one case."""
    name, mux, muz, periodic, interp, along, seed = case
    x, z, chi, S, Iupw = tc.xshard_problem(seed)
    Ibc = None if periodic else torch.as_tensor(tc.xshard_ibc())
    geom = build_geometry_2d(x, z, mux, muz, muz > 0, periodic=periodic)
    return [r.numpy() for r in formal_sol_2d(
        torch.as_tensor(chi), torch.as_tensor(S), geom,
        torch.as_tensor(Iupw), interp=interp, periodic=periodic, Ibc=Ibc,
        alongRay=along)]


def _sweep_jax(case):
    """The JAX package's x-sharded sweep of one case: the traced form of
    formal_sol_2d_xsharded (the one its Context runs) under jax.jit, on
    the geometry from its prep_xshard_geometry; equal to the eager
    formal_sol_2d_xsharded bit for bit, and ~5x cheaper to build."""
    name, mux, muz, periodic, interp, along, seed = case
    x, z, chi, S, Iupw = tc.xshard_problem(seed)
    Ibc = None if periodic else jnp.asarray(tc.xshard_ibc())
    geom = j_build_geometry_2d(x, z, mux, muz, muz > 0, periodic=periodic)
    prep = j_prep_xshard_geometry(geom, tc.XS_NZ, tc.XS_NX, np.float64)

    @jax.jit
    def sweep(chi, S, Iupw, Ibc):
        return j_formal_sol_2d_xsharded_traced(
            chi, S, prep, Iupw, _xmesh(), interp=interp, periodic=periodic,
            Ibc=Ibc, alongRay=along)
    return [np.asarray(r) for r in sweep(jnp.asarray(chi), jnp.asarray(S),
                                         jnp.asarray(Iupw), Ibc)]


def _jax_steps(ctx, bcData, steps):
    """The JAX package's x-sharded Context of the port's ``ctx`` problem:
    ``steps`` MALI steps, each followed by stat_equil."""
    xBc = None
    if bcData is not None:
        xBc = (tc.FixedXBc(bcData), tc.FixedXBc(bcData))
    jctx = jax_context(jax_atmos(ctx.atmos, xBc), mesh=_xmesh(),
                       formalSolver=ctx.cfg.formalSolver,
                       interpFn2d=ctx.cfg.interpFn2d)
    for _ in range(steps):
        jctx.formal_sol_gamma_matrices()
        jctx.stat_equil()
    return {'pops': np.asarray(jctx.popsState[0]['n']),
            'J': np.asarray(jctx.J), 'I': np.asarray(jctx.I)}


def _boundary_data():
    """tests/test_context_2d_xsharded.py's x boundary data: one periodic
    MALI step's intensities on the x = 0 column [Nlam, Nmu, 2, Nz]."""
    ctx = tc.context_2d()
    ctx.depthData.fill = True
    ctx.formal_sol_gamma_matrices()
    Nz, Nx = ctx.cfg.Nz, ctx.cfg.Nx
    I0 = ctx.depthData.I.numpy().reshape(ctx.cfg.Nlam, ctx.cfg.Nmu, 2, Nz,
                                         Nx)
    return I0[..., 0].copy()


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    sweep = tc.spawn_ranks(tc.xshard_case, 4,
                           tmp_path_factory.mktemp('sweep'))
    bcData = _boundary_data()
    context = tc.spawn_ranks(tc.context_2d_case, 4,
                             tmp_path_factory.mktemp('context'),
                             args=(bcData,))
    # the JAX references compile one shard_map program each: compiled in
    # threads (XLA releases the GIL) while this thread runs the port's
    with ThreadPoolExecutor(4) as pool:
        sweepJax = {c[0]: pool.submit(_sweep_jax, c)
                    for c in tc.xshard_cases()}
        ctxRefs, ctxJax = {}, {}
        for name, kw in tc.CTX_CASES.items():
            kw = dict(kw)
            bc = bcData if kw.pop('xBc', False) else None
            ctx = tc.context_2d(xBcData=bc, **kw)
            if name in JAX_CTX_CASES:
                ctxJax[name] = pool.submit(_jax_steps, ctx, bc, tc.CTX_STEPS)
            ref = {'steps': tc.context_steps(ctx, 1)}
            ref['J1'] = ctx.J.numpy()
            ref['steps'] += tc.context_steps(ctx, tc.CTX_STEPS - 1)
            ref.update({'pops': ctx.popsState[0]['n'].numpy(),
                        'J': ctx.J.numpy(), 'I': ctx.I.numpy()})
            ctxRefs[name] = ref
        sweepRefs = {c[0]: (_sweep_port(c), sweepJax[c[0]].result())
                     for c in tc.xshard_cases()}
        for name, fut in ctxJax.items():
            ctxRefs[name]['jax'] = fut.result()
    return (sweep.result(), sweepRefs), (context.result(), ctxRefs)


def _rel(ours, ref):
    return float(np.max(np.abs(np.asarray(ours) / np.asarray(ref) - 1.0)))


def _max_rel(ours, ref):
    """max |ours - ref| over max |ref|."""
    return float(np.abs(ours - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize('case', CASES)
def test_sweep_matches_unsharded_and_jax(runs, case):
    (out, refs), _ = runs
    port, jref = refs[case]
    for name, ours, p, j in zip(('I', 'Psi', 'IeffBase'), out[case], port,
                                jref):
        assert ours.shape == p.shape
        assert _max_rel(ours, p) < 1e-12, name
        assert _max_rel(ours, j) < 1e-10, name


def test_sweep_rejects_single_column_shards(runs):
    (out, _), _ = runs
    assert '>= 2 columns' in out['single_column']


@pytest.mark.parametrize('case', list(tc.CTX_CASES))
def test_context_matches_unsharded(runs, case):
    _, (out, refs) = runs
    res, ref = out[case], refs[case]
    assert res['block'] == (tc.CTX_NX // 4, (tc.CTX_NX // 4) * tc.CTX_NZ)
    # the collectives of a step: per direction one halo exchange and one
    # per plane and ring solve (two under BESSER interpolation), and the
    # thermalised lower boundary's start plane
    solves = 2 if 'besser' in case else 1
    assert res['collectives'] == 2 * (1 + solves * (tc.CTX_NZ - 1)) + 1
    assert row_err(res['J1'], ref['J1']) < 1e-12
    assert _rel(res['pops'], ref['pops']) < 1e-8
    assert _rel(res['J'], ref['J']) < 1e-8
    assert _rel(res['I'], ref['I']) < 1e-8
    np.testing.assert_allclose(res['activePops'], res['pops'])
    np.testing.assert_allclose(res['steps'], ref['steps'], rtol=1e-8)


@pytest.mark.parametrize('case', JAX_CTX_CASES)
def test_context_matches_jax_sharded(runs, case):
    _, (out, refs) = runs
    res, j = out[case], refs[case]['jax']
    assert _rel(res['pops'], j['pops']) < 1e-8
    assert row_err(res['J'], j['J']) < 1e-9
    assert row_err(res['I'], j['I']) < 1e-9


@pytest.mark.parametrize('case', ['one_d', 'divisible'])
def test_context_mesh_refusals(runs, case):
    """A 1D atmosphere with mesh= and Nx = 6 over 4 ranks raise
    ValueError (test_context_2d_xsharded.py:127-145)."""
    _, (out, _) = runs
    msg = out['raises'][case]
    assert msg and not msg.startswith('wrong message')


@pytest.mark.slow
def test_context_converged_like_unsharded(tmp_path):
    """The periodic Context of test_context_2d_xsharded.py:_make() (the
    default linear 2D solver) to convergence: the same iteration count
    sharded and unsharded, pops within 1e-9, J and I 1e-8."""
    ranks = tc.spawn_ranks(tc.context_2d_case, 4, tmp_path,
                           args=(None, True))
    ctx = tc.context_2d()
    nIt = tc.context_converge(ctx)
    res = ranks.result()['periodic_linear']
    assert res['nIter'] == nIt
    np.testing.assert_allclose(res['pops'], ctx.popsState[0]['n'].numpy(),
                               rtol=1e-9)
    np.testing.assert_allclose(res['J'], ctx.J.numpy(), rtol=1e-8)
    np.testing.assert_allclose(res['I'], ctx.I.numpy(), rtol=1e-8)
