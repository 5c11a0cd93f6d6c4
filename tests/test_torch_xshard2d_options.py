"""The x-sharded 2D Context's options (Context(mesh=) with the whole API)
against the unsharded port and the JAX package's x-sharded Context, on
the CPU.

A module fixture spawns 4 gloo ranks (tests/torch_dist_cases.py: one
thread each, a file:// rendezvous under tmp_path, a deadline of its own),
each holding 2 of the 8 columns of the 16 x 8 slab of
tests/test_context_2d_xsharded.py:_make (FAL-C at 16 depths, a 10%
temperature perturbation along x, H 6 + Ca II, 3 rays), and runs one case
per option (torch_dist_cases.py:xshard_option_run) while this process
runs each on the unsharded port:

- Ng(2, 3, 3) on the populations, 4 MALI steps with stat_equil (the
  extrapolation at the second): every rank applies the coefficients of
  the Ng of the whole grid's gathered populations (ops/ng.py:Ng);
- the escape-probability start (InitialSolution.EscapeProbability),
  formed on the whole host grid before the rank takes its block (its
  LTE fallback on this slab, sharded or not), then 2 MALI steps;
- H 6 active with conserveCharge, 4 NR steps (the new ne gathered on
  every rank);
- H 6 active with PRD (Ly-alpha, Ly-beta) and hybrid PRD, 4 rounds of a
  MALI step, stat_equil and prd_redistribute(maxIter=2);
- update_deps after T x 1.01 (2 steps before, 2 after);
- state_dict of the gathered state after 2 steps, and a pickle round trip
  that comes back unsharded;
- compute_rays(mus=[1.0]) from the gathered state;
- single_stokes_fs on a magnetised slab (problems.magnetise) after 1 step,
  the Stokes plane sweep sharded like the scalar one;
- iterate_on_device with Ng(2, 5, 8) to dJ, dPops < 0.1 (33 iterations):
  the host loop's count and populations;
- on-device PRD on the x-sharded Context raises, as in the JAX package.

The bars: 1e-9 against the unsharded port, J, I and the Stokes vector
per wavelength (the largest difference in a row over the row's largest
value: tests/test_torch_2d_context.py's convention), the populations
elementwise; after an Ng extrapolation 1e-8 per level (the fit divides
differences of nearly equal iterates: elementwise, the smallest
upper-level populations differ by up to 2.6e-8, each level's largest by
4.5e-11).  Slow: the same
cases on the JAX package's x-sharded Context (Mesh of 4 CPU devices),
pickling and compute_rays aside (unsharded by design).
"""
import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh
from lightweaver_tpu.ops.ng import NgOptions as JNgOptions

import torch_dist_cases as tc

from tests.test_torch_2d_context import jax_atmos, jax_context, row_err

# one intra-op thread per process: the tier-1 run has six pytest workers
torch.set_num_threads(1)

FEATURES = tc.XO_FEATURES
JAX_FEATURES = ('ng', 'charge', 'prd', 'hprd', 'update_deps', 'stokes',
                'iterate_on_device')


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    ranks = tc.spawn_ranks(tc.xshard_options_case, 4,
                           tmp_path_factory.mktemp('options'), timeout=400)
    ref = {f: tc.xshard_option_run(f, tc.xshard_option_context(f))
           for f in FEATURES}
    return ranks.result(), ref


def _rel(ours, ref):
    """max |ours / ref - 1|, elementwise."""
    return float(np.max(np.abs(np.asarray(ours) / np.asarray(ref) - 1.0)))


def _level_err(ours, ref):
    """The largest difference on each level over the level's largest
    population, the worst level."""
    ours, ref = np.asarray(ours), np.asarray(ref)
    return float((np.abs(ours - ref).max(axis=-1)
                  / np.abs(ref).max(axis=-1)).max())


def _stokes_err(ours, ref, I):
    """Q, U and V [3, Nlam, Nmu, Nx]: the largest difference per
    wavelength over Stokes I's largest there (some rows carry no
    polarisation)."""
    scale = np.abs(I).max(axis=(1, 2))[None, :, None, None]
    return float((np.abs(ours - ref) / scale).max())


def _check_ng(res, ref):
    assert res['accelerated'] == ref['accelerated']
    assert any(res['accelerated'])
    assert _level_err(res['pops'], ref['pops']) < 1e-8
    np.testing.assert_allclose(res['steps'], ref['steps'], rtol=1e-8)


def _check_escape(res, ref):
    """The escape-probability iteration reads the whole host grid; with
    the rank's block in its place it fails to broadcast.  Its start is
    the unsharded one to the bit (on this 2D slab both end in its LTE
    fallback: the one-ray escape solution is 1D)."""
    np.testing.assert_array_equal(res['start'], ref['start'])
    np.testing.assert_array_equal(res['start'], res['nStar'])
    assert _rel(res['pops'], ref['pops']) < 1e-9
    np.testing.assert_allclose(res['steps'], ref['steps'], rtol=1e-9)


def _check_charge(res, ref):
    assert _rel(res['ne'], ref['ne']) < 1e-9
    assert _rel(res['pops'], ref['pops']) < 1e-9
    np.testing.assert_allclose(res['steps'], ref['steps'], rtol=1e-9)
    ne0 = tc.xshard_option_context('charge').atmos.ne
    assert _rel(res['ne'], ne0) > 1e-3                  # NR moved ne


def _check_prd(res, ref):
    assert len(res['rho']) == 2
    for a, b in zip(res['rho'], ref['rho']):
        assert _rel(a, b) < 1e-9
    assert _rel(res['pops'], ref['pops']) < 1e-9
    np.testing.assert_allclose(res['steps'], ref['steps'], rtol=1e-8)
    assert np.abs(res['rho'][0] - 1.0).max() > 0.1       # real PRD


def _check_update_deps(res, ref):
    for a, b in zip(res['bg'], ref['bg']):
        assert _rel(a, b) < 1e-12
    assert _rel(res['pops'], ref['pops']) < 1e-9
    np.testing.assert_allclose(res['steps'], ref['steps'], rtol=1e-8)


def _check_state_dict(res, ref):
    st, r = res['state'], ref['state']
    assert row_err(st['J'], r['J']) < 1e-9
    assert row_err(st['I'], r['I']) < 1e-9
    for key in ('pops', 'nStar'):
        for a, b in zip(st[key], r[key]):
            assert a.shape == b.shape and _rel(a, b) < 1e-9, key
    assert res['kwargs'] == ref['kwargs'] and 'mesh' not in res['kwargs']
    p = res['pickled']
    assert not p['sharded'] and p['Nx'] == tc.CTX_NX
    np.testing.assert_array_equal(p['J'], st['J'])
    np.testing.assert_array_equal(p['I'], st['I'])
    np.testing.assert_array_equal(p['pops'], st['pops'][0])


def _check_compute_rays(res, ref):
    assert res['rays'].shape == ref['rays'].shape
    assert res['rays'].shape[1:] == (1, tc.CTX_NX)
    assert row_err(res['rays'], ref['rays']) < 1e-9


def _check_stokes(res, ref):
    assert row_err(res['I'], ref['I']) < 1e-9
    assert _stokes_err(res['Quv'], ref['Quv'], ref['I']) < 1e-9
    assert np.abs(ref['Quv']).max() > 0.0               # polarised


def _check_iterate_on_device(res, ref):
    assert res['nIter'] == ref['nIter'] < tc.XO_OD_MAX
    assert res['dJ'] < tc.XO_OD_TOL and res['dPops'] < tc.XO_OD_TOL
    assert _rel(res['pops'], ref['pops']) < 1e-9


def _check_od_prd(res, ref):
    assert res['raises'] and not res['raises'].startswith('wrong message')
    assert ref['raises'] == res['raises']


CHECKS = {'ng': _check_ng, 'escape': _check_escape,
          'charge': _check_charge, 'prd': _check_prd,
          'hprd': _check_prd, 'update_deps': _check_update_deps,
          'state_dict': _check_state_dict,
          'compute_rays': _check_compute_rays, 'stokes': _check_stokes,
          'iterate_on_device': _check_iterate_on_device,
          'od_prd': _check_od_prd}


@pytest.mark.parametrize('feature', FEATURES)
def test_xsharded_option_matches_unsharded(runs, feature):
    out, ref = runs
    res, r = out[feature], ref[feature]
    CHECKS[feature](res, r)
    if feature not in ('iterate_on_device', 'od_prd'):
        # iterate_on_device ends with a MALI step the host loop has not
        # taken; od_prd takes none
        assert row_err(res['J'], r['J']) < 1e-9


# ---- the JAX package's x-sharded Context ---------------------------------
def _jax_run(feature):
    """The feature's protocol (torch_dist_cases.py:xshard_option_run) on
    the JAX package's Context(mesh=Mesh of 4 CPU devices) of the same
    slab."""
    port = tc.xshard_option_context(feature)
    kw = {}
    if feature == 'ng':
        kw['ngOptions'] = JNgOptions(*tc.XO_NG)
    if feature in ('charge', 'prd', 'hprd'):
        kw['active'] = ('H',)
    kw['conserveCharge'] = feature == 'charge'
    kw['hprd'] = feature == 'hprd'
    ctx = jax_context(jax_atmos(port.atmos),
                      mesh=Mesh(np.asarray(jax.devices()[:4]), ('x',)),
                      **kw)
    out = {}

    def steps(n):
        for _ in range(n):
            ctx.formal_sol_gamma_matrices()
            ctx.stat_equil()
    if feature in ('ng', 'charge'):
        steps(tc.XO_STEPS)
        out['ne'] = np.asarray(ctx.atmos.ne).copy()
    elif feature in ('prd', 'hprd'):
        for _ in range(tc.XO_STEPS):
            ctx.formal_sol_gamma_matrices()
            ctx.stat_equil()
            ctx.prd_redistribute(maxIter=2)
        out['rho'] = [np.asarray(ctx.rhoPrd[ai][ti])
                      for ai, ti, a, t in ctx._prd_lines()]
    elif feature == 'update_deps':
        steps(2)
        ctx.atmos.temperature *= 1.01
        ctx.update_deps()
        steps(2)
    elif feature == 'stokes':
        steps(1)
        ctx.single_stokes_fs()
        out['I'], out['Quv'] = np.asarray(ctx.I), np.asarray(ctx.Quv)
    elif feature == 'iterate_on_device':
        out['nIter'] = ctx.iterate_on_device(
            NmaxIter=tc.XO_OD_MAX, JTol=tc.XO_OD_TOL, popsTol=tc.XO_OD_TOL,
            ngOptions=JNgOptions(*tc.XO_OD_NG))[0]
    out['pops'] = np.asarray(ctx.popsState[0]['n'])
    out['J'] = np.asarray(ctx.J)
    return out


@pytest.mark.slow
@pytest.mark.parametrize('feature', JAX_FEATURES)
def test_xsharded_option_matches_jax(runs, feature):
    """The port's x-sharded run against the JAX package's: the
    populations within 1e-8 (per level after an Ng extrapolation), J per
    wavelength within 1e-9, rho 1e-8, ne 1e-9, the Stokes vector per
    wavelength 1e-9, the on-device loop's count."""
    res, j = runs[0][feature], _jax_run(feature)
    popsErr = (_level_err if feature == 'ng' else _rel)(res['pops'],
                                                         j['pops'])
    assert popsErr < 1e-8
    if feature != 'iterate_on_device':
        assert row_err(res['J'], j['J']) < 1e-9
    else:
        assert res['nIter'] == j['nIter']
    if 'ne' in j:
        assert _rel(res['ne'], j['ne']) < 1e-9
    for a, b in zip(res.get('rho', []), j.get('rho', [])):
        assert _rel(a, b) < 1e-8
    if feature == 'stokes':
        assert row_err(res['I'], j['I']) < 1e-9
        assert _stokes_err(res['Quv'], j['Quv'], j['I']) < 1e-9
