"""The port's distribution over ranks (parallel/columns.py, multihost.py)
against the unsharded port and the JAX package's sharded runs, on the CPU.

Each module fixture spawns gloo ranks (tests/torch_dist_cases.py: one
thread each, a file:// rendezvous under tmp_path, a deadline of its own)
while this process computes the references, then waits for them.

- Columns (tests/test_column_batch.py:68-87): 8 columns of 16 depths, Ca
  II active, 2 rays, 5 MALI steps + stat_equil.  On a (4, 1) mesh the
  sharded batch equals the unsharded one (1e-12; bit for bit measured:
  each column's arithmetic does not depend on its neighbours).  On the
  (2, 2) mesh J after the first step equals it (1e-12; J of a row is the
  rank's own), and after 5 steps pops and J are within 1e-9: the
  wavelength split reassociates Gamma's lambda sums (4e-16), and the first
  steps' stat_equil, whose populations change by up to 36x, take that to
  1.1e-10 (measured).  Both against the JAX package's make_mesh(4, 2) run
  at its own bar, 1e-8.  A mesh of the wrong size and columns that do not
  split evenly raise.  Ng + accelerateScattering + conserveCharge, PRD
  and hybrid PRD batches (tests/test_torch_columns_prd.py's) on a (2, 1)
  mesh equal the unsharded batch (1e-12).
- Wavelengths (a non-slow twin of tests/test_wavelength_sharding.py: FAL-C
  at 24 depths, 3 rays) under each scheme on a (1, 2) mesh, one MALI
  step: J 1e-12, dJ 1e-10 and Gamma 1e-10 against the unsharded port, the
  JAX package's bars; against the JAX package's wavelength-sharded step
  the bars of the port's single Context against the JAX one
  (tests/test_torch_slice.py: J per wavelength and Gamma 1e-10).  Three
  steps with stat_equil against the unsharded port (1e-9).
- PRD on the wavelength axis (tests/test_column_batch.py:139-186's H 6
  PRD batch with Ca II active too, 2 columns of 24 depths: 1046
  wavelengths, which the JAX mesh splits) on a (1, 2) mesh, under each scheme
  and hybrid PRD (column_vlos_ramps' outflows) under the default one:
  four rounds of a MALI step, stat_equil and prd_redistribute(maxIter=2)
  in lockstep with the unsharded batch, and free-running against the JAX
  package's make_mesh(1, 2) batch.  Rank 1's block holds no PRD row.
- Multihost (tests/test_multihost.py, multihost_worker.py): the one-rank
  group on an in-process store, global_mesh's shapes and refusal,
  local_column_slice, make_global_array's round trip and two ranks' batch
  against the unsharded run (1e-12); slow: both run to convergence.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import lightweaver_tpu.rh_atoms as jatoms
from lightweaver_tpu.atmosphere import Atmosphere as JAtmosphere
from lightweaver_tpu.atomic_set import RadiativeSet as JRadiativeSet
from lightweaver_tpu.context import Context as JContext
from lightweaver_tpu.context import build_iteration_fn as j_build_iteration_fn
from lightweaver_tpu.parallel import ColumnBatch as JColumnBatch
from lightweaver_tpu.parallel import make_mesh as j_make_mesh
from lightweaver_tpu_torch.parallel import ColumnBatch, multihost as mh
from lightweaver_tpu_torch.problems import stacked_falc

import torch_dist_cases as tc

from tests.test_torch_prd_context import per_wavelength
from tests.test_torch_slice import relerr

# one intra-op thread per process: the tier-1 run has six pytest workers
torch.set_num_threads(1)


def _jax_models():
    return [jatoms.H_6_atom(), jatoms.CaII_atom()]


def _rel(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    return float(np.max(np.abs(ours / ref - 1.0)))


# ---- columns ------------------------------------------------------------
@pytest.fixture(scope='module')
def columns(tmp_path_factory):
    ranks = tc.spawn_ranks(tc.columns_case, 4,
                           tmp_path_factory.mktemp('columns'))
    arrays = stacked_falc(tc.COLUMNS_C, tc.COLUMNS_NK)
    port = ColumnBatch.from_stacked(*arrays, tc.models, ('Ca',), Nrays=2,
                                    device='cpu')
    steps = []
    for i in range(tc.COLUMNS_STEPS):
        ju = port.formal_sol_gamma_matrices()
        if i == 0:
            J1 = port.J
        pu = port.stat_equil()
        steps.append((ju.dJMax, pu.dPopsMax))
    mesh = j_make_mesh(nColumns=4, nWavelength=2, devices=jax.devices()[:8])
    jb = JColumnBatch.from_stacked(*arrays, _jax_models, ('Ca',), Nrays=2,
                                   mesh=mesh)
    for _ in range(tc.COLUMNS_STEPS):
        jb.formal_sol_gamma_matrices()
        jb.stat_equil()
    ref = {'pops': port.pops, 'J': port.J, 'I': port.I, 'J1': J1,
           'steps': steps, 'jaxPops': jb.pops,
           'jaxJ': np.asarray(jb.params['J'])}
    return ranks.result(), ref


@pytest.mark.parametrize('shape', [(4, 1), (2, 2)], ids=['4x1', '2x2'])
def test_columns_sharded_equals_unsharded(columns, shape):
    out, ref = columns
    res = out[shape]
    C, Nlam = tc.COLUMNS_C, ref['J'].shape[1]
    lo, hi = (0, None) if shape[1] == 1 else (0, Nlam // 2)
    assert res['block'] == (C // shape[0], lo, hi)
    assert _rel(res['J1'], ref['J1']) < 1e-12
    bar = 1e-12 if shape[1] == 1 else 1e-9
    for a, b in zip(res['pops'], ref['pops']):
        assert _rel(a, b) < bar
    assert _rel(res['J'], ref['J']) < bar
    assert _rel(res['I'], ref['I']) < bar
    np.testing.assert_allclose(res['steps'], ref['steps'], rtol=bar)


@pytest.mark.parametrize('shape', [(4, 1), (2, 2)], ids=['4x1', '2x2'])
def test_columns_sharded_matches_jax(columns, shape):
    """The port's sharded pops and J against the JAX package's
    make_mesh(4, 2) batch, within its bar (test_column_batch.py)."""
    out, ref = columns
    for a, b in zip(out[shape]['pops'], ref['jaxPops']):
        assert _rel(a, b) < 1e-8
    assert _rel(out[shape]['J'], ref['jaxJ']) < 1e-8


@pytest.mark.parametrize('case', ['mesh_size', 'uneven'])
def test_columns_mesh_mismatch_raises(columns, case):
    """make_mesh(3, 2) over 4 ranks and 5 columns over 2 column ranks
    raise ValueError."""
    assert columns[0]['raises'][case] and \
        not columns[0]['raises'][case].startswith('wrong message')


@pytest.fixture(scope='module')
def column_options(tmp_path_factory):
    ranks = tc.spawn_ranks(tc.columns_options_case, 2,
                           tmp_path_factory.mktemp('column_options'))
    ref = {option: tc.options_run(option, tc.options_batch(option))
           for option in ('ng_charge', 'prd', 'hprd')}
    return ranks.result(), ref


@pytest.mark.parametrize('option', ['ng_charge', 'prd', 'hprd'])
def test_columns_mesh_options(column_options, option):
    """Ng + accelerateScattering + conserveCharge, PRD and hybrid PRD
    (tests/test_torch_columns_prd.py's batches, 4 columns) on a (2, 1)
    mesh equal the unsharded batch (1e-12: the columns axis changes no
    column's arithmetic; the rho sub-iterations stop on the reduced
    drho, so every rank takes as many)."""
    out, ref = column_options
    res, r = out[option], ref[option]
    for key in ('pops', 'J', 'ne'):
        assert _rel(res[key], r[key]) < 1e-12, key
    np.testing.assert_allclose(res['steps'], r['steps'], rtol=1e-12)


# ---- wavelengths --------------------------------------------------------
def _jax_falc24():
    arrays = tc.falc24_arrays()
    atmos = JAtmosphere(height=arrays[0], temperature=arrays[1][0],
                        vlos=arrays[2][0], vturb=arrays[3][0],
                        ne=arrays[4][0], nHTot=arrays[5][0])
    atmos.quadrature(3)
    rs = JRadiativeSet(_jax_models())
    rs.set_active('Ca')
    return JContext(atmos, rs.compute_wavelength_grid(),
                    rs.compute_eq_pops(atmos))


def _jax_wavelength_sharded_step(ctx):
    """test_wavelength_sharding.py's sharded step: the dense [Nlam, Nk]
    leaves on a 'wavelength' mesh of 2 devices."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
    params = ctx.build_params()
    fn = jax.jit(j_build_iteration_fn(ctx.cfg),
                 static_argnames=('lambdaIterate', 'storeDepthData'))
    mesh = Mesh(np.array(jax.devices()[:2]), axis_names=('wavelength',))
    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    out = []
    for path, leaf in flat:
        keys = [getattr(p, 'key', None) for p in path]
        name = next((k for k in reversed(keys) if isinstance(k, str)), '')
        spec = (P('wavelength', None) if hasattr(leaf, 'ndim')
                and leaf.ndim == 2 and name in ('J', 'bgChi', 'bgEta',
                                                'bgSca') else P())
        out.append(jax.device_put(leaf, NamedSharding(mesh, spec)))
    shd = fn(jax.tree_util.tree_unflatten(treedef, out))
    return {'J': np.asarray(shd['J']), 'dJ': float(shd['dJ']),
            'Gamma': [np.asarray(g) for g in shd['Gamma']]}


@pytest.fixture(scope='module')
def wavelength(tmp_path_factory):
    ranks = tc.spawn_ranks(tc.wavelength_case, 2,
                           tmp_path_factory.mktemp('wavelength'))
    ref = {}
    for scheme in tc.LAMBDA_SCHEMES:
        b = ColumnBatch.from_stacked(*tc.falc24_arrays(), tc.models, ('Ca',),
                                     Nrays=3, device='cpu',
                                     fsIterScheme=scheme)
        ju = b.formal_sol_gamma_matrices()
        ref[scheme] = {'J': b.J[0], 'dJ': ju.dJMax, 'I': b.I,
                       'Gamma': [g.numpy() for g in b._Gamma],
                       'Rij': [[r.numpy() for r in rs] for rs in b._Rij],
                       'Nlam': b.cfg.Nlam}
        if scheme == tc.LAMBDA_SCHEMES[0]:
            b.stat_equil()
            for _ in range(2):
                b.formal_sol_gamma_matrices()
                b.stat_equil()
            ref['steps3'] = {'pops': b.pops[0][0], 'J': b.J[0]}
    ref['jax'] = _jax_wavelength_sharded_step(_jax_falc24())
    return ranks.result(), ref


@pytest.mark.parametrize('scheme', tc.LAMBDA_SCHEMES)
def test_wavelength_step_matches_unsharded(wavelength, scheme):
    out, ref = wavelength
    res, r = out[scheme], ref[scheme]
    assert res['block'] == (0, r['Nlam'] // 2)
    np.testing.assert_allclose(res['J'], r['J'], rtol=1e-12)
    np.testing.assert_allclose(res['I'], r['I'], rtol=1e-12)
    np.testing.assert_allclose(res['dJ'], r['dJ'], rtol=1e-10)
    for a, b in zip(res['Gamma'], r['Gamma']):
        assert relerr(a, b) < 1e-10
    for rs, qs in zip(res['Rij'], r['Rij']):
        for a, b in zip(rs, qs):
            assert relerr(a, b) < 1e-10


@pytest.mark.parametrize('scheme', tc.LAMBDA_SCHEMES)
def test_wavelength_step_matches_jax_sharded(wavelength, scheme):
    """Against the JAX package's wavelength-sharded step (the default
    scheme's; its schemes compute the same step)."""
    out, ref = wavelength
    res, j = out[scheme], ref['jax']
    assert per_wavelength(res['J'], j['J']) < 1e-10
    np.testing.assert_allclose(res['dJ'], j['dJ'], rtol=1e-10)
    for a, b in zip(res['Gamma'], j['Gamma']):
        assert relerr(a, b) < 1e-10


def test_wavelength_steps_with_stat_equil(wavelength):
    out, ref = wavelength
    assert _rel(out['steps3']['pops'], ref['steps3']['pops']) < 1e-9
    assert _rel(out['steps3']['J'], ref['steps3']['J']) < 1e-9


# ---- PRD on the wavelength axis -------------------------------------------
def _jax_lambda_prd(hprd):
    """The JAX package's batch of tc.lambda_prd_batch on its
    make_mesh(1, 2): LAMBDA_PRD_ROUNDS rounds of a MALI step, stat_equil
    and prd_redistribute(maxIter=2); rho [C, W, Nk] per PRD line, the
    populations."""
    mesh = j_make_mesh(1, 2, devices=jax.devices()[:2])
    jb = JColumnBatch.from_stacked(
        *tc.lambda_prd_arrays(hprd), _jax_models, ('H', 'Ca'), Nrays=3,
        hprd=hprd, accelerateScattering=True, mesh=mesh)
    for _ in range(tc.LAMBDA_PRD_ROUNDS):
        jb.formal_sol_gamma_matrices()
        jb.stat_equil()
        jb.prd_redistribute(maxIter=2)
    lines = [(ai, ti) for ai, a in enumerate(jb.cfg.activeAtoms)
             for ti, t in enumerate(a.trans) if t.isLine and t.isPrd]
    return {'rho': [np.asarray(jb.params['rhoPrd'][ai][ti])
                    for ai, ti in lines],
            'pops': np.asarray(jb.params['pops'][0])}


@pytest.fixture(scope='module')
def lambda_prd(tmp_path_factory):
    return tc.spawn_ranks(tc.lambda_prd_case, 2,
                          tmp_path_factory.mktemp('lambda_prd')).result()


@pytest.fixture(scope='module')
def lambda_prd_jax():
    return {hprd: _jax_lambda_prd(hprd) for hprd in (False, True)}


LAMBDA_PRD_NAMES = [c[0] for c in tc.LAMBDA_PRD_CASES]


@pytest.mark.parametrize('name', LAMBDA_PRD_NAMES)
def test_wavelength_axis_prd_lockstep(lambda_prd, name):
    """Each round of the (1, 2) mesh against the unsharded batch's round
    from the same state: rho per row of its window, J per wavelength,
    and the PRD rates within 1e-10, the populations, the emergent I and
    JRest per row within 1e-9 (the populations 1.8e-10 measured: the
    lambda split reassociates Gamma's sums, ~4e-16, which the first
    stat_equil of Ca II amplify, as in the columns' (2, 2) run above).
    The unsharded round itself moves by as
    much when its input populations move by 1e-16 (far from convergence
    drho is ~6e3: rho - 1 is a difference of near-equal terms), so the
    bars are per row, as J's are in tests/test_torch_2d_context.py;
    elementwise, rho near a row's minimum differs by up to ~1e-8 either
    way."""
    res = lambda_prd[name]
    # rank 1's block holds no PRD row: it solves no subset row and joins
    # every collective
    (lo0, hi0, n0), (lo1, hi1, n1) = res['rows']
    assert lo0 == 0 and hi0 == lo1 and n0 > 0 and n1 == 0
    assert len(res['errs']) == tc.LAMBDA_PRD_ROUNDS
    for k, e in enumerate(res['errs']):
        for key in ('rho', 'J', 'rates'):
            assert e[key] < 1e-10, (k, key, e[key])
        for key in ('pops', 'I', 'JRest'):
            assert e.get(key, 0.0) < 1e-9, (k, key, e[key])
    assert ('JRest' in res['errs'][0]) == name.startswith('hprd')


@pytest.mark.slow
@pytest.mark.parametrize('name', LAMBDA_PRD_NAMES)
def test_wavelength_axis_prd_matches_jax(lambda_prd, lambda_prd_jax, name):
    """The free-running (1, 2) mesh run against the JAX package's batch on
    its make_mesh(1, 2) (the default scheme's; its schemes compute the
    same step): rho within 1e-9 of each line's maximum and the
    populations within 1e-9, the bars of tests/test_torch_columns_prd.py
    on one device.  Slow: the two JAX programs take ~160 s to build and
    run on the CPU."""
    res, j = lambda_prd[name], lambda_prd_jax[name.startswith('hprd')]
    C, Nk = tc.LAMBDA_PRD_C, tc.LAMBDA_PRD_NK
    for rho, jr in zip(res['rho'], j['rho']):
        rho = rho.reshape(-1, C, Nk).transpose(1, 0, 2)
        assert np.abs(rho - jr).max() / np.abs(jr).max() < 1e-9
        assert np.abs(jr - 1.0).max() > 1.0                 # real PRD
    assert relerr(res['pops'], j['pops']) < 1e-9


# ---- multihost ----------------------------------------------------------
def test_initialize_single_process_noop():
    """num_processes=1: a one-rank group on an in-process store; a second
    call keeps it."""
    assert not dist.is_initialized()
    try:
        mh.initialize_multihost(num_processes=1, backend='gloo')
        mh.initialize_multihost(num_processes=1, backend='gloo')
        assert dist.get_world_size() == 1 and dist.get_rank() == 0
        assert mh.local_column_slice(103) == slice(0, 103)
        mesh = mh.global_mesh(device='cpu')
        assert tuple(mesh.mesh.shape) == (1, 1)
    finally:
        dist.destroy_process_group()
    with pytest.raises(ValueError, match='backend'):
        mh.initialize_multihost(num_processes=1, backend='mpi')


@pytest.fixture(scope='module')
def multihost(tmp_path_factory):
    return tc.spawn_ranks(tc.multihost_case, 2,
                          tmp_path_factory.mktemp('multihost')).result()


def test_global_mesh_shapes(multihost):
    (shape, names, shape2) = multihost['shapes']
    assert shape == (2, 1) and names == ('columns', 'wavelength')
    assert shape2 == (1, 2)
    assert 'mesh 3x1 != 2 ranks' in multihost['raises']


def test_local_column_slice_covers_all(multihost):
    assert multihost['slices'] == [(0, 4), (4, 8)]
    assert multihost['block'] == (4, 4 * 16)


def test_make_global_array_roundtrip(multihost):
    np.testing.assert_array_equal(multihost['roundtrip'], multihost['data'])


def test_two_process_batch_matches_unsharded(multihost):
    """Each rank's block of the columns, 4 MALI steps with stat_equil
    from the second (multihost_worker.py's schedule), against the
    unsharded run of every column on the same rank."""
    assert multihost['popsErr'] < 1e-12
    assert np.all(np.isfinite(multihost['pops'][0]))


@pytest.mark.slow
def test_two_process_converged(tmp_path):
    """Both batches iterated to convergence: the same step count and
    per-column counts, populations within 1e-12."""
    out = tc.spawn_ranks(tc.multihost_case, 2, tmp_path,
                         args=(True,)).result()
    assert out['nIter'][0] == out['nIter'][1] < 300
    np.testing.assert_array_equal(*out['nIterCol'])
    assert out['popsErr'] < 1e-12
