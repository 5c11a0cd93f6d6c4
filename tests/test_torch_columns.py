"""The port's 1.5D column batch and accelerateScattering against the JAX
package, on the CPU.

- BatchedNg (ops/ng.py) against the JAX package's on a random [C, L]
  sequence with frozen columns (1e-13), and its source text.
- accelerateScattering: the port's MALI step under each scheme fed the
  JAX Context's state for four MALI steps + stat_equil of the 40-depth Ca
  II mixed-precision problem (f64, 3 rays): Gamma and J to 1e-10 (J to
  1e-10 of each wavelength's maximum over depth), the populations after
  the port's stat_equil to 1e-8 (the solve amplifies Gamma's ~1e-11
  differences ~100x on this problem: 1.3e-9 measured); and one
  accelerated PRD subset solve of a 24-depth H 6 PRD problem
  (tests/test_torch_prd_context.py's bars).
- ColumnBatch.from_stacked (C = 3 FAL-C columns of 16 depths, 2 rays, Ca
  II active) against the JAX ColumnBatch over five MALI steps +
  stat_equil: populations, J, I and dJCol within 1e-9 (6.6e-10
  measured after the first step: the port's and the JAX package's
  single Contexts differ by as much).
- A batch column against a single port Context on it (1e-10; equal bit
  for bit on the CPU, since each column's profile normalisation is
  formed on its own depths), and a column forced converged keeping its J
  and populations.
- One batch step under the three schemes (1e-10), the legacy contexts=
  constructor against the JAX one, and mesh= raising.

PRD, hybrid PRD, Ng and charge conservation batches:
tests/test_torch_columns_prd.py.
"""
import ast
import dataclasses
import inspect

import numpy as np
import pytest
import torch

import lightweaver_tpu.ops.ng as jng
import lightweaver_tpu.parallel as jparallel
import lightweaver_tpu.rh_atoms as jatoms
from lightweaver_tpu.atmosphere import Atmosphere as JAtmosphere
from lightweaver_tpu.atomic_set import RadiativeSet as JRadiativeSet
from lightweaver_tpu.context import Context as JContext
from lightweaver_tpu.context import \
    build_prd_subset_fn as j_build_prd_subset_fn
from lightweaver_tpu.fal import Falc82 as JFalc82
from lightweaver_tpu.parallel import ColumnBatch as JColumnBatch
from lightweaver_tpu_torch import Atmosphere, CaII_atom, H_6_atom, \
    RadiativeSet
import lightweaver_tpu_torch.ops.ng as tng
import lightweaver_tpu_torch.parallel as tparallel
from lightweaver_tpu_torch.context import (Context, build_iteration_fn,
                                           build_prd_subset_fn)
from lightweaver_tpu_torch.convert import params_from_numpy
from lightweaver_tpu_torch.parallel import ColumnBatch
from lightweaver_tpu_torch.problems import (column_batch, falc_decimated,
                                            stacked_falc)

from tests.test_torch_prd_context import per_wavelength
from tests.test_torch_slice import relerr

SCHEMES = ('mali_full_precond', 'mali_full_precond_pallas',
           'mali_full_precond_fused')

# one intra-op thread per process: the tier-1 run has six pytest workers
torch.set_num_threads(1)


def _jax_models():
    return [jatoms.H_6_atom(), jatoms.CaII_atom()]


def _models():
    return [H_6_atom(), CaII_atom()]


# ---- BatchedNg --------------------------------------------------------
def _code(cls):
    """The class's source without its docstrings, as an AST dump."""
    tree = ast.parse(inspect.getsource(cls))
    for node in ast.walk(tree):
        body = getattr(node, 'body', None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:]
    return ast.dump(tree)


def test_batched_ng_copies_the_jax_source():
    """ops/ng.py's BatchedNg is the JAX package's code, line for line
    (docstrings aside; the drift guard tests/test_torch_model_layer.py
    keeps for Ng)."""
    assert _code(tng.BatchedNg) == _code(jng.BatchedNg)
    assert _code(tng.BatchedNg) != _code(tng.Ng)


@pytest.mark.parametrize('Norder', [2, 3])
def test_batched_ng_matches_jax(Norder):
    """A random sequence of [C, L] iterates converging geometrically per
    column, with columns frozen part of the way: every returned iterate,
    the acceleration flags and max_change within 1e-13."""
    rng = np.random.default_rng(Norder)
    C, L = 5, 40
    target = rng.uniform(1.0, 2.0, (C, L))
    rate = rng.uniform(0.5, 0.9, (C, 1))
    x = target + rng.uniform(-0.5, 0.5, (C, L))
    port = tng.BatchedNg(Norder, 2, 4, x)
    ref = jng.BatchedNg(Norder, 2, 4, x)
    accelerated = 0
    for it in range(16):
        x = target + rate * (x - target) + 1e-3 * rng.standard_normal(
            (C, L)) * rate ** it
        freeze = np.zeros(C, bool)
        if it >= 8:
            freeze[[1, 3]] = True
        a1, s1 = port.accelerate(x, freeze=freeze)
        a2, s2 = ref.accelerate(x, freeze=freeze)
        assert a1 == a2
        accelerated += a1
        np.testing.assert_allclose(s1, s2, rtol=1e-13, atol=0)
        np.testing.assert_allclose(port.max_change(), ref.max_change(),
                                   rtol=1e-13, atol=1e-300)
        x = s1
    assert accelerated >= 4
    assert (port.max_change()[[1, 3]] == 0.0).all()


# ---- accelerateScattering ---------------------------------------------
NSPACE_MIXED, NRAYS_MIXED = 40, 3


@pytest.fixture(scope='module')
def accelerated_steps():
    """Four MALI steps + stat_equil of the JAX Context with
    accelerateScattering on the 40-depth Ca II problem: the params before
    each step, its J and Gamma after it and the populations after the
    stat_equil that follows."""
    full = JFalc82()
    idx = np.unique(np.linspace(0, 81, NSPACE_MIXED).astype(int))
    atmos = JAtmosphere(height=full.height[idx],
                        temperature=full.temperature[idx],
                        vlos=full.vlos[idx], vturb=full.vturb[idx],
                        ne=full.ne[idx], nHTot=full.nHTot[idx])
    atmos.quadrature(NRAYS_MIXED)
    rs = JRadiativeSet(_jax_models())
    rs.set_active('Ca')
    spect = rs.compute_wavelength_grid()
    jctx = JContext(atmos, spect, rs.compute_eq_pops(atmos),
                    accelerateScattering=True)
    steps = []
    for _ in range(4):
        params = jctx.build_params()
        params = {k: ([list(v) for v in params[k]] if k == 'pops'
                      else params[k]) for k in params}
        ju = jctx.formal_sol_gamma_matrices()
        rec = {'params': params, 'J': np.array(jctx.J),
               'Gamma': np.array(jctx._Gamma[0]), 'dJ': float(ju.dJMax)}
        jctx.stat_equil()
        rec['pops'] = np.array(jctx.popsState[0]['n'])
        steps.append(rec)
    return steps


def _mixed_context(**kwargs):
    atmos = falc_decimated(NSPACE_MIXED)
    atmos.quadrature(NRAYS_MIXED)
    rs = RadiativeSet(_models())
    rs.set_active('Ca')
    spect = rs.compute_wavelength_grid()
    return Context(atmos, spect, rs.compute_eq_pops(atmos), device='cpu',
                   **kwargs)


@pytest.mark.parametrize('scheme', SCHEMES)
def test_accelerate_scattering_matches_jax(accelerated_steps, scheme):
    """Each MALI step of the scheme, fed the JAX Context's state, against
    the JAX step with accelerateScattering (J is accelerated, Gamma reads
    the same moments), then the port's stat_equil on its Gamma."""
    tctx = _mixed_context(accelerateScattering=True, fsIterScheme=scheme)
    assert tctx.cfg.accelerateScattering
    it = tctx._iter_fn
    for step, rec in enumerate(accelerated_steps):
        params = params_from_numpy(rec['params'], tctx.cfg)
        params['pack'] = it.pack(params)
        out = it(params)
        e = relerr(out['Gamma'][0], rec['Gamma'])
        assert e < 1e-10, ('Gamma', step, e)
        e = per_wavelength(out['J'], rec['J'])
        assert e < 1e-10, ('J', step, e)
        assert relerr(out['dJ'], rec['dJ']) < 1e-10
        tctx._Gamma = out['Gamma']
        tctx.popsState[0]['n'] = params['pops'][0]
        tctx.stat_equil()
        e = relerr(tctx.popsState[0]['n'], rec['pops'])
        assert e < 1e-8, ('pops', step, e)


def test_accelerate_scattering_changes_j_and_is_carried():
    """The acceleration moves J where the background scatters, is off by
    default, leaves the Lambda step (lambdaIterate: PsiBar = 0) as it
    was, and rides in state_dict's kwargs."""
    plain = _mixed_context()
    accel = _mixed_context(accelerateScattering=True)
    assert not plain.cfg.accelerateScattering
    for ctx in (plain, accel):
        ctx.formal_sol_gamma_matrices()
        ctx.stat_equil()
    a, b = plain._iter_fn(plain.build_params()), accel._iter_fn(
        plain.build_params())
    assert not torch.equal(a['J'], b['J'])
    a, b = (ctx._iter_fn(plain.build_params(), lambdaIterate=True)
            for ctx in (plain, accel))
    assert torch.equal(a['J'], b['J'])
    assert accel.state_dict()['kwargs']['accelerateScattering']
    again = Context.construct_from_state_dict_with(accel.state_dict())
    assert again.cfg.accelerateScattering


def test_accelerated_prd_subset_matches_jax():
    """One PRD subset solve with accelerateScattering on a 24-depth H 6
    PRD problem (Ly-alpha, Ly-beta in PRD) after three JAX MALI steps with
    prd_redistribute: the port's build_prd_subset_fn against the JAX one
    on the same params (J and I per wavelength 1e-9, dJ and the PRD
    rates 1e-10)."""
    full = JFalc82()
    idx = np.unique(np.linspace(0, 81, 24).astype(int))
    atmos = JAtmosphere(height=full.height[idx],
                        temperature=full.temperature[idx],
                        vlos=full.vlos[idx], vturb=full.vturb[idx],
                        ne=full.ne[idx], nHTot=full.nHTot[idx])
    atmos.quadrature(3)
    rs = JRadiativeSet([jatoms.H_6_atom()])
    rs.set_active('H')
    jctx = JContext(atmos, rs.compute_wavelength_grid(),
                    rs.compute_eq_pops(atmos), accelerateScattering=True)
    for _ in range(3):
        jctx.formal_sol_gamma_matrices()
        jctx.stat_equil()
        jctx.prd_redistribute()
    params = jctx.build_params()
    tatmos = falc_decimated(24)
    tatmos.quadrature(3)
    trs = RadiativeSet([H_6_atom()])
    trs.set_active('H')
    tctx = Context(tatmos, trs.compute_wavelength_grid(),
                   trs.compute_eq_pops(tatmos), device='cpu',
                   accelerateScattering=True)
    sub = jctx._prd_subset_idxs()
    lines = [(ai, ti) for ai, ti, a, t in jctx._prd_lines()]
    assert np.array_equal(sub, tctx._prd_subset_idxs()) and lines
    ref = j_build_prd_subset_fn(jctx.cfg, sub, lines)(params)
    out = build_prd_subset_fn(tctx.cfg, sub, lines)(
        params_from_numpy(params, tctx.cfg))
    plain = build_prd_subset_fn(
        dataclasses.replace(tctx.cfg, accelerateScattering=False), sub,
        lines)(params_from_numpy(params, tctx.cfg))
    # the Lyman windows' background scatters little: c = sca PsiBar is
    # small there, but the acceleration runs
    assert not torch.equal(plain['J'], out['J'])
    for key in ('J', 'I'):
        e = per_wavelength(out[key], ref[key])
        assert e < 1e-9, (key, e)
    # dJ = max |1 - Jdag/J| ~ 1e-4 here: its absolute error is J's
    # relative one
    assert abs(float(out['dJ']) - float(ref['dJ'])) < 1e-10
    for key in ('Rij', 'Rji'):
        for li in range(len(lines)):
            e = relerr(out[key][li], ref[key][li])
            assert e < 1e-10, (key, li, e)


# ---- ColumnBatch --------------------------------------------------------
C_STACKED, NK_STACKED, NRAYS_STACKED = 3, 16, 2


@pytest.fixture(scope='module')
def stacked_pair():
    """The JAX and port batches of C_STACKED FAL-C columns (Ca II active)
    after five MALI steps + stat_equil each, with the per-step records."""
    h, T, v, vt, ne, nH = stacked_falc(C_STACKED, NK_STACKED)
    jb = JColumnBatch.from_stacked(h, T, v, vt, ne, nH, _jax_models,
                                   ('Ca',), Nrays=NRAYS_STACKED)
    tb = column_batch(C_STACKED, Nk=NK_STACKED, Nrays=NRAYS_STACKED,
                      activeSpecies=('Ca',), device='cpu')
    errs = []
    for _ in range(5):
        for b in (jb, tb):
            b.formal_sol_gamma_matrices()
            b.stat_equil()
        errs.append({
            'pops': relerr(tb.pops[0], jb.pops[0]),
            'J': relerr(tb.J, np.asarray(jb.params['J'])),
            'I': relerr(tb.I, np.asarray(jb.I)),
            'dJCol': relerr(tb.dJCol, jb.dJCol),
            'dPopsCol': relerr(tb.dPopsCol, jb.dPopsCol)})
    return jb, tb, errs


def test_from_stacked_layout(stacked_pair):
    """The flat Context of C x NkCol depths, its Ncol, and the
    per-column views of the state."""
    _, tb, _ = stacked_pair
    C, Nk = C_STACKED, NK_STACKED
    assert (tb.Ncol, tb.NkCol, tb.cfg.Ncol, tb.cfg.Nk) == (C, Nk, C, C * Nk)
    Nl = tb.cfg.activeAtoms[0].Nlevel
    assert tb.pops[0].shape == (C, Nl, Nk)
    assert tb.J.shape == (C, tb.cfg.Nlam, Nk)
    assert tb.I.shape == (C, tb.cfg.Nlam, NRAYS_STACKED)
    assert tb.ne.shape == (C, Nk) and tb.dJCol.shape == (C,)
    np.testing.assert_array_equal(tb.flatCtx.atmos.height.reshape(C, Nk)[1],
                                  tb.flatCtx.atmos.height[:Nk])


@pytest.mark.parametrize('key', ['pops', 'J', 'I', 'dJCol', 'dPopsCol'])
def test_from_stacked_matches_jax(stacked_pair, key):
    """Five MALI steps + stat_equil of the batch against the JAX
    ColumnBatch on the same stacked inputs, within 1e-9 at every step."""
    _, _, errs = stacked_pair
    worst = max(e[key] for e in errs)
    assert worst < 1e-9, (key, [e[key] for e in errs])


def _single(height, T, vlos, vturb, ne, nH, c, Nrays, active, **kwargs):
    atmos = Atmosphere(height=height.copy(), temperature=T[c].copy(),
                       vlos=vlos[c].copy(), vturb=vturb[c].copy(),
                       ne=ne[c].copy(), nHTot=nH[c].copy())
    atmos.quadrature(Nrays)
    rs = RadiativeSet(_models())
    rs.set_active(*active)
    spect = rs.compute_wavelength_grid()
    return Context(atmos, spect, rs.compute_eq_pops(atmos), device='cpu',
                   **kwargs)


def test_batch_column_follows_a_single_context_and_freezes():
    """A batch column against a single port Context on the same column,
    in lockstep for five MALI steps + stat_equil (populations, J and the
    emergent I within 1e-10; equal bit for bit on the CPU); then column 0
    forced converged keeps its J and populations through three more
    steps while the others move."""
    C, Nk = C_STACKED, NK_STACKED
    stacked = stacked_falc(C, Nk)
    tb = column_batch(C, Nk=Nk, Nrays=NRAYS_STACKED, activeSpecies=('Ca',),
                      device='cpu')
    c = 1
    ctx = _single(*stacked, c, NRAYS_STACKED, ('Ca',))
    for _ in range(5):
        for x in (tb, ctx):
            x.formal_sol_gamma_matrices()
            x.stat_equil()
        assert relerr(tb.pops[0][c], ctx.popsState[0]['n']) < 1e-10
        assert relerr(tb.J[c], ctx.J) < 1e-10
        assert relerr(tb.I[c], ctx.I) < 1e-10
    tb.converged[0] = True
    pops0, J0 = tb.pops[0].copy(), tb.J.copy()
    for _ in range(3):
        tb.formal_sol_gamma_matrices()
        tb.stat_equil()
    assert np.array_equal(tb.pops[0][0], pops0[0])
    assert np.array_equal(tb.J[0], J0[0])
    assert not np.array_equal(tb.pops[0][1:], pops0[1:])
    assert tb.dPopsCol[0] == 0.0


def test_per_column_heights():
    """from_stacked with a height per column ([C, Nk]; column 1 stretched
    by 5%): each column against a single Context on its own height for
    three MALI steps + stat_equil (1e-10), the stretched column's own
    path lengths and thermalised lower boundary at work."""
    C, Nk = 2, NK_STACKED
    h, T, v, vt, ne, nH = stacked_falc(C, Nk, seed=7)
    heights = np.stack([h, 1.05 * h])
    tb = ColumnBatch.from_stacked(heights, T, v, vt, ne, nH, _models,
                                  ('Ca',), Nrays=NRAYS_STACKED, device='cpu')
    ctxs = [_single(heights[c], T, v, vt, ne, nH, c, NRAYS_STACKED, ('Ca',))
            for c in range(C)]
    for _ in range(3):
        for x in [tb] + ctxs:
            x.formal_sol_gamma_matrices()
            x.stat_equil()
    for c, ctx in enumerate(ctxs):
        assert relerr(tb.pops[0][c], ctx.popsState[0]['n']) < 1e-10, c
        assert relerr(tb.I[c], ctx.I) < 1e-10, c
    assert np.abs(tb.I[1] / tb.I[0] - 1.0).max() > 1e-3


def test_schemes_agree_on_a_batch_step():
    """One MALI step of the batch, after two default-scheme steps, under
    each scheme on the same params against the default scheme's:
    Gamma, the rates and J within 1e-10."""
    tb = column_batch(C_STACKED, Nk=NK_STACKED, Nrays=NRAYS_STACKED,
                      activeSpecies=('Ca',), device='cpu')
    for _ in range(2):
        tb.formal_sol_gamma_matrices()
        tb.stat_equil()
    outs = {}
    for scheme in SCHEMES:
        it = build_iteration_fn(dataclasses.replace(tb.cfg,
                                                    fsIterScheme=scheme))
        params = dict(tb.params)
        params['pack'] = it.pack(params)
        outs[scheme] = it(params)
    ref = outs[SCHEMES[0]]
    for scheme in SCHEMES[1:]:
        out = outs[scheme]
        assert relerr(out['Gamma'][0], ref['Gamma'][0]) < 1e-10, scheme
        for key in ('Rij', 'Rji'):
            for x, y in zip(out[key][0], ref[key][0]):
                assert relerr(x, y) < 1e-10, (scheme, key)
        assert per_wavelength(out['J'], ref['J']) < 1e-10, scheme
        assert out['I'].shape == (C_STACKED, tb.cfg.Nlam, NRAYS_STACKED)


def test_contexts_constructor_matches_jax():
    """The legacy constructor over two prebuilt Contexts (lockstep only)
    against the JAX one: three MALI steps + stat_equil, populations
    within 1e-9 and the batch's dPops and dJ within 1e-9."""
    h, T, v, vt, ne, nH = stacked_falc(2, NK_STACKED, seed=4)
    tctxs = [_single(h, T, v, vt, ne, nH, c, NRAYS_STACKED, ('Ca',))
             for c in range(2)]
    jctxs = []
    for c in range(2):
        atmos = JAtmosphere(height=h.copy(), temperature=T[c].copy(),
                            vlos=v[c].copy(), vturb=vt[c].copy(),
                            ne=ne[c].copy(), nHTot=nH[c].copy())
        atmos.quadrature(NRAYS_STACKED)
        rs = JRadiativeSet(_jax_models())
        rs.set_active('Ca')
        jctxs.append(JContext(atmos, rs.compute_wavelength_grid(),
                              rs.compute_eq_pops(atmos)))
    tb, jb = ColumnBatch(contexts=tctxs), JColumnBatch(contexts=jctxs)
    assert tb.flatCtx is None and tb.cfg.Ncol == 2
    for _ in range(3):
        tu, ju = tb.formal_sol_gamma_matrices(), jb.formal_sol_gamma_matrices()
        assert relerr(tu.dJMax, ju.dJMax) < 1e-9
        tp, jp = tb.stat_equil(), jb.stat_equil()
        assert relerr(tp.dPopsMax, jp.dPopsMax) < 1e-9
        assert relerr(tb.pops[0], jb.pops[0]) < 1e-9
    with pytest.raises(ValueError, match='from_stacked'):
        tb.ne
    with pytest.raises(ValueError, match='from_stacked'):
        tb.prd_redistribute()


def test_mesh_raises():
    """mesh= takes a ('columns', 'wavelength') DeviceMesh (make_mesh;
    the sharded batches: tests/test_torch_distributed.py): anything else
    raises in both constructors, and the package exports make_mesh and
    the multihost helpers as the JAX package does."""
    h, T, v, vt, ne, nH = stacked_falc(2, 8)
    with pytest.raises(ValueError, match='DeviceMesh'):
        ColumnBatch.from_stacked(h, T, v, vt, ne, nH, _models, ('Ca',),
                                 Nrays=2, mesh=object(), device='cpu')
    with pytest.raises(ValueError, match='DeviceMesh'):
        ColumnBatch(contexts=[object()], mesh=object())
    for name in ('ColumnBatch', 'make_mesh', 'initialize_multihost',
                 'global_mesh', 'local_column_slice', 'make_global_array',
                 'formal_sol_2d_xsharded'):
        assert hasattr(jparallel, name) and hasattr(tparallel, name), name
