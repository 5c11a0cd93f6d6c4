"""The port's 2D Context against the JAX package's.

The golden 2D problem (scripts/refgold/export_inputs.py:build_2d_atmos;
the port's problems.slab_2d(30, 8, periodic=False)): FAL-C at 30 depths,
8 columns 40 km apart with a +-5% temperature perturbation and a 1 km/s
shear flow, callable x boundaries, 6 rays, Ca II active, Nlam = 546.

- Lockstep (3 MALI steps): each step the JAX Context's params go through
  params_from_numpy into the port's iteration, as tests/test_torch_slice.py
  does for 1D.  Gamma, the rates and the populations after stat_equil on
  the same Gamma agree within 1e-10 (relative, with a floor of 1e-10 of
  each array's maximum; 9e-12 measured); J and the emergent I [Nlam,
  Nmu, Nx] within 1e-10 of each wavelength's maximum (over depth for J,
  over rays and columns for I; 4e-16 measured), as tests/test_torch_slice.py
  normalises them: pointwise, J reads 1.8e-10 at values eight decades
  below its wavelength's maximum (the optically thick deep layers), where
  the last-ulp differences of XLA's exp and torch's are carried along the
  planes (with XLA's exp in the port, 1e-12).  Under both 2D solvers, the
  linear one with the compat x boundary of the golden run.
- Periodic against callable x boundaries on an x-invariant slab (the port
  analogue of tests/test_context_2d.py::
  test_2d_nonperiodic_callable_xbc_matches_periodic): 1e-9.
- float32: two MALI steps of a 2D float32 Context; at each, the port's
  float32 iteration and the JAX float32 one on the JAX state, each held to
  the JAX float64 iteration on the same params by the rule of
  tests/test_torch_solvers.py: err(port f32) <= 2 err(JAX f32) + 32
  float32 ulps of the maximum.  dJ with float32 subnormals flushed, as XLA
  computes, to 1e-3 (tests/test_torch_f32.py).
- PRD on 2D: the JAX Context takes PRD and hybrid PRD on a 2D atmosphere
  with the full-grid MALI step in each rho sub-iteration, and so does the
  port: rho and J after prd_redistribute within 1e-10.
- What raises, as in the JAX package: the kernel schemes, mixed x
  boundaries, a 3D atmosphere, a mesh= that is not a DeviceMesh with an
  x dimension, a callable x boundary of the wrong
  shape; and, unlike the JAX Context which runs a 1D solver name as the
  linear 2D solver, a 1D solver name on a 2D atmosphere.
"""
import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import lightweaver_tpu.rh_atoms as jatoms
from lightweaver_tpu.atmosphere import Atmosphere as JAtmosphere
from lightweaver_tpu.atomic_set import RadiativeSet as JRadiativeSet
from lightweaver_tpu.context import Context as JContext
from lightweaver_tpu.context import build_iteration_fn as j_build_iteration_fn
from lightweaver_tpu_torch import rh_atoms as tatoms
from lightweaver_tpu_torch.atmosphere import Atmosphere
from lightweaver_tpu_torch.atomic_set import RadiativeSet
from lightweaver_tpu_torch.context import Context, build_iteration_fn
from lightweaver_tpu_torch.convert import params_from_numpy
from lightweaver_tpu_torch.problems import slab_2d, slab_2d_atmos

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..', 'scripts',
                                'refgold'))
import export_inputs  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), 'golden')
F32_BAR = 32 * np.finfo(np.float32).eps

# one intra-op thread per process: the tier-1 run has six pytest workers
torch.set_num_threads(1)


def relerr(ours, ref, floorRel=1e-10):
    ours = np.asarray(ours, np.float64)
    ref = np.asarray(ref, np.float64)
    floor = np.abs(ref).max() * floorRel
    return (np.abs(ours - ref) / np.maximum(np.abs(ref), floor)).max()


def row_err(ours, ref):
    """max |ours - ref| per wavelength row over the row's max |ref|, the
    worst row."""
    ours = np.asarray(ours, np.float64).reshape(len(ref), -1)
    ref = np.asarray(ref, np.float64).reshape(len(ref), -1)
    return (np.abs(ours - ref).max(axis=1) / np.abs(ref).max(axis=1)).max()


def jax_atmos(atmos, xBc=None, quadrature=3):
    """The JAX package's Atmosphere of the port's 2D ``atmos`` (the same
    arrays); ``xBc`` (lower, upper) JAX x boundaries, periodic without."""
    Nz, Nx = atmos.Nz, atmos.Nx

    def grid(a):
        return None if a is None else np.asarray(a).reshape(Nz, Nx)
    kw = {} if xBc is None else {'xLowerBc': xBc[0], 'xUpperBc': xBc[1]}
    out = JAtmosphere.make_2d(
        height=np.asarray(atmos.zGrid), x=np.asarray(atmos.x),
        temperature=grid(atmos.temperature), vx=grid(atmos.vx),
        vz=grid(atmos.vz), vturb=grid(atmos.vturb), ne=grid(atmos.ne),
        nHTot=grid(atmos.nHTot), B=grid(atmos.B),
        gammaB=grid(atmos.gammaB), chiB=grid(atmos.chiB), **kw)
    out.quadrature(quadrature)
    return out


def jax_context(atmos, active=('Ca',), **kw):
    rs = JRadiativeSet([jatoms.H_6_atom(), jatoms.CaII_atom()])
    rs.set_active(*active)
    spect = rs.compute_wavelength_grid()
    return JContext(atmos, spect, rs.compute_eq_pops(atmos), **kw)


def port_context(atmos, active=('Ca',), **kw):
    rs = RadiativeSet([tatoms.H_6_atom(), tatoms.CaII_atom()])
    rs.set_active(*active)
    spect = rs.compute_wavelength_grid()
    return Context(atmos, spect, rs.compute_eq_pops(atmos), device='cpu',
                   **kw)


GOLDEN_SOLVERS = {'linear': ('piecewise_linear_2d', True),
                  'besser': ('piecewise_besser_2d', False)}


def golden_pair(name):
    """The golden 2D problem under the JAX package and the port, with the
    compat x-lower boundary for the linear solver."""
    solver, compat = GOLDEN_SOLVERS[name]
    atmos = export_inputs.build_2d_atmos()
    if compat:
        atmos.xLowerBc = export_inputs.RefBugCompatXLower(0)
    rs = JRadiativeSet([jatoms.H_6_atom(), jatoms.CaII_atom()])
    rs.set_active('Ca')
    spect = rs.compute_wavelength_grid()
    jctx = JContext(atmos, spect, rs.compute_eq_pops(atmos),
                    formalSolver=solver)
    tctx = slab_2d(30, 8, periodic=False, device='cpu', formalSolver=solver,
                   refBugCompat=compat)
    return jctx, tctx


def test_slab_2d_rebuilds_the_golden_inputs():
    """slab_2d(30, 8, periodic=False) is build_2d_atmos(): the arrays of
    falc2d_ca_inputs.npz (the JAX golden test's staleness check, and the
    x boundary data, the LTE populations, the rays and the grid)."""
    inputs = np.load(os.path.join(GOLDEN, 'falc2d_ca_inputs.npz'))
    ctx = slab_2d(30, 8, periodic=False, device='cpu')
    np.testing.assert_allclose(np.asarray(ctx.spect.wavelength),
                               inputs['wavelength'], rtol=1e-12)
    atmos = ctx.atmos
    for key in ('temperature', 'ne', 'nHTot', 'vturb', 'vx', 'vz', 'x',
                'mux', 'muz', 'wmu'):
        np.testing.assert_array_equal(np.asarray(getattr(atmos, key)),
                                      inputs[key], err_msg=key)
    np.testing.assert_array_equal(atmos.zGrid, inputs['z'])
    np.testing.assert_allclose(ctx.bgChi.numpy(), inputs['bg_chi'],
                               rtol=1e-10)
    np.testing.assert_allclose(ctx.C[0], inputs['atom0_C'], rtol=1e-10)
    np.testing.assert_allclose(ctx.popsState[0]['n'].numpy(),
                               inputs['atom0_n0'], rtol=1e-12)
    data = ctx._boundary_data()
    for key, ref in (('xLowerBcData', 'xlowerbc_data'),
                     ('xUpperBcData', 'xupperbc_data')):
        np.testing.assert_allclose(data[key].numpy().reshape(
            inputs[ref].shape), inputs[ref], rtol=1e-12)
    assert ctx.cfg.Ndim == 2 and not ctx.cfg.xPeriodic
    assert ctx.cfg.formalSolver == 'piecewise_linear_2d'
    assert tuple(ctx.I.shape) == (546, 6, 8)


@pytest.mark.parametrize('name', sorted(GOLDEN_SOLVERS))
def test_lockstep_matches_jax(name):
    """Three MALI steps and stat_equil, each fed the JAX state (module
    docstring); the geometry of every (mu, toObs) ray is the JAX one bit
    for bit."""
    jctx, tctx = golden_pair(name)
    for key, g in jctx.cfg.geom2d.items():
        for k, v in g.items():
            assert np.array_equal(np.asarray(v),
                                  np.asarray(tctx.cfg.geom2d[key][k])), k
    for it in range(3):
        tparams = params_from_numpy(jctx.build_params(), tctx.cfg)
        out = tctx._iter_fn(tparams)
        ju = jctx.formal_sol_gamma_matrices()
        e = relerr(out['Gamma'][0], jctx._Gamma[0])
        assert e < 1e-10, ('Gamma', it, e)
        for ti in range(len(jctx.activeAtoms[0].trans)):
            for key, ref in (('Rij', jctx._Rij), ('Rji', jctx._Rji)):
                e = relerr(out[key][0][ti], ref[0][ti])
                assert e < 1e-10, (key, ti, it, e)
        for key, ref in (('J', jctx.J), ('I', jctx.I)):
            assert out[key].shape == ref.shape
            e = row_err(out[key], ref)
            assert e < 1e-10, (key, it, e)
        assert relerr(out['dJ'], ju.dJMax) < 1e-10
        tctx._Gamma = out['Gamma']
        tctx.popsState[0]['n'] = tparams['pops'][0]
        jup = jctx.stat_equil()
        tup = tctx.stat_equil()
        e = relerr(tctx.popsState[0]['n'], jctx.popsState[0]['n'])
        assert e < 1e-10, ('pops', it, e)
        np.testing.assert_allclose(tup.dPops, jup.dPops, rtol=1e-8,
                                   atol=1e-14)


class _FixedXBc:
    """A callable x boundary returning a fixed [Nlam, Nmu, 2, Nz] array,
    whose values ``scale`` multiplies (for a boundary that changes between
    MALI steps)."""

    def __init__(self, data):
        self.data = data
        self.scale = 1.0

    def compute_bc(self, atmos, spect):
        return self.data * self.scale


def _x_invariant(Nz, Nx, xBc):
    """tests/test_context_2d.py's x-invariant slab (FAL-C at Nz depths, Nx
    columns 200 km apart, no x flow), with ``xBc`` (lower, upper) or
    periodic."""
    from lightweaver_tpu_torch.fal import Falc82
    full = Falc82()
    idx = np.unique(np.linspace(0, 81, Nz).astype(int))
    Nz = len(idx)

    def col(a):
        return np.broadcast_to(a[idx][:, None], (Nz, Nx)).copy()
    kw = {} if xBc is None else {'xLowerBc': xBc[0], 'xUpperBc': xBc[1]}
    atmos = Atmosphere.make_2d(
        height=full.height[idx], x=np.arange(Nx) * 2e5,
        temperature=col(full.temperature), vx=np.zeros((Nz, Nx)),
        vz=col(full.vlos), vturb=col(full.vturb), ne=col(full.ne),
        nHTot=col(full.nHTot), **kw)
    atmos.quadrature(3)
    return atmos


def _rays(ctx):
    """I [2, Nlam, Nmu, Nk] of one MALI step's formal solution."""
    it = ctx._iter_fn
    params = ctx.build_params()
    chi, src = it.gather(params, it.scaJ(params))
    return it.formal_solve(params, chi, src)[0]


def test_callable_x_boundary_matches_periodic():
    """On an x-invariant slab, feeding the periodic solution's boundary
    column through callable x boundaries reproduces the periodic formal
    solution at every column (1e-9), as the JAX package's test holds it;
    slanted rays hit the side faces here."""
    Nz, Nx = 18, 6
    ctxP = port_context(_x_invariant(Nz, Nx, None),
                        formalSolver='piecewise_linear_2d')
    assert ctxP.cfg.xPeriodic
    assert any(g['axisZ'].any() for g in ctxP.cfg.geom2d.values())
    IP = _rays(ctxP).numpy()
    IP5 = IP.reshape(*IP.shape[:3], Nz, Nx)
    np.testing.assert_allclose(IP5[..., 1:], np.broadcast_to(
        IP5[..., :1], IP5[..., 1:].shape), rtol=1e-10)
    bcData = np.moveaxis(IP5[..., 0], 0, 2)          # [Nlam, Nmu, 2, Nz]
    ctxN = port_context(_x_invariant(Nz, Nx, (_FixedXBc(bcData),
                                              _FixedXBc(bcData))),
                        formalSolver='piecewise_linear_2d')
    assert not ctxN.cfg.xPeriodic
    np.testing.assert_allclose(_rays(ctxN).numpy(), IP, rtol=1e-9)


def test_x_boundary_is_reread_each_step():
    """A callable x boundary whose data grow 100x between two MALI steps:
    J and I after the second step against the JAX Context's (1e-10)."""
    Nz, Nx = 12, 4
    rng = np.random.default_rng(7)
    tctx = port_context(_x_invariant(Nz, Nx, None))
    shape = (tctx.cfg.Nlam, tctx.cfg.Nmu, 2, Nz)
    data = rng.uniform(0.5, 1.5, shape) * 1e-9
    bcs = [_FixedXBc(data), _FixedXBc(0.5 * data)]
    tctx = port_context(_x_invariant(Nz, Nx, bcs))
    jbcs = [_FixedXBc(data), _FixedXBc(0.5 * data)]
    jctx = jax_context(jax_atmos(_x_invariant(Nz, Nx, None),
                                 xBc=jbcs),
                       formalSolver='piecewise_linear_2d')
    for step in range(2):
        for b in bcs + jbcs:
            b.scale = 100.0 ** step
        tctx.formal_sol_gamma_matrices()
        jctx.formal_sol_gamma_matrices()
    assert relerr(tctx.J, jctx.J) < 1e-10
    assert relerr(tctx.I, jctx.I) < 1e-10


def _golden_atmos_inputs():
    ctx = slab_2d(30, 8, periodic=False, device='cpu')
    return ctx.atmos, ctx.spect, ctx.eqPops


@pytest.mark.parametrize('change', [
    {'fsIterScheme': 'mali_full_precond_pallas'},
    {'fsIterScheme': 'mali_full_precond_fused'},
    {'mesh': object()},
    {'formalSolver': 'piecewise_bezier3_1d'},
    {'interpFn2d': 'interp_cubic_2d'},
], ids=['pallas', 'fused', 'mesh', 'solver_1d', 'interp'])
def test_options_outside_2d_raise(change):
    """The kernel schemes (the JAX package's _pallas/_fused need 1D), a
    mesh= that is not a DeviceMesh with an x dimension (the x-sharded
    Context: tests/test_torch_xshard2d.py), a 1D solver name and an
    unknown interpolation on a 2D atmosphere raise ValueError at
    construction."""
    with pytest.raises(ValueError):
        Context(*_golden_atmos_inputs(), device='cpu', **change)


def test_setters_on_2d():
    """set_formal_solver takes the 2D names on a 2D Context and refuses
    the 1D ones; set_interp_fn takes INTERP_NAMES_2D; the kernel schemes
    refuse 2D with the JAX package's needs; each setter drops the
    iteration function (a new iteration runs the new scheme)."""
    ctx = slab_2d(12, 4, periodic=True, device='cpu')
    assert ctx.get_fs_iter_scheme_properties()['Ndim'] == 2
    fn = ctx._iter_fn
    ctx.set_formal_solver('piecewise_besser_2d')
    assert ctx.cfg.formalSolver == 'piecewise_besser_2d'
    assert ctx._iter_fn is not fn
    fn = ctx._iter_fn
    ctx.set_interp_fn('interp_besser_2d')
    assert ctx.cfg.interpFn2d == 'interp_besser_2d' and ctx._iter_fn is not fn
    for bad in ('piecewise_linear_1d', 'piecewise_bezier3_1d', 'bogus'):
        with pytest.raises(ValueError, match='2D atmosphere'):
            ctx.set_formal_solver(bad)
    with pytest.raises(ValueError, match='Unknown interpolation'):
        ctx.set_interp_fn('interp_linear_1d')
    for scheme in ('mali_full_precond_pallas', 'mali_full_precond_fused'):
        with pytest.raises(ValueError, match='needs 1D'):
            ctx.set_fs_iter_scheme(scheme)
    ref = slab_2d(12, 4, periodic=True, device='cpu',
                  formalSolver='piecewise_besser_2d',
                  interpFn2d='interp_besser_2d')
    out = ctx.formal_sol_gamma_matrices()
    refOut = ref.formal_sol_gamma_matrices()
    assert torch.equal(ctx.J, ref.J) and out.dJMax == refOut.dJMax


def test_mixed_x_boundaries_and_3d_raise():
    """Mixed periodic and callable x boundaries raise with the JAX
    package's message; so does a 3D atmosphere (no quadrature, no
    solver), and a callable x boundary of the wrong shape at the first
    MALI step."""
    atmos, spect, eqPops = _golden_atmos_inputs()
    from lightweaver_tpu_torch.atmosphere import PeriodicRadiation
    atmos.xUpperBc = PeriodicRadiation()
    with pytest.raises(ValueError, match='Mixed x boundary types'):
        Context(atmos, spect, eqPops, device='cpu')
    atmos.xUpperBc = _FixedXBc(np.zeros((3, 2, 2, 30)))
    ctx = Context(atmos, spect, eqPops, device='cpu')
    with pytest.raises(ValueError, match=r'\[Nlam, Nmu, 2\(down,up\), Nz\]'):
        ctx.formal_sol_gamma_matrices()
    from lightweaver_tpu_torch.fal import Falc82
    full = Falc82()
    Nz, Ny, Nx = 5, 2, 2

    def grid(a):
        return np.broadcast_to(a[:Nz, None, None], (Nz, Ny, Nx)).copy()
    atmos3 = Atmosphere.make_3d(
        height=full.height[:Nz], x=np.arange(Nx) * 1e5,
        y=np.arange(Ny) * 1e5, temperature=grid(full.temperature),
        vx=grid(0 * full.vlos), vy=grid(0 * full.vlos),
        vz=grid(full.vlos), vturb=grid(full.vturb), ne=grid(full.ne),
        nHTot=grid(full.nHTot))
    atmos3.muz = atmos3.wmu = np.ones(1)
    atmos3.mux = atmos3.muy = np.zeros(1)
    with pytest.raises(ValueError, match='3D atmosphere'):
        Context(atmos3, spect, eqPops, device='cpu')


def _rel(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    return np.abs(ours - ref).max() / np.abs(ref).max()


def test_f32_matches_jax_by_the_rule():
    """Two MALI steps of a 2D float32 Context (12 x 4, periodic): the
    port's float32 iteration on the JAX float32 state is as close to the
    JAX float64 iteration on the same params as the JAX float32 one
    (module docstring's rule) for J, I, Gamma and the rates; dJ with
    float32 subnormals flushed to 1e-3 of the JAX float32 dJ."""
    atmos = slab_2d_atmos(12, 4, dx=2e5, periodic=True)
    jctx = jax_context(jax_atmos(atmos), dtype=jnp.float32)
    assert jctx.accumDtype == jnp.float64
    tctx = port_context(atmos, dtype=torch.float32)
    it64 = jax.jit(j_build_iteration_fn(dataclasses.replace(
        jctx.cfg, dtype=jnp.float64)))
    it32 = jax.jit(j_build_iteration_fn(jctx.cfg))
    for step in range(2):
        jparams = jctx.build_params()
        j64 = jax.tree_util.tree_map(
            lambda x: (jnp.asarray(x, jnp.float64)
                       if getattr(x, 'dtype', None) == jnp.float32 else x),
            jparams)
        ref64 = it64(j64)
        ref32 = it32(jparams)
        out = build_iteration_fn(tctx.cfg)(
            params_from_numpy(jparams, tctx.cfg))
        pairs = [(out['J'], ref32['J'], ref64['J']),
                 (out['I'], ref32['I'], ref64['I']),
                 (out['Gamma'][0], ref32['Gamma'][0], ref64['Gamma'][0])]
        for key in ('Rij', 'Rji'):
            pairs += list(zip(out[key][0], ref32[key][0], ref64[key][0]))
        for ours, ref, truth in pairs:
            assert ours.dtype == torch.float64 or ours.dtype == torch.float32
            assert _rel(ours, truth) <= 2.0 * _rel(ref, truth) + F32_BAR
        assert out['I'].dtype == torch.float32
        assert out['J'].dtype == torch.float64
        torch.set_flush_denormal(True)
        try:
            ftz = build_iteration_fn(tctx.cfg)(
                params_from_numpy(jparams, tctx.cfg))
        finally:
            torch.set_flush_denormal(False)
        np.testing.assert_allclose(float(ftz['dJ']), float(ref32['dJ']),
                                   rtol=1e-3)
        jctx.formal_sol_gamma_matrices()
        jctx.stat_equil()


@pytest.mark.parametrize('hprd', [False, True], ids=['prd', 'hprd'])
def test_prd_on_2d_matches_jax(hprd):
    """H 6-level active with Ly-alpha and Ly-beta in PRD on a 2D slab (12
    x 4 with the 1 km/s x flow, so hybrid PRD's comoving frame moves): two
    MALI steps, stat_equil, then prd_redistribute(maxIter=2) in each
    package, the full-grid MALI step in every sub-iteration: rho, J and the
    populations within 1e-10 (lockstep at each MALI step)."""
    atmos = slab_2d_atmos(12, 4, periodic=True)
    jctx = jax_context(jax_atmos(atmos), active=('H',),
                       formalSolver='piecewise_linear_2d', hprd=hprd)
    tctx = port_context(atmos, active=('H',), hprd=hprd)
    assert tctx._prd_lines() and tctx.cfg.hprd == hprd
    for step in range(2):
        jctx.formal_sol_gamma_matrices()
        tctx.formal_sol_gamma_matrices()
        jctx.stat_equil()
        tctx.stat_equil()
    ju = jctx.prd_redistribute(maxIter=2)
    tu = tctx.prd_redistribute(maxIter=2)
    assert tu.NprdSubIter == ju.NprdSubIter
    for ai, ti, a, t in tctx._prd_lines():
        e = relerr(tctx.rhoPrd[ai][ti], jctx.rhoPrd[ai][ti])
        assert e < 1e-10, ('rho', ti, e)
    assert relerr(tctx.J, jctx.J) < 1e-10
    assert relerr(tctx.popsState[0]['n'], jctx.popsState[0]['n']) < 1e-10
