"""Hybrid PRD under the float32 state against the JAX package's.

1D: the small H 6 problem of tests/test_torch_prd_context.py (FAL-C at 20
depths, 3 rays, Ly-alpha and Ly-beta in PRD) with its 0-5 km/s outflow
ramp and hprd=True, in float32.  The JAX float32 hybrid-PRD Context takes
three MALI steps, each followed by stat_equil and prd_redistribute, then a
fourth MALI step and stat_equil.  2D: the slab of
tests/test_torch_2d_context.py::test_prd_on_2d_matches_jax (12 x 4, the 1
km/s x flow, H 6 active) in float32 after two MALI steps and stat_equil.
From each state:

- one MALI iteration: the port's float32 iteration and the JAX float32
  one on the JAX params, each held to the JAX float64 iteration on the
  same params cast to float64 (the rule of tests/test_torch_solvers.py):
  err(port f32, JAX f64) <= 2 err(JAX f32, JAX f64) + 32 float32 ulps of
  the maximum, for Gamma, the rates, J, I and JRest.  J, I and JRest are
  held per wavelength (each row over its maximum), each row to twice the
  larger of its own JAX float32 distance and the worst one over the rows
  where JAX float32 is within 10% of float64: the JAX float32 J and I are
  73-84% from float64 in the six bluest rows of the 1D problem (the
  port's within 0.5%), and elsewhere the rows' float32 rounding scatters
  both packages by up to ~1e-3 row by row (without hybrid PRD too).
- one prd_redistribute: the JAX float32 state goes into the port's
  float32 Context and into a JAX float64 Context; the JAX float32 Context,
  the JAX float64 one and the port redistribute once (on 2D with the
  full-grid MALI step, maxIter=1), and the port is held by the same rule
  to the float64 redistribution: rho, the PRD lines' rates, J and JRest.

Where the two float32 paths form a quantity in different dtypes:

- the port keeps its state (populations, background, collisional rates,
  rho) in float64 and casts it for the ray maths; the JAX float32 Context
  keeps it in float32 (its values come across exactly);
- the comoving-frame shift, its interpolation fractions and rho in the
  ray maths are float32 on both sides;
- J is summed in float64 from float32 products on both sides; JRest in
  float64 from float32 products in the port, in float32 in JAX;
- rho is formed in float64 from float64 J, JRest, rates and populations in
  the port, in float32 in JAX.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import lightweaver_tpu.rh_atoms as jatoms
from lightweaver_tpu.atomic_set import RadiativeSet as JRadiativeSet
from lightweaver_tpu.context import Context as JContext
from lightweaver_tpu.context import build_iteration_fn as j_build_iteration_fn
from lightweaver_tpu_torch import H_6_atom, RadiativeSet
from lightweaver_tpu_torch.context import Context, build_iteration_fn
from lightweaver_tpu_torch.convert import params_from_numpy
from lightweaver_tpu_torch.problems import (falc_interpolated, slab_2d_atmos,
                                            vlos_ramp)

from tests.test_torch_2d_context import jax_atmos, jax_context, port_context
from tests.test_torch_slice import _jax_falc_interpolated

NSPACE, NRAYS = 20, 3
F32_BAR = 32 * np.finfo(np.float32).eps

# one intra-op thread per process: the tier-1 run has six pytest workers
torch.set_num_threads(1)


def _np(x):
    return np.asarray(x, np.float64)


def rel(ours, ref):
    ours, ref = _np(ours), _np(ref)
    return np.abs(ours - ref).max() / np.abs(ref).max()


def per_row(ours, ref):
    """max |ours - ref| over the row's max |ref|, per row of the first axis
    (wavelength)."""
    ours = _np(ours).reshape(len(ref), -1)
    ref = _np(ref).reshape(len(ref), -1)
    return np.abs(ours - ref).max(axis=1) / np.abs(ref).max(axis=1)


def assert_rule(ours, ref32, ref64, err, what):
    e, e32 = err(ours, ref64), err(ref32, ref64)
    if np.ndim(e32):
        e32 = np.maximum(e32, e32[e32 < 0.1].max())
    bar = 2.0 * e32 + F32_BAR
    assert np.all(e <= bar), (what, np.max(e - bar))


def pair_1d():
    atmos = _jax_falc_interpolated(NSPACE)
    atmos.quadrature(NRAYS)
    atmos.vlos = 5e3 * (atmos.height - atmos.height.min()) \
        / (atmos.height.max() - atmos.height.min())
    rs = JRadiativeSet([jatoms.H_6_atom()])
    rs.set_active('H')
    jctx = JContext(atmos, rs.compute_wavelength_grid(),
                    rs.compute_eq_pops(atmos), hprd=True, dtype=jnp.float32)
    tatmos = vlos_ramp(falc_interpolated(NSPACE))
    tatmos.quadrature(NRAYS)
    trs = RadiativeSet([H_6_atom()])
    trs.set_active('H')
    tctx = Context(tatmos, trs.compute_wavelength_grid(),
                   trs.compute_eq_pops(tatmos), hprd=True, device='cpu',
                   dtype=torch.float32)
    for _ in range(3):
        jctx.formal_sol_gamma_matrices()
        jctx.stat_equil()
        jctx.prd_redistribute()
    jctx.formal_sol_gamma_matrices()
    jctx.stat_equil()
    return jctx, tctx


def pair_2d():
    atmos = slab_2d_atmos(12, 4, periodic=True)
    jctx = jax_context(jax_atmos(atmos), active=('H',),
                       formalSolver='piecewise_linear_2d', hprd=True,
                       dtype=jnp.float32)
    tctx = port_context(atmos, active=('H',), hprd=True, dtype=torch.float32)
    for _ in range(2):
        jctx.formal_sol_gamma_matrices()
        jctx.stat_equil()
    return jctx, tctx


@pytest.fixture(scope='module', params=['1d', '2d'])
def stepped(request):
    jctx, tctx = (pair_1d if request.param == '1d' else pair_2d)()
    assert jctx.cfg.hprd and tctx.cfg.hprd
    assert jctx.accumDtype == jnp.float64
    return request.param, jctx, tctx


def to_f64(tree):
    return jax.tree_util.tree_map(
        lambda x: (jnp.asarray(x, jnp.float64)
                   if getattr(x, 'dtype', None) == jnp.float32 else x), tree)


def test_hprd_f32_iteration_by_the_rule(stepped):
    """One MALI iteration from the JAX float32 state (module docstring):
    Gamma, the rates, J, I and JRest; J and JRest float64 in the port, I
    float32."""
    dim, jctx, tctx = stepped
    jparams = jctx.build_params()
    ref32 = jctx._iter_fn(jparams)   # the Context's compiled step
    ref64 = jax.jit(j_build_iteration_fn(dataclasses.replace(
        jctx.cfg, dtype=jnp.float64)))(to_f64(jparams))
    out = build_iteration_fn(tctx.cfg)(params_from_numpy(jparams, tctx.cfg))
    assert out['I'].dtype == torch.float32
    assert out['J'].dtype == out['JRest'].dtype == torch.float64
    for key in ('J', 'I', 'JRest'):
        assert_rule(out[key], ref32[key], ref64[key], per_row, key)
    assert_rule(out['Gamma'][0], ref32['Gamma'][0], ref64['Gamma'][0], rel,
                'Gamma')
    for key in ('Rij', 'Rji'):
        for ti, x in enumerate(out[key][0]):
            assert_rule(x, ref32[key][0][ti], ref64[key][0][ti], rel,
                        (key, ti))


def inject(ctx, jctx, dtype, host):
    """The JAX float32 Context's iteration state (J, JRest, populations and
    nStar, rates, rho) into ``ctx``, its arrays made by ``host`` in
    ``dtype``."""
    ctx._params = ctx.build_params()
    ctx.J = host(jctx.J, dtype)
    ctx.JRest = host(jctx.JRest, dtype)
    for st, jst in zip(ctx.popsState, jctx.popsState):
        st['n'] = host(jst['n'], dtype)
        st['nStar'] = host(jst['nStar'], dtype)
    ctx._Rij = [[host(x, dtype) for x in row] for row in jctx._Rij]
    ctx._Rji = [[host(x, dtype) for x in row] for row in jctx._Rji]
    for ai, ti, a, t in ctx._prd_lines():
        ctx.rhoPrd[ai][ti] = host(jctx.rhoPrd[ai][ti], dtype)


def test_hprd_f32_redistribute_by_the_rule(stepped):
    """One prd_redistribute from the JAX float32 state (module docstring):
    rho, the PRD lines' rates, J and JRest, held to the JAX float64
    redistribution from the same state; rho and J float64 in the port."""
    dim, jctx, tctx = stepped
    j64 = JContext(jctx.atmos, jctx.spect, jctx.eqPops, hprd=True,
                   dtype=jnp.float64,
                   **({'formalSolver': 'piecewise_linear_2d'}
                      if dim == '2d' else {}))
    inject(j64, jctx, jnp.float64, lambda x, dt: jnp.asarray(x, dt))
    inject(tctx, jctx, torch.float64,
           lambda x, dt: torch.tensor(_np(x), dtype=dt))
    maxIter = 1 if dim == '2d' else 3
    u64 = j64.prd_redistribute(maxIter=maxIter)
    u32 = jctx.prd_redistribute(maxIter=maxIter)
    tu = tctx.prd_redistribute(maxIter=maxIter)
    assert tu.NprdSubIter == u32.NprdSubIter == u64.NprdSubIter
    lines = [(ai, ti) for ai, ti, a, t in tctx._prd_lines()]
    for ai, ti in lines:
        rho = tctx.rhoPrd[ai][ti]
        assert rho.dtype == torch.float64
        assert np.abs(_np(jctx.rhoPrd[ai][ti]) - 1.0).max() > 0.1
        assert_rule(rho, jctx.rhoPrd[ai][ti], j64.rhoPrd[ai][ti], rel,
                    ('rho', ti))
        for key in ('_Rij', '_Rji'):
            assert_rule(getattr(tctx, key)[ai][ti],
                        getattr(jctx, key)[ai][ti],
                        getattr(j64, key)[ai][ti], rel, (key, ti))
    assert tctx.J.dtype == tctx.JRest.dtype == torch.float64
    assert_rule(tctx.J, jctx.J, j64.J, per_row, 'J')
    assert_rule(tctx.JRest, jctx.JRest, j64.JRest, per_row, 'JRest')
