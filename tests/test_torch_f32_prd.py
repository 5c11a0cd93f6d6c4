"""prd_redistribute under the float32 state against the JAX package's.

The small H 6 PRD problem of tests/test_torch_prd_context.py (FAL-C
interpolated to 20 depths, 3 rays, Ly-alpha and Ly-beta in PRD) with a
float32 state: the JAX Context takes three MALI steps, each followed by
stat_equil and prd_redistribute, then a fourth MALI step and stat_equil;
its state goes into the port's float32 Context (populations, rates, rho
and J as float64, as the port keeps its state) and both redistribute
once more.

The port forms rho in float64 from float64 J, rates and populations, as
it keeps rho; the JAX float32 Context forms it from float32 inputs and
stores it as float32.  The subset formal solution runs in float32 on both
sides, the port's summing J in float64 from float32 products.  The bars
are twice the distance between the JAX float32 redistribution and a JAX
float64 one from the same state (measured: rho 7.3e-4 and 1.4e-3 of its
maximum, Rij 1.3e-5, Rji 7.7e-4, J 1.4e-2 of each wavelength's maximum
over depth, dRho 4.0e-2 relative): rho 3e-3, Rij/Rji 2e-3, J 3e-2, dRho
8e-2.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import lightweaver_tpu.rh_atoms as jatoms
from lightweaver_tpu.atomic_set import RadiativeSet as JRadiativeSet
from lightweaver_tpu.context import Context as JContext
from lightweaver_tpu_torch import H_6_atom, RadiativeSet
from lightweaver_tpu_torch.context import Context
from lightweaver_tpu_torch.problems import falc_interpolated

from tests.test_torch_slice import _jax_falc_interpolated

NSPACE, NRAYS = 20, 3

# one intra-op thread per process: the tier-1 run has six pytest workers
torch.set_num_threads(1)


def rel(ours, ref):
    ours = np.asarray(ours, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(ours - ref).max() / np.abs(ref).max()


def per_wavelength(ours, ref):
    ours = np.asarray(ours, np.float64)
    ref = np.asarray(ref, np.float64)
    return (np.abs(ours - ref).max(axis=1) / np.abs(ref).max(axis=1)).max()


@pytest.fixture(scope='module')
def redistributed():
    atmos = _jax_falc_interpolated(NSPACE)
    atmos.quadrature(NRAYS)
    rs = JRadiativeSet([jatoms.H_6_atom()])
    rs.set_active('H')
    jctx = JContext(atmos, rs.compute_wavelength_grid(),
                    rs.compute_eq_pops(atmos), dtype=jnp.float32)
    for _ in range(3):
        jctx.formal_sol_gamma_matrices()
        jctx.stat_equil()
        jctx.prd_redistribute()
    jctx.formal_sol_gamma_matrices()
    jctx.stat_equil()

    tatmos = falc_interpolated(NSPACE)
    tatmos.quadrature(NRAYS)
    trs = RadiativeSet([H_6_atom()])
    trs.set_active('H')
    tctx = Context(tatmos, trs.compute_wavelength_grid(),
                   trs.compute_eq_pops(tatmos), device='cpu',
                   dtype=torch.float32)

    def t_(x):
        return torch.tensor(np.asarray(x), dtype=torch.float64)
    tctx._params = tctx.build_params()
    tctx.J = t_(jctx.J)
    for st, jst in zip(tctx.popsState, jctx.popsState):
        st['n'] = t_(jst['n'])
    tctx._Rij = [[t_(x) for x in row] for row in jctx._Rij]
    tctx._Rji = [[t_(x) for x in row] for row in jctx._Rji]
    lines = [(ai, ti) for ai, ti, a, t in tctx._prd_lines()]
    for ai, ti in lines:
        tctx.rhoPrd[ai][ti] = t_(jctx.rhoPrd[ai][ti])
    ju = jctx.prd_redistribute()
    tu = tctx.prd_redistribute()
    return jctx, tctx, ju, tu, lines


def test_prd_redistribute_f32_matches_jax(redistributed):
    """rho, the PRD lines' rates, J and dRho after one prd_redistribute
    call from the same float32 state, at the module docstring's bars; rho,
    the rates and J float64 in the port."""
    jctx, tctx, ju, tu, lines = redistributed
    assert tu.updatedRho and tu.NprdSubIter == ju.NprdSubIter
    np.testing.assert_allclose(tu.dRho, ju.dRho, rtol=8e-2)
    for ai, ti in lines:
        rho = tctx.rhoPrd[ai][ti]
        assert rho.dtype == torch.float64
        ref = np.asarray(jctx.rhoPrd[ai][ti])
        assert np.abs(ref - 1.0).max() > 1.0
        assert rel(rho, ref) < 3e-3, ('rho', ti)
        for key in ('Rij', 'Rji'):
            x = getattr(tctx, '_' + key)[ai][ti]
            assert x.dtype == torch.float64
            assert rel(x, getattr(jctx, '_' + key)[ai][ti]) < 2e-3, (key, ti)
    assert tctx.J.dtype == torch.float64
    assert per_wavelength(tctx.J, jctx.J) < 3e-2
