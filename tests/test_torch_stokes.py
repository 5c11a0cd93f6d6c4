"""Full-Stokes Zeeman synthesis of the port against the JAX package:
ops/stokes.py (stokes_K, delo_bezier_stokes), the polarised profiles
(Context.compute_polarised_profiles) and the polarised formal solution
(Context.single_stokes_fs with updateJ and J20, compute_rays(stokes=True)),
then the physics oracles of tests/test_stokes.py.

The Context problem: FAL-C interpolated to 20 depths, 3 rays, H 6-level
+ Ca II with Ca II active, in a uniform 0.1 T field at inclination pi/3
and azimuth pi/6 (BASELINE config 4's field).  The port takes the JAX
Context's J and populations after two MALI steps, so each comparison
isolates the synthesis.  Bars: 1e-9 of each quantity's amplitude (its
maximum magnitude): Q, U and V cross zero, so relative errors are
normalised as tests/test_vs_reference_golden.py's amperr does.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import lightweaver_tpu.rh_atoms as jatoms
from lightweaver_tpu.atomic_set import RadiativeSet as JRadiativeSet
from lightweaver_tpu.context import Context as JContext
from lightweaver_tpu.ops import stokes as jstokes
from lightweaver_tpu_torch.ops import stokes as tstokes
from lightweaver_tpu_torch.problems import (falc_interpolated, magnetise,
                                            timedep_context)

from tests.test_torch_slice import _jax_falc_interpolated

NSPACE, NRAYS = 20, 3
POL_NAMES = ('phi', 'phiQ', 'phiU', 'phiV', 'psiQ', 'psiU', 'psiV', 'wphi')

# one intra-op thread per process: the tier-1 run has six pytest workers
torch.set_num_threads(1)


def amperr(ours, ref):
    """max |ours - ref| / max |ref|."""
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    return np.abs(ours - ref).max() / np.abs(ref).max()


def _random_stokes(B=12, N=30, seed=0):
    """Random smooth opacities (polarised components up to 30% of chiI),
    source functions, heights, mu and boundary Stokes vectors."""
    rng = np.random.default_rng(seed)
    chiI = 10 ** np.cumsum(rng.uniform(0.0, 0.3, (B, N)), axis=1) * 1e-8
    chi7 = np.concatenate([chiI[:, None],
                           chiI[:, None] * rng.uniform(-0.3, 0.3, (B, 6, N))],
                          axis=1)
    S4 = np.concatenate([rng.uniform(1.0, 2.0, (B, 1, N)),
                         rng.uniform(-0.1, 0.1, (B, 3, N))], axis=1)
    h = np.linspace(2e6, 0.0, N)
    Iupw = np.concatenate([rng.uniform(1.0, 2.0, (B, 1)),
                           rng.uniform(-0.1, 0.1, (B, 3))], axis=1)
    return chi7, S4, h, rng.uniform(0.1, 1.0, B), Iupw


def test_stokes_K_matches_jax():
    chi7 = np.moveaxis(_random_stokes()[0], 1, -1)
    K = tstokes.stokes_K(torch.tensor(chi7))
    assert K.shape == chi7.shape[:-1] + (4, 4)
    assert amperr(K.numpy(), jstokes.stokes_K(jnp.asarray(chi7))) < 1e-15


@pytest.mark.parametrize('to_obs', [True, False])
def test_delo_bezier_stokes_matches_jax(to_obs):
    """The DELO-Bezier3 sweep of random polarised rays: 1e-10 of each
    Stokes component's amplitude (the Bezier weights' exp, and the 4x4
    solves' order, in the last ulps)."""
    args = _random_stokes()
    ours = tstokes.delo_bezier_stokes(*map(torch.tensor, args),
                                      to_obs=to_obs).numpy()
    ref = np.asarray(jstokes.delo_bezier_stokes(*map(jnp.asarray, args),
                                                to_obs=to_obs))
    assert ours.shape == ref.shape == (12, 4, 30)
    for s in range(4):
        assert amperr(ours[:, s], ref[:, s]) < 1e-10, s


@pytest.fixture(scope='module')
def pair():
    atmos = _jax_falc_interpolated(NSPACE)
    atmos.quadrature(NRAYS)
    magnetise(atmos)
    rs = JRadiativeSet([jatoms.H_6_atom(), jatoms.CaII_atom()])
    rs.set_active('Ca')
    spect = rs.compute_wavelength_grid()
    jctx = JContext(atmos, spect, rs.compute_eq_pops(atmos))
    for _ in range(2):
        jctx.formal_sol_gamma_matrices()
        jctx.stat_equil()
    tctx = timedep_context(device='cpu',
                           atmos=magnetise(falc_interpolated(NSPACE)),
                           Nrays=NRAYS)
    tctx.J = torch.tensor(np.asarray(jctx.J))
    for st, jst in zip(tctx.popsState, jctx.popsState):
        st['n'] = torch.tensor(np.asarray(jst['n']))
    return jctx, tctx


def test_polarised_profiles_match_jax(pair):
    """The seven profiles and wphi of every polarisable line (Ca II's
    five), [W, Nmu, 2, Nk] as in the JAX package."""
    jctx, tctx = pair
    jctx.compute_polarised_profiles()
    tctx.compute_polarised_profiles()
    n = 0
    for ai, (jrow, trow) in enumerate(zip(jctx.phi7, tctx.phi7)):
        for ti, (j7, t7) in enumerate(zip(jrow, trow)):
            assert (j7 is None) == (t7 is None), (ai, ti)
            if j7 is None:
                continue
            n += 1
            for name in POL_NAMES:
                assert t7[name].shape == j7[name].shape
                assert amperr(t7[name], j7[name]) < 1e-9, (ai, ti, name)
    assert n == 5


def test_single_stokes_fs_matches_jax(pair):
    """single_stokes_fs without updateJ, then twice with updateJ and J20
    (the second reads the first's J20): I, Q, U, V, J and J20."""
    jctx, tctx = pair
    for kw in ({}, {'updateJ': True, 'J20': True},
               {'updateJ': True, 'J20': True}):
        ju = jctx.single_stokes_fs(**kw)
        tu = tctx.single_stokes_fs(**kw)
        assert tu.updatedJ == ju.updatedJ
        assert tctx.I.shape == (jctx.cfg.Nlam, NRAYS)
        assert tctx.Quv.shape == (3, jctx.cfg.Nlam, NRAYS)
        assert amperr(tctx.I, jctx.I) < 1e-9, kw
        for s in range(3):
            assert amperr(tctx.Quv[s], jctx.Quv[s]) < 1e-9, ('QUV'[s], kw)
        assert amperr(tctx.J, jctx.J) < 1e-9
        if kw:
            assert amperr(tctx.J20, jctx.J20) < 1e-9


def test_compute_rays_stokes_matches_jax(pair):
    """compute_rays(stokes=True) over Ca II 854.2 nm at mu = 1 and 0.3:
    [4, Nlam, Nmu] against the JAX package's."""
    jctx, tctx = pair
    lam = np.linspace(853.9, 855.0, 41)
    ours = tctx.compute_rays(lam, mus=[1.0, 0.3], stokes=True)
    ref = np.asarray(jctx.compute_rays(lam, mus=[1.0, 0.3], stokes=True))
    assert ours.shape == ref.shape == (4, 41, 2)
    for s in range(4):
        assert amperr(ours[s], ref[s]) < 1e-9, s


def _port_ctx(B=None, gammaB=0.0, chiB=0.0):
    """The port's Context of the oracle problem after 5 MALI steps."""
    atmos = falc_interpolated(NSPACE)
    if B is not None:
        magnetise(atmos, B, gammaB, chiB)
    ctx = timedep_context(device='cpu', atmos=atmos, Nrays=NRAYS)
    for it in range(5):
        ctx.formal_sol_gamma_matrices()
        if it >= 3:
            ctx.stat_equil()
    return ctx


LAM_8542 = np.linspace(853.9, 855.0, 81)


@pytest.fixture(scope='module')
def scalarI():
    return _port_ctx().compute_rays(LAM_8542, mus=[1.0])


def test_weak_field_limit(scalarI):
    """B -> 0 (1 G): Stokes I is the scalar formal solution's and Q, U, V
    are negligible (tests/test_stokes.py's oracle)."""
    IQUV = _port_ctx(B=1e-4, gammaB=0.3, chiB=0.2).compute_rays(
        LAM_8542, mus=[1.0], stokes=True)
    np.testing.assert_allclose(IQUV[0], scalarI, rtol=2e-3)
    assert np.abs(IQUV[1:]).max() < 1e-4 * np.abs(IQUV[0]).max()


def test_longitudinal_field_gives_v_and_no_linear_polarisation():
    """A vertical 1.5 kG field seen along a vertical ray: V antisymmetric
    about the core, Q = U = 0 (tests/test_stokes.py's oracle)."""
    I, Q, U, V = _port_ctx(B=0.15).compute_rays(LAM_8542, mus=[1.0],
                                                stokes=True)[:, :, 0]
    core = np.argmin(np.abs(LAM_8542 - 854.44))
    assert np.abs(Q).max() < 1e-8 * I.max()
    assert np.abs(U).max() < 1e-8 * I.max()
    assert np.abs(V).max() > 1e-4 * I[core]
    assert abs(V.sum()) / np.abs(V).sum() < 0.2
