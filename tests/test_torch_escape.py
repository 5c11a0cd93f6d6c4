"""The escape-probability start of the port against the JAX package.

escape.py is a copy of lightweaver_tpu/escape.py (numpy, the Voigt
function from the port's ops/faddeeva.py); its functions are held to the
JAX module's at 1e-12, and the start of tests/test_escape_probability.py's
problem (FAL-C decimated to 30 depths, 3 rays, H 6-level + Ca II with Ca
II active) to the JAX Context's, with the LTE fallback when the
iteration does not converge.

The escape iteration's solve is ill-conditioned: its populations span 20
decades, and one solve takes Gamma's 1e-15 differences to 1e-6 relative
in the smallest populations (measured on the second iterate), which set
its stopping test (max |1 - prev/new| < 3e-2).  So the port and the JAX
package stop after 76 and 78 iterations and their starts differ by 4% in
those populations, 1.2e-3 of each depth's largest.  The port's escape
Gamma is held to the JAX one at every JAX iterate (1e-11 in every
element, 2.9e-12 measured), the first iterate per depth at 1e-7, and
the start per depth at 1e-2.
"""
import numpy as np
import pytest
import torch

import lightweaver_tpu.escape as jescape
import lightweaver_tpu.rh_atoms as jatoms
from lightweaver_tpu.atmosphere import Atmosphere as JAtmosphere
from lightweaver_tpu.atomic_set import RadiativeSet as JRadiativeSet
from lightweaver_tpu.context import Context as JContext
from lightweaver_tpu.fal import Falc82 as JFalc82
from lightweaver_tpu.utils import InitialSolution as JInitialSolution
from lightweaver_tpu_torch import (CaII_atom, H_6_atom, InitialSolution,
                                   RadiativeSet)
from lightweaver_tpu_torch import escape
from lightweaver_tpu_torch.context import Context
from lightweaver_tpu_torch.problems import falc_decimated

from tests.test_torch_slice import relerr

NSPACE, NRAYS = 30, 3

# one intra-op thread per process: the tier-1 run has six pytest workers
torch.set_num_threads(1)


@pytest.mark.parametrize('line', [True, False])
def test_escape_probability_matches_jax(line):
    rng = np.random.default_rng(11)
    tau = 10 ** rng.uniform(-4, 3, 40)
    tauC = 10 ** rng.uniform(-5, 2, 40)
    alpha = rng.uniform(1.0, 30.0, 40)
    for a, b in zip(escape.escape_probability(line, tau, tauC, alpha),
                    jescape.escape_probability(line, tau, tauC, alpha)):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0.0)


@pytest.mark.parametrize('line', [True, False])
def test_escape_formal_sol_matches_jax(line):
    rng = np.random.default_rng(12)
    Nk = 30
    height = np.sort(rng.uniform(0, 2e6, Nk))[::-1].copy()
    T = rng.uniform(4e3, 2e4, Nk)
    chi = 10 ** rng.uniform(-9, -3, Nk)
    chiB = 10 ** rng.uniform(-10, -5, Nk)
    S = 10 ** rng.uniform(-10, -6, Nk)
    lam = 393.4 if line else 150.0
    for a, b in zip(
            escape.escape_formal_sol(height, T, lam, chi, chiB, S, line),
            jescape.escape_formal_sol(height, T, lam, chi, chiB, S, line)):
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0.0)


def inputs(jax):
    """tests/test_escape_probability.py's problem, in either package."""
    if jax:
        full = JFalc82()
        idx = np.unique(np.linspace(0, 81, NSPACE).astype(int))
        atmos = JAtmosphere(height=full.height[idx],
                            temperature=full.temperature[idx],
                            vlos=full.vlos[idx], vturb=full.vturb[idx],
                            ne=full.ne[idx], nHTot=full.nHTot[idx])
        rs = JRadiativeSet([jatoms.H_6_atom(), jatoms.CaII_atom()])
    else:
        atmos = falc_decimated(NSPACE)
        rs = RadiativeSet([H_6_atom(), CaII_atom()])
    atmos.quadrature(NRAYS)
    rs.set_active('Ca')
    spect = rs.compute_wavelength_grid()
    return atmos, spect, rs.compute_eq_pops(atmos)


@pytest.fixture(scope='module')
def start_pair():
    """The JAX and port Contexts with the escape-probability start, the
    populations at which the JAX start evaluated its Gamma, and the port's
    start populations (tests below run the start again on the Context)."""
    iterates = []
    gamma = jescape.gamma_escape_prob

    def recorded(ctx, ai, n):
        iterates.append(np.array(n))
        return gamma(ctx, ai, n)
    jescape.gamma_escape_prob = recorded
    try:
        jctx = JContext(*inputs(True),
                        initSol=JInitialSolution.EscapeProbability)
    finally:
        jescape.gamma_escape_prob = gamma
    tctx = Context(*inputs(False), initSol=InitialSolution.EscapeProbability,
                   device='cpu')
    return jctx, tctx, iterates, tctx.popsState[0]['n'].clone()


def test_escape_start_matches_jax(start_pair):
    """The start populations: per depth within 1e-2 of the JAX start's
    largest population (1.2e-3 measured); they conserve the total and
    depart from LTE."""
    jctx, tctx = start_pair[:2]
    n = start_pair[3]
    assert n.dtype == torch.float64 and n.device.type == 'cpu'
    ref = np.asarray(jctx.popsState[0]['n'])
    assert (np.abs(n.numpy() - ref).max(axis=0)
            / np.abs(ref).max(axis=0)).max() < 1e-2
    nTotal = tctx.eqPops.atomicPops['Ca'].nTotal
    np.testing.assert_allclose(n.sum(dim=0), nTotal, rtol=1e-6)
    assert (n / tctx.popsState[0]['nStar'] - 1.0).abs().max() > 0.05


def test_gamma_escape_prob_matches_jax_at_every_iterate(start_pair):
    jctx, tctx, iterates = start_pair[:3]
    assert len(iterates) > 10
    for n in iterates:
        np.testing.assert_allclose(escape.gamma_escape_prob(tctx, 0, n),
                                   jescape.gamma_escape_prob(jctx, 0, n),
                                   rtol=1e-11, atol=0.0)


def test_first_iterate_matches_jax(start_pair):
    """The port's first escape iterate (its second Gamma evaluation point)
    against the JAX start's, per depth over the largest population at
    1e-7 (3.9e-8 measured): the first solve already takes Gamma's 1e-15
    differences to 2.5e-6 relative in the smallest populations."""
    tctx, iterates = start_pair[1:3]
    seen = []
    gamma = escape.gamma_escape_prob

    def recorded(ctx, ai, n):
        seen.append(np.array(n))
        return gamma(ctx, ai, n)
    escape.gamma_escape_prob = recorded
    try:
        escape.set_pops_escape_probability(tctx, Niter=2)
    finally:
        escape.gamma_escape_prob = gamma
    np.testing.assert_array_equal(seen[0], iterates[0])
    err = (np.abs(seen[1] - iterates[1]).max(axis=0)
           / np.abs(iterates[1]).max(axis=0))
    assert err.max() < 1e-7, err.max()


def test_escape_start_is_deterministic(start_pair):
    """The same inputs give the same start bit for bit (the card and the
    CPU run the same host code), and Ng's history begins at it (the Ng
    objects are built after the escape-probability start, as in the JAX
    package)."""
    again = Context(*inputs(False), initSol=InitialSolution.EscapeProbability,
                    device='cpu')
    assert torch.equal(again.popsState[0]['n'], start_pair[3])
    np.testing.assert_array_equal(again.ngs[0].previous[0],
                                  start_pair[3].numpy().ravel())


def test_lte_fallback_matches_jax(start_pair):
    """One escape-probability iteration cannot converge: the populations
    fall back to LTE (nStar), in both packages."""
    jctx, tctx = start_pair[:2]
    escape.set_pops_escape_probability(tctx, Niter=1)
    jescape.set_pops_escape_probability(jctx, Niter=1)
    np.testing.assert_array_equal(tctx.popsState[0]['n'],
                                  tctx.popsState[0]['nStar'])
    assert relerr(tctx.popsState[0]['n'], jctx.popsState[0]['n']) < 1e-12
