"""Newton-Raphson charge conservation in the port against the JAX package.

build_nr_fn on seeded random systems (two atoms, continuum pairs, dC/dne
terms, with and without the time-dependent residual and the step limit)
against lightweaver_tpu.nr_update.build_nr_fn at 1e-12.  Then the
Context: FAL-C interpolated to 12 depths (bench.py's interpolation), 2
rays, H 6-level + Ca II active, conserveCharge=True, 3 Lambda iterations
and one MALI step whose stat_equil runs the NR step, in the port and in
the JAX package from the same start: the finite-difference dC/dne
(_fd_dC) at 1e-12, and after the NR step the populations, ne, nStar and
dNeMax at 1e-9.  The NR step moves ne, and with it nStar and the
collisional rates; the next MALI step's Gamma must see both (the
continua's gij read nStar), held to the JAX one at 1e-10.  The golden
falc_h6ca_nr step (converged falc_h6ca, one raw NR step) is marked slow.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import lightweaver_tpu.rh_atoms as jatoms
from lightweaver_tpu.atomic_set import RadiativeSet as JRadiativeSet
from lightweaver_tpu.context import Context as JContext
from lightweaver_tpu.nr_update import build_nr_fn as j_build_nr_fn
from lightweaver_tpu_torch import (CaII_atom, Falc82, H_6_atom, RadiativeSet,
                                   iterate_ctx_se)
from lightweaver_tpu_torch.context import Context
from lightweaver_tpu_torch.nr_update import build_nr_fn
from lightweaver_tpu_torch.problems import falc_interpolated, h6ca_context

from tests.test_torch_ng import depth_err, pops_err, sync
from tests.test_torch_slice import _jax_falc_interpolated, relerr

GOLDEN = os.path.join(os.path.dirname(__file__), 'golden')
NSPACE, NRAYS, NSCATTER = 12, 2, 3

# one intra-op thread per process: the tier-1 run has six pytest workers
torch.set_num_threads(1)


def random_nr_inputs(seed=3, Nk=9):
    """Two atoms (4 and 3 levels) with valid rate matrices (zero column
    sums), collisional and dC/dne matrices, populations, ne and the
    background electrons, as numpy arrays."""
    rng = np.random.default_rng(seed)
    Nlevels = [4, 3]
    stages = [np.array([0.0, 0.0, 0.0, 1.0]), np.array([1.0, 1.0, 2.0])]
    contPairs = [[(0, 3), (1, 3)], [(0, 2)]]
    G, C, dC, n, nPrev, nTot = [], [], [], [], [], []
    for Nl in Nlevels:
        g = rng.uniform(0.1, 2.0, (Nl, Nl, Nk))
        g[np.arange(Nl), np.arange(Nl)] = 0.0
        g[np.arange(Nl), np.arange(Nl)] = -g.sum(axis=0)
        G.append(g)
        C.append(rng.uniform(0.0, 0.5, (Nl, Nl, Nk)))
        dC.append(rng.uniform(-1e-3, 1e-3, (Nl, Nl, Nk)))
        n.append(rng.uniform(0.5, 2.0, (Nl, Nk)))
        nPrev.append(rng.uniform(0.5, 2.0, (Nl, Nk)))
        nTot.append(n[-1].sum(axis=0) * rng.uniform(0.9, 1.1, Nk))
    return dict(Nlevels=Nlevels, stages=stages, contPairs=contPairs, G=G,
                C=C, dC=dC, n=n, nPrev=nPrev, nTot=nTot,
                ne=rng.uniform(1.0, 3.0, Nk), bgNe=rng.uniform(0.0, 1.0, Nk))


@pytest.mark.parametrize('stepLimit', [False, True])
@pytest.mark.parametrize('timeDep', [False, True])
def test_build_nr_fn_matches_jax(timeDep, stepLimit):
    d = random_nr_inputs()
    args = (d['Nlevels'], d['stages'], d['contPairs'], timeDep)
    jfn = j_build_nr_fn(*args, jnp.float64, stepLimit=stepLimit)
    tfn = build_nr_fn(*args, torch.float64, stepLimit=stepLimit)
    crsw, dt = 1.3, 0.7

    def run(fn, conv):
        extra = (dt, [conv(x) for x in d['nPrev']]) if timeDep else ()
        return fn([conv(x) for x in d['G']], [conv(x) for x in d['n']],
                  [conv(x) for x in d['nTot']], [conv(x) for x in d['C']],
                  [conv(x) for x in d['dC']], conv(d['ne']),
                  conv(d['bgNe']), crsw, *extra)
    jNs, jNe = run(jfn, jnp.asarray)
    tNs, tNe = run(tfn, torch.as_tensor)
    for a, b in zip(tNs, jNs):
        assert relerr(a, b, floorRel=0.0) < 1e-12
    assert relerr(tNe, jNe, floorRel=0.0) < 1e-12
    # the step moved the state (and, with stepLimit, stays positive)
    assert relerr(tNe, d['ne'], floorRel=0.0) > 1e-3
    if stepLimit:
        assert all(torch.all(x > 0) for x in tNs) and torch.all(tNe > 0)


def jax_context(dtype=None, active=('H', 'Ca'), **options):
    atmos = _jax_falc_interpolated(NSPACE)
    atmos.quadrature(NRAYS)
    rs = JRadiativeSet([jatoms.H_6_atom(), jatoms.CaII_atom()])
    rs.set_active(*active)
    spect = rs.compute_wavelength_grid()
    return JContext(atmos, spect, rs.compute_eq_pops(atmos), dtype=dtype,
                    **options)


def port_context(active=('H', 'Ca'), **options):
    atmos = falc_interpolated(NSPACE)
    atmos.quadrature(NRAYS)
    rs = RadiativeSet([H_6_atom(), CaII_atom()])
    rs.set_active(*active)
    spect = rs.compute_wavelength_grid()
    return Context(atmos, spect, rs.compute_eq_pops(atmos), device='cpu',
                   **options)


def nr_step(ctxs):
    """NSCATTER Lambda iterations and one MALI step with stat_equil on each
    Context; returns the stat_equil updates."""
    for _ in range(NSCATTER + 1):
        for c in ctxs:
            c.formal_sol_gamma_matrices()
    return [c.stat_equil() for c in ctxs]


def nstar_err(a, b):
    return max(relerr(x['nStar'], y['nStar']) for x, y in
               zip(a.popsState, b.popsState))


@pytest.fixture(scope='module', params=[False, True], ids=['all', 'hOnly'])
def nr_pair(request):
    """The JAX and port Contexts after one NR step (charge conservation
    over every active atom, or over hydrogen alone), then one more MALI
    step each; the NR step's updates and the Gamma before it."""
    hOnly = request.param
    jctx = jax_context(conserveCharge=True, nrHOnly=hOnly)
    tctx = port_context(conserveCharge=True, nrHOnly=hOnly)
    ne0 = tctx.atmos.ne.copy()
    jup, tup = nr_step([jctx, tctx])
    after = {'ne0': ne0, 'pops': pops_err(tctx, jctx),
             'ne': relerr(tctx.atmos.ne, jctx.atmos.ne),
             'nStar': nstar_err(tctx, jctx)}
    for c in (jctx, tctx):
        c.formal_sol_gamma_matrices()
    return jctx, tctx, jup, tup, after


def test_nr_step_matches_jax(nr_pair):
    jctx, tctx, jup, tup, after = nr_pair
    assert tup.updatedNe and jup.updatedNe
    assert after['pops'] < 1e-9
    assert after['ne'] < 1e-9
    assert after['nStar'] < 1e-9
    assert relerr(tup.dNeMax, jup.dNeMax) < 1e-9
    np.testing.assert_allclose(tup.dPops, jup.dPops, rtol=1e-8)
    # ne really moved
    assert relerr(tctx.atmos.ne, after['ne0'], floorRel=0.0) > 1e-3


def test_gamma_after_nr_sees_the_new_nstar(nr_pair):
    """The MALI step after the NR step: Gamma and the rates against the
    JAX Context's at 1e-10 (floor 1e-10 of each maximum).  The continua's
    gij read nStar, which the NR step moved with ne."""
    jctx, tctx = nr_pair[:2]
    for ai in range(2):
        assert relerr(tctx._Gamma[ai], jctx._Gamma[ai]) < 1e-10, ai
        for ti in range(len(jctx.activeAtoms[ai].trans)):
            for key in ('_Rij', '_Rji'):
                e = relerr(getattr(tctx, key)[ai][ti],
                           getattr(jctx, key)[ai][ti])
                assert e < 1e-10, (key, ai, ti, e)


def test_collisions_follow_ne_after_nr(nr_pair):
    jctx, tctx = nr_pair[:2]
    for ai in range(2):
        assert relerr(tctx.C[ai], jctx.C[ai]) < 1e-10
        np.testing.assert_array_equal(tctx._deviceC()[ai], tctx.C[ai])


def test_nr_without_hydrogen_active_raises():
    """As in the JAX package: NR needs hydrogen active (the first active
    atom); the port and the JAX Context raise the same ValueError."""
    for ctx in (jax_context(active=('Ca',), conserveCharge=True,
                            nrHOnly=True),
                port_context(active=('Ca',), conserveCharge=True,
                             nrHOnly=True)):
        ctx.formal_sol_gamma_matrices()
        with pytest.raises(ValueError, match='without Hydrogen active'):
            ctx.stat_equil()


def test_nr_f32_state_against_jax():
    """The float32 state: one MALI step with the NR step from the JAX
    float32 Context's state (J and populations copied in before each
    step), beside a float64 port Context on the same state.  The port's NR
    runs in float64 in either precision.  Populations and ne finite and
    within twice the JAX float32 state's own distance to the float64 step
    (populations per depth over the largest, ne relative), and within
    1e-2 of the float64 step."""
    jctx = jax_context(dtype=jnp.float32, conserveCharge=True)
    tctx = port_context(dtype=torch.float32, conserveCharge=True)
    t64 = port_context(conserveCharge=True)
    for it in range(NSCATTER + 1):
        for c in (tctx, t64):
            sync(c, jctx)
        for c in (jctx, tctx, t64):
            c.formal_sol_gamma_matrices()
    for c in (jctx, tctx, t64):
        c.stat_equil()
    for st in tctx.popsState:
        assert torch.isfinite(st['n']).all() and st['n'].dtype == torch.float64
    assert np.all(np.isfinite(tctx.atmos.ne))
    assert depth_err(tctx, jctx) <= 2.0 * depth_err(jctx, t64)
    assert depth_err(tctx, t64) < 1e-2
    neErr = relerr(tctx.atmos.ne, jctx.atmos.ne, floorRel=0.0)
    assert neErr <= 2.0 * relerr(jctx.atmos.ne, t64.atmos.ne, floorRel=0.0)
    assert relerr(tctx.atmos.ne, t64.atmos.ne, floorRel=0.0) < 1e-2


@pytest.fixture(scope='module')
def fresh_pair():
    """The JAX and port Contexts without charge conservation, untouched."""
    return jax_context(), port_context()


def test_fd_dc_matches_jax(fresh_pair):
    """The finite-difference dC/dne on the start state, at 1e-12; ne and
    the LTE populations are restored."""
    jctx, tctx = fresh_pair
    ne = tctx.atmos.ne.copy()
    nStar = [tctx.eqPops.atomicPops[a.model.element].nStar.copy()
             for a in tctx.activeAtoms]
    jd = jctx._fd_dC(jctx.cfg.activeAtoms, [0, 1], 1.0)
    td = tctx._fd_dC(tctx.cfg.activeAtoms, [0, 1], 1.0)
    for a, b in zip(td, jd):
        assert relerr(a, b) < 1e-12
    np.testing.assert_array_equal(tctx.atmos.ne, ne)
    for a, n in zip(tctx.activeAtoms, nStar):
        np.testing.assert_array_equal(
            tctx.eqPops.atomicPops[a.model.element].nStar, n)


# this test moves the Contexts of fresh_pair on: it stays the last one to
# read them
def test_nr_raw_step_and_time_dependent_data_match_jax(fresh_pair):
    """nr_post_update called directly after the Lambda iterations and one
    MALI step: the reference's raw step (stepLimit=False) with the
    backward-Euler residual (dt, the previous populations), against the
    JAX Context's at 1e-9."""
    jctx, tctx = fresh_pair
    for _ in range(NSCATTER + 1):
        for c in (jctx, tctx):
            c.formal_sol_gamma_matrices()
    prev = [np.array(st['n']) for st in jctx.popsState]
    dN = [c.nr_post_update(hOnly=False, stepLimit=False,
                           timeDependentData={'dt': 0.5, 'nPrev': prev})
          for c in (jctx, tctx)]
    assert relerr(dN[1], dN[0]) < 1e-9
    assert pops_err(tctx, jctx) < 1e-9
    assert relerr(tctx.atmos.ne, jctx.atmos.ne) < 1e-9


@pytest.mark.slow
def test_nr_golden_step():
    """falc_h6ca converged (211 iterations), then one raw NR step
    (stepLimit=False) with the finite-difference dC/dne: dC against the
    golden inputs at 1e-10, populations within 1e-7 and ne within 1e-9
    of the compiled reference's step (falc_h6ca_nr)."""
    inputs = np.load(os.path.join(GOLDEN, 'falc_h6ca_nr_inputs.npz'))
    ref = np.load(os.path.join(GOLDEN, 'falc_h6ca_nr_ref.npz'))
    c = h6ca_context(Falc82(), 5, device='cpu')
    nIter = iterate_ctx_se(c, NmaxIter=500, quiet=True)
    assert abs(nIter - int(ref['out_niter'][0])) <= 2
    dCs = c._fd_dC(c.cfg.activeAtoms, [0, 1], 1.0)
    for ia in range(2):
        np.testing.assert_allclose(dCs[ia], inputs[f'atom{ia}_dC'],
                                   rtol=1e-10)
    c.nr_post_update(fdCollisionRates=True, stepLimit=False)
    for ia in range(2):
        assert relerr(c.popsState[ia]['n'], ref[f'out_nr_pops_a{ia}'],
                      floorRel=0.0) < 1e-7
    assert relerr(c.atmos.ne, ref['out_nr_ne'], floorRel=0.0) < 1e-9
