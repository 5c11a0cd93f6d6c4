"""Time-dependent population updates and update_deps in the port against
the JAX package.

The small problem: FAL-C interpolated to 12 depths (bench.py's
interpolation), 2 rays, H 6-level + Ca II with Ca II active, from the LTE
start (the golden falc_ca_timedep problem, cut to size).  The backward-
Euler solve (I - dt Gamma) n = nOld against the JAX one on a seeded
system; a shortened step protocol (3 Lambda iterations, then 2 steps of
dt = 0.2 s with 2 sub-iterations each) against the JAX Context in
lockstep (J and the populations copied from the JAX Context before each
sub-iteration); restoring the populations of the start of a step; and
update_deps after T (+5%) and vlos (a 0-2 km/s ramp) change, then one
MALI step on the JAX Context's state against the JAX one at 1e-10, and
under each kernel scheme against the default one (the schemes' packed
profiles must be rebuilt).

The step's populations are held to 5e-9 (relative, floor 1e-10 of the
maximum): where dt Gamma is large (the deepest points, dt |Gamma| ~
1e8) I - dt Gamma is nearly the singular Gamma, and the solve amplifies
the MALI step's ~1e-12 differences of Gamma to 1.5e-9 (measured, at the
bottom depth; the compiled reference and the JAX package agree to ~2e-8
on the golden run for the same reason).
The golden protocol at full size (546 wavelengths, 6 steps) runs here
too: populations per step within 1e-6 and J within 1e-7 of the compiled
reference.
"""
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import lightweaver_tpu.rh_atoms as jatoms
from lightweaver_tpu.atomic_set import RadiativeSet as JRadiativeSet
from lightweaver_tpu.context import Context as JContext
from lightweaver_tpu.context import _time_dep_solve as j_time_dep_solve
from lightweaver_tpu_torch.context import _time_dep_solve
from lightweaver_tpu_torch.problems import falc_interpolated, timedep_context

from tests.test_torch_ng import sync
from tests.test_torch_slice import _jax_falc_interpolated, relerr

GOLDEN = os.path.join(os.path.dirname(__file__), 'golden')
NSPACE, NRAYS, NSCATTER = 12, 2, 3
DT, NSTEP, NSUB = 0.2, 2, 2
SCHEMES = ('mali_full_precond', 'mali_full_precond_pallas',
           'mali_full_precond_fused')

# one intra-op thread per process: the tier-1 run has six pytest workers
torch.set_num_threads(1)


def test_time_dep_solve_matches_jax():
    rng = np.random.default_rng(5)
    Nl, Nk = 6, 11
    G = rng.uniform(0.0, 3.0, (Nl, Nl, Nk))
    G[np.arange(Nl), np.arange(Nl)] = 0.0
    G[np.arange(Nl), np.arange(Nl)] = -G.sum(axis=0)
    nOld = rng.uniform(0.5, 2.0, (Nl, Nk))
    ours = _time_dep_solve(torch.as_tensor(G), torch.as_tensor(nOld), DT)
    ref = j_time_dep_solve(jnp.asarray(G), jnp.asarray(nOld),
                           jnp.asarray(DT))
    assert relerr(ours, ref, floorRel=0.0) < 1e-13
    # particle conservation: Gamma's columns sum to zero
    np.testing.assert_allclose(ours.sum(dim=0), nOld.sum(axis=0),
                               rtol=1e-12)


def jax_context():
    atmos = _jax_falc_interpolated(NSPACE)
    atmos.quadrature(NRAYS)
    rs = JRadiativeSet([jatoms.H_6_atom(), jatoms.CaII_atom()])
    rs.set_active('Ca')
    spect = rs.compute_wavelength_grid()
    return JContext(atmos, spect, rs.compute_eq_pops(atmos))


def port_context(scheme=None):
    ctx = timedep_context(device='cpu', atmos=falc_interpolated(NSPACE),
                          Nrays=NRAYS)
    if scheme is not None:
        ctx.set_fs_iter_scheme(scheme)
    return ctx


def step_protocol(ctx, nStep=NSTEP, nSub=NSUB, dt=DT, lead=None):
    """NSCATTER Lambda iterations, then nStep steps of dt with nSub
    (MALI step + time_dep_update) sub-iterations each; the populations
    after each sub-iteration (numpy) and the updates.  With ``lead`` (a
    JAX Context) the port Context ``ctx`` runs in lockstep with it: the
    lead's J and populations (and those of the start of the step) are
    copied into ``ctx`` before each sub-iteration of the two."""
    ctxs = [ctx] if lead is None else [lead, ctx]
    for _ in range(NSCATTER):
        for c in ctxs:
            c.formal_sol_gamma_matrices()
    pops, updates = [], []
    for _ in range(nStep):
        if lead is not None:
            sync(ctx, lead)
        prev = [[st['n'] for st in c.popsState] for c in ctxs]
        for _ in range(nSub):
            if lead is not None:
                sync(ctx, lead)
            for i, c in enumerate(ctxs):
                c.formal_sol_gamma_matrices()
                upd, prev[i] = c.time_dep_update(dt, prev[i])
            updates.append(upd)
            pops.append(np.array(ctx.popsState[0]['n']))
    return pops, updates


@pytest.fixture(scope='module')
def pair():
    return jax_context(), port_context()


def test_step_protocol_matches_jax(pair):
    jctx, tctx = pair
    jPops = []
    record = jctx.time_dep_update

    def recorded(dt, prev):
        out = record(dt, prev)
        jPops.append((np.array(jctx.popsState[0]['n']), out[0]))
        return out
    jctx.time_dep_update = recorded
    tp, tu = step_protocol(tctx, lead=jctx)
    del jctx.time_dep_update
    for i, (a, (b, _)) in enumerate(zip(tp, jPops)):
        assert relerr(a, b) < 5e-9, i
    for a, (_, b) in zip(tu, jPops):
        np.testing.assert_allclose(a.dPops, b.dPops, rtol=1e-6)
    # the steps moved the populations
    assert relerr(tp[-1], tp[0], floorRel=0.0) > 1e-3


def test_restore_prev_pops(pair):
    """time_dep_restore_prev_pops puts the populations of the start of a
    step back after a rejected sub-iteration."""
    _, tctx = pair
    tctx.formal_sol_gamma_matrices()
    start = [st['n'].clone() for st in tctx.popsState]
    upd, prev = tctx.time_dep_update(10 * DT)
    assert upd.dPopsMax > 0.0
    assert not torch.equal(tctx.popsState[0]['n'], start[0])
    tctx.time_dep_restore_prev_pops(prev)
    assert torch.equal(tctx.popsState[0]['n'], start[0])


def perturb(atmos):
    """+5% temperature and a 0-2 km/s vlos ramp, in place."""
    atmos.temperature[:] = atmos.temperature * 1.05
    h = atmos.height
    atmos.vlos = 2e3 * (h - h.min()) / (h.max() - h.min())


def update_deps_after_a_step(ctx):
    """One Lambda iteration and a MALI step with stat_equil, then the
    atmosphere changes and update_deps."""
    for _ in range(2):
        ctx.formal_sol_gamma_matrices()
    ctx.stat_equil()
    perturb(ctx.atmos)
    ctx.update_deps()


def test_update_deps_matches_jax():
    """After update_deps: Gamma, the rates, J and I of the next MALI step
    on the JAX Context's J and populations (1e-10; J and I of each
    wavelength's maximum), nStar and the background against the JAX
    Context."""
    jctx, tctx = jax_context(), port_context()
    before = tctx.bgChi.clone()
    for c in (jctx, tctx):
        update_deps_after_a_step(c)
    sync(tctx, jctx)
    ju = jctx.formal_sol_gamma_matrices()
    tu = tctx.formal_sol_gamma_matrices()
    assert relerr(tctx.bgChi, jctx.bgChi) < 1e-12
    assert relerr(tctx.popsState[0]['nStar'],
                  jctx.popsState[0]['nStar']) < 1e-12
    assert relerr(tctx.temperature, jctx.temperature) < 1e-15
    assert relerr(tctx._Gamma[0], jctx._Gamma[0]) < 1e-10
    for ti in range(len(tctx.activeAtoms[0].trans)):
        for key in ('_Rij', '_Rji'):
            e = relerr(getattr(tctx, key)[0][ti], getattr(jctx, key)[0][ti])
            assert e < 1e-10, (key, ti, e)
    for key in ('J', 'I'):
        ours, ref = np.asarray(getattr(tctx, key)), np.asarray(getattr(jctx,
                                                                       key))
        e = (np.abs(ours - ref).max(axis=1) / np.abs(ref).max(axis=1)).max()
        assert e < 1e-10, (key, e)
    assert relerr(tu.dJMax, ju.dJMax) < 1e-9
    # the atmosphere change reached the background
    assert relerr(tctx.bgChi, before, floorRel=0.0) > 1e-2


@pytest.mark.parametrize('scheme', SCHEMES[1:])
def test_update_deps_rebuilds_the_scheme_packs(scheme):
    """The kernel schemes bake the line profiles into their packed input
    (line_pack, fused_pack): after update_deps (vlos moved every profile)
    their MALI step on the default-scheme Context's J and populations
    equals its step, Gamma and J at 1e-10."""
    ref, ctx = port_context(), port_context(scheme)
    for c in (ref, ctx):
        update_deps_after_a_step(c)
    sync(ctx, ref)
    for c in (ref, ctx):
        c.formal_sol_gamma_matrices()
    assert relerr(ctx._Gamma[0], ref._Gamma[0]) < 1e-10
    e = (np.abs(np.asarray(ctx.J) - np.asarray(ref.J)).max(axis=1)
         / np.abs(np.asarray(ref.J)).max(axis=1)).max()
    assert e < 1e-10


def test_golden_time_dependent_protocol():
    """The golden protocol (falc_ca_timedep): from the LTE start, 3
    Lambda iterations then 6 steps of dt = 0.2 s with 2 sub-iterations
    each: populations at the end of each step within 1e-6 and the final J
    within 1e-7 of the compiled reference's."""
    inputs = np.load(os.path.join(GOLDEN, 'falc_ca_timedep_inputs.npz'))
    ref = np.load(os.path.join(GOLDEN, 'falc_ca_timedep_ref.npz'))
    c = timedep_context(device='cpu')
    np.testing.assert_allclose(c.spect.wavelength, inputs['wavelength'],
                               rtol=1e-12)
    np.testing.assert_allclose(c.C[0], inputs['atom0_C'], rtol=1e-10)
    np.testing.assert_allclose(c.popsState[0]['n'], inputs['atom0_n0'],
                               rtol=1e-10)
    pops, _ = step_protocol(c, nStep=6, nSub=2, dt=0.2)
    for step in range(6):
        assert relerr(pops[2 * step + 1], ref[f'out_td_step{step}_a0'],
                      floorRel=0.0) < 1e-6, step
    assert relerr(c.J, ref['out_J'], floorRel=0.0) < 1e-7
