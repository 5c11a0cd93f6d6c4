"""The port's column batch with Ng, accelerateScattering and charge
conservation, and with PRD and hybrid PRD, against the JAX package's
ColumnBatch on the CPU (tests/test_torch_columns.py has the rest).

- H 6-level + Ca II with H active, C = 2 FAL-C columns of 16 depths, 3
  rays, NgOptions(2, 2, 4) (two extrapolations in the run),
  accelerateScattering and conserveCharge: eight MALI steps with
  stat_equil from the third, populations and ne within 1e-9 after every
  stat_equil (6e-11 measured).
- H 6-level alone active (Ly-alpha, Ly-beta in PRD), C = 2 columns of 24
  depths with distinct velocity fields (column 0 static, column 1 a 5
  km/s outflow gradient), 3 rays, accelerateScattering, PRD and hybrid
  PRD: four rounds of a MALI step, stat_equil and
  prd_redistribute(maxIter=2), rho within 1e-9 of its maximum (~5e-10
  absolute on values up to ~20 measured; the trajectories run free, so
  single elements near 0.5 differ by up to 2.5e-9 relative) and the
  populations within 1e-9 (~3e-11 measured), and the per-column drho.
"""
import numpy as np
import pytest
import torch

import lightweaver_tpu.rh_atoms as jatoms
from lightweaver_tpu.ops.ng import NgOptions as JNgOptions
from lightweaver_tpu.parallel import ColumnBatch as JColumnBatch
from lightweaver_tpu_torch import H_6_atom
from lightweaver_tpu_torch.ops.ng import NgOptions
from lightweaver_tpu_torch.problems import column_batch, stacked_falc

from tests.test_torch_slice import relerr

# one intra-op thread per process: the tier-1 run has six pytest workers
torch.set_num_threads(1)


def test_ng_accelerated_charge_conserving_batch_matches_jax():
    """Per-column Ng, the accelerated J and the flat Context's NR step
    together, against the JAX batch on the same stacked inputs."""
    C, Nk = 2, 16
    h, T, v, vt, ne, nH = stacked_falc(C, Nk, seed=3)
    jb = JColumnBatch.from_stacked(
        h, T, v, vt, ne, nH,
        lambda: [jatoms.H_6_atom(), jatoms.CaII_atom()], ('H',), Nrays=3,
        conserveCharge=True, accelerateScattering=True,
        ngOptions=JNgOptions(2, 2, 4))
    tb = column_batch(C, Nk=Nk, seed=3, Nrays=3, activeSpecies=('H',),
                      device='cpu', conserveCharge=True,
                      accelerateScattering=True,
                      ngOptions=NgOptions(2, 2, 4))
    flags = []
    accelerate = tb.ngs[0].accelerate

    def recorded(*args, **kwargs):
        out = accelerate(*args, **kwargs)
        flags.append(out[0])
        return out
    tb.ngs[0].accelerate = recorded
    for it in range(8):
        jb.formal_sol_gamma_matrices()
        tb.formal_sol_gamma_matrices()
        if it < 2:
            continue
        ju, tu = jb.stat_equil(), tb.stat_equil()
        assert relerr(tb.pops[0], jb.pops[0]) < 1e-9, it
        assert relerr(tb.ne, jb.ne) < 1e-9, it
        np.testing.assert_allclose(tu.dPops, ju.dPops, rtol=1e-8)
    assert sum(flags) == 2
    assert not np.allclose(tb.ne, ne)                 # NR moved ne


@pytest.mark.parametrize('hprd', [False, True], ids=['prd', 'hprd'])
def test_prd_batch_matches_jax(hprd):
    """Batched PRD redistribution (the flat Context's scattering integral,
    one subset sweep for both columns) against the JAX batch: rho,
    populations and the per-column drho of every round."""
    C, Nk = 2, 24
    h, T, _, vt, ne, nH = stacked_falc(C, Nk, spread=0.0)
    vlos = np.zeros((C, Nk))
    vlos[1] = np.linspace(5e3, 0.0, Nk)
    jb = JColumnBatch.from_stacked(
        h, T, vlos, vt, ne, nH, lambda: [jatoms.H_6_atom()], ('H',),
        Nrays=3, hprd=hprd, accelerateScattering=True)
    tb = column_batch(C, models=lambda: [H_6_atom()], activeSpecies=('H',),
                      Nk=Nk, spread=0.0, vlos=vlos, Nrays=3, device='cpu',
                      hprd=hprd, accelerateScattering=True)
    assert tb.flatCtx.cfg.hprd == hprd
    lines = tb.flatCtx._prd_lines()
    assert len(lines) == 2
    for it in range(4):
        for b in (jb, tb):
            b.formal_sol_gamma_matrices()
            b.stat_equil()
            u = b.prd_redistribute(maxIter=2)
        assert u.updatedRho and u.NprdSubIter == 2
        for ai, ti, a, t in lines:
            rho = tb.params['rhoPrd'][ai][ti].numpy()
            rho = rho.reshape(t.W, C, Nk).transpose(1, 0, 2)
            ref = np.asarray(jb.params['rhoPrd'][ai][ti])
            e = np.abs(rho - ref).max() / np.abs(ref).max()
            assert e < 1e-9, (it, ti, e)
        assert relerr(tb.pops[0], jb.pops[0]) < 1e-9, it
        np.testing.assert_allclose(tb.dRhoCol, jb.dRhoCol, rtol=1e-6)
    ai, ti, a, t = lines[0]
    rho = tb.params['rhoPrd'][ai][ti].numpy().reshape(t.W, C, Nk)
    assert np.abs(rho - 1.0).max() > 1.0                # real PRD
    assert np.abs(rho[:, 1] - rho[:, 0]).max() > 1e-3   # the velocity column
