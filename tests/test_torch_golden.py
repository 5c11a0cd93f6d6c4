"""The port against the compiled reference's golden run of falc_h6ca.

Same problem and bars as tests/test_vs_reference_golden.py
(test_one_iteration_vs_reference, test_converged_vs_reference), driven
through lightweaver_tpu_torch on the CPU, where the depth sweep runs its
plain PyTorch version.  chip_smoke.py runs the full convergence on the
card through the CUDA kernel.
"""
import os

import numpy as np
import pytest
import torch

from lightweaver_tpu_torch import (CaII_atom, Context, Falc82, H_6_atom,
                                   RadiativeSet, iterate_ctx_se)

GOLDEN = os.path.join(os.path.dirname(__file__), 'golden')

# one intra-op thread per process: the tier-1 run has six pytest workers
torch.set_num_threads(1)


@pytest.fixture(scope='module')
def ref():
    return np.load(os.path.join(GOLDEN, 'falc_h6ca_ref.npz'))


def _ctx():
    atmos = Falc82()
    atmos.quadrature(5)
    rs = RadiativeSet([H_6_atom(), CaII_atom()])
    rs.set_active('H', 'Ca')
    spect = rs.compute_wavelength_grid()
    eqPops = rs.compute_eq_pops(atmos)
    return Context(atmos, spect, eqPops, formalSolver='piecewise_bezier3_1d',
                   device='cpu')


def relerr(ours, ref, floorRel=0.0):
    ours = np.asarray(ours)
    ref = np.asarray(ref)
    floor = np.abs(ref).max() * max(floorRel, 1e-300)
    return (np.abs(ours - ref) / np.maximum(np.abs(ref), floor)).max()


def test_phi_wphi_vs_reference(ref):
    ctx = _ctx()
    for ia, a in enumerate(ctx.activeAtoms):
        for it, t in enumerate(a.trans):
            if not t.isLine:
                continue
            tag = f'a{ia}t{it}'
            assert relerr(ctx.phi[ia][it], ref[f'out_phi_{tag}']) < 1e-8, tag
            assert relerr(ctx.wphi[ia][it],
                          ref[f'out_wphi_{tag}']) < 1e-11, tag


def test_one_iteration_vs_reference(ref):
    """J, I and preconditioned Gamma after the first formal solution
    (8e-11, 1.1e-10 and 6e-12 measured)."""
    ctx = _ctx()
    ctx.formal_sol_gamma_matrices()
    assert relerr(ctx.J, ref['out_J_iter1']) < 1e-8
    assert relerr(ctx.I, ref['out_I_iter1']) < 1e-8
    for ia in range(2):
        G = np.asarray(ctx._Gamma[ia])
        GRef = ref[f'out_Gamma_iter1_a{ia}']
        assert relerr(G, GRef, floorRel=1e-10) < 1e-8, f'atom{ia}'


@pytest.mark.slow
def test_converged_vs_reference(ref):
    """Full MALI convergence (no Ng, JTol 5e-3, popsTol 1e-3): iteration
    count within 2 of the reference's, populations, J and I within 1e-7.
    Slow on the CPU (over 60 s); chip_smoke.py runs it on the card."""
    ctx = _ctx()
    nIter = iterate_ctx_se(ctx, NmaxIter=500, quiet=True)
    assert abs(nIter - int(ref['out_niter'][0])) <= 2
    for ia in range(2):
        assert relerr(ctx.popsState[ia]['n'], ref[f'out_pops_a{ia}']) < 1e-7
    assert relerr(ctx.J, ref['out_J']) < 1e-7
    assert relerr(ctx.I, ref['out_I']) < 1e-7
