"""BASELINE config 5's 2D leg converged on the CPU against the compiled
reference's golden runs, at the bars of tests/test_vs_reference_golden.py
:test_2d_converged_vs_reference and :test_2d_besser_converged_vs_reference
(the same iteration count; populations, J and the emergent I within 1e-8
(linear) and 1e-9 (BESSER), relative with no floor).

The problem is problems.slab_2d(30, 8, periodic=False): Ca II over a
horizontally perturbed FAL-C slab with callable x boundaries.  The linear
run carries RefBugCompatXLower, which copies the reference linear
solver's start-plane index-swap bug (FormalScalar2d.cpp:570; STATUS.md);
the BESSER run, the reference's default 2D solver, needs none.  Both take
a few minutes on one CPU worker: `slow`, as the JAX package marks its
own.
"""
import os

import numpy as np
import pytest
import torch

from lightweaver_tpu_torch import iterate_ctx_se
from lightweaver_tpu_torch.problems import slab_2d

GOLDEN = os.path.join(os.path.dirname(__file__), 'golden')

# one intra-op thread per process: the tier-1 run has six pytest workers
torch.set_num_threads(1)


def relerr(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    return (np.abs(ours - ref) / np.abs(ref)).max()


@pytest.mark.slow
@pytest.mark.parametrize('solver,ref,compat,bar', [
    ('piecewise_linear_2d', 'falc2d_ca_ref.npz', True, 1e-8),
    ('piecewise_besser_2d', 'falc2d_ca_besser_ref.npz', False, 1e-9)],
    ids=['linear', 'besser'])
def test_2d_converged_vs_reference(solver, ref, compat, bar):
    ref = np.load(os.path.join(GOLDEN, ref))
    ctx = slab_2d(30, 8, periodic=False, device='cpu', formalSolver=solver,
                  refBugCompat=compat)
    nIter = iterate_ctx_se(ctx, NmaxIter=500, quiet=True)
    assert nIter == int(ref['out_niter'][0])
    assert relerr(ctx.popsState[0]['n'], ref['out_pops_a0']) < bar
    assert relerr(ctx.J, ref['out_J']) < bar
    assert relerr(ctx.I.numpy().reshape(ref['out_I'].shape),
                  ref['out_I']) < bar
