"""The port against the compiled reference's golden runs of BASELINE
config 3 (FAL-C, H 6-level + Mg II active, 5 rays, Ly-alpha, Ly-beta and
Mg II h & k in PRD) and of its hybrid-PRD variant.

Same problems and bars as tests/test_vs_reference_golden.py
(test_prd_converged_vs_reference, test_hprd_converged_vs_reference),
driven through lightweaver_tpu_torch on the CPU, where every kernel
wrapper runs its plain PyTorch version.  chip_smoke.py runs both
convergences on the card through the CUDA kernels.
"""
import os

import numpy as np
import pytest
import torch

from lightweaver_tpu_torch import iterate_ctx_se
from lightweaver_tpu_torch.problems import h6mg_context

from tests.test_torch_golden import relerr

GOLDEN = os.path.join(os.path.dirname(__file__), 'golden')

# one intra-op thread per process: the tier-1 run has six pytest workers
torch.set_num_threads(1)


def _golden(name):
    return (np.load(os.path.join(GOLDEN, f'falc_h6mg_{name}_ref.npz')),
            np.load(os.path.join(GOLDEN, f'falc_h6mg_{name}_inputs.npz')))


def test_one_iteration_vs_reference():
    """J, I and preconditioned Gamma after the first formal solution
    (rho = 1 still), at the golden test's 1e-8."""
    ref, inputs = _golden('prd')
    ctx = h6mg_context(device='cpu')
    np.testing.assert_allclose(ctx.spect.wavelength, inputs['wavelength'],
                               rtol=1e-12)
    ctx.formal_sol_gamma_matrices()
    assert relerr(ctx.J, ref['out_J_iter1']) < 1e-8
    assert relerr(ctx.I, ref['out_I_iter1']) < 1e-8
    for ia in range(2):
        G = np.asarray(ctx._Gamma[ia])
        GRef = ref[f'out_Gamma_iter1_a{ia}']
        assert relerr(G, GRef, floorRel=1e-10) < 1e-8, f'atom{ia}'


@pytest.mark.slow
def test_prd_converged_vs_reference():
    """The full MALI + PRD-redistribution loop: iteration count within 2
    of the reference's 297; populations, J, emergent I and every PRD
    line's rho within 1e-7."""
    ref, inputs = _golden('prd')
    ctx = h6mg_context(device='cpu')
    for ia, a in enumerate(ctx.activeAtoms):
        for it, t in enumerate(a.trans):
            if t.isLine and t.isPrd:
                np.testing.assert_allclose(
                    ctx.Qelast[ia][it], inputs[f'atom{ia}_trans{it}_qelast'],
                    rtol=1e-10)
    nIter = iterate_ctx_se(ctx, NmaxIter=500, prd=True, quiet=True)
    assert abs(nIter - int(ref['out_niter'][0])) <= 2
    for ia in range(2):
        assert relerr(ctx.popsState[ia]['n'], ref[f'out_pops_a{ia}']) < 1e-7
    assert relerr(ctx.J, ref['out_J']) < 1e-7
    assert relerr(ctx.I, ref['out_I']) < 1e-7
    for ai, ti, a, t in ctx._prd_lines():
        assert relerr(ctx.rhoPrd[ai][ti],
                      ref[f'out_rho_a{ai}t{ti}']) < 1e-7, (ai, ti)


@pytest.mark.slow
def test_hprd_converged_vs_reference():
    """Hybrid PRD with the 0-5 km/s outflow ramp: iteration count within
    2 of 297; populations and rho within 1e-7; J and I within 1e-7
    amplitude-normalised per wavelength."""
    ref, inputs = _golden('hprd')
    ctx = h6mg_context(hprd=True, device='cpu')
    np.testing.assert_allclose(ctx.spect.wavelength, inputs['wavelength'],
                               rtol=1e-12)
    np.testing.assert_allclose(ctx.atmos.vlos, inputs['vz'], rtol=1e-12)
    nIter = iterate_ctx_se(ctx, NmaxIter=500, prd=True, quiet=True)
    assert abs(nIter - int(ref['out_niter'][0])) <= 2
    for ia in range(2):
        assert relerr(ctx.popsState[ia]['n'], ref[f'out_pops_a{ia}']) < 1e-7
    for ai, ti, a, t in ctx._prd_lines():
        assert relerr(ctx.rhoPrd[ai][ti],
                      ref[f'out_rho_a{ai}t{ti}']) < 1e-7, (ai, ti)
    for ours, name in ((ctx.J, 'out_J'), (ctx.I, 'out_I')):
        ours, refA = np.asarray(ours), ref[name]
        d = np.abs(ours - refA).max(axis=1) / np.abs(refA).max(axis=1)
        assert d.max() < 1e-7, (name, d.max())
