"""The depth-sweep wrapper of lightweaver_tpu_torch and its CUDA kernel.

No jax here, so the file also runs where only torch is installed; on a
machine with an NVIDIA GPU the kernel is compared with its plain version:

    python -m pytest tests/test_torch_kernels.py --noconftest -q

(--noconftest: tests/conftest.py imports and configures jax, which the
port does not need).  Without a GPU the tests marked gpu skip.
"""
import numpy as np
import pytest
import torch

from lightweaver_tpu_torch.ops import sweep as tsweep
from lightweaver_tpu_torch.problems import random_rays

# one intra-op thread per process: the tier-1 run has six pytest workers
torch.set_num_threads(1)


def _sweep_case(NL, Nmu, Nk, seed=0, device='cpu'):
    """Random smooth rays (as tests/test_pallas_sweep.py builds them),
    direction-major [2, NL, Nmu, Nk]."""
    return {k: torch.tensor(v, dtype=torch.float64, device=device)
            for k, v in random_rays(NL, Nmu, Nk, seed).items()}


def test_sweep_moments_are_the_ray_sums():
    """J, PsiBar and IeffSrcBar are the wmu/2-weighted sums over both
    directions and all mu of I, Psi and IeffBase + Psi*srcNum (1e-13:
    summation order only)."""
    c = _sweep_case(5, 4, 20, seed=4)
    I, Psi, IeffB, mom = tsweep.formal_solve_sweep(**c)
    w = 0.5 * c['wmu'].numpy()[None, None, :, None]
    for name, x in (('J', I), ('IBar', I), ('PsiBar', Psi),
                    ('IeffSrcBar', IeffB + Psi * c['srcNum'])):
        ref = (x.numpy() * w).sum(axis=(0, 2))
        np.testing.assert_allclose(mom[name].numpy(), ref, rtol=1e-13)


def test_sweep_checks_inputs():
    c = _sweep_case(4, 2, 10)
    with pytest.raises(ValueError, match='srcNum'):
        tsweep.formal_solve_sweep(**{**c, 'srcNum': c['srcNum'][:, :2]})
    with pytest.raises(ValueError, match='wmu is torch.float32'):
        tsweep.formal_solve_sweep(**{**c, 'wmu': c['wmu'].float()})
    with pytest.raises(ValueError, match='Nk >= 3'):
        tsweep.formal_solve_sweep(**{**c, 'chi': c['chi'][..., :2],
                                     'srcNum': c['srcNum'][..., :2],
                                     'height': c['height'][:2]})


def test_sweep_dispatch_never_falls_back():
    """Only a CPU tensor takes the plain version: other devices raise,
    and the CUDA route refuses tensors that are not on a card rather than
    computing on the CPU."""
    c = _sweep_case(4, 2, 10)
    meta = {k: v.to('meta') for k, v in c.items()}
    with pytest.raises(RuntimeError, match='no sweep kernel'):
        tsweep.formal_solve_sweep(**meta)
    before = tsweep.sweep_cuda.launches
    with pytest.raises(ValueError, match='CUDA'):
        tsweep.sweep_cuda(**c)
    assert tsweep.sweep_cuda.launches == before


def test_context_on_cuda_without_a_gpu_raises():
    """Asking for device='cuda' where there is no GPU fails at once; no
    stage quietly runs on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip('checks the behaviour without a CUDA device')
    from lightweaver_tpu_torch.problems import falc_interpolated, h6ca_context
    with pytest.raises((RuntimeError, AssertionError)):
        h6ca_context(falc_interpolated(12), 2, device='cuda')


@pytest.mark.gpu
@pytest.mark.parametrize('Nk', [82, 500])
def test_sweep_kernel_matches_plain(Nk):
    """The CUDA kernel against the plain version on the card, at the main
    path's shapes.  nvcc contracts multiply-adds into FMAs and torch's
    separate ops do not; the difference compounds along the depth chain,
    hence 1e-9 of each quantity's maximum."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    c = _sweep_case(1046, 5, Nk, seed=5, device='cuda')
    plain = tsweep.formal_solve_sweep_plain(**c)
    before = tsweep.sweep_cuda.launches
    kern = tsweep.formal_solve_sweep(**c)
    torch.cuda.synchronize()
    assert tsweep.sweep_cuda.launches == before + 1
    for name, a, b in zip(('I', 'Psi', 'IeffBase'), kern[:3], plain[:3]):
        err = ((a - b).abs().max() / b.abs().max()).item()
        assert err < 1e-9, (name, err)
    for name in ('J', 'IBar', 'PsiBar', 'IeffSrcBar'):
        a, b = kern[3][name], plain[3][name]
        err = ((a - b).abs().max() / b.abs().max()).item()
        assert err < 1e-9, (name, err)


@pytest.mark.gpu
def test_context_on_cuda_goes_through_the_kernel():
    """One MALI iteration of a small problem on the card: the formal
    solve launches the kernel once and J agrees with the same iteration
    on the CPU to 1e-9 of each wavelength's maximum over depth (FMA
    contraction and the card's exp, carried along the depth chain)."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    from lightweaver_tpu_torch.problems import falc_interpolated, h6ca_context
    cpu = h6ca_context(falc_interpolated(20), 3)
    gpu = h6ca_context(falc_interpolated(20), 3, device='cuda')
    cpu.formal_sol_gamma_matrices()
    before = tsweep.sweep_cuda.launches
    gpu.formal_sol_gamma_matrices()
    assert tsweep.sweep_cuda.launches == before + 1
    J, Jref = gpu.J.cpu().numpy(), cpu.J.numpy()
    err = np.abs(J - Jref).max(axis=1) / np.abs(Jref).max(axis=1)
    assert err.max() < 1e-9
