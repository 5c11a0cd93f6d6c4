"""Depth-sweep formal solve with in-sweep angular moments.

Counterpart of lightweaver_tpu/ops/pallas_sweep.py.  The CUDA kernel
``csrc/sweep.cu`` replaces the TPU kernel
``lightweaver_tpu/ops/pallas_sweep.py:_sweep_kernel``; the plain PyTorch
version below (built on ops/formal_solver.py) computes the same function
and is what runs for tensors on the CPU.

Layout: chi and srcNum are direction-major [2, NL, Nmu, Nk] (d = 0 is the
down sweep from the upper boundary, d = 1 the up sweep from the lower
one), unpadded and contiguous.  S = srcNum / chi is formed inside.

The kernel is built from the source at first use on a CUDA tensor with
nvcc (sm_90a, ops/_build.py) and bound through ctypes.  A CUDA tensor
either launches the kernel or raises; nothing falls back to the plain
version.
"""
import torch

from . import _build
from .formal_solver import formal_sol_1d


def angular_moments(I, Psi, IeffBase, srcNum, wmu):
    """Moments over the rays of each (lambda, k) with weights wmu/2, summed
    mu ascending within a direction, then down + up (the kernel's order).
    Returns {'J', 'PsiBar', 'IBar', 'IeffSrcBar'}, each [NL, Nk]; in f64
    IBar is J itself."""
    wmuHalf = 0.5 * wmu
    J, PsiBar, IeffSrcBar = [], [], []
    for d in range(2):
        Jd = PsiD = IsD = 0.0
        for m in range(wmu.shape[0]):
            w = wmuHalf[m]
            Jd = Jd + w * I[d, :, m]
            PsiD = PsiD + w * Psi[d, :, m]
            IsD = IsD + w * (IeffBase[d, :, m] + Psi[d, :, m] * srcNum[d, :, m])
        J.append(Jd)
        PsiBar.append(PsiD)
        IeffSrcBar.append(IsD)
    J = J[0] + J[1]
    return {'J': J, 'PsiBar': PsiBar[0] + PsiBar[1], 'IBar': J,
            'IeffSrcBar': IeffSrcBar[0] + IeffSrcBar[1]}


def formal_solve_sweep_plain(chi, srcNum, height, muz, IupwD, IupwU, wmu):
    """Plain PyTorch version of the sweep kernel: the sequential Bezier-3
    formal solution per direction, then the angular moments."""
    _, NL, Nmu, Nk = chi.shape
    S = srcNum / chi
    muzB = muz[None, :].expand(NL, Nmu).reshape(-1)
    outs = []
    for d, toObs, Iupw in ((0, False, IupwD), (1, True, IupwU)):
        outs.append(formal_sol_1d(chi[d].reshape(-1, Nk),
                                  S[d].reshape(-1, Nk), height, muzB,
                                  Iupw.reshape(-1), to_obs=toObs))
    I, Psi, IeffBase = (torch.stack([o[i].reshape(NL, Nmu, Nk)
                                     for o in outs]) for i in range(3))
    return I, Psi, IeffBase, angular_moments(I, Psi, IeffBase, srcNum, wmu)


def _check_inputs(chi, srcNum, height, muz, IupwD, IupwU, wmu):
    if chi.dim() != 4 or chi.shape[0] != 2:
        raise ValueError(f'chi must be [2, NL, Nmu, Nk], got {tuple(chi.shape)}')
    _, NL, Nmu, Nk = chi.shape
    if Nk < 3:
        raise ValueError(f'the Bezier-3 sweep needs Nk >= 3, got {Nk}')
    shapes = {'srcNum': (srcNum, (2, NL, Nmu, Nk)), 'height': (height, (Nk,)),
              'muz': (muz, (Nmu,)), 'IupwD': (IupwD, (NL, Nmu)),
              'IupwU': (IupwU, (NL, Nmu)), 'wmu': (wmu, (Nmu,))}
    for name, (x, shape) in shapes.items():
        if tuple(x.shape) != shape:
            raise ValueError(f'{name} must be {shape}, got {tuple(x.shape)}')
    for name, x in [('chi', chi)] + [(n, v[0]) for n, v in shapes.items()]:
        if x.device != chi.device:
            raise ValueError(f'{name} is on {x.device}, chi on {chi.device}')
        if x.dtype != chi.dtype:
            raise ValueError(f'{name} is {x.dtype}, chi is {chi.dtype}')


def formal_solve_sweep(chi, srcNum, height, muz, IupwD, IupwU, wmu):
    """Formal solution of every ray plus the angular moments.

    chi, srcNum: [2, NL, Nmu, Nk] direction-major (srcNum = eta + sca*J;
    S = srcNum/chi is formed inside); height [Nk]; muz, wmu [Nmu];
    IupwD, IupwU [NL, Nmu] boundary intensities of the down and up sweeps.
    Returns (I, Psi, IeffBase) [2, NL, Nmu, Nk] and the moments dict
    {'J', 'PsiBar', 'IBar', 'IeffSrcBar'} of [NL, Nk] (weights wmu/2).

    On the CPU this is the plain PyTorch version; on a CUDA device it
    launches the kernel csrc/sweep.cu (f64 only) or raises.
    """
    _check_inputs(chi, srcNum, height, muz, IupwD, IupwU, wmu)
    if chi.device.type == 'cpu':
        return formal_solve_sweep_plain(chi, srcNum, height, muz, IupwD,
                                        IupwU, wmu)
    if chi.device.type != 'cuda':
        raise RuntimeError(f'no sweep kernel for device {chi.device}')
    return sweep_cuda(chi, srcNum, height, muz, IupwD, IupwU, wmu)


def sweep_cuda(chi, srcNum, height, muz, IupwD, IupwU, wmu):
    """Launch the CUDA sweep kernel; ``sweep_cuda.launches`` counts the
    launches."""
    if not chi.is_cuda:
        raise ValueError(f'sweep_cuda takes CUDA tensors, got {chi.device}')
    if chi.dtype != torch.float64:
        raise TypeError(f'the sweep kernel is instantiated for float64 '
                        f'only, got {chi.dtype}')
    chi = _contiguous('chi', chi)
    srcNum = _contiguous('srcNum', srcNum)
    _, NL, Nmu, Nk = chi.shape
    dh = torch.abs(height[:-1] - height[1:]).contiguous()
    iupw = torch.stack([IupwD, IupwU]).contiguous()
    wmuHalf = (0.5 * wmu).contiguous()
    muz = muz.contiguous()
    I, Psi, IeffBase = (torch.empty_like(chi) for _ in range(3))
    J, PsiBar, IeffSrcBar = (torch.empty((NL, Nk), dtype=chi.dtype,
                                         device=chi.device)
                             for _ in range(3))
    # one thread per ray, whole lambda rows per block, about a warp each
    rowsPerBlock = max(1, 32 // (2 * Nmu))
    err = load_library().lw_sweep_f64(
        chi.data_ptr(), srcNum.data_ptr(), dh.data_ptr(), muz.data_ptr(),
        wmuHalf.data_ptr(), iupw.data_ptr(), I.data_ptr(), Psi.data_ptr(),
        IeffBase.data_ptr(), J.data_ptr(), PsiBar.data_ptr(),
        IeffSrcBar.data_ptr(), NL, Nmu, Nk, rowsPerBlock,
        _build.cuda_stream(chi))
    _build.check_launch(err, 'sweep')
    sweep_cuda.launches += 1
    return I, Psi, IeffBase, {'J': J, 'PsiBar': PsiBar, 'IBar': J,
                              'IeffSrcBar': IeffSrcBar}


sweep_cuda.launches = 0


def _contiguous(name, x):
    if not x.is_contiguous():
        raise ValueError(f'{name} must be contiguous')
    return x


def load_library():
    """Build csrc/sweep.cu with nvcc (once per source hash) and load it."""
    return _build.load('sweep', {
        'lw_sweep_f64': [_build.PTR] * 12 + [_build.INT] * 4 + [_build.PTR]})
