"""Depth-sweep formal solve with in-sweep angular moments.

Counterpart of lightweaver_tpu/ops/pallas_sweep.py.  The CUDA kernel
``csrc/sweep.cu`` replaces the TPU kernel
``lightweaver_tpu/ops/pallas_sweep.py:_sweep_kernel``; the plain PyTorch
version below (built on ops/formal_solver.py) computes the same function
and is what runs for tensors on the CPU.

Layout: chi and srcNum are direction-major [2, NL, Nmu, Nk] (d = 0 is the
down sweep from the upper boundary, d = 1 the up sweep from the lower
one), unpadded and contiguous.  S = srcNum / chi is formed inside.

Two instances, float64 and float32 (the f32 state; the TPU runs the
kernel only in f32).  Both return J in float64: the sum of the
working-type products w I in a double accumulator, which in float32 is
J = sum fl32(w I) to double rounding, the contract the TPU kernel's
TwoSum pair met.  PsiBar, IBar and IeffSrcBar are summed in the working
type.

The kernel is built from the source at first use on a CUDA tensor with
nvcc (sm_90a, ops/_build.py) and bound through ctypes.  A CUDA tensor
either launches the instance of its dtype or raises; nothing falls back to
the plain version or to another instance.
"""
import torch

from . import _build
from .formal_solver import formal_sol_1d


def angular_moments(I, Psi, IeffBase, srcNum, wmu):
    """Moments over the rays of each (lambda, k) with weights wmu/2, summed
    mu ascending within a direction, then down + up (the kernel's order).
    Returns {'J', 'PsiBar', 'IBar', 'IeffSrcBar'}, each [NL, Nk].  J is
    float64: the working-type products w I summed in float64.  The others
    are in the working type; in float64 IBar is J itself."""
    wmuHalf = 0.5 * wmu
    J, PsiBar, IBar, IeffSrcBar = [], [], [], []
    for d in range(2):
        Jd = PsiD = IBd = IsD = 0.0
        for m in range(wmu.shape[0]):
            w = wmuHalf[m]
            wI = w * I[d, :, m]
            Jd = Jd + wI.double()
            IBd = IBd + wI
            PsiD = PsiD + w * Psi[d, :, m]
            IsD = IsD + w * (IeffBase[d, :, m] + Psi[d, :, m] * srcNum[d, :, m])
        J.append(Jd)
        PsiBar.append(PsiD)
        IBar.append(IBd)
        IeffSrcBar.append(IsD)
    J = J[0] + J[1]
    return {'J': J, 'PsiBar': PsiBar[0] + PsiBar[1],
            'IBar': J if I.dtype == torch.float64 else IBar[0] + IBar[1],
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
    launches the instance of csrc/sweep.cu for the dtype (float64 or
    float32) or raises.  J is float64 in both (module docstring).
    """
    _check_inputs(chi, srcNum, height, muz, IupwD, IupwU, wmu)
    if chi.device.type == 'cpu':
        return formal_solve_sweep_plain(chi, srcNum, height, muz, IupwD,
                                        IupwU, wmu)
    if chi.device.type != 'cuda':
        raise RuntimeError(f'no sweep kernel for device {chi.device}')
    return sweep_cuda(chi, srcNum, height, muz, IupwD, IupwU, wmu)


def sweep_cuda(chi, srcNum, height, muz, IupwD, IupwU, wmu):
    """Launch the CUDA sweep kernel's instance for chi's dtype;
    ``sweep_cuda.launches`` counts the float64 launches,
    ``sweep_cuda.launches_f32`` the float32 ones."""
    if not chi.is_cuda:
        raise ValueError(f'sweep_cuda takes CUDA tensors, got {chi.device}')
    if chi.dtype not in (torch.float64, torch.float32):
        raise TypeError(f'the sweep kernel is instantiated for float64 and '
                        f'float32, got {chi.dtype}')
    f32 = chi.dtype == torch.float32
    chi = _contiguous('chi', chi)
    srcNum = _contiguous('srcNum', srcNum)
    _, NL, Nmu, Nk = chi.shape
    dh = torch.abs(height[:-1] - height[1:]).contiguous()
    iupw = torch.stack([IupwD, IupwU]).contiguous()
    wmuHalf = (0.5 * wmu).contiguous()
    muz = muz.contiguous()
    I, Psi, IeffBase = (torch.empty_like(chi) for _ in range(3))
    J = chi.new_empty((NL, Nk), dtype=torch.float64)
    PsiBar, IeffSrcBar = (chi.new_empty((NL, Nk)) for _ in range(2))
    IBar = chi.new_empty((NL, Nk)) if f32 else J
    # one thread per ray, whole lambda rows per block, about a warp each
    rowsPerBlock = max(1, 32 // (2 * Nmu))
    lib = load_library()
    rows = [J.data_ptr(), PsiBar.data_ptr()] + (
        [IBar.data_ptr()] if f32 else []) + [IeffSrcBar.data_ptr()]
    err = (lib.lw_sweep_f32 if f32 else lib.lw_sweep_f64)(
        chi.data_ptr(), srcNum.data_ptr(), dh.data_ptr(), muz.data_ptr(),
        wmuHalf.data_ptr(), iupw.data_ptr(), I.data_ptr(), Psi.data_ptr(),
        IeffBase.data_ptr(), *rows, NL, Nmu, Nk, rowsPerBlock,
        _build.cuda_stream(chi))
    _build.check_launch(err, 'sweep')
    if f32:
        sweep_cuda.launches_f32 += 1
    else:
        sweep_cuda.launches += 1
    return I, Psi, IeffBase, {'J': J, 'PsiBar': PsiBar, 'IBar': IBar,
                              'IeffSrcBar': IeffSrcBar}


sweep_cuda.launches = 0
sweep_cuda.launches_f32 = 0


def _contiguous(name, x):
    if not x.is_contiguous():
        raise ValueError(f'{name} must be contiguous')
    return x


def load_library():
    """Build csrc/sweep.cu with nvcc (once per source hash) and load it."""
    return _build.load('sweep', {
        'lw_sweep_f64': [_build.PTR] * 12 + [_build.INT] * 4 + [_build.PTR],
        'lw_sweep_f32': [_build.PTR] * 13 + [_build.INT] * 4 + [_build.PTR]})
