"""Depth-sweep formal solve with in-sweep angular moments.

Counterpart of lightweaver_tpu/ops/pallas_sweep.py.  The CUDA kernel
``csrc/sweep.cu`` replaces the TPU kernel
``lightweaver_tpu/ops/pallas_sweep.py:_sweep_kernel``; the plain PyTorch
version below (built on ops/formal_solver.py) computes the same function
and is what runs for tensors on the CPU.

Three 1D solvers (ops/formal_solver.py:SOLVER_NAMES_1D): piecewise
linear, cubic Bezier (the default, the only one of the TPU kernel) and
BESSER.  The JAX package runs the other two in XLA; here the kernel is
templated on the solver's per-point step, so that every solver's sweep
is one launch.

Layout: chi and srcNum are direction-major [2, NL, Nmu, Nk] (d = 0 is the
down sweep from the upper boundary, d = 1 the up sweep from the lower
one), unpadded and contiguous.  S = srcNum / chi is formed inside.

The kernel runs one block per lambda row and a warp per ray, parallel
along depth (past 16 rays per direction the warps take the rays in
passes, so any Nmu is taken): it sums the recurrence in the order of
ops/formal_solver.py:affine_solve(mode='chunked'), the plain version in
the sequential order.

Two precisions per solver, float64 and float32 (the f32 state; the TPU
runs the kernel only in f32).  Both return J in float64: the sum of the
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
from .formal_solver import SOLVER_NAMES_1D, formal_sol_1d

BEZIER3 = 'piecewise_bezier3_1d'


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


def formal_solve_sweep_plain(chi, srcNum, height, muz, IupwD, IupwU, wmu,
                             solver=BEZIER3):
    """Plain PyTorch version of the sweep kernel: the sequential formal
    solution of ``solver`` per direction, then the angular moments."""
    _, NL, Nmu, Nk = chi.shape
    S = srcNum / chi
    muzB = muz[None, :].expand(NL, Nmu).reshape(-1)
    outs = []
    for d, toObs, Iupw in ((0, False, IupwD), (1, True, IupwU)):
        outs.append(formal_sol_1d(chi[d].reshape(-1, Nk),
                                  S[d].reshape(-1, Nk), height, muzB,
                                  Iupw.reshape(-1), to_obs=toObs,
                                  method=solver))
    I, Psi, IeffBase = (torch.stack([o[i].reshape(NL, Nmu, Nk)
                                     for o in outs]) for i in range(3))
    return I, Psi, IeffBase, angular_moments(I, Psi, IeffBase, srcNum, wmu)


def _check_inputs(chi, srcNum, height, muz, IupwD, IupwU, wmu, solver):
    if solver not in SOLVER_NAMES_1D:
        raise ValueError(f'the sweep kernel has no solver {solver!r}; '
                         f'available: {SOLVER_NAMES_1D}')
    if chi.dim() != 4 or chi.shape[0] != 2:
        raise ValueError(f'chi must be [2, NL, Nmu, Nk], got {tuple(chi.shape)}')
    _, NL, Nmu, Nk = chi.shape
    if Nk < 3:
        raise ValueError(f'the sweep needs Nk >= 3, got {Nk}')
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


def formal_solve_sweep(chi, srcNum, height, muz, IupwD, IupwU, wmu,
                       solver=BEZIER3):
    """Formal solution of every ray plus the angular moments.

    chi, srcNum: [2, NL, Nmu, Nk] direction-major (srcNum = eta + sca*J;
    S = srcNum/chi is formed inside); height [Nk]; muz, wmu [Nmu];
    IupwD, IupwU [NL, Nmu] boundary intensities of the down and up sweeps;
    solver one of SOLVER_NAMES_1D.
    Returns (I, Psi, IeffBase) [2, NL, Nmu, Nk] and the moments dict
    {'J', 'PsiBar', 'IBar', 'IeffSrcBar'} of [NL, Nk] (weights wmu/2).

    On the CPU this is the plain PyTorch version; on a CUDA device it
    launches the instance of csrc/sweep.cu for the solver and dtype
    (float64 or float32) or raises.  J is float64 in both (module
    docstring).
    """
    _check_inputs(chi, srcNum, height, muz, IupwD, IupwU, wmu, solver)
    if chi.device.type == 'cpu':
        return formal_solve_sweep_plain(chi, srcNum, height, muz, IupwD,
                                        IupwU, wmu, solver)
    if chi.device.type != 'cuda':
        raise RuntimeError(f'no sweep kernel for device {chi.device}')
    return sweep_cuda(chi, srcNum, height, muz, IupwD, IupwU, wmu, solver)


MAX_SMEM = 232448      # bytes of shared memory an H100 block may have
MAX_RAYS_PER_PASS = 32   # warps of a 1024-thread block


def rays_per_pass(Nmu):
    """Warps of a block of the sweep and fused kernels
    (csrc/sweep_row.cuh:rays_per_pass): the 2 Nmu rays of a row in the
    fewest passes of at most MAX_RAYS_PER_PASS warps, split evenly."""
    passes = -(-2 * Nmu // MAX_RAYS_PER_PASS)
    return -(-2 * Nmu // passes)


def smem_bytes(dtype, Nmu, Nk):
    """The dynamic shared memory per block of the sweep and fused kernels
    (csrc/sweep_row.cuh:smem_bytes): J's [2][Nk] doubles, the [2][2 or
    3][Nk] moment accumulators and two [3][R][32] tiles of the working
    type, R = rays_per_pass(Nmu)."""
    item = 4 if dtype == torch.float32 else 8
    nAcc = 3 if dtype == torch.float32 else 2
    return (16 * Nk + item * 2 * nAcc * Nk
            + item * 2 * 3 * 32 * rays_per_pass(Nmu))


def check_smem(dtype, Nmu, Nk):
    """Raise ValueError, naming the limit, where one lambda row's block
    needs more shared memory than an H100 block may have."""
    need = smem_bytes(dtype, Nmu, Nk)
    if need > MAX_SMEM:
        raise ValueError(f'Nk={Nk}, Nmu={Nmu} needs {need} bytes of shared '
                         f'memory per block, more than the {MAX_SMEM} an '
                         f'H100 block may have')


# the sweep kernel's solver argument (csrc/sweep.cu: lw::Solver)
SOLVER_CODES = {name: code for code, name in enumerate(SOLVER_NAMES_1D)}


def launch_attr(solver, dtype):
    """The attribute of sweep_cuda that counts the launches of the
    instance for ``solver`` and ``dtype``: 'launches' (Bezier-3, float64),
    'launches_f32', 'launches_linear', 'launches_besser_f32', ..."""
    name = '' if solver == BEZIER3 else '_' + solver.split('_')[1]
    return 'launches' + name + ('_f32' if dtype == torch.float32 else '')


def sweep_cuda(chi, srcNum, height, muz, IupwD, IupwU, wmu, solver=BEZIER3):
    """Launch the CUDA sweep kernel's instance for ``solver`` and chi's
    dtype; each instance counts its launches in the attribute
    launch_attr(solver, dtype) of sweep_cuda (``sweep_cuda.launches`` the
    Bezier-3 float64 ones, ``sweep_cuda.launches_f32`` the float32 ones).
    A solver the kernel does not instantiate raises."""
    if solver not in SOLVER_CODES:
        raise ValueError(f'the sweep kernel has no solver {solver!r}; '
                         f'available: {SOLVER_NAMES_1D}')
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
    check_smem(chi.dtype, Nmu, Nk)
    I, Psi, IeffBase = (torch.empty_like(chi) for _ in range(3))
    J = chi.new_empty((NL, Nk), dtype=torch.float64)
    PsiBar, IeffSrcBar = (chi.new_empty((NL, Nk)) for _ in range(2))
    IBar = chi.new_empty((NL, Nk)) if f32 else J
    lib = load_library()
    rows = [J.data_ptr(), PsiBar.data_ptr()] + (
        [IBar.data_ptr()] if f32 else []) + [IeffSrcBar.data_ptr()]
    err = (lib.lw_sweep_f32 if f32 else lib.lw_sweep_f64)(
        chi.data_ptr(), srcNum.data_ptr(), dh.data_ptr(), muz.data_ptr(),
        wmuHalf.data_ptr(), iupw.data_ptr(), I.data_ptr(), Psi.data_ptr(),
        IeffBase.data_ptr(), *rows, NL, Nmu, Nk, SOLVER_CODES[solver],
        _build.cuda_stream(chi))
    _build.check_launch(err, 'sweep')
    attr = launch_attr(solver, chi.dtype)
    setattr(sweep_cuda, attr, getattr(sweep_cuda, attr) + 1)
    return I, Psi, IeffBase, {'J': J, 'PsiBar': PsiBar, 'IBar': IBar,
                              'IeffSrcBar': IeffSrcBar}


for _solver in SOLVER_NAMES_1D:
    for _dtype in (torch.float64, torch.float32):
        setattr(sweep_cuda, launch_attr(_solver, _dtype), 0)


def _contiguous(name, x):
    if not x.is_contiguous():
        raise ValueError(f'{name} must be contiguous')
    return x


def load_library():
    """Build csrc/sweep.cu with nvcc (once per source hash) and load it."""
    return _build.load('sweep', {
        'lw_sweep_f64': [_build.PTR] * 12 + [_build.INT] * 4 + [_build.PTR],
        'lw_sweep_f32': [_build.PTR] * 13 + [_build.INT] * 4 + [_build.PTR]})
