"""The PRD subset solve's formal solution: chi and srcNum of the
PRD-active rows assembled from their rho-free part and the PRD lines'
rho, then the depth sweep and the angular moments
(context.py:build_prd_subset_fn, once per PRD sub-iteration).

Inside a PRD redistribution only the PRD lines' rho and J change, so the
subset solve forms the rest once per redistribution: chiFix = the
background plus every other transition's chi plus each PRD line's n_i
Vij, etaFix = the background plus every other transition's eta, and per
PRD line its Vij on its rows.  What a sub-iteration adds, per PRD line
(a ``SubsetLine``) covering a row:

    rc     = (1 - frac) rho[i0, k] + frac rho[i0 + 1, k]   (hybrid PRD)
             or rho of the row (angle-averaged PRD)
    Vji    = (gS Vij) rc,  gS = Bji / Bij
    chi    = chiFix - sum_lines nj Vji
    srcNum = (etaFix + sum_lines nj (uS Vji)) + scaJ,  uS = Aji / Bji

the lines in their order, then the sweep of ops/sweep.py by the solver
from the upwind boundaries (ops/fused.py's kinds: zero, data, or
thermalised from the Planck rows and the assembled chi at the two
outermost depths).  Returns I [2, NL, Nmu, Nk] and the moments {'J',
'PsiBar', 'IBar', 'IeffSrcBar'}; the subset solve reads no Psi and no
IeffBase, and the kernel stores neither.

The CUDA kernel ``csrc/prd_subset.cu`` (sweep_row.cuh's body, chi and
srcNum assembled per lane in registers) runs on a CUDA tensor, through
the operator torch.ops.lightweaver.prd_subset, in float64 and float32
and for each 1D solver; the plain version below (the assembly in torch,
then ops/sweep.py's plain sweep) runs for CPU tensors and is what the
tests hold the kernel to.  The kernel takes at most MAX_LINES lines.
"""
import ctypes
from typing import NamedTuple, Optional

import torch

from . import _build
from .fused import BC_KINDS, _upwind
from .formal_solver import SOLVER_NAMES_1D
from .sweep import (BEZIER3, SOLVER_CODES, boundary_shape, check_ray_elements,
                    check_smem, column_shapes, formal_solve_sweep_plain)

# the PRD lines one launch takes (csrc/prd_subset.cu: kMaxLines)
MAX_LINES = 8


class SubsetLine(NamedTuple):
    """One PRD line of the subset solve: its rows [s0, s0 + nW) of the
    NL rows, Vij [2, nW, Nmu, Nk] there, the upper level's population nj
    [Nk], gS = Bji / Bij and uS = Aji / Bji, its rho [W, Nk] over the
    whole window and ``off``, the window row of row s0; under hybrid PRD
    the comoving-frame coefficients i0 (int64) and frac, [2, W, Nmu, Nk]
    over the whole window (None under angle-averaged PRD)."""
    s0: int
    Vij: torch.Tensor
    nj: torch.Tensor
    gS: float
    uS: float
    rho: torch.Tensor
    off: int
    i0: Optional[torch.Tensor] = None
    frac: Optional[torch.Tensor] = None


def comoving_rho(rho, i0, frac):
    """rho [W, Nk] at the comoving-frame positions (i0, frac) [..., Nk]:
    (1 - frac) rho[i0, k] + frac rho[i0 + 1, k]
    (ref: Source/LwTransition.hpp:118-126); rho[i0 + 1] read as rho[1:]
    at i0, so no index tensor is formed."""
    kIdx = torch.arange(rho.shape[1], device=rho.device)
    return (1.0 - frac) * rho[i0, kIdx] + frac * rho[1:][i0, kIdx]


def line_rho_rows(line: SubsetLine):
    """The rho that scales the line's Vji on its rows: [2, nW, Nmu, Nk]
    comoving under hybrid PRD, else [1, nW, 1, Nk]."""
    nW = line.Vij.shape[1]
    rows = slice(line.off, line.off + nW)
    if line.i0 is None:
        return line.rho[rows][None, :, None, :]
    return comoving_rho(line.rho, line.i0[:, rows], line.frac[:, rows])


def assemble(chiFix, etaFix, scaJ, lines):
    """chi and srcNum [2, NL, Nmu, Nk] in the kernel's order of terms."""
    chi, eta = chiFix.clone(), etaFix.clone()
    for L in lines:
        rows = slice(L.s0, L.s0 + L.Vij.shape[1])
        vji = (L.gS * L.Vij) * line_rho_rows(L)
        chi[:, rows] -= L.nj * vji
        eta[:, rows] += L.nj * (L.uS * vji)
    return chi, eta + scaJ[None, :, None, :]


def sweep_args(chiFix, etaFix, scaJ, lines, height, muz, wmu, upper,
               lower):
    """The arguments of ops/sweep.py:formal_solve_sweep that the kernel
    sweeps: the assembled chi and srcNum and the boundary values of every
    column from the assembled chi."""
    chi, srcNum = assemble(chiFix, etaFix, scaJ, lines)
    _, NL, Nmu, Nk = chi.shape
    Ncol, Nc = column_shapes(Nk, height)
    shape = boundary_shape(NL, Nmu, height)
    h = height.reshape(Ncol, Nc)
    ends = chi.unflatten(-1, (Ncol, Nc))
    if height.dim() == 1:
        ends, h = ends[..., 0, :], h[0]
    IupwD = _upwind(upper, ends[0, ..., 0], ends[0, ..., 1],
                    torch.abs(h[..., 0] - h[..., 1]), muz, shape)
    IupwU = _upwind(lower, ends[1, ..., Nc - 1], ends[1, ..., Nc - 2],
                    torch.abs(h[..., Nc - 1] - h[..., Nc - 2]), muz, shape)
    return chi, srcNum, height, muz, IupwD, IupwU, wmu


def prd_subset_sweep_plain(chiFix, etaFix, scaJ, lines, height, muz, wmu,
                           upper, lower, solver=BEZIER3):
    """Plain PyTorch version of the kernel: the assembly and the boundary
    values (sweep_args), then ops/sweep.py's plain sweep.  Returns (I,
    moments)."""
    I, _, _, moments = formal_solve_sweep_plain(
        *sweep_args(chiFix, etaFix, scaJ, lines, height, muz, wmu, upper,
                    lower), solver)
    return I, moments


def _check_inputs(chiFix, etaFix, scaJ, lines, height, muz, wmu, upper,
                  lower, solver):
    if solver not in SOLVER_NAMES_1D:
        raise ValueError(f'the PRD subset kernel has no solver {solver!r}; '
                         f'available: {SOLVER_NAMES_1D}')
    if chiFix.dim() != 4 or chiFix.shape[0] != 2:
        raise ValueError(f'chiFix must be [2, NL, Nmu, Nk], got '
                         f'{tuple(chiFix.shape)}')
    _, NL, Nmu, Nk = chiFix.shape
    check_ray_elements(chiFix, 'chiFix')
    Ncol, Nc = column_shapes(Nk, height)
    if Nc < 3:
        raise ValueError(f'the sweep needs Nk >= 3 per column, got {Nc}')
    bcShape = {'zero': None, 'data': boundary_shape(NL, Nmu, height),
               'therm': (NL, 2) if height.dim() == 1 else (NL, Ncol, 2)}
    real = chiFix.dtype
    shapes = {'etaFix': (etaFix, chiFix.shape, real),
              'scaJ': (scaJ, (NL, Nk), real),
              'height': (height, height.shape, real),
              'muz': (muz, (Nmu,), real), 'wmu': (wmu, (Nmu,), real)}
    for name, (kind, rows) in (('upper', upper), ('lower', lower)):
        if kind not in BC_KINDS:
            raise ValueError(f'{name} boundary kind {kind!r} is not one of '
                             f'{tuple(BC_KINDS)}')
        if bcShape[kind] is None:
            if rows is not None:
                raise ValueError(f'a zero {name} boundary takes no rows')
        else:
            shapes[name] = (rows, bcShape[kind], real)
    for s, L in enumerate(lines):
        if L.Vij.dim() != 4:
            raise ValueError(f'line {s}: Vij must be [2, nW, Nmu, Nk], got '
                             f'{tuple(L.Vij.shape)}')
        nW = L.Vij.shape[1]
        W = L.rho.shape[0]
        if not (0 <= L.s0 and L.s0 + nW <= NL and 0 <= L.off
                and L.off + nW <= W and nW >= 1):
            raise ValueError(f'line {s}: rows [{L.s0}, {L.s0 + nW}) of '
                             f'{NL} and window rows [{L.off}, '
                             f'{L.off + nW}) of {W} do not fit')
        if (L.i0 is None) != (L.frac is None):
            raise ValueError(f'line {s}: i0 and frac go together')
        shapes[f'line {s} Vij'] = (L.Vij, (2, nW, Nmu, Nk), real)
        shapes[f'line {s} nj'] = (L.nj, (Nk,), real)
        shapes[f'line {s} rho'] = (L.rho, (W, Nk), real)
        if L.i0 is not None:
            shapes[f'line {s} i0'] = (L.i0, (2, W, Nmu, Nk), torch.int64)
            shapes[f'line {s} frac'] = (L.frac, (2, W, Nmu, Nk), real)
    for name, (x, shape, dtype) in shapes.items():
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f'{name} must be {tuple(shape)}, got '
                             f'{tuple(x.shape)}')
        if x.dtype != dtype:
            raise TypeError(f'{name} is {x.dtype}, the kernel takes {dtype} '
                            f'beside chiFix {real}')
        if x.device != chiFix.device:
            raise ValueError(f'{name} is on {x.device}, chiFix on '
                             f'{chiFix.device}')


def prd_subset_sweep(chiFix, etaFix, scaJ, lines, height, muz, wmu, upper,
                     lower, solver=BEZIER3):
    """I [2, NL, Nmu, Nk] and the moments {'J', 'PsiBar', 'IBar',
    'IeffSrcBar'} [NL, Nk] (weights wmu/2, J in float64) of the subset
    rows assembled from chiFix, etaFix [2, NL, Nmu, Nk], scaJ [NL, Nk] and
    the PRD lines ``lines`` (SubsetLine; module docstring); height [Nk]
    or [Ncol, NkCol], muz and wmu [Nmu], each boundary ('zero', None),
    ('data', rows) or ('therm', Planck rows) as ops/fused.py takes them.
    On the CPU the plain version; on a CUDA device one launch of
    csrc/prd_subset.cu for the dtype (float64 or float32) and the solver,
    or raises."""
    args = (chiFix, etaFix, scaJ, list(lines), height, muz, wmu, upper,
            lower, solver)
    _check_inputs(*args)
    if chiFix.device.type == 'cpu':
        return prd_subset_sweep_plain(*args)
    if chiFix.device.type != 'cuda':
        raise RuntimeError(f'no PRD subset kernel for device '
                           f'{chiFix.device}')
    return prd_subset_cuda(*args)


def prd_subset_cuda(chiFix, etaFix, scaJ, lines, height, muz, wmu, upper,
                    lower, solver=BEZIER3):
    """Launch csrc/prd_subset.cu on prd_subset_sweep's checked arguments:
    one launch on the current stream, nothing read back to the host,
    through the operator torch.ops.lightweaver.prd_subset; counts its
    launches in ``prd_subset_cuda.launches`` (float64) and
    ``.launches_f32``.  Raises on more than MAX_LINES lines, a dtype the
    kernel is not built for, or a tensor that is not contiguous."""
    if not chiFix.is_cuda:
        raise ValueError(f'prd_subset_cuda takes CUDA tensors, got '
                         f'{chiFix.device}')
    if chiFix.dtype not in (torch.float64, torch.float32):
        raise TypeError(f'the PRD subset kernel is instantiated for float64 '
                        f'and float32, got {chiFix.dtype}')
    if len(lines) > MAX_LINES:
        raise ValueError(f'the PRD subset kernel takes at most {MAX_LINES} '
                         f'lines, got {len(lines)}')
    f32 = chiFix.dtype == torch.float32
    _, NL, Nmu, Nk = chiFix.shape
    Ncol, Nc = column_shapes(Nk, height)
    check_smem(chiFix.dtype, Nmu, Nc)
    ins = [chiFix, etaFix, scaJ]
    lineTensors = [x for L in lines
                   for x in (L.Vij, L.rho, L.i0, L.frac, L.nj)]
    bcs = [rows for _, rows in (upper, lower)]
    if not all(x is None or x.is_contiguous()
               for x in ins + lineTensors + bcs):
        raise ValueError('the PRD subset kernel takes contiguous tensors')
    # per column |h[k] - h[k+1]| [Ncol, Nc - 1]
    dh = torch.abs(height[..., :-1] - height[..., 1:]).reshape(
        Ncol, Nc - 1).contiguous()
    ins += [dh, muz.contiguous(), (0.5 * wmu).contiguous()] + bcs
    I = chiFix.new_empty(chiFix.shape)
    J = chiFix.new_empty((NL, Nk), dtype=torch.float64)
    PsiBar, IeffSrcBar = (chiFix.new_empty((NL, Nk)) for _ in range(2))
    IBar = chiFix.new_empty((NL, Nk)) if f32 else J
    outs = [I, J, PsiBar] + ([IBar] if f32 else []) + [IeffSrcBar]
    consts = [c for L in lines for c in (float(L.gS), float(L.uS))]
    ints = [n for L in lines
            for n in (L.s0, L.Vij.shape[1], L.rho.shape[0], L.off)]
    torch.ops.lightweaver.prd_subset(
        ins, lineTensors, consts, ints, outs, SOLVER_CODES[solver],
        BC_KINDS[upper[0]], BC_KINDS[lower[0]])
    attr = 'launches_f32' if f32 else 'launches'
    setattr(prd_subset_cuda, attr, getattr(prd_subset_cuda, attr) + 1)
    return I, {'J': J, 'PsiBar': PsiBar, 'IBar': IBar,
               'IeffSrcBar': IeffSrcBar}


prd_subset_cuda.launches = 0
prd_subset_cuda.launches_f32 = 0


def _prd_subset_launch(ins, lineTensors, consts, ints, outs, solver, upKind,
                       loKind):
    """The launch of lw_prd_subset_f64 / _f32 on prd_subset_cuda's checked
    tensors (ins: chiFix, etaFix, scaJ, dh, muz, wmu/2, the two boundary
    rows; five tensors a line; outs: I, J, PsiBar, IBar (float32 only),
    IeffSrcBar), the CUDA kernel of the operator lightweaver::prd_subset."""
    chiFix = ins[0]
    _, NL, Nmu, NT = chiFix.shape
    Ncol = ins[3].shape[0]
    f32 = chiFix.dtype == torch.float32
    nLines = len(lineTensors) // 5
    ptrs = (ctypes.c_void_p * max(1, len(lineTensors)))(
        *(None if x is None else x.data_ptr() for x in lineTensors))
    cs = (ctypes.c_double * max(1, len(consts)))(*consts)
    ns = (ctypes.c_int * max(1, len(ints)))(*ints)
    lib = load_library()
    err = (lib.lw_prd_subset_f32 if f32 else lib.lw_prd_subset_f64)(
        *(None if x is None else x.data_ptr() for x in ins), ptrs, cs, ns,
        nLines, *(x.data_ptr() for x in outs), NL, Nmu, NT // Ncol, Ncol,
        solver, upKind, loKind, _build.cuda_stream(chiFix))
    _build.check_launch(err, 'PRD subset')


# the operator, beside sweep2d and prd_scatter in the namespace that
# ops/formal_solver2d.py defines (a fragment of it: either module may load
# first)
_OPS = torch.library.Library('lightweaver', 'FRAGMENT')
_OPS.define('prd_subset(Tensor?[] ins, Tensor?[] lineTensors, float[] consts, '
            'int[] ints, Tensor(a!)[] outs, int solver, int upKind, '
            'int loKind) -> ()')
_OPS.impl('prd_subset', _prd_subset_launch, 'CUDA')


def load_library():
    """Build csrc/prd_subset.cu with nvcc, once per source hash, and load
    it."""
    head = [_build.PTR] * 11 + [_build.INT]
    tail = [_build.INT] * 7 + [_build.PTR]
    return _build.load('prd_subset', {
        'lw_prd_subset_f64': head + [_build.PTR] * 4 + tail,
        'lw_prd_subset_f32': head + [_build.PTR] * 5 + tail})
