"""Fused lambda step: opacity/emissivity assembly + Bezier-3 formal
solution + angular moments in one pass (iteration scheme
'mali_full_precond_fused').

Counterpart of lightweaver_tpu/ops/pallas_fused.py.  The CUDA kernel
``csrc/fused.cu`` replaces the TPU kernel ``_fused_kernel`` there; the
plain PyTorch version below (the slot assembly, then ops/sweep.py's plain
sweep) computes the same function and is what runs for tensors on the
CPU:

    chi    = bgChi + sum_c chiCo[c] * phiP[c]
    srcNum = (bgEta + sum_c etaCo[c] * phiP[c]) + scaJ
    I, Psi, IeffBase, moments = sweep(chi, srcNum) from the upwind BCs

Line windows are interval-coloured into C slots (`assign_line_slots`) so
that overlapping windows sit in different slots: phiP [C, 2, Nlam, Nmu,
Nk] holds each slot's line profiles (zeros between windows), chiCo/etaCo
[C, Nlam, Nk] the coefficient rows that absorb the populations and
a1 = (hc/4pi)(lambda0/lambda) Bij.  Background rows [Nlam, Nk] carry the
continua.  Each boundary is ('zero', None), ('data', I_incident
[Nlam, Nmu]) or ('therm', Planck rows [Nlam, 2] at the outermost and the
next depth), the thermalised value using the dtau of the assembled chi
between those two depths, as context.formal_solve forms it.  A height
[Ncol, NkCol] splits depth into Ncol independent columns, as in
ops/sweep.py; each boundary's rows then carry a column axis ('data'
[Nlam, Nmu, Ncol], 'therm' [Nlam, Ncol, 2], also at Ncol = 1) and one
launch takes every column.

Two instances, float64 and float32 (the f32 state).  J comes out in
float64 in both, the working-type products w I summed in a double
accumulator (ops/sweep.py: the contract of the JAX kernel's TwoSum pair);
the other moments are in the working type.  A CUDA tensor launches the
instance of its dtype or raises.

The kernel is the sweep kernel's body (csrc/sweep_row.cuh: one block per
lambda row, a warp per ray along depth, moments in the same pass) with
each lane assembling chi and srcNum of its depth from the slots; it takes
the shapes the sweep kernel takes (any Nmu, Nk up to the shared memory of
ops/sweep.py:smem_bytes).
"""
import torch

from . import _build
from .sweep import (BEZIER3, boundary_shape, check_ray_elements, check_smem,
                    column_shapes, formal_solve_sweep_plain)

BC_KINDS = {'zero': 0, 'therm': 1, 'data': 2}


def assign_line_slots(allAtoms):
    """Greedy interval colouring of the line windows (pallas_fused.py:
    assign_line_slots).  Returns ({(ai, ti): slot}, C): overlapping
    windows get distinct slots; C >= 1 is the largest overlap."""
    lines = sorted((t.Nblue, t.Nred, ai, ti)
                   for ai, a in enumerate(allAtoms)
                   for ti, t in enumerate(a.trans) if t.isLine)
    slotEnd = []                      # per slot: current rightmost Nred
    slots = {}
    for nb, nr, ai, ti in lines:
        for c in range(len(slotEnd)):
            if slotEnd[c] <= nb:
                slotEnd[c] = nr
                slots[(ai, ti)] = c
                break
        else:
            slots[(ai, ti)] = len(slotEnd)
            slotEnd.append(nr)
    return slots, max(1, len(slotEnd))


def fused_scheme_supported(cfg) -> bool:
    """Whether the fused kernel covers this configuration: float64 or
    float32, the two instances built; the Bezier-3 solver, the only one
    it is built for (as the JAX package's fused kernel); no hybrid PRD (a
    slot's coefficient rows hold one rho per row, not the comoving-frame
    rho of each ray); a 1D atmosphere (the kernel sweeps depth); and
    factored Gamma (dense Gamma reads srcNum, which the kernel never
    forms), as the JAX package's fused_scheme_supported."""
    return (cfg.dtype in (torch.float64, torch.float32) and not cfg.hprd
            and getattr(cfg, 'Ndim', 1) == 1
            and getattr(cfg, 'gammaMode', 'factored') == 'factored'
            and getattr(cfg, 'formalSolver', BEZIER3) == BEZIER3)


def assemble(phiP, chiCo, etaCo, bgChi, bgEta, scaJ):
    """chi and srcNum [2, Nlam, Nmu, Nk] from the slots, in the kernel's
    order of terms."""
    def row(x):
        return x[None, :, None, :]
    chi, eta = row(bgChi), row(bgEta)
    for c in range(phiP.shape[0]):
        chi = chi + row(chiCo[c]) * phiP[c]
        eta = eta + row(etaCo[c]) * phiP[c]
    return chi, eta + row(scaJ)


def _upwind(bc, chi0, chi1, dh0, muz, shape):
    """One sweep's boundary values: chi0, chi1 [NL, Nmu] at the two
    outermost depths and their distance dh0 (per column: [NL, Nmu, Ncol]
    and [Ncol])."""
    kind, rows = bc
    if kind == 'data':
        return rows
    if kind == 'therm':
        if len(shape) == 2:
            dtau = 0.5 * (chi0 + chi1) * dh0 / muz[None, :]
            return rows[:, 0:1] - (rows[:, 1:2] - rows[:, 0:1]) / dtau
        dtau = 0.5 * (chi0 + chi1) * dh0 / muz[None, :, None]
        b0, b1 = rows[:, None, :, 0], rows[:, None, :, 1]
        return b0 - (b1 - b0) / dtau
    return chi0.new_zeros(shape)


def fused_lambda_step_plain(phiP, chiCo, etaCo, bgChi, bgEta, scaJ, height,
                            muz, wmu, upper, lower):
    """Plain PyTorch version of the fused kernel: the slot assembly, the
    boundary values of every column, then the plain sweep."""
    chi, srcNum = assemble(phiP, chiCo, etaCo, bgChi, bgEta, scaJ)
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
    return formal_solve_sweep_plain(chi, srcNum, height, muz, IupwD, IupwU,
                                    wmu)


def _check_inputs(phiP, chiCo, etaCo, bgChi, bgEta, scaJ, height, muz, wmu,
                  upper, lower):
    if phiP.dim() != 5 or phiP.shape[1] != 2:
        raise ValueError(f'phiP must be [C, 2, Nlam, Nmu, Nk], got '
                         f'{tuple(phiP.shape)}')
    C, _, NL, Nmu, Nk = phiP.shape
    check_ray_elements(phiP[0], 'a slot of phiP')
    Ncol, Nc = column_shapes(Nk, height)
    if Nc < 3:
        raise ValueError(f'the Bezier-3 sweep needs Nk >= 3 per column, '
                         f'got {Nc}')
    bcShape = {'zero': None, 'data': boundary_shape(NL, Nmu, height),
               'therm': (NL, 2) if height.dim() == 1 else (NL, Ncol, 2)}
    shapes = {'chiCo': (chiCo, (C, NL, Nk)), 'etaCo': (etaCo, (C, NL, Nk)),
              'bgChi': (bgChi, (NL, Nk)), 'bgEta': (bgEta, (NL, Nk)),
              'scaJ': (scaJ, (NL, Nk)),
              'height': (height, tuple(height.shape)),
              'muz': (muz, (Nmu,)), 'wmu': (wmu, (Nmu,))}
    for name, (kind, rows) in (('upper', upper), ('lower', lower)):
        if kind not in BC_KINDS:
            raise ValueError(f'{name} boundary kind {kind!r} is not one of '
                             f'{tuple(BC_KINDS)}')
        if bcShape[kind] is None:
            if rows is not None:
                raise ValueError(f'a zero {name} boundary takes no rows')
        else:
            shapes[name] = (rows, bcShape[kind])
    for name, (x, shape) in shapes.items():
        if tuple(x.shape) != shape:
            raise ValueError(f'{name} must be {shape}, got {tuple(x.shape)}')
        if x.device != phiP.device or x.dtype != phiP.dtype:
            raise ValueError(f'{name} is {x.dtype} on {x.device}, phiP is '
                             f'{phiP.dtype} on {phiP.device}')


def fused_lambda_step(phiP, chiCo, etaCo, bgChi, bgEta, scaJ, height, muz,
                      wmu, upper, lower):
    """(I, Psi, IeffBase) [2, Nlam, Nmu, Nk] and the moments
    {'J', 'PsiBar', 'IBar', 'IeffSrcBar'} [Nlam, Nk] (weights wmu/2) of
    the assembled problem (module docstring), J in float64.  On the CPU
    this is the plain PyTorch version; on a CUDA device it launches the
    instance of csrc/fused.cu for the dtype (float64 or float32) or
    raises."""
    args = (phiP, chiCo, etaCo, bgChi, bgEta, scaJ, height, muz, wmu, upper,
            lower)
    _check_inputs(*args)
    if phiP.device.type == 'cpu':
        return fused_lambda_step_plain(*args)
    if phiP.device.type != 'cuda':
        raise RuntimeError(f'no fused kernel for device {phiP.device}')
    return fused_cuda(*args)


def load_library():
    """Build csrc/fused.cu with nvcc (once per source hash) and load it."""
    return _build.load('fused', {
        'lw_fused_f64': [_build.PTR] * 17 + [_build.INT] * 7 + [_build.PTR],
        'lw_fused_f32': [_build.PTR] * 18 + [_build.INT] * 7 + [_build.PTR]})


def fused_cuda(phiP, chiCo, etaCo, bgChi, bgEta, scaJ, height, muz, wmu,
               upper, lower):
    """Launch the fused kernel's instance for phiP's dtype;
    ``fused_cuda.launches`` counts the float64 launches,
    ``fused_cuda.launches_f32`` the float32 ones."""
    if not phiP.is_cuda:
        raise ValueError(f'fused_cuda takes CUDA tensors, got {phiP.device}')
    if phiP.dtype not in (torch.float64, torch.float32):
        raise TypeError(f'the fused kernel is instantiated for float64 and '
                        f'float32, got {phiP.dtype}')
    f32 = phiP.dtype == torch.float32
    ins = [phiP, chiCo, etaCo, bgChi, bgEta, scaJ]
    bcs = [rows for _, rows in (upper, lower) if rows is not None]
    if not all(x.is_contiguous() for x in ins + bcs):
        raise ValueError('the fused kernel takes contiguous tensors')
    C, _, NL, Nmu, Nk = phiP.shape
    check_ray_elements(phiP[0], 'a slot of phiP')
    Ncol, Nc = column_shapes(Nk, height)
    check_smem(phiP.dtype, Nmu, Nc)
    # per column |h[k] - h[k+1]| [Ncol, Nc - 1]
    dh = torch.abs(height[..., :-1] - height[..., 1:]).contiguous()
    muz = muz.contiguous()
    wmuHalf = (0.5 * wmu).contiguous()
    shape = (2, NL, Nmu, Nk)
    I, Psi, IeffBase = (phiP.new_empty(shape) for _ in range(3))
    J = phiP.new_empty((NL, Nk), dtype=torch.float64)
    PsiBar, IeffSrcBar = (phiP.new_empty((NL, Nk)) for _ in range(2))
    IBar = phiP.new_empty((NL, Nk)) if f32 else J
    lib = load_library()
    rowPtrs = [J.data_ptr(), PsiBar.data_ptr()] + (
        [IBar.data_ptr()] if f32 else []) + [IeffSrcBar.data_ptr()]
    err = (lib.lw_fused_f32 if f32 else lib.lw_fused_f64)(
        *(x.data_ptr() for x in ins), dh.data_ptr(), muz.data_ptr(),
        wmuHalf.data_ptr(),
        *(None if rows is None else rows.data_ptr()
          for _, rows in (upper, lower)),
        I.data_ptr(), Psi.data_ptr(), IeffBase.data_ptr(), *rowPtrs, C, NL,
        Nmu, Nc, Ncol, BC_KINDS[upper[0]], BC_KINDS[lower[0]],
        _build.cuda_stream(phiP))
    _build.check_launch(err, 'fused')
    if f32:
        fused_cuda.launches_f32 += 1
    else:
        fused_cuda.launches += 1
    return I, Psi, IeffBase, {'J': J, 'PsiBar': PsiBar, 'IBar': IBar,
                              'IeffSrcBar': IeffSrcBar}


fused_cuda.launches = 0
fused_cuda.launches_f32 = 0
