"""Partial frequency redistribution: Gouttebroze's gII approximation and
the angle-averaged scattering integral, in PyTorch.

Counterpart of lightweaver_tpu/ops/prd.py, with the same constants and
the same dense formulation: the scattering integral of one line is one
[Nk, W, NFINE] tensor with a static fine-grid length and masked
quadrature weights, and gII is recomputed on the fly
(ref: Source/Prd.cpp:33-645).  The JAX package leaves all of it to XLA.
Here the plain torch version (prd_scatter_rho_plain, batched over depth
with no Python loop within a block of depths, BLOCK_ELEMENTS) runs for
CPU tensors; on a CUDA device the integral is one launch per line of the
kernel csrc/prd_scatter.cu (prd_scatter_cuda), which computes the same
function with each (window row, depth) pair's fine grid in registers.

``interp`` reproduces ``jnp.interp`` (its default, constant ends) on
batched rows, so that the rest-frame mean intensity of hybrid PRD and the
fine-grid J here resample exactly as the JAX package does.
"""
import math

import numpy as np
import torch

from .. import tracing
from . import _build

# ref: Source/Prd.cpp:33-36
PrdQWing = 4.0
PrdQCore = 2.0
PrdQSpread = 5.0
PrdDQ = 0.15

# static fine-grid size: max integration range / DQ + 1
# (ref max_fine_grid_size: Source/Prd.cpp:126-129)
NFINE = int(max(2 * PrdQWing + PrdQSpread, 2 * PrdQSpread) / PrdDQ) + 2

# the elements of each [depths, W, NFINE] temporary of one block of the
# scattering integral (prd_scatter_rho_plain): 2^26, 537 MB in float64,
# so that the temporaries alive at once stay near 7 GB at any grid size
BLOCK_ELEMENTS = 1 << 26

# jnp.interp's threshold below which an interval counts as empty
_DX_EPS = float(np.spacing(np.finfo(np.float64).eps))


def interp(x, xp, fp):
    """Linear interpolation of rows (xp, fp) [..., n] at x [..., m], the
    leading dimensions of x broadcast against those of xp: jnp.interp's
    formula row by row.  i = clip(searchsorted(xp, x, right), 1, n-1);
    f = fp[i-1] + (delta/dx) df, or fp[i-1] where dx ~ 0; fp[0] left of
    xp[0] and fp[-1] right of xp[-1]."""
    n = xp.shape[-1]
    x = x.expand(*xp.shape[:-1], x.shape[-1]).contiguous()
    xp = xp.contiguous()
    # n = 1: i = 0 and its left neighbour row 0 too (jnp.interp's i - 1
    # wraps to the last row), an empty interval
    i = torch.searchsorted(xp, x, right=True).clamp(1, n - 1)
    il = (i - 1).clamp(min=0)
    xl, xr = xp.gather(-1, il), xp.gather(-1, i)
    fl, fr = fp.gather(-1, il), fp.gather(-1, i)
    df = fr - fl
    dx = xr - xl
    delta = x - xl
    dx0 = torch.abs(dx) <= _DX_EPS
    # fl + t df as one fused multiply-add, the contraction XLA makes
    f = torch.where(dx0, fl, torch.addcmul(
        fl, delta / torch.where(dx0, 1.0, dx), df))
    f = torch.where(x < xp[..., :1], fp[..., :1], f)
    return torch.where(x > xp[..., -1:], fp[..., -1:], f)


def _G_zero(x):
    return 1.0 / (torch.abs(x) + torch.sqrt(x * x + 1.273239545))


def gII(aDamp, qEmit, qAbs):
    """Gouttebroze's fast approximation for the angle-averaged resonance
    redistribution function ratio GII = PII/phi (Gouttebroze 1986,
    A&A 160, 195; ref: Source/Prd.cpp:50-124).  Elementwise over
    broadcastable tensors."""
    flip = qEmit < 0.0
    qE = torch.where(flip, -qEmit, qEmit)
    qA = torch.where(flip, -qAbs, qAbs)

    # core value (used for qE < PrdQWing)
    expArg = torch.clamp(qE * qE - qA * qA, max=50.0)
    giiCore = torch.where(torch.abs(qA) <= qE, _G_zero(qE),
                          torch.exp(expArg) * _G_zero(qA))
    coreOutside = (qA < -PrdQWing) | (qA > qE + PrdQSpread)
    giiCore = torch.where(coreOutside, 0.0, giiCore)

    # wing value (used for qE >= PrdQCore); waveratio == 1 (resonance)
    uMin = torch.abs(qA - qE) / 2.0
    giiWing = ((1.0 - 2.0 * uMin * _G_zero(uMin))
               * torch.exp(-uMin * uMin) / math.sqrt(math.pi))
    ratio = qA / torch.clamp(qE, min=1e-10)
    giiWing = giiWing * (2.75 - (2.5 - 0.75 * ratio) * ratio)
    wingOutside = torch.abs(qA - qE) > PrdQSpread
    giiWingFar = torch.where(wingOutside, 0.0, giiWing)

    # transition blend between core and wing
    phiCore = torch.exp(-torch.clamp(qE * qE, max=50.0))
    phiWing = aDamp / (math.sqrt(math.pi) * (aDamp * aDamp + qE * qE))
    coreFactor = phiCore / (phiCore + phiWing)

    blended = coreFactor * giiCore + (1.0 - coreFactor) * giiWing
    inCoreRange = torch.where(qE < PrdQCore, giiCore, blended)
    inCoreRange = torch.where(coreOutside, 0.0, inCoreRange)
    return torch.where(qE < PrdQWing, inCoreRange, giiWingFar)


def _scattering_range_start(qEmit):
    """(q0, qN), the non-zero GII integration range around qEmit
    (ref scattering_int_range: Source/Prd.cpp:234-263)."""
    aq = torch.abs(qEmit)
    q0 = torch.where(
        aq < PrdQCore, -PrdQWing,
        torch.where(aq < PrdQWing,
                    torch.where(qEmit > 0.0, -PrdQWing, qEmit - PrdQSpread),
                    qEmit - PrdQSpread))
    qN = torch.where(
        aq < PrdQCore, PrdQWing,
        torch.where(aq < PrdQWing,
                    torch.where(qEmit > 0.0, qEmit + PrdQSpread, PrdQWing),
                    qEmit + PrdQSpread))
    return q0, qN


def prd_scatter_rho(qWave, aDamp, Jw, gammaPrefactor, Jbar):
    """rho(la, k) for one PRD line.

    qWave: [W, Nk] emission frequency in Doppler units per depth, rising
    along W at every depth (the window's wavelengths); aDamp: [Nk]; Jw:
    [W, Nk] mean intensity on the line window; gammaPrefactor: [Nk] =
    (n_i/n_j) Bij / (Pj+Qj); Jbar: [Nk] = Rij/Bij.  Returns rho [W, Nk].

    On a CUDA device one launch of csrc/prd_scatter.cu (prd_scatter_cuda)
    on the inputs in float64 (a float32 J or Jbar of accumDtype=float32
    converts exactly), which raises on what it cannot take; otherwise the
    plain version (prd_scatter_rho_plain).
    ref: Source/Prd.cpp:468-645
    """
    args = (qWave, aDamp, Jw, gammaPrefactor, Jbar)
    if qWave.is_cuda:
        return prd_scatter_cuda(*(x.to(torch.float64).contiguous()
                                  for x in args))
    return prd_scatter_rho_plain(*args)


def prd_scatter_rho_plain(qWave, aDamp, Jw, gammaPrefactor, Jbar):
    """prd_scatter_rho in plain torch, on any device.

    The integral is pointwise in depth, so it runs over blocks of depths
    whose [depths, W, NFINE] temporaries hold at most BLOCK_ELEMENTS
    elements each (one block where the whole grid fits): each depth's
    arithmetic is the same in any block, so the result is the unblocked
    one bit for bit.
    """
    W, Nk = qWave.shape
    step = max(1, BLOCK_ELEMENTS // (W * NFINE))
    if step >= Nk:
        return _scatter_rho_block(qWave, aDamp, Jw, gammaPrefactor, Jbar)
    return torch.cat([_scatter_rho_block(
        qWave[:, k:k + step], aDamp[k:k + step], Jw[:, k:k + step],
        gammaPrefactor[k:k + step], Jbar[k:k + step])
        for k in range(0, Nk, step)], dim=1)


def _scatter_rho_block(qWave, aDamp, Jw, gammaPrefactor, Jbar):
    """prd_scatter_rho_plain on one block of depths, as one dense [Nk, W,
    NFINE] evaluation."""
    W, Nk = qWave.shape
    dt, dev = qWave.dtype, qWave.device
    qW = qWave.T                                  # [Nk, W]
    Jk = Jw.T                                     # [Nk, W]

    q0, qN = _scattering_range_start(qW)          # [Nk, W]
    Np = torch.floor((qN - q0) / PrdDQ).to(torch.int32) + 1     # [Nk, W]
    f = torch.arange(NFINE, dtype=dt, device=dev)
    qFine = q0[..., None] + f * PrdDQ             # [Nk, W, Nfine]

    # hybrid Simpson/trapezoid end-corrected weights, masked past Np
    # (ref: Source/Prd.cpp:536-551)
    idx = torch.arange(NFINE, device=dev)[None, None, :]
    NpB = Np[..., None]

    def const(v):
        # a fill on the device: no copy from the host
        return torch.full((), v, dtype=dt, device=dev)
    wq = torch.where((idx == 0) | (idx == NpB - 1), const(5.0 / 12.0),
                     torch.where((idx == 1) | (idx == NpB - 2),
                                 const(13.0 / 12.0), const(1.0))) * PrdDQ
    wq = torch.where(idx < NpB, wq, const(0.0))

    # J linearly interpolated onto the fine grid (clamped at window ends)
    JFine = interp(qFine.reshape(Nk, W * NFINE), qW, Jk).reshape(
        Nk, W, NFINE)

    g = gII(aDamp[:, None, None], qW[..., None], qFine) * wq
    gNorm = torch.sum(g, dim=-1)
    scatInt = torch.sum(g * JFine, dim=-1)
    rho = 1.0 + gammaPrefactor[:, None] * (scatInt / gNorm - Jbar[:, None])
    return rho.T.contiguous()                     # [W, Nk]


# csrc/prd_scatter.cu's threads per block (kThreads): the pairs a launch
# takes, W Nk, stay below 2^31 - this
PRD_THREADS = 128
MAX_PAIRS = 2 ** 31 - 1 - PRD_THREADS


def prd_scatter_cuda(qWave, aDamp, Jw, gammaPrefactor, Jbar):
    """Launch csrc/prd_scatter.cu on prd_scatter_rho's arguments: rho [W,
    Nk] of one PRD line in one launch, on the current stream, with nothing
    read back to the host, through the operator
    torch.ops.lightweaver.prd_scatter (so that the profiler links the
    kernel to an operation), inside the span lw.prd.scatter_kernel.
    Counts its launches in ``prd_scatter_cuda.launches``.  Raises
    TypeError on a dtype other than float64 and ValueError on a shape, a
    tensor that is not contiguous or not on qWave's CUDA device, or more
    pairs than a launch takes."""
    if qWave.dim() != 2:
        raise ValueError(f'qWave must be [W, Nk], got {tuple(qWave.shape)}')
    W, Nk = qWave.shape
    tensors = {'qWave': (qWave, (W, Nk)), 'aDamp': (aDamp, (Nk,)),
               'Jw': (Jw, (W, Nk)), 'gammaPrefactor': (gammaPrefactor, (Nk,)),
               'Jbar': (Jbar, (Nk,))}
    for name, (x, shape) in tensors.items():
        if x.dtype != torch.float64:
            raise TypeError(f'the PRD scattering kernel takes float64, '
                            f'{name} is {x.dtype}')
        if tuple(x.shape) != shape:
            raise ValueError(f'{name} must be {shape}, got '
                             f'{tuple(x.shape)}')
        if not x.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
        if x.device != qWave.device:
            raise ValueError(f'{name} is on {x.device}, qWave on '
                             f'{qWave.device}')
    if not qWave.is_cuda:
        raise ValueError(f'prd_scatter_cuda takes CUDA tensors, got '
                         f'{qWave.device}')
    if W * Nk > MAX_PAIRS:
        raise ValueError(f'the PRD scattering kernel takes at most '
                         f'{MAX_PAIRS} pairs a launch, got W={W} x Nk={Nk}')
    out = torch.empty_like(qWave)
    with tracing.span('lw.prd.scatter_kernel'):
        torch.ops.lightweaver.prd_scatter(qWave, aDamp, Jw, gammaPrefactor,
                                          Jbar, out)
    prd_scatter_cuda.launches += 1
    return out


prd_scatter_cuda.launches = 0


def _prd_scatter_launch(qWave, aDamp, Jw, gammaPrefactor, Jbar, out):
    """The launch of lw_prd_scatter_f64 on prd_scatter_cuda's checked
    tensors, the CUDA kernel of the operator lightweaver::prd_scatter."""
    W, Nk = qWave.shape
    err = load_library().lw_prd_scatter_f64(
        qWave.data_ptr(), aDamp.data_ptr(), Jw.data_ptr(),
        gammaPrefactor.data_ptr(), Jbar.data_ptr(), out.data_ptr(), W, Nk,
        NFINE, _build.cuda_stream(qWave))
    _build.check_launch(err, 'PRD scattering')


# the operator, beside ops/formal_solver2d.py's sweep2d in the namespace
# that file defines (a fragment of it: either module may load first)
_OPS = torch.library.Library('lightweaver', 'FRAGMENT')
_OPS.define('prd_scatter(Tensor qWave, Tensor aDamp, Tensor Jw, '
            'Tensor gammaPrefactor, Tensor Jbar, Tensor(a!) out) -> ()')
_OPS.impl('prd_scatter', _prd_scatter_launch, 'CUDA')


def load_library():
    """Build csrc/prd_scatter.cu with nvcc, once per source hash, and load
    it."""
    sig = [_build.PTR] * 6 + [_build.INT] * 3 + [_build.PTR]
    return _build.load('prd_scatter', {'lw_prd_scatter_f64': sig})
