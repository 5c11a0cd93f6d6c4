"""Partial frequency redistribution: Gouttebroze's gII approximation and
the angle-averaged scattering integral, in PyTorch.

Counterpart of lightweaver_tpu/ops/prd.py, with the same constants and
the same dense formulation: the scattering integral of one line is one
[Nk, W, NFINE] tensor with a static fine-grid length and masked
quadrature weights, and gII is recomputed on the fly
(ref: Source/Prd.cpp:33-645).  The JAX package leaves all of it to XLA,
so it is plain torch here too, batched over depth with no Python loop.

``interp`` reproduces ``jnp.interp`` (its default, constant ends) on
batched rows, so that the rest-frame mean intensity of hybrid PRD and the
fine-grid J here resample exactly as the JAX package does.
"""
import math

import numpy as np
import torch

# ref: Source/Prd.cpp:33-36
PrdQWing = 4.0
PrdQCore = 2.0
PrdQSpread = 5.0
PrdDQ = 0.15

# static fine-grid size: max integration range / DQ + 1
# (ref max_fine_grid_size: Source/Prd.cpp:126-129)
NFINE = int(max(2 * PrdQWing + PrdQSpread, 2 * PrdQSpread) / PrdDQ) + 2

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
    i = torch.searchsorted(xp, x, right=True).clamp(1, n - 1)
    xl, xr = xp.gather(-1, i - 1), xp.gather(-1, i)
    fl, fr = fp.gather(-1, i - 1), fp.gather(-1, i)
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

    qWave: [W, Nk] emission frequency in Doppler units per depth;
    aDamp: [Nk]; Jw: [W, Nk] mean intensity on the line window;
    gammaPrefactor: [Nk] = (n_i/n_j) Bij / (Pj+Qj); Jbar: [Nk] = Rij/Bij.
    Returns rho [W, Nk].
    ref: Source/Prd.cpp:468-645
    """
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
