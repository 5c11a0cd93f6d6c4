"""Escape-probability initial solution for active-atom populations.

A cheap single-ray, per-transition Gamma estimate iterated with the
collisional rates to give a better-than-LTE starting point for MALI.
Host-side numpy: this is a one-shot setup heuristic, not a hot path.
A copy of lightweaver_tpu/escape.py: the numpy body is the JAX package's;
the Context's device tensors (nStar, the background) are read through the
host, the Voigt function is ops/faddeeva.py's on float64 CPU tensors, and
the start populations go back to the Context's device.

ref: Source/EscapeProbability.cpp:58-252,
     Source/LwMiddleLayer.pyx:2537-2581
"""
import numpy as np
import torch

from . import constants as Const
from .ops.faddeeva import voigt_H


def _host(x) -> np.ndarray:
    """A device tensor (or array) as a float64 numpy array."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy().astype(np.float64)
    return np.asarray(x, np.float64)


def _voigt_H_host(a, v) -> np.ndarray:
    """ops/faddeeva.py:voigt_H on numpy inputs, in float64 on the CPU."""
    def t_(x):
        return torch.as_tensor(np.asarray(x, np.float64))
    return voigt_H(t_(a), t_(v)).numpy()


def escape_probability(line: bool, tau, tauC, alpha):
    """Single-ray escape probability q and its tau-derivative dq.
    ref: Source/EscapeProbability.cpp:58-80"""
    tau = np.asarray(tau, np.float64)
    tauC = np.asarray(tauC, np.float64)
    etc = np.exp(-np.minimum(tauC, 500.0))
    if line:
        beta = 2.0 * np.pi
        q = etc / (2.0 + beta * tau)
        dq = -(tauC * beta + 2.0 * tauC / tau + beta) * q / (beta * tau + 2.0)
    else:
        beta = np.maximum(3.0 * (tau + tauC) / alpha, 1.0)
        b3 = beta ** 3
        ex = -b3 * (tau + tauC) - alpha * (beta - 1.0)
        q = np.exp(np.maximum(ex, -500.0)) / (2.0 * beta)
        dq = -b3 * q
    zero = tauC > 50.0
    return np.where(zero, 0.0, q), np.where(zero, 0.0, dq)


def escape_formal_sol(height, temperature, lam_nm, chi, chiB, S, line):
    """One-ray Feautrier-style escape-probability formal solution:
    returns (P = I+ + I-, Lambda diagonal).
    ref: Source/EscapeProbability.cpp:81-131
    (deviation: the photon-energy ratio alpha uses the wavelength in
    metres, making hc/(kB lambda T) dimensionless as intended)."""
    Nk = height.shape[0]
    tau = np.zeros(Nk)
    tauB = np.zeros(Nk)
    for k in range(1, Nk - 1):
        zz = abs(height[k - 1] - height[k + 1]) * 0.5
        tauB[k] = tauB[k - 1] + chiB[k] * zz
        tau[k] = tau[k - 1] + chi[k] * zz + tauB[k]
    tau[0] = 0.5 * tau[1]
    tauB[0] = 0.5 * tauB[1]
    tau[-1] = 2.0 * tau[-2]
    tauB[-1] = 2.0 * tauB[-2]

    P = np.zeros(Nk)
    Lam = np.ones(Nk)
    P[-1] = S[-1]

    alpha = (Const.HC / Const.KBoltzmann
             / (lam_nm * Const.NM_TO_M) / temperature)
    ep, dp = escape_probability(line, tau, tauB, alpha)
    Lam_all = 1.0 - 2.0 * ep

    acc = 0.0
    for k in range(Nk - 2, 1, -1):
        dx = 0.5 * np.log((tau[k + 1] + tauB[k + 1])
                          / (tau[k - 1] + tauB[k - 1]))
        acc += -S[k] * dp[k] * (tau[k] * dx)
        P[k] = S[k] * Lam_all[k] + acc
        Lam[k] = Lam_all[k]
    P[1] = P[2]
    Lam[1] = Lam[2]
    P[0] = P[1]
    Lam[0] = Lam[1]
    return P, Lam


def gamma_escape_prob(ctx, ai: int, n: np.ndarray) -> np.ndarray:
    """Escape-probability radiative Gamma for active atom ai given current
    populations n [Nlevel, Nk].
    ref: Source/EscapeProbability.cpp:132-252"""
    a = ctx.cfg.activeAtoms[ai]
    atmos = ctx.atmos
    Nk = atmos.Nspace
    T = np.asarray(atmos.temperature)
    height = np.asarray(atmos.height)
    vBroad = a.model.vBroad(atmos)
    nStar = _host(ctx.popsState[ai]['nStar'])
    bgChi = _host(ctx.bgChi)
    bgEta = _host(ctx.bgEta)

    Gamma = np.zeros((a.Nlevel, a.Nlevel, Nk))
    for ti, t in enumerate(a.trans):
        if t.isLine:
            lt = t.W // 2
            la = t.Nblue + lt
            aDamp = ctx.aDamp[ai][ti]
            vBase = ((t.wavelength[lt] - t.lambda0) * Const.CLight
                     / t.lambda0)
            vk = (vBase + np.asarray(atmos.vlos)) / vBroad
            phi = _voigt_H_host(aDamp, vk) / (Const.SqrtPi * vBroad)
            Vij = Const.HC_FOURPI * t.Bij * phi
            Vji = (t.Bji / t.Bij) * Vij
            Uji = (t.Aji / t.Bji) * Vji
            chi = n[t.i] * Vij - n[t.j] * Vji
            S = (n[t.j] * Uji + bgEta[la]) / (chi + bgChi[la])
            P, Lam = escape_formal_sol(height, T, t.wavelength[lt],
                                       chi, bgChi[la], S, line=True)
            Ieff = P - S * Lam
            Gamma[t.j, t.i] += t.Bij * Ieff
            Gamma[t.i, t.j] += t.Aji * (1.0 - Lam) + t.Bji * Ieff
        else:
            # chunked continuum sampling every ~10 nm
            wlaSum = 0.0
            prevWl = 0.0
            for ltc in range(t.W):
                wlaSum += t.wlambda[ltc]
                if (t.wavelength[ltc] - prevWl < 10.0 and ltc != t.W - 1):
                    continue
                prevWl = t.wavelength[ltc]
                lam = t.wavelength[ltc]
                la = t.Nblue + ltc
                hc_kl = Const.HC_K / lam
                gij = nStar[t.i] / nStar[t.j] * np.exp(-hc_kl / T)
                alpha_x = t.alpha[ltc]
                Vij = np.full(Nk, alpha_x)
                Vji = gij * Vij
                Uji = (Const.TwoHC / lam ** 3) * Vji
                chi = n[t.i] * Vij - n[t.j] * Vji
                S = (n[t.j] * Uji + bgEta[la]) / (chi + bgChi[la])
                P, Lam = escape_formal_sol(height, T, lam, chi, bgChi[la],
                                           S, line=False)
                Ieff = P - S * Lam
                Gamma[t.i, t.j] += ((Uji + Vji * Ieff) - Lam * Uji) * wlaSum
                Gamma[t.j, t.i] += (Vij * Ieff - Lam * Uji) * wlaSum
                wlaSum = 0.0

    return Gamma


def set_pops_escape_probability(ctx, Niter: int = 100,
                                tol: float = 3e-2) -> None:
    """Iterate escape-probability Gamma + collisions to give starting
    populations for every active atom; falls back to LTE populations on
    non-convergence.
    ref: Source/LwMiddleLayer.pyx:2537-2581"""
    ctx.compute_collisions()
    for ai, a in enumerate(ctx.cfg.activeAtoms):
        nStar = _host(ctx.popsState[ai]['nStar'])
        nTotal = np.asarray(ctx.eqPops.atomicPops[a.model.element].nTotal)
        n = nStar.copy()
        C = ctx.C[ai]
        converged = False
        prev = None
        for it in range(Niter):
            G = C + gamma_escape_prob(ctx, ai, n)
            # diagonal = -column sums over the TOTAL (C + radiative) matrix
            Nl, _, Nk = G.shape
            ii = np.arange(Nl)
            G[ii, ii] = 0.0
            G[ii, ii] = -G.sum(axis=0)
            iE = np.argmax(n, axis=0)
            mask = np.arange(Nl)[:, None] == iE[None, :]
            Gs = np.where(mask[:, None, :], 1.0, G)
            rhs = np.where(mask, nTotal[None, :], 0.0)
            try:
                nNew = np.linalg.solve(np.moveaxis(Gs, -1, 0),
                                       np.moveaxis(rhs, -1, 0)[..., None]
                                       )[..., 0].T
            except np.linalg.LinAlgError:
                break
            if prev is not None:
                delta = np.nanmax(np.abs(1.0 - prev / nNew))
                if delta < tol:
                    n = nNew
                    converged = True
                    break
            prev = nNew
            n = nNew
        if not converged or not np.all(np.isfinite(n)) or np.any(n <= 0):
            n = nStar.copy()     # LTE fallback
        ctx.popsState[ai]['n'] = ctx.cfg.state(n)
