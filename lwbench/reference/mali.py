"""The reference's MALI step, written from the published method and not
from the port's code: the short-characteristics formal solution, the
preconditioned rate matrices and the statistical-equilibrium solve, in
float64 torch, wavelength by wavelength block.

- Formal solution in 1D (each column on its own): cubic Bezier (DELO-
  Bezier3; de la Cruz Rodriguez & Piskunov 2013, ApJ 764, 33) with
  Steffen's (1990) monotonic derivatives, the last point of a sweep by
  the linear short characteristic (Olson & Kunasz 1987), as Lightweaver's
  piecewise_bezier3_1d.  The upper boundary is dark; the lower one
  thermalised, I = B + dB/dtau along the ray.
- In 2D (x, z), periodic in x: per ray and z plane the upwind and the
  downwind point of the short characteristic lie on the neighbouring
  z plane or on the neighbouring x column, and chi, S and I are
  interpolated linearly between the two grid points there; along the ray
  BESSER (Stepan & Trujillo Bueno 2013, A&A 557, A143), the last plane of
  a sweep linear.  An upwind point on the x column couples the plane's
  points into a ring, solved exactly: one pass with I(-1) = 0 beside the
  running product of the attenuations, then the closure.  The thermalised
  start plane takes B and its gradient towards the downwind point.
- Rates (Rybicki & Hummer 1992, A&A 262, 209, full preconditioning; the
  rate matrix of Lightweaver's Gamma accumulation): over every
  wavelength, ray and direction, Gamma[i, j] += w ((Uji + Vji Ieff)
  - Psi chi_i U_j) and Gamma[j, i] += w (Vij Ieff - Psi chi_j U_i), with
  Ieff = I - Psi eta_atom, chi_l the atom's opacity into level l (+ as a
  lower level, - as an upper one), U_l the spontaneous coefficients of
  the transitions with upper level l; Gamma starts from the collisional
  rates and its diagonal is minus the column sums.
- Statistical equilibrium per point: the row of the most populated level
  replaced by particle conservation, then a dense solve.

Psi is the diagonal of the approximate operator divided by chi, so that
Psi eta is an intensity.  Every array is [..., Nk] with the points last;
the 2D points are k = z Nx + x with z = 0 the top.
"""
import math

import numpy as np
import torch

from .lwref import constants as Const

BLOCK = 16      # wavelength rows per block of the rate accumulation


def planck(T, lam):
    """B_nu(T) at wavelength lam [nm], broadcast."""
    return (Const.TwoHC / lam ** 3) / torch.expm1(Const.HC_K / (lam * T))


# ---- weights ---------------------------------------------------------------
def _series(num, den_power, terms):
    """Taylor coefficients in t of f(t) = num(t, e^-t) / t^den_power,
    where num is given as (p, q): polynomials (lowest power first) with
    num = p(t) + e^-t q(t); the coefficients of t^1 .. t^terms."""
    p, q = num
    N = den_power + terms + 1
    c = [0.0] * N
    for n, pn in enumerate(p):
        c[n] += pn
    for n in range(N):
        # e^-t q(t): sum_m q_m t^m sum_r (-t)^r / r!
        c[n] += sum(qm * (-1.0) ** (n - m) / math.factorial(n - m)
                    for m, qm in enumerate(q) if m <= n)
    return c[den_power + 1:den_power + terms + 1]


def _poly(coeffs, t):
    """sum_i coeffs[i] t^(i+1)."""
    acc = torch.zeros_like(t)
    for c in reversed(coeffs):
        acc = (acc + c) * t
    return acc


def _exp_series(t, terms):
    """1 - t + t^2/2 - ... to the power ``terms``."""
    return sum((-t) ** n / math.factorial(n) for n in range(terms + 1))


def linear_weights(t):
    """(w0, w1) of the linear short characteristic over an interval of
    optical depth t: w0 = 1 - e^-t, w1 = w0 - t e^-t; series below 5e-4,
    both 1 above 50."""
    e = torch.exp(-torch.clamp(t, max=50.0))
    w0 = torch.where(t < 5e-4, t - 0.5 * t * t, 1.0 - e)
    w1 = torch.where(t < 5e-4, t * t * (0.5 - t / 3.0),
                     1.0 - e - torch.clamp(t, max=50.0) * e)
    big = t > 50.0
    return torch.where(big, 1.0, w0), torch.where(big, 1.0, w1)


# cubic Bezier: I = e^-t I_uw + a S_uw + b S_0 + g C_uw + d C_0; t^3 times
# each weight is p(t) + e^-t q(t)
_B3 = {'a': ((6.0,), (-6.0, -6.0, -3.0, -1.0)),
       'b': ((-6.0, 6.0, -3.0, 1.0), (6.0,)),
       'g': ((-18.0, 6.0), (18.0, 12.0, 3.0)),
       'd': ((18.0, -12.0, 3.0), (-18.0, -6.0))}
_B3_TAYLOR = {k: _series(v, 3, 3) for k, v in _B3.items()}
B3_SMALL = 5e-2
B3_LARGE = 30.0     # above it e^-t is taken as 0


def bezier3_weights(t):
    """(a, b, g, d, e^-t) of the cubic Bezier step over optical depth t:
    closed forms (e^-t = 0 above B3_LARGE), their Taylor series to t^3
    below B3_SMALL."""
    small = t < B3_SMALL
    tc = torch.clamp(t, min=B3_SMALL)
    e = torch.where(tc > B3_LARGE, 0.0, torch.exp(-tc))
    out = []
    for k, (p, q) in _B3.items():
        num = (sum(c * tc ** n for n, c in enumerate(p))
               + e * sum(c * tc ** n for n, c in enumerate(q)))
        out.append(torch.where(small, _poly(_B3_TAYLOR[k], t), num / tc ** 3))
    out.append(torch.where(small, _exp_series(t, 3), e))
    return out


# BESSER (quadratic Bezier): I = e^-t I_uw + M S_uw + O S_0 + C S_ctrl;
# t^2 times each weight is p(t) + e^-t q(t)
_BQ = {'M': ((2.0,), (-2.0, -2.0, -1.0)),
       'O': ((2.0, -2.0, 1.0), (-2.0,)),
       'C': ((-4.0, 2.0), (4.0, 2.0))}
_BQ_TAYLOR = {k: _series(v, 2, 8) for k, v in _BQ.items()}
BQ_SMALL = 0.14


def besser_weights(t):
    """(M, O, C, e^-t) of the BESSER step over optical depth t: closed
    forms, their Taylor series to t^8 (e^-t to t^7) below BQ_SMALL."""
    small = t < BQ_SMALL
    tc = torch.clamp(t, min=BQ_SMALL)
    e = torch.exp(-torch.clamp(tc, max=200.0))
    out = []
    for k, (p, q) in _BQ.items():
        num = (sum(c * tc ** n for n, c in enumerate(p))
               + e * sum(c * tc ** n for n, c in enumerate(q)))
        out.append(torch.where(small, _poly(_BQ_TAYLOR[k], t), num / tc ** 2))
    out.append(torch.where(small, _exp_series(t, 7), e))
    return out


def steffen(hM, hP, yM, y0, yP):
    """Steffen's (1990) monotonic derivative at y0 between yM (hM before)
    and yP (hP after)."""
    sM = (y0 - yM) / hM
    sP = (yP - y0) / hP
    p = (sM * hP + sP * hM) / (hM + hP)
    lim = torch.minimum(torch.minimum(sM.abs(), sP.abs()), 0.5 * p.abs())
    return (torch.sign(sM) + torch.sign(sP)) * lim


def besser_control(hM, hP, yM, y0, yP):
    """The BESSER control point of the interval from yM (hM before y0)
    to y0, with yP hP after: the derivative at y0 from both sides; the
    control point y0 where y0 is an extremum; clipped to yM where it
    leaves [yM, y0], and moved to keep the downwind control point at yP
    where that one leaves [y0, yP]."""
    dM = (y0 - yM) / hM
    dP = (yP - y0) / hP
    d0 = (hM * dP + hP * dM) / (hM + hP)
    cM = y0 - 0.5 * hM * d0
    cP = y0 + 0.5 * hP * d0
    outM = (cM < torch.minimum(yM, y0)) | (cM > torch.maximum(yM, y0))
    outP = (cP < torch.minimum(y0, yP)) | (cP > torch.maximum(y0, yP))
    cMfix = y0 - hM * (yP - y0) / hP
    c = torch.where(outM, yM, torch.where(outP, cMfix, cM))
    return torch.where(dM * dP <= 0.0, y0, c)


# ---- 1D -------------------------------------------------------------------
def sweep_bezier3(chi, S, ds, Iupw):
    """One sweep of rays [..., N] in sweep order (point 0 the boundary,
    ds [..., N-1] the path lengths between neighbours, Iupw [...] the
    incoming intensity): the intensity and Psi at each point."""
    N = chi.shape[-1]

    def derivs(y, h):
        """dy/ds at each point: Steffen inside, one-sided at the ends."""
        inner = steffen(h[..., :-1], h[..., 1:], y[..., :-2], y[..., 1:-1],
                        y[..., 2:])
        return torch.cat([((y[..., 1] - y[..., 0]) / h[..., 0])[..., None],
                          inner,
                          ((y[..., -1] - y[..., -2]) / h[..., -1])[..., None]],
                         dim=-1)

    # optical depth of each interval from chi's cubic Bezier
    dchi = derivs(chi, ds)
    c1 = chi[..., :-1] + ds / 3.0 * dchi[..., :-1]
    c2 = chi[..., 1:] - ds / 3.0 * dchi[..., 1:]
    dtau = 0.25 * ds * (chi[..., :-1] + c1 + c2 + chi[..., 1:])
    dS = derivs(S, dtau)
    I = torch.empty_like(chi)
    Psi = torch.zeros_like(chi)
    I[..., 0] = Iupw
    a, b, g, d, e = bezier3_weights(dtau[..., :N - 2])
    cuw = S[..., :N - 2] + dtau[..., :N - 2] / 3.0 * dS[..., :N - 2]
    c0 = S[..., 1:N - 1] - dtau[..., :N - 2] / 3.0 * dS[..., 1:N - 1]
    local = a * S[..., :N - 2] + b * S[..., 1:N - 1] + g * cuw + d * c0
    Psi[..., 1:N - 1] = b + d
    prev = Iupw
    for m in range(1, N - 1):
        prev = e[..., m - 1] * prev + local[..., m - 1]
        I[..., m] = prev
    # the last point: linear, over the mean of the two chi
    t = 0.5 * (chi[..., -1] + chi[..., -2]) * ds[..., -1]
    w0, w1 = linear_weights(t)
    I[..., -1] = ((1.0 - w0) * prev + w0 * S[..., -1]
                  + w1 * (S[..., -2] - S[..., -1]) / t)
    Psi[..., -1] = w0 - w1 / t
    return I, Psi / chi


def solve_1d(p, chi, S, d):
    """I and Psi [Nlam, Nmu, Nk] of direction d (0 down, 1 up) of a
    column."""
    if p.formalSolver != 'piecewise_bezier3_1d':
        raise ValueError('the reference takes the cubic Bezier 1D solver '
                         'only')
    h = torch.as_tensor(p.height, dtype=chi.dtype, device=chi.device)
    order = torch.arange(p.Nk, device=chi.device)
    if d == 1:
        order = order.flip(0)
    chiS, SS, hS = chi[..., order], S[..., order], h[order]
    ds = (hS[1:] - hS[:-1]).abs()[None, None, :] / p.muz[None, :, None]
    ds = ds.expand(chi.shape[0], -1, -1)
    if d == 0:
        Iupw = torch.zeros_like(chi[..., 0])
    else:
        lam = p.wavelength[:, None]
        B0 = planck(p.temperature[order[0]], lam)
        B1 = planck(p.temperature[order[1]], lam)
        t = 0.5 * (chiS[..., 0] + chiS[..., 1]) * ds[..., 0]
        Iupw = B0 + (B0 - B1) / t
    I, Psi = sweep_bezier3(chiS, SS, ds, Iupw)
    back = torch.argsort(order)
    return I[..., back], Psi[..., back]


# ---- 2D -------------------------------------------------------------------
def _ring(A, b):
    """I_q = A_q I_(q-1) + b_q around a ring along the first axis: one
    pass from I_(-1) = 0 beside the running product of the A, then the
    closure I_(-1) = I_(N-1)."""
    I0 = torch.empty_like(b)
    prev = torch.zeros_like(b[0])
    for q in range(A.shape[0]):
        prev = torch.addcmul(b[q], A[q], prev, out=I0[q])
    P = torch.cumprod(A, dim=0)
    return I0 + P * (I0[-1] / (1.0 - P[-1]))[None]


def _geometry(p, d, dev):
    """Per ray of direction d: its x step (+1 or -1), its path across a
    column (tx, inf for a vertical ray), |muz|, and the index tensors
    [Nmu, Nx] of the upwind and the downwind neighbour column and of the
    ring order (each column after its upwind neighbour)."""
    sign = 1.0 if d == 1 else -1.0
    Nx = len(p.x)
    dx = p.x[1] - p.x[0]
    if not np.allclose(np.diff(p.x), dx):
        raise ValueError('the reference takes a uniform x grid')
    mux = sign * p.mux.cpu().numpy()
    dj = np.where(mux >= 0, 1, -1)
    with np.errstate(divide='ignore'):
        tx = np.where(mux == 0.0, np.inf, dx / np.abs(mux))
    cols = np.arange(Nx)
    ring = np.where(dj[:, None] > 0, cols[None, :], cols[::-1][None, :])

    def t_(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=dev)
    return (tx, np.abs(p.muz.cpu().numpy()),
            t_((cols[None, :] - dj[:, None]) % Nx),
            t_((cols[None, :] + dj[:, None]) % Nx), t_(ring))


def _face(tx, tz, like):
    """Per ray: (on the x column? [1, Nmu, 1], the weight of the far
    point, the path length), each broadcast like ``like`` [.., Nmu, ..]:
    the short characteristic over z distance tz (per ray) leaves through
    the x column where tx < tz."""
    side = tx < tz
    with np.errstate(divide='ignore', invalid='ignore'):
        w = np.where(side, tx / tz, np.where(np.isinf(tx), 0.0, tz / tx))
    ds = np.where(side, tx, tz)

    def t_(a, dt):
        return torch.as_tensor(a, dtype=dt, device=like.device)[None, :, None]
    return (t_(side, torch.bool), t_(w, like.dtype), t_(ds, like.dtype))


def _take(X, idx):
    """X [..., Nmu, Nx] at each ray's columns idx [Nmu, Nx]."""
    return torch.gather(X, -1, idx.expand(X.shape))


def _between(X0, X1, side, w, idx):
    """The value at the intersection from plane X0 towards plane X1 (each
    [..., Nmu, Nx]) through the neighbour columns ``idx``: on the column,
    between X0 and X1 there; else on plane X1, between the column itself
    and the neighbour."""
    X1n = _take(X1, idx)
    return torch.where(side, (1.0 - w) * _take(X0, idx) + w * X1n,
                       (1.0 - w) * X1 + w * X1n)


def solve_2d(p, chi, S, d):
    """I and Psi [Nlam, Nmu, Nk] of direction d of the slab (x periodic,
    z = 0 the top; d = 1 the rays going up), every ray of the direction
    at once."""
    if p.interp2d != 'interp_linear_2d' or \
            p.formalSolver != 'piecewise_besser_2d':
        raise ValueError('the reference takes the linear upwind '
                         'interpolation and BESSER only')
    Nlam, Nmu = chi.shape[:2]
    z = p.height
    Nz, Nx = len(z), len(p.x)
    tx, muz, up, dn, ring = _geometry(p, d, chi.device)
    back = torch.argsort(ring, dim=-1)
    chi = chi.view(Nlam, Nmu, Nz, Nx)
    S = S.view(Nlam, Nmu, Nz, Nx)
    I = torch.zeros_like(chi)
    Psi = torch.zeros_like(chi)
    planes = list(range(Nz - 1, -1, -1)) if d == 1 else list(range(Nz))
    T = p.temperature.view(Nz, Nx)[None, :, None, :].expand(1, Nz, Nmu, Nx)
    T = T.permute(0, 2, 1, 3)                           # [1, Nmu, Nz, Nx]
    lam = p.wavelength[:, None, None]
    if d == 1:
        z0, z1 = planes[0], planes[1]
        side, w, ds = _face(tx, abs(z[z1] - z[z0]) / muz, chi)
        chiDw = _between(chi[:, :, z0], chi[:, :, z1], side, w, dn)
        TDw = _between(T[:, :, z0], T[:, :, z1], side, w, dn)
        B0 = planck(T[:, :, z0], lam)
        t = 0.5 * (chi[:, :, z0] + chiDw) * ds
        I[:, :, z0] = B0 - (planck(TDw, lam) - B0) / t
    for m in range(1, Nz):
        zc, zp = planes[m], planes[m - 1]
        side, w, ds = _face(tx, abs(z[zc] - z[zp]) / muz, chi)
        chiC, SC = chi[:, :, zc], S[:, :, zc]
        chiUw = _between(chiC, chi[:, :, zp], side, w, up)
        SUw = _between(SC, S[:, :, zp], side, w, up)
        if m < Nz - 1:
            zn = planes[m + 1]
            sideN, wN, dsN = _face(tx, abs(z[zn] - z[zc]) / muz, chi)
            chiDw = _between(chiC, chi[:, :, zn], sideN, wN, dn)
            SDw = _between(SC, S[:, :, zn], sideN, wN, dn)
            chiCtl = besser_control(ds, dsN, chiUw, chiC, chiDw)
            t = (chiUw + chiCtl + chiC) * ds / 3.0
            SCtl = besser_control(t, 0.5 * (chiC + chiDw) * dsN, SUw, SC,
                                  SDw)
            M, O, C, e = besser_weights(t)
            local = M * SUw + O * SC + C * SCtl
            psi = O + C
        else:
            t = 0.5 * (chiUw + chiC) * ds
            w0, w1 = linear_weights(t)
            e = 1.0 - w0
            local = w0 * SC + w1 * (SUw - SC) / t
            psi = w0 - w1 / t
        # I_uw on the column: (1 - w) I(zc, up) + w I(zp, up), the first
        # term coupling the plane into a ring; on plane zp: known
        Iprev = I[:, :, zp]
        IprevUp = _take(Iprev, up)
        A = torch.where(side, e * (1.0 - w), 0.0)
        b = local + e * torch.where(side, w * IprevUp,
                                    (1.0 - w) * Iprev + w * IprevUp)
        Iring = _ring(_take(A, ring).permute(2, 0, 1).contiguous(),
                      _take(b, ring).permute(2, 0, 1).contiguous())
        I[:, :, zc] = _take(Iring.permute(1, 2, 0), back)
        Psi[:, :, zc] = psi / chiC
    return I.view(Nlam, Nmu, -1), Psi.view(Nlam, Nmu, -1)


# ---- the MALI step ----------------------------------------------------------
def _rows(t, lo, hi, d, n):
    """Uji, Vij, Vji [b, Nmu or 1, Nk] of transition t on the grid rows
    [lo, hi) (inside its window) for direction d."""
    r = slice(lo - t.lo, hi - t.lo)
    if t.line:
        return t.Uji[d, r], t.Vij[d, r], t.Vji[d, r]
    return t.Uji[r, None], t.Vij[r, None], t.Vji[r, None]


def opacity(p, pops, J, d):
    """chi and S [Nlam, Nmu, Nk] of direction d."""
    chi = p.bgChi[:, None, :].expand(-1, p.Nmu, -1).clone()
    eta = (p.bgEta + p.bgSca * J)[:, None, :].expand(-1, p.Nmu, -1).clone()
    for a, n in zip(p.atoms, pops):
        for t in a.trans:
            Uji, Vij, Vji = _rows(t, t.lo, t.hi, d, n)
            chi[t.lo:t.hi] += n[t.i] * Vij - n[t.j] * Vji
            eta[t.lo:t.hi] += n[t.j] * Uji
    return chi, eta / chi


def formal_sol_gamma(p, J, pops):
    """One formal solution from the lagged J and the populations: the new
    J [Nlam, Nk] and the rate matrix [Nl, Nl, Nk] of each active atom."""
    solve = solve_1d if p.dim == 1 else solve_2d
    Jnew = torch.zeros_like(J)
    Gammas = [a.C.clone() for a in p.active]
    wmu2 = 0.5 * p.wmu
    for d in (0, 1):
        chi, S = opacity(p, pops, J, d)
        I, Psi = solve(p, chi, S, d)
        del chi, S
        Jnew += (wmu2[None, :, None] * I).sum(dim=1)
        for ai, (a, n) in enumerate((a, n) for a, n in zip(p.atoms, pops)
                                    if a.active):
            _accumulate(p, a, n, I, Psi, d, Gammas[ai], wmu2)
    for G in Gammas:
        off = G * (1.0 - torch.eye(G.shape[0], dtype=G.dtype,
                                   device=G.device)[:, :, None])
        G.copy_(off - torch.diag_embed(off.sum(dim=0).T).permute(1, 2, 0))
    return Jnew, Gammas


def _accumulate(p, a, n, I, Psi, d, G, wmu2):
    """Add direction d's share of the rates of atom a to G."""
    Nl = a.Nlevel
    for lo in range(0, p.Nlam, BLOCK):
        hi = min(lo + BLOCK, p.Nlam)
        cover = [t for t in a.trans if t.lo < hi and lo < t.hi]
        if not cover:
            continue
        shape = (hi - lo, p.Nmu, p.Nk)
        chiL = I.new_zeros((Nl,) + shape)
        UL = I.new_zeros((Nl,) + shape)
        etaA = I.new_zeros(shape)
        parts = []
        for t in cover:
            l2, h2 = max(lo, t.lo), min(hi, t.hi)
            Uji, Vij, Vji = _rows(t, l2, h2, d, n)
            r = slice(l2 - lo, h2 - lo)
            chiT = n[t.i] * Vij - n[t.j] * Vji
            chiL[t.i, r] += chiT
            chiL[t.j, r] -= chiT
            UL[t.j, r] += Uji
            etaA[r] += n[t.j] * Uji
            parts.append((t, r, l2, h2, Uji, Vij, Vji))
        PsiB = Psi[lo:hi]
        Ieff = I[lo:hi] - PsiB * etaA
        for t, r, l2, h2, Uji, Vij, Vji in parts:
            w = (t.wla[l2 - t.lo:h2 - t.lo, None, :]
                 * wmu2[None, :, None])
            Ie, Ps = Ieff[r], PsiB[r]
            G[t.i, t.j] += (((Uji + Vji * Ie) - Ps * chiL[t.i, r] * UL[t.j, r])
                            * w).sum(dim=(0, 1))
            G[t.j, t.i] += ((Vij * Ie - Ps * chiL[t.j, r] * UL[t.i, r])
                            * w).sum(dim=(0, 1))


def stat_equil(p, Gammas, pops):
    """The populations that solve each active atom's rate equations, with
    the row of its most populated level (at the populations ``pops``)
    replaced by particle conservation."""
    out = []
    ai = 0
    for a, n in zip(p.atoms, pops):
        if not a.active:
            out.append(n)
            continue
        G = Gammas[ai].permute(2, 0, 1).clone()         # [Nk, Nl, Nl]
        ai += 1
        k = torch.arange(p.Nk, device=n.device)
        top = torch.argmax(n, dim=0)
        G[k, top, :] = 1.0
        rhs = torch.zeros((p.Nk, a.Nlevel), dtype=n.dtype, device=n.device)
        rhs[k, top] = a.nTotal
        out.append(torch.linalg.solve(G, rhs).T.contiguous())
    return out
