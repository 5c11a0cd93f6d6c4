"""Batched 1D short-characteristics formal solver (cubic Bezier).

Port of lightweaver_tpu/ops/formal_solver.py for the
'piecewise_bezier3_1d' solver with the sequential ('scan') depth
recurrence.  The per-point coefficients of the affine recurrence

    I_m = A_m * I_{m-1} + b_m          (m in sweep order, m = 0 upwind)

are computed as dense tensors over [batch, Ndep]; the recurrence is then
a loop over depth.  This is the plain PyTorch reference that the CUDA
depth-sweep kernel (csrc/sweep.cu) is checked against.
ref: Source/LwInternal.hpp:90-110 (w2),
     Source/Bezier.hpp (cent_deriv, Bezier3_coeffs),
     Source/FormalScalar.cpp:209-325
"""
import torch
import torch.nn.functional as F


def w2(dtau):
    """Linear short-characteristics integration weights (w0, w1).

    ref: Source/LwInternal.hpp:90-110
    """
    third = 1.0 / 3.0
    small = dtau < 5.0e-4
    big = dtau > 50.0
    dtau_safe = torch.clamp(dtau, 0.0, 50.0)
    expdt = torch.exp(-dtau_safe)
    w0_mid = 1.0 - expdt
    w1_mid = w0_mid - dtau_safe * expdt
    w0_small = dtau * (1.0 - 0.5 * dtau)
    w1_small = dtau * dtau * (0.5 - dtau * third)
    one = torch.ones_like(dtau)
    w0 = torch.where(small, w0_small, torch.where(big, one, w0_mid))
    w1 = torch.where(small, w1_small, torch.where(big, one, w1_mid))
    return w0, w1


def cent_deriv(dsuw, dsdw, yuw, y0, ydw):
    """Steffen (1990) monotonic central derivative.

    ref: Source/Bezier.hpp:57-66
    """
    S0 = (ydw - y0) / dsdw
    Suw = (y0 - yuw) / dsuw
    P0 = torch.abs((Suw * dsdw + S0 * dsuw) / (dsdw + dsuw))
    return ((torch.sign(S0) + torch.sign(Suw))
            * torch.minimum(torch.abs(Suw),
                            torch.minimum(torch.abs(S0), 0.5 * P0)))


# The power series in dt of the Bezier-3 weights (alpha, beta, gamma,
# delta), coefficients of dt^1 .. dt^12, from their closed forms below:
# e.g. alpha dt^3 = 6 - e^-dt (6 + 6 dt + 3 dt^2 + dt^3)
# = 6 e^-dt sum_{n>=4} dt^n / n!.  Their first three terms are the Taylor
# branch's.  Twelve terms reach float32 precision for dt < 1.
B3_SERIES = (
    (1 / 4, -1 / 5, 1 / 12, -1 / 42, 1 / 192, -1 / 1080, 1 / 7200,
     -1 / 55440, 1 / 483840, -1 / 4717440, 1 / 50803200, -1 / 598752000),
    (1 / 4, -1 / 20, 1 / 120, -1 / 840, 1 / 6720, -1 / 60480, 1 / 604800,
     -1 / 6652800, 1 / 79833600, -1 / 1037836800, 1 / 14529715200,
     -1 / 217945728000),
    (1 / 4, -3 / 20, 1 / 20, -1 / 84, 1 / 448, -1 / 2880, 1 / 21600,
     -1 / 184800, 1 / 1774080, -1 / 18869760, 1 / 220147200,
     -1 / 2794176000),
    (1 / 4, -1 / 10, 1 / 40, -1 / 210, 1 / 1344, -1 / 10080, 1 / 86400,
     -1 / 831600, 1 / 8870400, -1 / 103783680, 1 / 1320883200,
     -1 / 18162144000),
)
# below it, float32 takes the weights from B3_SERIES instead of the
# closed forms
B3_SERIES_MAX = 1.0


def _b3_series(coef, dt):
    """sum_i coef[i] dt^(i+1) by Horner's rule, in dt's dtype."""
    acc = torch.full_like(dt, coef[-1])
    for c in reversed(coef[:-1]):
        acc = acc * dt + c
    return acc * dt


def bezier3_coeffs(dt):
    """Cubic Bezier integration coefficients (alpha, beta, gamma, delta, edt).

    alpha:S_uw, beta:S_0, gamma:C_uw, delta:C_0, edt:exp(-dtau).
    Taylor branch for dt < 5e-2, asymptotic branch for dt > 30.  In
    float32 the closed forms of the middle branch cancel near its lower
    end (alpha dt^3 = 6 - e^-dt (...) ~ dt^4 / 4 against terms of 6, up
    to ~20% of alpha lost at dt = 5e-2), a noise that keeps the f32 state
    from converging; so for 5e-2 <= dt < B3_SERIES_MAX float32 sums the
    same functions' power series (B3_SERIES), which do not cancel.  Float64
    keeps the closed forms, as the reference.
    ref: Source/Bezier.hpp:81-127
    """
    dt2 = dt * dt
    dt3 = dt2 * dt
    small = dt < 5e-2
    big = dt > 30.0

    # the mid branch needs dt clipped into [5e-2, 30]; the asymptotic
    # branch uses the true dt, guarded only against small values
    dt_m = torch.clamp(dt, 5e-2, 30.0)
    dt2_m = dt_m * dt_m
    dt3_m = dt2_m * dt_m
    edt_m = torch.exp(-dt_m)

    a_small = 0.25 * dt - 0.2 * dt2 + dt3 / 12.0
    b_small = 0.25 * dt - 0.05 * dt2 + dt3 / 120.0
    g_small = 0.25 * dt - 0.15 * dt2 + 0.05 * dt3
    d_small = 0.25 * dt - 0.1 * dt2 + 0.025 * dt3
    e_small = 1.0 - dt + 0.5 * dt2 - dt3 / 6.0

    dt_b = torch.clamp(dt, min=5e-2)
    dt2_b = dt_b * dt_b
    dt3_b = dt2_b * dt_b
    a_big = 6.0 / dt3_b
    b_big = (-6.0 + 6.0 * dt_b - 3.0 * dt2_b + dt3_b) / dt3_b
    g_big = 3.0 * (2.0 * dt_b - 6.0) / dt3_b
    d_big = 3.0 * (6.0 - 4.0 * dt_b + dt2_b) / dt3_b
    e_big = torch.zeros_like(dt)

    a_mid = (6.0 - edt_m * (6.0 + 6.0 * dt_m + 3.0 * dt2_m + dt3_m)) / dt3_m
    b_mid = (6.0 * edt_m - 6.0 + 6.0 * dt_m - 3.0 * dt2_m + dt3_m) / dt3_m
    g_mid = 3.0 * (2.0 * dt_m - 6.0 + edt_m * (6.0 + 4.0 * dt_m + dt2_m)) / dt3_m
    d_mid = 3.0 * (6.0 - 4.0 * dt_m + dt2_m - 2.0 * edt_m * (3.0 + dt_m)) / dt3_m

    if dt.dtype != torch.float64:
        series = (dt >= 5e-2) & (dt < B3_SERIES_MAX)
        a_mid, b_mid, g_mid, d_mid = (
            torch.where(series, _b3_series(c, dt_m), m)
            for c, m in zip(B3_SERIES, (a_mid, b_mid, g_mid, d_mid)))

    def sel(s, b, m):
        return torch.where(small, s, torch.where(big, b, m))

    return (sel(a_small, a_big, a_mid), sel(b_small, b_big, b_mid),
            sel(g_small, g_big, g_mid), sel(d_small, d_big, d_mid),
            sel(e_small, e_big, edt_m))


def _point_derivs(y, ds):
    """Per-point derivatives: Steffen central at interior, one-sided at ends.

    y: [B, N]; ds: [B, N-1] interval widths. Returns [B, N].
    """
    d_int = cent_deriv(ds[..., :-1], ds[..., 1:],
                       y[..., :-2], y[..., 1:-1], y[..., 2:])
    d0 = ((y[..., 1] - y[..., 0]) / ds[..., 0])[..., None]
    dN = ((y[..., -1] - y[..., -2]) / ds[..., -1])[..., None]
    return torch.cat([d0, d_int, dN], dim=-1)


def _sweep_coeffs_bezier3(chi, S, ds):
    """Affine coefficients (A, b, psiN, bNL) [B, N] of the cubic-Bezier
    (DELO-Bezier3 scalar) solver, in sweep order; psiN is Psi before the
    division by chi, bNL the non-local part of b (b - psiN*S_0 without
    the cancelling subtraction).

    Interior points m = 1..N-2 use Bezier-3; the final point m = N-1
    falls back to the linear w2 step (with the plain-average dtau).
    ref: Source/FormalScalar.cpp:209-325
    """
    def pad0(x):
        return F.pad(x, (1, 0))

    # chi control points per interval (m, m+1), m = 0..N-2
    dchi = _point_derivs(chi, ds)                          # [B, N]
    Cuw = chi[..., :-1] + (ds / 3.0) * dchi[..., :-1]
    C0 = chi[..., 1:] - (ds / 3.0) * dchi[..., 1:]
    dtau = ds * (chi[..., :-1] + chi[..., 1:] + Cuw + C0) * 0.25  # [B, N-1]

    # S derivatives wrt tau: one-sided at the ends, Steffen central interior
    dS = _point_derivs(S, dtau)                            # [B, N]

    # interval (m-1, m) quantities for interior target points m = 1..N-2
    dt_uw = dtau[..., :-1]                                 # [B, N-2]
    alpha, beta, gamma, delta, edt = bezier3_coeffs(dt_uw)
    CuwS = S[..., :-2] + (dt_uw / 3.0) * dS[..., :-2]
    C0S = S[..., 1:-1] - (dt_uw / 3.0) * dS[..., 1:-1]
    b_bez = (alpha * S[..., :-2] + beta * S[..., 1:-1]
             + gamma * CuwS + delta * C0S)
    A_bez = edt
    Psi_bez = beta + delta
    bNL_bez = (alpha * S[..., :-2] + gamma * CuwS
               - delta * (dt_uw / 3.0) * dS[..., 1:-1])

    # final point: linear step with plain-average dtau
    dtau_end = 0.5 * (chi[..., -1] + chi[..., -2]) * ds[..., -1]
    dS_end = (S[..., -1] - S[..., -2]) / dtau_end
    w0e, w1e = w2(dtau_end)
    A_end = (1.0 - w0e)[..., None]
    b_end = (w0e * S[..., -1] - w1e * dS_end)[..., None]
    Psi_end = (w0e - w1e / dtau_end)[..., None]
    bNL_end = ((w1e / dtau_end) * S[..., -2])[..., None]

    A = pad0(torch.cat([A_bez, A_end], dim=-1))
    b = pad0(torch.cat([b_bez, b_end], dim=-1))
    Psi = pad0(torch.cat([Psi_bez, Psi_end], dim=-1))
    bNL = pad0(torch.cat([bNL_bez, bNL_end], dim=-1))
    return A, b, Psi, bNL


def formal_sol_1d(chi, S, height, muz, I_upw, to_obs=True):
    """Batched 1D formal solution along depth for many rays at once.

    chi, S : [B, Ndep] opacity and source function per ray (k=0 is the top).
    height : [Ndep] geometric height (decreasing with k).
    muz : [B] |mu| of each ray.
    I_upw : [B] upwind boundary intensity at the sweep start.
    to_obs : sweep direction; True = bottom-to-top (upgoing).

    Returns (I, Psi, IeffBase), each [B, Ndep] in the original depth
    indexing: Psi is the diagonal approximate operator (divided by chi),
    IeffBase = A * I_upwind + bNL, the MALI effective intensity's part
    that does not cancel in optically-thick regions.
    """
    if to_obs:
        chi_s, S_s, h_s = chi.flip(-1), S.flip(-1), height.flip(-1)
    else:
        chi_s, S_s, h_s = chi, S, height

    ds = torch.abs(h_s[1:] - h_s[:-1])[None, :] / muz[:, None]
    A, b, Psi, bNL = _sweep_coeffs_bezier3(chi_s, S_s, ds)
    b[..., 0] = I_upw

    # the sequential recurrence, I_{-1} = 0 and A_0 = 0
    N = chi.shape[-1]
    I_s = torch.empty_like(b)
    Iprev = torch.zeros_like(I_upw)
    for m in range(N):
        Iprev = A[:, m] * Iprev + b[:, m]
        I_s[:, m] = Iprev

    # IeffBase = A * I_upwind + bNL; at the sweep start Psi = 0 and
    # IeffBase = I = I_upw
    I_shift = torch.cat([I_upw[:, None], I_s[:, :-1]], dim=-1)
    bNL[..., 0] = I_upw
    ieffb = A * I_shift + bNL

    if to_obs:
        I_s, Psi, ieffb = I_s.flip(-1), Psi.flip(-1), ieffb.flip(-1)
    return I_s, Psi / chi, ieffb
