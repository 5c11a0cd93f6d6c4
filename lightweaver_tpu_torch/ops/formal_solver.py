"""Batched 1D short-characteristics formal solvers: piecewise linear,
cubic Bezier and BESSER.

Port of lightweaver_tpu/ops/formal_solver.py's three 1D solvers
(SOLVER_NAMES_1D) with the sequential ('scan') depth recurrence.  The
per-point coefficients of the affine recurrence

    I_m = A_m * I_{m-1} + b_m          (m in sweep order, m = 0 upwind)

are computed as dense tensors over [batch, Ndep]; the recurrence is then
a loop over depth (affine_solve, mode 'sequential').  This is the plain
PyTorch reference that the CUDA depth-sweep kernel (csrc/sweep.cu) is
checked against; affine_solve's mode 'chunked' sums the recurrence in that
kernel's order.
ref: Source/LwInternal.hpp:90-110 (w2),
     Source/Bezier.hpp (cent_deriv, Bezier3_coeffs),
     Source/FormalScalar.cpp:136-467
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


def besser_control_point(hM, hP, yM, yO, yP):
    """BESSER (Stepan & Trujillo Bueno 2013) monotonic quadratic-Bezier
    control point.  ref: Source/FormalScalar.cpp:327-363"""
    dM = (yO - yM) / hM
    dP = (yP - yO) / hP
    yOp = (hM * dP + hP * dM) / (hM + hP)
    cM = yO - 0.5 * hM * yOp
    cP = yO + 0.5 * hP * yOp

    incr = dM >= 0.0
    minYMO = torch.where(incr, yM, yO)
    maxYMO = torch.where(incr, yO, yM)
    minYOP = torch.where(incr, yO, yP)
    maxYOP = torch.where(incr, yP, yO)

    cM_bad = (cM < minYMO) | (cM > maxYMO)
    cP_bad = (cP < minYOP) | (cP > maxYOP)

    # if cP is out of range: cP = yP, recompute cM
    cM_fixed = yO - 0.5 * hM * ((yP - yO) / (0.5 * hP))
    out = torch.where(cM_bad, yM, torch.where(cP_bad, cM_fixed, cM))
    return torch.where(dM * dP <= 0.0, yO, out)


def besser_coeffs(t):
    """BESSER integration coefficients (M, O, C, edt), Taylor branch for
    t < 0.14.  The same formulas in either dtype, as in the JAX package:
    in float32 the middle branch cancels just above t = 0.14.
    ref: Source/FormalScalar.cpp:365-394"""
    small = t < 0.14
    tm = torch.clamp(t, min=0.14)
    t2 = tm * tm
    edt_m = torch.exp(-torch.clamp(tm, max=200.0))
    m_mid = (2.0 - edt_m * (t2 + 2.0 * tm + 2.0)) / t2
    o_mid = 1.0 - 2.0 * (edt_m + tm - 1.0) / t2
    c_mid = 2.0 * (tm - 2.0 + edt_m * (tm + 2.0)) / t2

    m_small = (t * (t * (t * (t * (t * (t * ((140.0 - 18.0 * t) * t - 945.0)
               + 5400.0) - 25200.0) + 90720.0) - 226800.0) + 302400.0)) / 907200.0
    o_small = (t * (t * (t * (t * (t * (t * ((10.0 - t) * t - 90.0) + 720.0)
               - 5040.0) + 30240.0) - 151200.0) + 604800.0)) / 1814400.0
    c_small = (t * (t * (t * (t * (t * (t * ((35.0 - 4.0 * t) * t - 270.0)
               + 1800.0) - 10080.0) + 45360.0) - 151200.0) + 302400.0)) / 907200.0
    t3 = t * t * t
    e_small = (1.0 - t + 0.5 * t * t - t3 / 6.0 + t * t3 / 24.0
               - t * t * t3 / 120.0 + t3 * t3 / 720.0 - t3 * t3 * t / 5040.0)

    M = torch.where(small, m_small, m_mid)
    O = torch.where(small, o_small, o_mid)
    Cc = torch.where(small, c_small, c_mid)
    edt = torch.where(small, e_small, edt_m)
    return M, O, Cc, edt


def _pad0(x):
    """x with a zero at the sweep start (m = 0) of its last axis."""
    return F.pad(x, (1, 0))


def _sweep_coeffs_linear(chi, S, ds):
    """Affine coefficients (A, b, psiN, bNL) [B, N] of piecewise-linear
    short characteristics, in sweep order; psiN is Psi before the
    division by chi, bNL = (w1/dtau) S_uw the non-local part of b,
    formed without the cancelling subtraction b - psiN S_0.
    ref: Source/FormalScalar.cpp:136-207
    """
    # dtau of interval (m-1, m), defined for m >= 1
    dtau = 0.5 * (chi[..., :-1] + chi[..., 1:]) * ds       # [B, N-1]
    dS = (S[..., :-1] - S[..., 1:]) / dtau                 # (S_uw - S_m)/dtau
    w0, w1 = w2(dtau)
    return (_pad0(1.0 - w0), _pad0(w0 * S[..., 1:] + w1 * dS),
            _pad0(w0 - w1 / dtau), _pad0((w1 / dtau) * S[..., :-1]))


def _linear_end(chi, S, ds):
    """The last point's (A, b, psiN, bNL), each [B, 1]: the linear w2
    step with the plain-average dtau, which ends the Bezier-3 and BESSER
    sweeps."""
    dtau_end = 0.5 * (chi[..., -1] + chi[..., -2]) * ds[..., -1]
    dS_end = (S[..., -1] - S[..., -2]) / dtau_end
    w0e, w1e = w2(dtau_end)
    return ((1.0 - w0e)[..., None], (w0e * S[..., -1] - w1e * dS_end)[..., None],
            (w0e - w1e / dtau_end)[..., None],
            ((w1e / dtau_end) * S[..., -2])[..., None])


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

    return tuple(_pad0(torch.cat([x, e], dim=-1)) for x, e in
                 zip((A_bez, b_bez, Psi_bez, bNL_bez), _linear_end(chi, S, ds)))


def _sweep_coeffs_besser(chi, S, ds):
    """Affine coefficients (A, b, psiN, bNL) [B, N] of the BESSER solver,
    in sweep order: monotonic quadratic Bezier at the interior points m =
    1..N-2 (control points from m-1, m and m+1, the downwind dtau the
    plain average), the linear w2 step at m = N-1.
    ref: Source/FormalScalar.cpp:396-467
    """
    # target point m = 1..N-2: upwind interval (m-1, m), downwind (m, m+1)
    ds_uw = ds[..., :-1]
    ds_dw = ds[..., 1:]
    chi_uw = chi[..., :-2]
    chi_0 = chi[..., 1:-1]
    chi_dw = chi[..., 2:]
    chiC = besser_control_point(ds_uw, ds_dw, chi_uw, chi_0, chi_dw)
    dtau_uw = (1.0 / 3.0) * (chi_uw + chiC + chi_0) * ds_uw
    dtau_dw = 0.5 * (chi_0 + chi_dw) * ds_dw

    S_uw = S[..., :-2]
    S_0 = S[..., 1:-1]
    S_dw = S[..., 2:]
    SC = besser_control_point(dtau_uw, dtau_dw, S_uw, S_0, S_dw)
    M, O, Cc, edt = besser_coeffs(dtau_uw)
    inner = (edt, M * S_uw + O * S_0 + Cc * SC, O + Cc,
             M * S_uw + Cc * (SC - S_0))
    return tuple(_pad0(torch.cat([x, e], dim=-1)) for x, e in
                 zip(inner, _linear_end(chi, S, ds)))


_COEFF_FNS = {
    'piecewise_linear_1d': _sweep_coeffs_linear,
    'piecewise_bezier3_1d': _sweep_coeffs_bezier3,
    'piecewise_besser_1d': _sweep_coeffs_besser,
}

SOLVER_NAMES_1D = tuple(_COEFF_FNS)


CHUNK = 32     # the sweep kernel's chunk: the 32 lanes of a warp


def affine_solve(A, b, mode='sequential'):
    """Solve I_m = A_m I_{m-1} + b_m along the last axis (sweep order),
    with I_{-1} = 0 (so I_0 = b_0 when A_0 = 0).  A, b: [..., N].

    'sequential' is the loop over m.  'chunked' is the order of the CUDA
    sweep kernel (csrc/bezier3.cuh:warp_ray): chunks of CHUNK
    consecutive m, in each an inclusive Kogge-Stone scan of the affine
    maps (step s composes lane L with lane L - s: A_L A_{L-s},
    A_L b_{L-s} + b_L), then I = A_cum I_carry + b_cum with the previous
    chunk's last I carried in."""
    N = A.shape[-1]
    I = torch.empty_like(b)
    if mode == 'sequential':
        Iprev = torch.zeros_like(b[..., 0])
        for m in range(N):
            Iprev = A[..., m] * Iprev + b[..., m]
            I[..., m] = Iprev
        return I
    if mode != 'chunked':
        raise ValueError(f'unknown recurrence mode {mode!r}')
    carry = torch.zeros_like(b[..., 0])
    for c0 in range(0, N, CHUNK):
        a, bb = A[..., c0:c0 + CHUNK], b[..., c0:c0 + CHUNK]
        s = 1
        while s < CHUNK:
            a, bb = (torch.cat([a[..., :s], a[..., s:] * a[..., :-s]], -1),
                     torch.cat([bb[..., :s], a[..., s:] * bb[..., :-s]
                                + bb[..., s:]], -1))
            s *= 2
        I[..., c0:c0 + CHUNK] = a * carry[..., None] + bb
        carry = I[..., min(c0 + CHUNK, N) - 1]
    return I


def formal_sol_1d(chi, S, height, muz, I_upw, to_obs=True,
                  method='piecewise_bezier3_1d', mode='sequential'):
    """Batched 1D formal solution along depth for many rays at once.

    chi, S : [B, Ndep] opacity and source function per ray (k=0 is the top).
    height : [Ndep] geometric height (decreasing with k).
    muz : [B] |mu| of each ray.
    I_upw : [B] upwind boundary intensity at the sweep start.
    to_obs : sweep direction; True = bottom-to-top (upgoing).
    method : the solver, one of SOLVER_NAMES_1D.
    mode : affine_solve's order of the recurrence, 'sequential' (the JAX
        package's scan) or 'chunked' (the sweep kernel's).

    Returns (I, Psi, IeffBase), each [B, Ndep] in the original depth
    indexing: Psi is the diagonal approximate operator (divided by chi),
    IeffBase = A * I_upwind + bNL, the MALI effective intensity's part
    that does not cancel in optically-thick regions.
    """
    if method not in _COEFF_FNS:
        raise ValueError(f'unknown 1D formal solver {method!r}; available: '
                         f'{SOLVER_NAMES_1D}')
    if to_obs:
        chi_s, S_s, h_s = chi.flip(-1), S.flip(-1), height.flip(-1)
    else:
        chi_s, S_s, h_s = chi, S, height

    ds = torch.abs(h_s[1:] - h_s[:-1])[None, :] / muz[:, None]
    A, b, Psi, bNL = _COEFF_FNS[method](chi_s, S_s, ds)
    b[..., 0] = I_upw

    I_s = affine_solve(A, b, mode)

    # IeffBase = A * I_upwind + bNL; at the sweep start Psi = 0 and
    # IeffBase = I = I_upw
    I_shift = torch.cat([I_upw[:, None], I_s[:, :-1]], dim=-1)
    bNL[..., 0] = I_upw
    ieffb = A * I_shift + bNL

    if to_obs:
        I_s, Psi, ieffb = I_s.flip(-1), Psi.flip(-1), ieffb.flip(-1)
    return I_s, Psi / chi, ieffb
