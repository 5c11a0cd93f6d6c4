// The Bezier-3 short-characteristics step shared by the depth-sweep
// kernel (sweep.cu) and the fused lambda-step kernel (fused.cu): Steffen
// derivatives, the Bezier-3 and linear-w2 weights, and the sweep of one
// ray by one warp, parallel along depth, in the order of
// ops/formal_solver.py:affine_solve(mode='chunked') (bezier3_warp_ray,
// driven by sweep_row.cuh).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace lw {

template <typename T>
__device__ __forceinline__ T sgn(T x) {
    return static_cast<T>((x > T(0)) - (x < T(0)));
}

// Steffen (1990) monotonic central derivative (ref Bezier.hpp:57-66).
template <typename T>
__device__ __forceinline__ T cent_deriv(T dsuw, T dsdw, T yuw, T y0, T ydw) {
    const T S0 = (ydw - y0) / dsdw;
    const T Suw = (y0 - yuw) / dsuw;
    const T P0 = fabs((Suw * dsdw + S0 * dsuw) / (dsdw + dsuw));
    return (sgn(S0) + sgn(Suw)) * fmin(fabs(Suw), fmin(fabs(S0), T(0.5) * P0));
}

// sum_i c_i x^i, i = 1..12, by Horner's rule in T (c_i constant-folded)
template <typename T>
__device__ __forceinline__ T series12(T x, T c1, T c2, T c3, T c4, T c5,
                                      T c6, T c7, T c8, T c9, T c10, T c11,
                                      T c12) {
    T acc = c12;
    acc = acc * x + c11;
    acc = acc * x + c10;
    acc = acc * x + c9;
    acc = acc * x + c8;
    acc = acc * x + c7;
    acc = acc * x + c6;
    acc = acc * x + c5;
    acc = acc * x + c4;
    acc = acc * x + c3;
    acc = acc * x + c2;
    acc = acc * x + c1;
    return acc * x;
}

// Cubic Bezier integration coefficients (ref Bezier.hpp:81-127).  In
// float the middle branch's closed forms cancel near its lower end
// (alpha dt^3 = 6 - e^-dt (...) ~ dt^4 / 4 against terms of 6), so for
// 5e-2 <= dt < 1 the float instance sums the same functions' power
// series instead (ops/formal_solver.py:B3_SERIES, the same coefficients);
// double keeps the closed forms, as the reference.
template <typename T>
__device__ __forceinline__ void bezier3_coeffs(T dt, T& a, T& b, T& g, T& d,
                                               T& e) {
    const T dt2 = dt * dt;
    const T dt3 = dt2 * dt;
    if (std::is_same<T, float>::value && dt >= T(5e-2) && dt < T(1.0)) {
        a = series12<T>(dt, T(1.0 / 4), T(-1.0 / 5), T(1.0 / 12),
                        T(-1.0 / 42), T(1.0 / 192), T(-1.0 / 1080),
                        T(1.0 / 7200), T(-1.0 / 55440), T(1.0 / 483840),
                        T(-1.0 / 4717440), T(1.0 / 50803200),
                        T(-1.0 / 598752000));
        b = series12<T>(dt, T(1.0 / 4), T(-1.0 / 20), T(1.0 / 120),
                        T(-1.0 / 840), T(1.0 / 6720), T(-1.0 / 60480),
                        T(1.0 / 604800), T(-1.0 / 6652800),
                        T(1.0 / 79833600), T(-1.0 / 1037836800),
                        T(1.0 / 14529715200.0), T(-1.0 / 217945728000.0));
        g = series12<T>(dt, T(1.0 / 4), T(-3.0 / 20), T(1.0 / 20),
                        T(-1.0 / 84), T(1.0 / 448), T(-1.0 / 2880),
                        T(1.0 / 21600), T(-1.0 / 184800), T(1.0 / 1774080),
                        T(-1.0 / 18869760), T(1.0 / 220147200),
                        T(-1.0 / 2794176000.0));
        d = series12<T>(dt, T(1.0 / 4), T(-1.0 / 10), T(1.0 / 40),
                        T(-1.0 / 210), T(1.0 / 1344), T(-1.0 / 10080),
                        T(1.0 / 86400), T(-1.0 / 831600), T(1.0 / 8870400),
                        T(-1.0 / 103783680), T(1.0 / 1320883200),
                        T(-1.0 / 18162144000.0));
        e = exp(-dt);
    } else if (dt < T(5e-2)) {
        a = T(0.25) * dt - T(0.2) * dt2 + dt3 / T(12.0);
        b = T(0.25) * dt - T(0.05) * dt2 + dt3 / T(120.0);
        g = T(0.25) * dt - T(0.15) * dt2 + T(0.05) * dt3;
        d = T(0.25) * dt - T(0.1) * dt2 + T(0.025) * dt3;
        e = T(1.0) - dt + T(0.5) * dt2 - dt3 / T(6.0);
    } else if (dt > T(30.0)) {
        a = T(6.0) / dt3;
        b = (T(-6.0) + T(6.0) * dt - T(3.0) * dt2 + dt3) / dt3;
        g = T(3.0) * (T(2.0) * dt - T(6.0)) / dt3;
        d = T(3.0) * (T(6.0) - T(4.0) * dt + dt2) / dt3;
        e = T(0.0);
    } else {
        const T edt = exp(-dt);
        a = (T(6.0) - edt * (T(6.0) + T(6.0) * dt + T(3.0) * dt2 + dt3)) / dt3;
        b = (T(6.0) * edt - T(6.0) + T(6.0) * dt - T(3.0) * dt2 + dt3) / dt3;
        g = T(3.0) * (T(2.0) * dt - T(6.0) + edt * (T(6.0) + T(4.0) * dt + dt2))
            / dt3;
        d = T(3.0) * (T(6.0) - T(4.0) * dt + dt2 - T(2.0) * edt * (T(3.0) + dt))
            / dt3;
        e = edt;
    }
}

// Linear short-characteristics weights (ref LwInternal.hpp:90-110).
template <typename T>
__device__ __forceinline__ void w2(T dtau, T& w0, T& w1) {
    if (dtau < T(5.0e-4)) {
        w0 = dtau * (T(1.0) - T(0.5) * dtau);
        w1 = dtau * dtau * (T(0.5) - dtau * (T(1.0) / T(3.0)));
    } else if (dtau > T(50.0)) {
        w0 = T(1.0);
        w1 = T(1.0);
    } else {
        const T expdt = exp(-dtau);
        w0 = T(1.0) - expdt;
        w1 = w0 - dtau * expdt;
    }
}

constexpr unsigned kFullWarp = 0xffffffffu;

// v of the lane `delta` below, or `edge` on the lanes that have none
template <typename T>
__device__ __forceinline__ T lane_before(T v, int delta, T edge, int lane) {
    const T u = __shfl_up_sync(kFullWarp, v, delta);
    return lane < delta ? edge : u;
}

// v of the next lane, or `edge` on lane 31
template <typename T>
__device__ __forceinline__ T lane_after(T v, T edge, int lane) {
    const T u = __shfl_down_sync(kFullWarp, v, 1);
    return lane == 31 ? edge : u;
}

// Sweep one ray of N >= 3 depths with the 32 lanes of a warp, in chunks
// of 32 consecutive sweep indices m from the upwind end (k = m for the
// down sweep, k = N-1-m for the up sweep, up == true).  Per chunk each
// lane takes one depth:
//   1. it has chi and srcNum of its depth and, prefetched, of the next
//      chunk's (coalesced loads through load(k, chi, srcNum)); the
//      neighbours the Steffen derivatives and dtau need come by shuffles:
//      two points ahead for chi and one for S from the next lanes or the
//      prefetched chunk, the point behind from the previous lane or the
//      previous chunk's last lane;
//   2. it forms its affine map I_m = A_m I_{m-1} + b_m and bNL_m, psiN_m
//      as ops/formal_solver.py:_sweep_coeffs_bezier3 does (the sweep start
//      A = 0, b = I0; Bezier-3 at the interior points; the linear w2 step
//      at m = N-1), where I0 = upwind(chi_0, chi_1) takes chi at the two
//      outermost sweep indices (lanes 0 and 1 of the first chunk, by
//      shuffle; a thermalised boundary needs their dtau);
//   3. a 5-step Kogge-Stone scan composes the maps over the chunk, and
//      the last lane's I carries into the next chunk;
//   4. it forms I, Psi = psiN / chi and IeffBase = A I_{m-1} + bNL and
//      hands them to emit(k, valid, I, Psi, IeffBase, srcNum), which every
//      lane of every chunk calls (valid is false past the ray's end), so
//      emit may hold a block barrier when all warps sweep N depths.
// dh[k] = |h[k] - h[k+1]|, mu the ray's direction cosine.
template <typename T, typename Load, typename Upwind, typename Emit>
__device__ __forceinline__ void bezier3_warp_ray(const Load& load,
                                                 const T* __restrict__ dh,
                                                 T mu, int N, bool up,
                                                 const Upwind& upwind,
                                                 const Emit& emit) {
    const int lane = threadIdx.x & 31;
    const T three = T(3.0);
    auto kOf = [&](int m) { return up ? N - 1 - m : m; };
    // chi, srcNum, S at sweep index m and the path length of interval
    // (m, m+1); harmless dummies past the ray's end
    auto fetch = [&](int m, T& c, T& src, T& S, T& ds) {
        if (m < N) {
            load(kOf(m), c, src);
        } else {
            c = T(1.0);
            src = T(0.0);
        }
        S = src / c;
        ds = m < N - 1 ? dh[up ? N - 2 - m : m] / mu : T(1.0);
    };
    // Steffen derivative at sweep index q, one-sided at the two ends
    auto deriv = [&](int q, T dsL, T dsR, T yL, T y0, T yR) {
        return q == 0 ? (yR - y0) / dsR
             : q == N - 1 ? (y0 - yL) / dsL
             : cent_deriv(dsL, dsR, yL, y0, yR);
    };

    T c, src, S, ds;
    fetch(lane, c, src, S, ds);
    const T I0 = upwind(__shfl_sync(kFullWarp, c, 0),
                        __shfl_sync(kFullWarp, c, 1));
    // the previous chunk's last point (unused in the first chunk)
    T cPrev = T(1.0), sPrev = T(0.0), dsPrev = T(1.0), dtauPrev = T(1.0),
      dSPrev = T(0.0), Icarry = T(0.0);
    for (int base = 0; base < N; base += 32) {
        const int m = base + lane;
        T cN, srcN, SN, dsN;
        fetch(m + 32, cN, srcN, SN, dsN);

        const T cM1 = lane_before(c, 1, cPrev, lane);
        const T sM1 = lane_before(S, 1, sPrev, lane);
        const T dsM1 = lane_before(ds, 1, dsPrev, lane);
        const T cP1 = lane_after(c, __shfl_sync(kFullWarp, cN, 0), lane);
        const T sP1 = lane_after(S, __shfl_sync(kFullWarp, SN, 0), lane);
        const T dsP1 = lane_after(ds, __shfl_sync(kFullWarp, dsN, 0), lane);
        // two ahead: lanes 30 and 31 from the next chunk (every lane
        // takes part in both shuffles)
        const T cNext2 = __shfl_sync(kFullWarp, cN, (lane + 2) & 31);
        const T cHere2 = __shfl_down_sync(kFullWarp, c, 2);
        const T cP2 = lane >= 30 ? cNext2 : cHere2;

        // chi derivatives at m and m+1, dtau of interval (m, m+1)
        const T dchi = deriv(m, dsM1, ds, cM1, c, cP1);
        const T dchiP = deriv(m + 1, ds, dsP1, c, cP1, cP2);
        const T Cuw = c + (ds / three) * dchi;
        const T C0 = cP1 - (ds / three) * dchiP;
        const T dtau = ds * (c + cP1 + Cuw + C0) * T(0.25);
        const T dtauM1 = lane_before(dtau, 1, dtauPrev, lane);
        // S derivative at m
        const T dS = m == 0 ? (sP1 - S) / dtau
                            : cent_deriv(dtauM1, dtau, sM1, S, sP1);
        const T dSM1 = lane_before(dS, 1, dSPrev, lane);

        T A, b, psiN, bNL;
        if (m == 0) {
            A = T(0.0);
            b = I0;
            psiN = T(0.0);
            bNL = I0;
        } else if (m <= N - 2) {
            T alphaC, betaC, gammaC, deltaC, edt;
            bezier3_coeffs(dtauM1, alphaC, betaC, gammaC, deltaC, edt);
            const T CuwS = sM1 + (dtauM1 / three) * dSM1;
            const T C0S = S - (dtauM1 / three) * dS;
            A = edt;
            b = alphaC * sM1 + betaC * S + gammaC * CuwS + deltaC * C0S;
            psiN = betaC + deltaC;
            bNL = alphaC * sM1 + gammaC * CuwS - deltaC * (dtauM1 / three) * dS;
        } else if (m == N - 1) {
            const T dtauE = T(0.5) * (c + cM1) * dsM1;
            const T dSE = (S - sM1) / dtauE;
            T w0e, w1e;
            w2(dtauE, w0e, w1e);
            A = T(1.0) - w0e;
            b = w0e * S - w1e * dSE;
            psiN = w0e - w1e / dtauE;
            bNL = (w1e / dtauE) * sM1;
        } else {
            A = T(1.0);
            b = psiN = bNL = T(0.0);
        }

        // Kogge-Stone: lane L ends with the composite map of m = base..L
        T Ac = A, bc = b;
#pragma unroll
        for (int off = 1; off < 32; off *= 2) {
            const T Au = __shfl_up_sync(kFullWarp, Ac, off);
            const T bu = __shfl_up_sync(kFullWarp, bc, off);
            if (lane >= off) {
                bc = Ac * bu + bc;
                Ac = Ac * Au;
            }
        }
        const T I = Ac * Icarry + bc;
        const T Iupw = lane_before(I, 1, Icarry, lane);
        emit(kOf(m), m < N, I, m == 0 ? T(0.0) : psiN / c,
             A * Iupw + bNL, src);

        cPrev = __shfl_sync(kFullWarp, c, 31);
        sPrev = __shfl_sync(kFullWarp, S, 31);
        dsPrev = __shfl_sync(kFullWarp, ds, 31);
        dtauPrev = __shfl_sync(kFullWarp, dtau, 31);
        dSPrev = __shfl_sync(kFullWarp, dS, 31);
        Icarry = __shfl_sync(kFullWarp, I, 31);
        c = cN;
        src = srcN;
        S = SN;
        ds = dsN;
    }
}

}  // namespace lw
