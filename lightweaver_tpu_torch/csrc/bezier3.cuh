// The Bezier-3 short-characteristics step shared by the depth-sweep
// kernel (sweep.cu) and the fused lambda-step kernel (fused.cu): Steffen
// derivatives, the Bezier-3 and linear-w2 weights, and the sweep of one
// ray in the summation order of ops/formal_solver.py:formal_sol_1d.
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

// Sweep one ray of N >= 3 depths from its upwind boundary value I0:
// d = 0 (up == false) runs k = 0 .. N-1, d = 1 runs k = N-1 .. 0.
// load(k, chi, S) gives the opacity and source function at depth k;
// dh[k] = |h[k] - h[k+1]|, mu the ray's direction cosine.  Writes I,
// Psi = psiN / chi and IeffBase = A I_upwind + bNL at every depth.
//
// The thread carries chi, S, the path lengths, dchi, dtau and dS in
// registers: the coefficients at m reach two points downwind for chi and
// one for S, so each step loads one new depth.
template <typename T, typename Load>
__device__ __forceinline__ void bezier3_ray(const Load& load,
                                            const T* __restrict__ dh, T mu,
                                            int N, bool up, T I0,
                                            T* __restrict__ IR,
                                            T* __restrict__ psiR,
                                            T* __restrict__ ieffbR) {
    // depth index and path length of interval (m, m+1), sweep order m
    auto kOf = [&](int m) { return up ? N - 1 - m : m; };
    auto dsOf = [&](int m) { return dh[up ? N - 2 - m : m] / mu; };
    const T three = T(3.0);

    // sweep start: I = Iupw, Psi = 0, IeffBase = Iupw
    IR[kOf(0)] = I0;
    psiR[kOf(0)] = T(0.0);
    ieffbR[kOf(0)] = I0;

    // window at m = 1: chi/S at m-1, m, m+1; ds at m-1, m
    T cm1, cm, cp, sm1, sm, sp;
    load(kOf(0), cm1, sm1);
    load(kOf(1), cm, sm);
    load(kOf(2), cp, sp);
    T dsm1 = dsOf(0), dsm = dsOf(1);
    T dchim1 = (cm - cm1) / dsm1;
    T dchim = cent_deriv(dsm1, dsm, cm1, cm, cp);
    T dtaum1;
    {
        const T Cuw = cm1 + (dsm1 / three) * dchim1;
        const T C0 = cm - (dsm1 / three) * dchim;
        dtaum1 = dsm1 * (cm1 + cm + Cuw + C0) * T(0.25);
    }
    T dSm1 = (sm - sm1) / dtaum1;
    T Iprev = I0;

    // interior points m = 1..N-2: Bezier-3 over the upwind interval
    for (int m = 1; m <= N - 2; ++m) {
        T cpp = cp, spp = sp, dsp = dsm;
        const bool hasNext = m + 2 <= N - 1;
        if (hasNext) {
            load(kOf(m + 2), cpp, spp);
            dsp = dsOf(m + 1);
        }
        const T dchip = hasNext ? cent_deriv(dsm, dsp, cm, cp, cpp)
                                : (cp - cm) / dsm;
        const T Cuw = cm + (dsm / three) * dchim;
        const T C0 = cp - (dsm / three) * dchip;
        const T dtaum = dsm * (cm + cp + Cuw + C0) * T(0.25);
        const T dSm = cent_deriv(dtaum1, dtaum, sm1, sm, sp);

        T alphaC, betaC, gammaC, deltaC, edt;
        bezier3_coeffs(dtaum1, alphaC, betaC, gammaC, deltaC, edt);
        const T CuwS = sm1 + (dtaum1 / three) * dSm1;
        const T C0S = sm - (dtaum1 / three) * dSm;
        const T b = alphaC * sm1 + betaC * sm + gammaC * CuwS + deltaC * C0S;
        const T psiN = betaC + deltaC;
        const T bNL = alphaC * sm1 + gammaC * CuwS
                      - deltaC * (dtaum1 / three) * dSm;
        const T Inew = edt * Iprev + b;
        const int k = kOf(m);
        IR[k] = Inew;
        psiR[k] = psiN / cm;
        ieffbR[k] = edt * Iprev + bNL;

        cm1 = cm; cm = cp; cp = cpp;
        sm1 = sm; sm = sp; sp = spp;
        dsm1 = dsm; dsm = dsp;
        dchim1 = dchim; dchim = dchip;
        dtaum1 = dtaum; dSm1 = dSm;
        Iprev = Inew;
    }

    // final point: linear step with plain-average dtau
    {
        const T dtauE = T(0.5) * (cm + cm1) * dsm1;
        const T dSE = (sm - sm1) / dtauE;
        T w0e, w1e;
        w2(dtauE, w0e, w1e);
        const T A = T(1.0) - w0e;
        const T b = w0e * sm - w1e * dSE;
        const T psiN = w0e - w1e / dtauE;
        const T bNL = (w1e / dtauE) * sm1;
        const int k = kOf(N - 1);
        IR[k] = A * Iprev + b;
        psiR[k] = psiN / cm;
        ieffbR[k] = A * Iprev + bNL;
    }
}

}  // namespace lw
