// Depth-sweep formal solver for 1D short characteristics (cubic Bezier),
// with the angular moments of the MALI iteration.
//
// Replaces the TPU kernel lightweaver_tpu/ops/pallas_sweep.py:_sweep_kernel
// (body lane_sweep_affine).  Computes the same function as the plain
// PyTorch version in lightweaver_tpu_torch/ops/sweep.py
// (formal_solve_sweep_plain, built on ops/formal_solver.py:formal_sol_1d):
//
//   for every ray (lambda, mu, direction) of the direction-major
//   [2, NL, Nmu, Nk] layout (d = 0 sweeps down from k = 0, d = 1 up from
//   k = Nk-1):  S = srcNum / chi; Steffen-limited Bezier-3 coefficients
//   along depth (linear w2 step at the last point); the affine recurrence
//   I_m = A_m I_{m-1} + b_m from the upwind boundary value; Psi = psiN/chi
//   and IeffBase = A_m I_{m-1} + bNL_m.
//   Then, per (lambda, k), the moments with weights wmu/2:
//   J = sum_d sum_mu w I, PsiBar = sum w Psi,
//   IeffSrcBar = sum w (IeffBase + Psi srcNum).
//
// Design.  The TPU kernel rode depth on the 128 vector lanes, hence its
// lane-roll stencils, Kogge-Stone prefix and 128/RB padding; none of that
// carries over.  Here one thread owns one ray and walks depth in order,
// with the same summation order as formal_sol_1d.  It carries chi, S,
// the path lengths, dchi, dtau and dS in registers, so each step reads
// one new chi and one new srcNum value (the coefficients at m reach two
// points downwind for chi and one for S).  A block holds whole lambda
// rows (all 2*Nmu rays of each), so after a __syncthreads the same block
// reduces its rows' moments over rays in a fixed order (mu ascending
// within a direction, then down + up): deterministic, no atomics.  The
// moment pass reads with neighbouring threads on neighbouring depths.
// f64 accumulates J directly in double; the f32 state's TwoSum pair
// (Jhi, Jlo) belongs to a later float instantiation of the template.
//
// Bound on an H100.  The kernel streams 2 ray tensors in and 3 out:
// ~209 MB at FALC-500 in f64 (1046 x 5 x 2 x 500 x 8 B each), ~62 us at
// 3.35 TB/s.  But one thread per ray is only 10,460 threads, each running
// a dependent 500-step chain, so the kernel is latency-bound far above
// that, and the per-thread loads along a depth row are uncoalesced
// (neighbouring threads are Nk elements apart).  A depth-major layout or
// shared-memory staging of ray x depth tiles is the fix, left to later
// work.
//
// nvcc contracts multiply-adds into FMAs by default; the plain version's
// separate torch ops do not, so the two differ by rounding that grows
// along the chain.  The comparison tolerance states this.

#include <cuda_runtime.h>
#include <math.h>

namespace {

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

// Cubic Bezier integration coefficients (ref Bezier.hpp:81-127).
template <typename T>
__device__ __forceinline__ void bezier3_coeffs(T dt, T& a, T& b, T& g, T& d,
                                               T& e) {
    const T dt2 = dt * dt;
    const T dt3 = dt2 * dt;
    if (dt < T(5e-2)) {
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

// Block: rowsPerBlock lambda rows x (2 * Nmu) rays, one thread per ray.
template <typename T>
__global__ void sweep_kernel(const T* __restrict__ chi,
                             const T* __restrict__ src,
                             const T* __restrict__ dh,      // [Nk-1]
                             const T* __restrict__ muz,     // [Nmu]
                             const T* __restrict__ wmuHalf, // [Nmu]
                             const T* __restrict__ iupw,    // [2, NL, Nmu]
                             T* __restrict__ Iout, T* __restrict__ psiOut,
                             T* __restrict__ ieffbOut,
                             T* __restrict__ Jout, T* __restrict__ psiBarOut,
                             T* __restrict__ isBarOut,
                             int NL, int Nmu, int N, int rowsPerBlock) {
    const int raysPerRow = 2 * Nmu;
    const int tid = threadIdx.x;
    const int row0 = blockIdx.x * rowsPerBlock;
    const int l = row0 + tid / raysPerRow;
    const int rem = tid % raysPerRow;
    const int dir = rem / Nmu;
    const int imu = rem % Nmu;

    if (tid < rowsPerBlock * raysPerRow && l < NL) {
        const size_t ray = (static_cast<size_t>(dir) * NL + l) * Nmu + imu;
        const T* chiR = chi + ray * N;
        const T* srcR = src + ray * N;
        T* IR = Iout + ray * N;
        T* psiR = psiOut + ray * N;
        T* ieffbR = ieffbOut + ray * N;
        const bool up = dir == 1;
        const T mu = muz[imu];
        // depth index and path length of interval (m, m+1), sweep order m
        auto kOf = [&](int m) { return up ? N - 1 - m : m; };
        auto dsOf = [&](int m) { return dh[up ? N - 2 - m : m] / mu; };
        const T three = T(3.0);

        // sweep start: I = Iupw, Psi = 0, IeffBase = Iupw
        const T I0 = iupw[ray];
        IR[kOf(0)] = I0;
        psiR[kOf(0)] = T(0.0);
        ieffbR[kOf(0)] = I0;

        // window at m = 1: chi/S at m-1, m, m+1; ds at m-1, m
        T cm1 = chiR[kOf(0)], cm = chiR[kOf(1)], cp = chiR[kOf(2)];
        T sm1 = srcR[kOf(0)] / cm1, sm = srcR[kOf(1)] / cm;
        T sp = srcR[kOf(2)] / cp;
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
                cpp = chiR[kOf(m + 2)];
                spp = srcR[kOf(m + 2)] / cpp;
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
            const T b = alphaC * sm1 + betaC * sm + gammaC * CuwS
                        + deltaC * C0S;
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

    __syncthreads();

    // angular moments of this block's rows; neighbouring threads take
    // neighbouring depths
    const int nRows = min(rowsPerBlock, NL - row0);
    for (int idx = tid; idx < nRows * N; idx += blockDim.x) {
        const int lr = row0 + idx / N;
        const int k = idx % N;
        T J = T(0.0), psiBar = T(0.0), isBar = T(0.0);
        for (int d = 0; d < 2; ++d) {
            T Jd = T(0.0), psiD = T(0.0), isD = T(0.0);
            for (int m = 0; m < Nmu; ++m) {
                const size_t off =
                    ((static_cast<size_t>(d) * NL + lr) * Nmu + m) * N + k;
                const T w = wmuHalf[m];
                const T psi = psiOut[off];
                Jd += w * Iout[off];
                psiD += w * psi;
                isD += w * (ieffbOut[off] + psi * src[off]);
            }
            J += Jd;
            psiBar += psiD;
            isBar += isD;
        }
        const size_t o = static_cast<size_t>(lr) * N + k;
        Jout[o] = J;
        psiBarOut[o] = psiBar;
        isBarOut[o] = isBar;
    }
}

}  // namespace

extern "C" int lw_sweep_f64(const double* chi, const double* src,
                            const double* dh, const double* muz,
                            const double* wmuHalf, const double* iupw,
                            double* Iout, double* psi, double* ieffb,
                            double* J, double* psiBar, double* isBar, int NL,
                            int Nmu, int Nk, int rowsPerBlock, void* stream) {
    const int threads = rowsPerBlock * 2 * Nmu;
    const int blocks = (NL + rowsPerBlock - 1) / rowsPerBlock;
    sweep_kernel<double><<<blocks, threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        chi, src, dh, muz, wmuHalf, iupw, Iout, psi, ieffb, J, psiBar, isBar,
        NL, Nmu, Nk, rowsPerBlock);
    return static_cast<int>(cudaGetLastError());
}
