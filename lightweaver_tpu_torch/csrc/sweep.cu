// Depth-sweep formal solver for 1D short characteristics (cubic Bezier),
// with the angular moments of the MALI iteration.
//
// Replaces the TPU kernel lightweaver_tpu/ops/pallas_sweep.py:_sweep_kernel
// (body lane_sweep_affine), in two instances: float64 (lw_sweep_f64) and
// float32 (lw_sweep_f32), the precision the TPU runs it in.  Computes the
// same function as the plain PyTorch version in
// lightweaver_tpu_torch/ops/sweep.py (formal_solve_sweep_plain, built on
// ops/formal_solver.py:formal_sol_1d):
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
// with the same summation order as formal_sol_1d (the per-ray step is
// bezier3.cuh:bezier3_ray, shared with fused.cu).  It carries chi, S,
// the path lengths, dchi, dtau and dS in registers, so each step reads
// one new chi and one new srcNum value (the coefficients at m reach two
// points downwind for chi and one for S).  A block holds whole lambda
// rows (all 2*Nmu rays of each), so after a __syncthreads the same block
// reduces its rows' moments over rays in a fixed order (mu ascending
// within a direction, then down + up): deterministic, no atomics.  The
// moment pass reads with neighbouring threads on neighbouring depths.
// J is accumulated in a double register in both instances: in float64
// from the products w I, in float32 from the float products fl32(w I),
// so J = sum fl32(w I) to double rounding (the TPU kernel's TwoSum pair
// Jhi + Jlo met the same contract, ~2^-48 relative, without f64).  The
// other moments accumulate in the working type, as on the TPU; the float
// instance writes IBar = sum w I in float beside J, the double one has
// IBar = J.
//
// Bound on an H100.  The kernel streams 2 ray tensors in and 3 out:
// ~209 MB at FALC-500 in f64 (1046 x 5 x 2 x 500 x 8 B each), ~62 us at
// 3.35 TB/s, and half of it, ~105 MB and ~31 us, in float32.  But one
// thread per ray is only 10,460 threads, each running a dependent
// 500-step chain, so the kernel is latency-bound far above
// that, and the per-thread loads along a depth row are uncoalesced
// (neighbouring threads are Nk elements apart).  A depth-major layout or
// shared-memory staging of ray x depth tiles is the fix, left to later
// work.
//
// nvcc contracts multiply-adds into FMAs by default; the plain version's
// separate torch ops do not, so the two differ by rounding that grows
// along the chain.  The comparison tolerance states this.

#include "bezier3.cuh"

#include <type_traits>

namespace {

// Block: rowsPerBlock lambda rows x (2 * Nmu) rays, one thread per ray.
// iBarOut is written by the float instance only (the double one's IBar is
// J itself).
template <typename T>
__global__ void sweep_kernel(const T* __restrict__ chi,
                             const T* __restrict__ src,
                             const T* __restrict__ dh,      // [Nk-1]
                             const T* __restrict__ muz,     // [Nmu]
                             const T* __restrict__ wmuHalf, // [Nmu]
                             const T* __restrict__ iupw,    // [2, NL, Nmu]
                             T* __restrict__ Iout, T* __restrict__ psiOut,
                             T* __restrict__ ieffbOut,
                             double* __restrict__ Jout,
                             T* __restrict__ psiBarOut,
                             T* __restrict__ iBarOut,
                             T* __restrict__ isBarOut,
                             int NL, int Nmu, int N, int rowsPerBlock) {
    constexpr bool kIBar = !std::is_same<T, double>::value;
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
        const auto load = [&](int k, T& c, T& S) {
            c = chiR[k];
            S = srcR[k] / c;
        };
        lw::bezier3_ray<T>(load, dh, muz[imu], N, dir == 1, iupw[ray], IR,
                           psiR, ieffbR);
    }

    __syncthreads();

    // angular moments of this block's rows; neighbouring threads take
    // neighbouring depths
    const int nRows = min(rowsPerBlock, NL - row0);
    for (int idx = tid; idx < nRows * N; idx += blockDim.x) {
        const int lr = row0 + idx / N;
        const int k = idx % N;
        double J = 0.0;
        T psiBar = T(0.0), iBar = T(0.0), isBar = T(0.0);
        for (int d = 0; d < 2; ++d) {
            double Jd = 0.0;
            T psiD = T(0.0), iD = T(0.0), isD = T(0.0);
            for (int m = 0; m < Nmu; ++m) {
                const size_t off =
                    ((static_cast<size_t>(d) * NL + lr) * Nmu + m) * N + k;
                const T w = wmuHalf[m];
                const T psi = psiOut[off];
                const T wI = w * Iout[off];
                Jd += static_cast<double>(wI);
                if constexpr (kIBar) iD += wI;
                psiD += w * psi;
                isD += w * (ieffbOut[off] + psi * src[off]);
            }
            J += Jd;
            psiBar += psiD;
            iBar += iD;
            isBar += isD;
        }
        const size_t o = static_cast<size_t>(lr) * N + k;
        Jout[o] = J;
        psiBarOut[o] = psiBar;
        if constexpr (kIBar) iBarOut[o] = iBar;
        isBarOut[o] = isBar;
    }
}

template <typename T>
int launch(const T* chi, const T* src, const T* dh, const T* muz,
           const T* wmuHalf, const T* iupw, T* Iout, T* psi, T* ieffb,
           double* J, T* psiBar, T* iBar, T* isBar, int NL, int Nmu, int Nk,
           int rowsPerBlock, void* stream) {
    const int threads = rowsPerBlock * 2 * Nmu;
    const int blocks = (NL + rowsPerBlock - 1) / rowsPerBlock;
    sweep_kernel<T><<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        chi, src, dh, muz, wmuHalf, iupw, Iout, psi, ieffb, J, psiBar, iBar,
        isBar, NL, Nmu, Nk, rowsPerBlock);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lw_sweep_f64(const double* chi, const double* src,
                            const double* dh, const double* muz,
                            const double* wmuHalf, const double* iupw,
                            double* Iout, double* psi, double* ieffb,
                            double* J, double* psiBar, double* isBar, int NL,
                            int Nmu, int Nk, int rowsPerBlock, void* stream) {
    return launch<double>(chi, src, dh, muz, wmuHalf, iupw, Iout, psi, ieffb,
                          J, psiBar, nullptr, isBar, NL, Nmu, Nk,
                          rowsPerBlock, stream);
}

extern "C" int lw_sweep_f32(const float* chi, const float* src,
                            const float* dh, const float* muz,
                            const float* wmuHalf, const float* iupw,
                            float* Iout, float* psi, float* ieffb, double* J,
                            float* psiBar, float* iBar, float* isBar, int NL,
                            int Nmu, int Nk, int rowsPerBlock, void* stream) {
    return launch<float>(chi, src, dh, muz, wmuHalf, iupw, Iout, psi, ieffb,
                         J, psiBar, iBar, isBar, NL, Nmu, Nk, rowsPerBlock,
                         stream);
}
