// Depth-sweep formal solver for 1D short characteristics (cubic Bezier),
// with the angular moments of the MALI iteration.
//
// Replaces the TPU kernel lightweaver_tpu/ops/pallas_sweep.py:_sweep_kernel
// (body lane_sweep_affine; the pallas_call at line 297), in two instances:
// float64 (lw_sweep_f64) and float32 (lw_sweep_f32), the precision the TPU
// runs it in.  Computes the same function as the plain PyTorch version in
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
// Design.  The Bezier-3 coefficients at a depth depend on chi and S near
// it, never on I; only the recurrence is sequential, and it is
// associative.  The TPU kernel rode depth on the 128 vector lanes with a
// Kogge-Stone prefix; here one block takes one lambda row and each of its
// 2 Nmu rays gets a warp (320 threads at Nmu = 5), which walks the ray
// from its upwind end in chunks of 32 consecutive depths
// (bezier3.cuh:bezier3_warp_ray): coalesced loads of chi and srcNum with
// the next chunk prefetched, the stencil neighbours by shuffles, each
// lane's (A, b, bNL, psiN), a 5-step warp scan of the affine maps with
// the last I carried into the next chunk, and coalesced stores of I, Psi
// and IeffBase.  The recurrence is summed in the order of
// ops/formal_solver.py:affine_solve(mode='chunked').  The moments never
// read a ray output back from device memory: per chunk the warps put
// w I, w Psi and w (IeffBase + Psi srcNum) of their 32 depths in a shared
// tile; after one barrier, 64 threads sum it over mu in a fixed order
// (mu ascending within a direction) into per-direction, per-depth
// accumulators in shared memory ([2][Nk] doubles for J, [2][2 or 3][Nk]
// of T), and the block ends by writing J, PsiBar, IBar and IeffSrcBar as
// down + up.  Deterministic, no atomics.  J is summed in double in both
// instances: in float32 from the float products fl32(w I), so J =
// sum fl32(w I) to double rounding (the TPU kernel's TwoSum pair Jhi +
// Jlo met the same contract, ~2^-48 relative, without f64).  The other
// moments accumulate in the working type; the float instance writes
// IBar = sum w I in float beside J, the double one has IBar = J.
//
// Any Nk >= 3: the dynamic shared memory grows as 48 Nk + 3072 Nmu bytes
// in float64 (40 Nk + 1536 Nmu in float32; ops/sweep.py:smem_bytes);
// past the 227 KB a block may have (Nk ~4,500 at Nmu = 5 in float64) the
// launch is refused.
//
// Bound on an H100: bytes.  The kernel streams 2 ray tensors in and 3
// out, ~209 MB at FALC-500 in f64 (1046 x 5 x 2 x 500 x 8 B each), ~62 us
// at 3.35 TB/s, and half of it in float32.  At Nk = 82 and on the
// 416-row PRD subset the bound is a few microseconds, below a launch's
// own latency; there the time is each block's chain of ceil(Nk/32)
// dependent chunks.
//
// nvcc contracts multiply-adds into FMAs by default; the plain version's
// separate torch ops do not, and the scan sums the recurrence in another
// order than the plain sequential loop, so the two differ by rounding.
// The comparison tolerance states this.

#include "bezier3.cuh"

#include <type_traits>

namespace {

constexpr int kMaxSmem = 232448;   // 227 KB, the most a block may have

// rays' w I, w Psi, w (IeffBase + Psi srcNum)
constexpr int kNQ = 3;

template <typename T>
__host__ __device__ constexpr int accRows() {   // PsiBar, IeffSrcBar (+ IBar)
    return std::is_same<T, double>::value ? 2 : 3;
}

template <typename T>
size_t smem_bytes(int Nmu, int N) {
    return sizeof(double) * 2 * N + sizeof(T) * 2 * accRows<T>() * N
           + sizeof(T) * 2 * kNQ * 2 * Nmu * 32;
}

// Block: one lambda row l, 2 Nmu warps, warp = d Nmu + mu.  iBarOut is
// written by the float instance only (the double one's IBar is J).
template <typename T>
__global__ void __launch_bounds__(1024)
    sweep_kernel(const T* __restrict__ chi, const T* __restrict__ src,
                 const T* __restrict__ dh,       // [Nk-1]
                 const T* __restrict__ muz,      // [Nmu]
                 const T* __restrict__ wmuHalf,  // [Nmu]
                 const T* __restrict__ iupw,     // [2, NL, Nmu]
                 T* __restrict__ Iout, T* __restrict__ psiOut,
                 T* __restrict__ ieffbOut, double* __restrict__ Jout,
                 T* __restrict__ psiBarOut, T* __restrict__ iBarOut,
                 T* __restrict__ isBarOut, int NL, int Nmu, int N) {
    constexpr bool kIBar = !std::is_same<T, double>::value;
    constexpr int NA = accRows<T>();
    extern __shared__ __align__(16) unsigned char smRaw[];
    double* accJ = reinterpret_cast<double*>(smRaw);     // [2][N]
    T* acc = reinterpret_cast<T*>(accJ + 2 * N);         // [2][NA][N]
    T* tiles = acc + 2 * NA * N;                         // [2][kNQ][nRays][32]

    const int l = blockIdx.x;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int nRays = 2 * Nmu;
    const int dir = warp / Nmu, imu = warp % Nmu;
    const size_t ray = (static_cast<size_t>(dir) * NL + l) * Nmu + imu;
    const T* chiR = chi + ray * N;
    const T* srcR = src + ray * N;
    T* IR = Iout + ray * N;
    T* psiR = psiOut + ray * N;
    T* ieffbR = ieffbOut + ray * N;
    const T w = wmuHalf[imu];

    int chunk = 0;
    const auto load = [&](int k, T& c, T& s) {
        c = chiR[k];
        s = srcR[k];
    };
    const auto emit = [&](int k, bool valid, T I, T psi, T ieffb, T srcv) {
        if (valid) {
            IR[k] = I;
            psiR[k] = psi;
            ieffbR[k] = ieffb;
        }
        T* tile = tiles + (chunk & 1) * kNQ * nRays * 32;
        tile[(0 * nRays + warp) * 32 + lane] = w * I;
        tile[(1 * nRays + warp) * 32 + lane] = w * psi;
        tile[(2 * nRays + warp) * 32 + lane] = w * (ieffb + psi * srcv);
        // one barrier per chunk: the tiles alternate, so the next chunk
        // writes the other one while this one is summed
        __syncthreads();
        if (threadIdx.x < 64) {
            const int d = threadIdx.x >> 5, ln = threadIdx.x & 31;
            const int m = chunk * 32 + ln;
            if (m < N) {
                const int kk = d ? N - 1 - m : m;
                double Jd = 0.0;
                T iD = T(0.0), psiD = T(0.0), isD = T(0.0);
                for (int mu = 0; mu < Nmu; ++mu) {
                    const int r = d * Nmu + mu;
                    const T wI = tile[(0 * nRays + r) * 32 + ln];
                    Jd += static_cast<double>(wI);
                    if constexpr (kIBar) iD += wI;
                    psiD += tile[(1 * nRays + r) * 32 + ln];
                    isD += tile[(2 * nRays + r) * 32 + ln];
                }
                accJ[d * N + kk] = Jd;
                acc[(d * NA + 0) * N + kk] = psiD;
                acc[(d * NA + 1) * N + kk] = isD;
                if constexpr (kIBar) acc[(d * NA + 2) * N + kk] = iD;
            }
        }
        ++chunk;
    };
    lw::bezier3_warp_ray<T>(load, dh, muz[imu], N, dir == 1, iupw[ray],
                            emit);
    __syncthreads();

    for (int k = threadIdx.x; k < N; k += blockDim.x) {
        const size_t o = static_cast<size_t>(l) * N + k;
        Jout[o] = accJ[k] + accJ[N + k];
        psiBarOut[o] = acc[k] + acc[NA * N + k];
        isBarOut[o] = acc[N + k] + acc[(NA + 1) * N + k];
        if constexpr (kIBar) iBarOut[o] = acc[2 * N + k] + acc[(NA + 2) * N + k];
    }
}

template <typename T>
int launch(const T* chi, const T* src, const T* dh, const T* muz,
           const T* wmuHalf, const T* iupw, T* Iout, T* psi, T* ieffb,
           double* J, T* psiBar, T* iBar, T* isBar, int NL, int Nmu, int Nk,
           void* stream) {
    const size_t smem = smem_bytes<T>(Nmu, Nk);
    if (Nk < 3 || Nmu < 1 || 64 * Nmu > 1024 || smem > kMaxSmem)
        return static_cast<int>(cudaErrorInvalidValue);
    static size_t smemSet = 48 * 1024;
    if (smem > smemSet) {
        const cudaError_t e = cudaFuncSetAttribute(
            sweep_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
        smemSet = smem;
    }
    sweep_kernel<T><<<NL, 64 * Nmu, smem, static_cast<cudaStream_t>(stream)>>>(
        chi, src, dh, muz, wmuHalf, iupw, Iout, psi, ieffb, J, psiBar, iBar,
        isBar, NL, Nmu, Nk);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lw_sweep_f64(const double* chi, const double* src,
                            const double* dh, const double* muz,
                            const double* wmuHalf, const double* iupw,
                            double* Iout, double* psi, double* ieffb,
                            double* J, double* psiBar, double* isBar, int NL,
                            int Nmu, int Nk, void* stream) {
    return launch<double>(chi, src, dh, muz, wmuHalf, iupw, Iout, psi, ieffb,
                          J, psiBar, nullptr, isBar, NL, Nmu, Nk, stream);
}

extern "C" int lw_sweep_f32(const float* chi, const float* src,
                            const float* dh, const float* muz,
                            const float* wmuHalf, const float* iupw,
                            float* Iout, float* psi, float* ieffb, double* J,
                            float* psiBar, float* iBar, float* isBar, int NL,
                            int Nmu, int Nk, void* stream) {
    return launch<float>(chi, src, dh, muz, wmuHalf, iupw, Iout, psi, ieffb,
                         J, psiBar, iBar, isBar, NL, Nmu, Nk, stream);
}
