// One lambda row per block: the sweep of its 2 Nmu rays by the solver S
// (linear, Bezier-3 or BESSER), a warp per ray (bezier3.cuh:warp_ray),
// and their angular moments, in one pass.  Shared by the depth-sweep
// kernel (sweep.cu, rays read from chi and srcNum) and the fused
// lambda-step kernel (fused.cu, Bezier-3, rays assembled from line
// slots); each supplies a Rays type with
//
//   load(ray, l, k, chi, srcNum)   chi and srcNum of ray `ray` (the index
//                                  into the direction-major [2, NL, Nmu]
//                                  rays) of row l at depth k;
//   upwind(ray, l, dir, imu, mu, chi0, chi1)
//                                  the ray's upwind boundary value, given
//                                  chi at its two outermost depths.
//
// Rays per pass.  A block has R = ceil(2 Nmu / P) warps, P =
// ceil(2 Nmu / 32) passes (rays_per_pass): up to 16 rays per direction
// one pass with a warp per ray, more in P passes over the rays in order
// (d Nmu + mu).  In the last pass a warp without a ray sweeps the row's
// last ray again with its stores and moments masked, so that every warp
// meets each chunk's barrier.
//
// Moments.  Per chunk of 32 depths the warps put w I, w Psi and
// w (IeffBase + Psi srcNum) of their depths in a shared tile; after one
// barrier 64 threads add them over the pass's rays of their direction, mu
// ascending, into per-direction, per-depth accumulators in shared memory
// (a direction's first ray starts its sums; later passes add to them), so
// every pass count sums in the order of one pass: J = sum fl(w I) in
// double, the others in T.  The tiles alternate, so the next chunk writes
// one while the other is summed; the barrier counter runs across passes.
// The block ends by writing J, PsiBar, IBar (float instance) and
// IeffSrcBar as down + up.  Nothing is read back from device memory and
// there are no atomics.
//
// Shared memory: 16 Nk + 2 NA Nk sizeof(T) + 2 x 3 x 32 R sizeof(T) bytes
// (NA = 2 moment rows in double, 3 in float; smem_bytes, mirrored by
// ops/sweep.py:smem_bytes); past kMaxSmem the launch is refused.
#pragma once

#include "bezier3.cuh"

#include <type_traits>

namespace lw {

constexpr int kMaxSmem = 232448;   // 227 KB, the most an H100 block may have
constexpr int kMaxRaysPerPass = 32;   // warps of a 1024-thread block

// rays' w I, w Psi, w (IeffBase + Psi srcNum)
constexpr int kNQ = 3;

template <typename T>
__host__ __device__ constexpr int accRows() {   // PsiBar, IeffSrcBar (+ IBar)
    return std::is_same<T, double>::value ? 2 : 3;
}

inline int rays_per_pass(int Nmu) {
    const int nRays = 2 * Nmu;
    const int passes = (nRays + kMaxRaysPerPass - 1) / kMaxRaysPerPass;
    return (nRays + passes - 1) / passes;
}

template <typename T>
size_t smem_bytes(int Nmu, int N) {
    return sizeof(double) * 2 * N + sizeof(T) * 2 * accRows<T>() * N
           + sizeof(T) * 2 * kNQ * 32 * rays_per_pass(Nmu);
}

// Block l = blockIdx.x, blockDim.x = 32 rays_per_pass(Nmu).  iBarOut is
// written by the float instance only (the double one's IBar is J).
template <int S, typename T, typename Rays>
__device__ __forceinline__ void sweep_row(
    const Rays& rays, const T* __restrict__ dh,  // [N-1]
    const T* __restrict__ muz, const T* __restrict__ wmuHalf,  // [Nmu]
    T* __restrict__ Iout, T* __restrict__ psiOut, T* __restrict__ ieffbOut,
    double* __restrict__ Jout, T* __restrict__ psiBarOut,
    T* __restrict__ iBarOut, T* __restrict__ isBarOut, int NL, int Nmu,
    int N) {
    constexpr bool kIBar = !std::is_same<T, double>::value;
    constexpr int NA = accRows<T>();
    extern __shared__ __align__(16) unsigned char smRaw[];
    double* accJ = reinterpret_cast<double*>(smRaw);     // [2][N]
    T* acc = reinterpret_cast<T*>(accJ + 2 * N);         // [2][NA][N]
    T* tiles = acc + 2 * NA * N;                         // [2][kNQ][R][32]

    const int l = blockIdx.x;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int R = blockDim.x >> 5;
    const int nRays = 2 * Nmu;
    int barrier = 0;
    for (int r0 = 0; r0 < nRays; r0 += R) {
        const bool active = r0 + warp < nRays;
        const int r = active ? r0 + warp : nRays - 1;
        const int dir = r / Nmu, imu = r % Nmu;
        const size_t ray = (static_cast<size_t>(dir) * NL + l) * Nmu + imu;
        T* IR = Iout + ray * N;
        T* psiR = psiOut + ray * N;
        T* ieffbR = ieffbOut + ray * N;
        const T w = wmuHalf[imu];
        const T mu = muz[imu];

        int chunk = 0;
        const auto load = [&](int k, T& c, T& s) {
            rays.load(ray, l, k, c, s);
        };
        const auto upwind = [&](T c0, T c1) {
            return rays.upwind(ray, l, dir, imu, mu, c0, c1);
        };
        const auto emit = [&](int k, bool valid, T I, T psi, T ieffb,
                              T srcv) {
            if (valid && active) {
                IR[k] = I;
                psiR[k] = psi;
                ieffbR[k] = ieffb;
            }
            T* tile = tiles + (barrier & 1) * kNQ * R * 32;
            tile[(0 * R + warp) * 32 + lane] = w * I;
            tile[(1 * R + warp) * 32 + lane] = w * psi;
            tile[(2 * R + warp) * 32 + lane] = w * (ieffb + psi * srcv);
            __syncthreads();
            if (threadIdx.x < 64) {
                const int d = threadIdx.x >> 5, ln = threadIdx.x & 31;
                // this pass's rays of direction d
                const int lo = max(r0, d * Nmu);
                const int hi = min(min(r0 + R, nRays), (d + 1) * Nmu);
                const int m = chunk * 32 + ln;
                if (lo < hi && m < N) {
                    const int kk = d ? N - 1 - m : m;
                    const bool first = lo == d * Nmu;
                    T* accD = acc + d * NA * N + kk;
                    double Jd = first ? 0.0 : accJ[d * N + kk];
                    T psiD = first ? T(0.0) : accD[0];
                    T isD = first ? T(0.0) : accD[N];
                    T iD = T(0.0);
                    if constexpr (kIBar) iD = first ? T(0.0) : accD[2 * N];
                    for (int q = lo; q < hi; ++q) {
                        const int t = q - r0;
                        const T wI = tile[(0 * R + t) * 32 + ln];
                        Jd += static_cast<double>(wI);
                        if constexpr (kIBar) iD += wI;
                        psiD += tile[(1 * R + t) * 32 + ln];
                        isD += tile[(2 * R + t) * 32 + ln];
                    }
                    accJ[d * N + kk] = Jd;
                    accD[0] = psiD;
                    accD[N] = isD;
                    if constexpr (kIBar) accD[2 * N] = iD;
                }
            }
            ++chunk;
            ++barrier;
        };
        warp_ray<S, T>(load, dh, mu, N, dir == 1, upwind, emit);
    }
    __syncthreads();

    for (int k = threadIdx.x; k < N; k += blockDim.x) {
        const size_t o = static_cast<size_t>(l) * N + k;
        Jout[o] = accJ[k] + accJ[N + k];
        psiBarOut[o] = acc[k] + acc[NA * N + k];
        isBarOut[o] = acc[N + k] + acc[(NA + 1) * N + k];
        if constexpr (kIBar)
            iBarOut[o] = acc[2 * N + k] + acc[(NA + 2) * N + k];
    }
}

// Launch `Kernel` over NL rows with 32 rays_per_pass(Nmu) threads and
// its shared memory; cudaErrorInvalidValue for shapes it does not take.
// The kernel is a template argument, so that each kernel keeps its own
// record of the shared memory it was allowed.
template <typename T, auto Kernel, typename... Args>
int launch_rows(int NL, int Nmu, int N, void* stream, Args... args) {
    const size_t smem = smem_bytes<T>(Nmu, N);
    if (N < 3 || Nmu < 1 || NL < 1 || smem > kMaxSmem)
        return static_cast<int>(cudaErrorInvalidValue);
    static size_t smemSet = 48 * 1024;   // per kernel
    if (smem > smemSet) {
        const cudaError_t e = cudaFuncSetAttribute(
            Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (e != cudaSuccess) return static_cast<int>(e);
        smemSet = smem;
    }
    Kernel<<<NL, 32 * rays_per_pass(Nmu), smem,
             static_cast<cudaStream_t>(stream)>>>(args...);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace lw
