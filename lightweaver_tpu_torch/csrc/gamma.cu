// Line part of the MALI Gamma/rate accumulation for one same-atom overlap
// group of K lines on their union window.
//
// Replaces the TPU kernel lightweaver_tpu/ops/pallas_gamma.py:
// group_gamma_rates (inner `kernel`), in two instances: float64
// (lw_group_gamma_f64) and float32 (lw_group_gamma_f32), the precision the
// TPU runs it in.  Computes the same function as the
// plain PyTorch version lightweaver_tpu_torch/ops/gamma.py:
// group_gamma_rates_plain.  For every row r of the union window (global
// wavelength row l = row0 + r), depth k and ray (d, mu), with w = wmu/2:
//
//   Vij = a1 phi;  Vji = g rho Vij;  Uji = u Vji          (per member m)
//   chi_m = n_i Vij - n_j Vji;  etaAtom = etaC + sum_m n_j Uji
//   Ieff  = IeffBase + Psi (srcNum - etaAtom)             [compensated]
//   chi_i/chi_j/U_i/U_j = continuum level rows + signed member sums
//   Gij += w wl [(Uji + Vji Ieff) - Psi chi_i U_j];  Gji += w wl [Vij Ieff
//   - Psi chi_j U_i];  Rij += w wl I Vij;  Rji += w wl (Uji + I Vji)
//   PPB_m = sum w Psi phi_m;  PairPPB_(m,m') = sum w Psi phi_m phi_m'
//
// with wl = wlambda * 4pi/hc * wphi.  The JAX kernel takes S and chiTot;
// this one takes srcNum, which the port's gather emits and which equals
// S chiTot to one rounding.
//
// Design.  The TPU kernel ran the union window as a sequential grid of
// BW-row blocks with depth on the lanes.  Here one thread owns one depth k
// and one block of BW rows: it loops over the rows, the 2 Nmu rays and
// the members, keeps the 4K Gamma/rate partials in registers and writes
// one partial per (member, quantity, block, k); the caller sums the
// blocks in f64 (as the JAX caller does outside its kernel).  In float32
// that is the TPU kernel's contract: products and partials in float over
// at most BW rows x 2 Nmu rays, G4 written as float, the lambda sum
// finished in f64 by the caller.  PPB and
// PairPPB are written once per row.  Every load has k fastest, so a warp
// reads 32 neighbouring depths: coalesced in the direction-major
// [2, Nlam, Nmu, Nk] layout.  No atomics: the result is deterministic.
// K is a template parameter (1..4, the largest group among the repo's
// model atoms is Mg II's 4), so the per-member arrays live in registers.
//
// Bound on an H100: bytes.  Per group it reads Psi, IeffBase, I and
// srcNum on the window rows (4 x 2 Nmu Nk doubles per row) plus phi of
// each member; at FALC-500 all groups together read ~185 MB per
// iteration, ~55 us at 3.35 TB/s (half in float32).  One thread per
// (k, block) gives only Nk x ceil(Wu/BW) threads per launch (a few
// thousand), so each launch is latency-bound well above that.

#include <cuda_runtime.h>

constexpr int KMAX = 4;

// per-group statics, passed by value (ops/gamma.py:_GroupStatics)
struct GroupStatics {
    int levels[KMAX][2];       // (i, j) of each member
    int signs[KMAX][KMAX][2];  // sign of member m2's chi in m's chi_i/chi_j
    int uIn[KMAX][KMAX][2];    // member m2's Uji in m's U_i / U_j
};

namespace {

template <typename T, int K>
__global__ void group_gamma_kernel(
    const T* __restrict__ phi,      // [K, 2, Wu, Nmu, Nk]
    const T* __restrict__ rho,      // [K, Wu, Nk]
    const T* __restrict__ psi,      // [2, Nlam, Nmu, Nk]
    const T* __restrict__ ieffb,    // [2, Nlam, Nmu, Nk]
    const T* __restrict__ Iray,     // [2, Nlam, Nmu, Nk]
    const T* __restrict__ src,      // [2, Nlam, Nmu, Nk]
    const T* __restrict__ chiCL,    // [Nlev, Nlam, Nk]
    const T* __restrict__ UCL,      // [Nlev, Nlam, Nk]
    const T* __restrict__ etaC,     // [Nlam, Nk]
    const T* __restrict__ n,        // [Nlev, Nk]
    const T* __restrict__ coef,     // [K, Wu, 4]: a1, g, u, wlambda 4pi/hc
    const T* __restrict__ wphi,     // [K, Nk]
    const T* __restrict__ wmuHalf,  // [Nmu]
    T* __restrict__ G4,             // [K, 4, nBlk, Nk]
    T* __restrict__ PPB,            // [K, Wu, Nk]
    T* __restrict__ pair,           // [P, Wu, Nk]
    GroupStatics st, int Nlam, int Nmu, int Nk, int Wu, int row0, int BW) {
    constexpr int P = K * (K - 1) / 2;
    const int k = blockIdx.x * blockDim.x + threadIdx.x;
    const int blk = blockIdx.y;
    const int nBlk = gridDim.y;
    if (k >= Nk) return;

    T nI[K], nJ[K], wph[K];
#pragma unroll
    for (int m = 0; m < K; ++m) {
        nI[m] = n[st.levels[m][0] * Nk + k];
        nJ[m] = n[st.levels[m][1] * Nk + k];
        wph[m] = wphi[m * Nk + k];
    }
    T acc[K][4];
#pragma unroll
    for (int m = 0; m < K; ++m)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[m][c] = T(0.0);

    const int r1 = min(Wu, (blk + 1) * BW);
    for (int r = blk * BW; r < r1; ++r) {
        const int l = row0 + r;
        T a1[K], gR[K], uR[K], wl[K], rh[K];
        T chiCi[K], chiCj[K], UCi[K], UCj[K];
#pragma unroll
        for (int m = 0; m < K; ++m) {
            const T* cf = coef + (static_cast<size_t>(m) * Wu + r) * 4;
            a1[m] = cf[0];
            gR[m] = cf[1];
            uR[m] = cf[2];
            wl[m] = cf[3] * wph[m];
            rh[m] = rho[(static_cast<size_t>(m) * Wu + r) * Nk + k];
            const size_t li = (static_cast<size_t>(st.levels[m][0]) * Nlam + l)
                              * Nk + k;
            const size_t lj = (static_cast<size_t>(st.levels[m][1]) * Nlam + l)
                              * Nk + k;
            chiCi[m] = chiCL[li];
            chiCj[m] = chiCL[lj];
            UCi[m] = UCL[li];
            UCj[m] = UCL[lj];
        }
        const T etaCb = etaC[static_cast<size_t>(l) * Nk + k];
        T ppb[K], pp[P > 0 ? P : 1];
#pragma unroll
        for (int m = 0; m < K; ++m) ppb[m] = T(0.0);
#pragma unroll
        for (int p = 0; p < P; ++p) pp[p] = T(0.0);

        for (int d = 0; d < 2; ++d) {
            for (int mu = 0; mu < Nmu; ++mu) {
                const T w = wmuHalf[mu];
                const size_t off =
                    ((static_cast<size_t>(d) * Nlam + l) * Nmu + mu) * Nk + k;
                const T ps = psi[off];
                T ph[K], v1[K], v2[K], u2[K], chiM[K];
                T etaA = etaCb;
#pragma unroll
                for (int m = 0; m < K; ++m) {
                    ph[m] = phi[(((static_cast<size_t>(m) * 2 + d) * Wu + r)
                                 * Nmu + mu) * Nk + k];
                    v1[m] = a1[m] * ph[m];
                    v2[m] = gR[m] * v1[m] * rh[m];
                    u2[m] = uR[m] * v2[m];
                    chiM[m] = nI[m] * v1[m] - nJ[m] * v2[m];
                    etaA = etaA + nJ[m] * u2[m];
                    ppb[m] += w * ph[m] * ps;
                }
                {
                    int p = 0;
#pragma unroll
                    for (int m = 0; m < K; ++m)
#pragma unroll
                        for (int m2 = m + 1; m2 < K; ++m2)
                            pp[p++] += w * ph[m] * ph[m2] * ps;
                }
                const T Ieff = ieffb[off] + ps * (src[off] - etaA);
                const T Iw = Iray[off];
#pragma unroll
                for (int m = 0; m < K; ++m) {
                    T chi_i = chiCi[m], chi_j = chiCj[m];
                    T U_i = UCi[m], U_j = UCj[m];
#pragma unroll
                    for (int m2 = 0; m2 < K; ++m2) {
                        if (st.signs[m][m2][0])
                            chi_i += T(st.signs[m][m2][0]) * chiM[m2];
                        if (st.signs[m][m2][1])
                            chi_j += T(st.signs[m][m2][1]) * chiM[m2];
                        if (st.uIn[m][m2][0]) U_i += u2[m2];
                        if (st.uIn[m][m2][1]) U_j += u2[m2];
                    }
                    const T wlw = w * wl[m];
                    acc[m][0] += ((u2[m] + v2[m] * Ieff) - ps * chi_i * U_j)
                                 * wlw;
                    acc[m][1] += (v1[m] * Ieff - ps * chi_j * U_i) * wlw;
                    acc[m][2] += Iw * v1[m] * wlw;
                    acc[m][3] += (u2[m] + Iw * v2[m]) * wlw;
                }
            }
        }
#pragma unroll
        for (int m = 0; m < K; ++m)
            PPB[(static_cast<size_t>(m) * Wu + r) * Nk + k] = ppb[m];
#pragma unroll
        for (int p = 0; p < P; ++p)
            pair[(static_cast<size_t>(p) * Wu + r) * Nk + k] = pp[p];
    }
#pragma unroll
    for (int m = 0; m < K; ++m)
#pragma unroll
        for (int c = 0; c < 4; ++c)
            G4[((static_cast<size_t>(m) * 4 + c) * nBlk + blk) * Nk + k] =
                acc[m][c];
}

template <typename T, int K>
cudaError_t launch(const T* phi, const T* rho, const T* psi, const T* ieffb,
                   const T* I, const T* src, const T* chiCL, const T* UCL,
                   const T* etaC, const T* n, const T* coef, const T* wphi,
                   const T* wmuHalf, T* G4, T* PPB, T* pair,
                   const GroupStatics& st, int Nlam, int Nmu, int Nk, int Wu,
                   int row0, int BW, cudaStream_t stream) {
    const int threads = 128;
    const dim3 grid((Nk + threads - 1) / threads, (Wu + BW - 1) / BW);
    group_gamma_kernel<T, K><<<grid, threads, 0, stream>>>(
        phi, rho, psi, ieffb, I, src, chiCL, UCL, etaC, n, coef, wphi,
        wmuHalf, G4, PPB, pair, st, Nlam, Nmu, Nk, Wu, row0, BW);
    return cudaGetLastError();
}

template <typename T>
int launch_k(const T* phi, const T* rho, const T* psi, const T* ieffb,
             const T* I, const T* src, const T* chiCL, const T* UCL,
             const T* etaC, const T* n, const T* coef, const T* wphi,
             const T* wmuHalf, T* G4, T* PPB, T* pair, GroupStatics st,
             int K, int Nlam, int Nmu, int Nk, int Wu, int row0, int BW,
             void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LW_GROUP_LAUNCH(KK)                                                  \
    case KK:                                                                 \
        return static_cast<int>(launch<T, KK>(                               \
            phi, rho, psi, ieffb, I, src, chiCL, UCL, etaC, n, coef, wphi,   \
            wmuHalf, G4, PPB, pair, st, Nlam, Nmu, Nk, Wu, row0, BW, s));
    switch (K) {
        LW_GROUP_LAUNCH(1)
        LW_GROUP_LAUNCH(2)
        LW_GROUP_LAUNCH(3)
        LW_GROUP_LAUNCH(4)
        default:
            return static_cast<int>(cudaErrorInvalidValue);
    }
#undef LW_GROUP_LAUNCH
}

}  // namespace

extern "C" int lw_group_gamma_f64(
    const double* phi, const double* rho, const double* psi,
    const double* ieffb, const double* I, const double* src,
    const double* chiCL, const double* UCL, const double* etaC,
    const double* n, const double* coef, const double* wphi,
    const double* wmuHalf, double* G4, double* PPB, double* pair,
    GroupStatics st, int K, int Nlam, int Nmu, int Nk, int Wu, int row0,
    int BW, void* stream) {
    return launch_k<double>(phi, rho, psi, ieffb, I, src, chiCL, UCL, etaC,
                            n, coef, wphi, wmuHalf, G4, PPB, pair, st, K,
                            Nlam, Nmu, Nk, Wu, row0, BW, stream);
}

extern "C" int lw_group_gamma_f32(
    const float* phi, const float* rho, const float* psi, const float* ieffb,
    const float* I, const float* src, const float* chiCL, const float* UCL,
    const float* etaC, const float* n, const float* coef, const float* wphi,
    const float* wmuHalf, float* G4, float* PPB, float* pair,
    GroupStatics st, int K, int Nlam, int Nmu, int Nk, int Wu, int row0,
    int BW, void* stream) {
    return launch_k<float>(phi, rho, psi, ieffb, I, src, chiCL, UCL, etaC, n,
                           coef, wphi, wmuHalf, G4, PPB, pair, st, K, Nlam,
                           Nmu, Nk, Wu, row0, BW, stream);
}
