// Fused lambda step: opacity/emissivity assembly, the Bezier-3 formal
// solution of every ray and its angular moments in one pass
// (iteration scheme 'mali_full_precond_fused').
//
// Replaces the TPU kernel lightweaver_tpu/ops/pallas_fused.py:
// _fused_kernel (launched by fused_lambda_step), in two instances: float64
// (lw_fused_f64) and float32 (lw_fused_f32), the precision the TPU runs it
// in.  Computes the same
// function as the plain PyTorch version lightweaver_tpu_torch/ops/
// fused.py:fused_lambda_step_plain:
//
//   chi = bgChi + sum_c chiCo_c phiP_c;  eta = bgEta + sum_c etaCo_c phiP_c
//   srcNum = eta + sca J;  S = srcNum / chi
//   upwind boundary: zero, data, or thermalised from the Planck rows at the
//   two outermost depths and the dtau of the assembled chi there
//   I, Psi, IeffBase: the Bezier-3 sweep of sweep.cu (bezier3.cuh)
//   J = sum w I, PsiBar = sum w Psi, IeffSrcBar = sum w (IeffBase + Psi
//   srcNum), w = wmu/2 over both directions and all mu
//
// over interval-coloured line slots c (ops/fused.py:assign_line_slots):
// overlapping line windows sit in different slots, so each (row, slot)
// holds one line's profile and a coefficient row that absorbs the
// populations and a1 = (hc/4pi)(lambda0/lambda) Bij.
//
// Design.  The sweep kernel's layout and thread mapping: one thread per
// ray (lambda, mu, direction) walks depth in order, whole lambda rows per
// block.  At each depth it forms chi and srcNum in registers from the
// background rows and the C slots, so chiTot and srcNum are never written
// to device memory; the moment pass after __syncthreads forms srcNum again
// the same way (the same value, bit for bit) and reduces in sweep.cu's
// fixed order, with no atomics.  J is accumulated in a double register
// from the working-type products w I, as in sweep.cu (the TPU kernel's
// TwoSum pair met the same contract); in float32 chi, eta and srcNum are
// assembled in float registers and the other moments accumulate in float,
// IBar = sum w I among them (in float64 IBar is J).
//
// Bound on an H100.  It reads phiP (83.7 MB at FALC-500 in f64, C = 2)
// and writes I, Psi and IeffBase (125 MB): ~210 MB, ~63 us at 3.35 TB/s;
// half in float32.
// Like sweep.cu it runs 10,460 threads each through a dependent chain
// along depth with loads Nk elements apart between neighbouring threads,
// so it is latency-bound far above that bound.

#include "bezier3.cuh"

#include <type_traits>

namespace {

enum BcKind { BC_ZERO = 0, BC_THERM = 1, BC_DATA = 2 };

template <typename T>
struct Slots {
    const T* phiP;   // [C, 2, NL, Nmu, N]
    const T* chiCo;  // [C, NL, N]
    const T* etaCo;  // [C, NL, N]
    const T* bgChi;  // [NL, N]
    const T* bgEta;  // [NL, N]
    const T* scaJ;   // [NL, N]
    int C;
    size_t slotStride;  // 2 NL Nmu N
    size_t coStride;    // NL N

    // chi and srcNum of ray offset rayOff (= ray index * N) and row offset
    // rowOff (= l * N) at depth k
    __device__ __forceinline__ void at(size_t rayOff, size_t rowOff, int k,
                                       T& chi, T& src) const {
        T c = bgChi[rowOff + k];
        T e = bgEta[rowOff + k];
        for (int s = 0; s < C; ++s) {
            const T p = phiP[s * slotStride + rayOff + k];
            c = c + chiCo[s * coStride + rowOff + k] * p;
            e = e + etaCo[s * coStride + rowOff + k] * p;
        }
        chi = c;
        src = e + scaJ[rowOff + k];
    }
};

// Block: rowsPerBlock lambda rows x (2 * Nmu) rays, one thread per ray.
template <typename T>
__global__ void fused_kernel(Slots<T> sl,
                             const T* __restrict__ dh,       // [N-1]
                             const T* __restrict__ muz,      // [Nmu]
                             const T* __restrict__ wmuHalf,  // [Nmu]
                             const T* __restrict__ bcUp,     // by kind
                             const T* __restrict__ bcLo,
                             T* __restrict__ Iout, T* __restrict__ psiOut,
                             T* __restrict__ ieffbOut,
                             double* __restrict__ Jout,
                             T* __restrict__ psiBarOut,
                             T* __restrict__ iBarOut,
                             T* __restrict__ isBarOut, int NL, int Nmu,
                             int N, int upKind, int loKind,
                             int rowsPerBlock) {
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
        const size_t rayOff = ray * N;
        const size_t rowOff = static_cast<size_t>(l) * N;
        const T mu = muz[imu];
        const auto load = [&](int k, T& c, T& S) {
            T src;
            sl.at(rayOff, rowOff, k, c, src);
            S = src / c;
        };

        // upwind boundary value of this ray
        const int kind = dir == 0 ? upKind : loKind;
        const T* bc = dir == 0 ? bcUp : bcLo;
        T I0 = T(0.0);
        if (kind == BC_DATA) {
            I0 = bc[static_cast<size_t>(l) * Nmu + imu];
        } else if (kind == BC_THERM) {
            // Planck rows [NL, 2] at the outermost and next depth; dtau of
            // the interval between them, as context.formal_solve forms it
            T c0, c1, unused;
            sl.at(rayOff, rowOff, dir == 0 ? 0 : N - 1, c0, unused);
            sl.at(rayOff, rowOff, dir == 0 ? 1 : N - 2, c1, unused);
            const T dtau = T(0.5) * (c0 + c1) * dh[dir == 0 ? 0 : N - 2] / mu;
            const T b0 = bc[2 * static_cast<size_t>(l)];
            const T b1 = bc[2 * static_cast<size_t>(l) + 1];
            I0 = b0 - (b1 - b0) / dtau;
        }
        lw::bezier3_ray<T>(load, dh, mu, N, dir == 1, I0, Iout + rayOff,
                           psiOut + rayOff, ieffbOut + rayOff);
    }

    __syncthreads();

    // angular moments of this block's rows, in sweep.cu's order
    const int nRows = min(rowsPerBlock, NL - row0);
    for (int idx = tid; idx < nRows * N; idx += blockDim.x) {
        const int lr = row0 + idx / N;
        const int k = idx % N;
        const size_t rowOff = static_cast<size_t>(lr) * N;
        double J = 0.0;
        T psiBar = T(0.0), iBar = T(0.0), isBar = T(0.0);
        for (int d = 0; d < 2; ++d) {
            double Jd = 0.0;
            T psiD = T(0.0), iD = T(0.0), isD = T(0.0);
            for (int m = 0; m < Nmu; ++m) {
                const size_t rayOff =
                    ((static_cast<size_t>(d) * NL + lr) * Nmu + m) * N;
                const size_t off = rayOff + k;
                T chi, src;
                sl.at(rayOff, rowOff, k, chi, src);
                const T w = wmuHalf[m];
                const T psi = psiOut[off];
                const T wI = w * Iout[off];
                Jd += static_cast<double>(wI);
                if constexpr (kIBar) iD += wI;
                psiD += w * psi;
                isD += w * (ieffbOut[off] + psi * src);
            }
            J += Jd;
            psiBar += psiD;
            iBar += iD;
            isBar += isD;
        }
        const size_t o = rowOff + k;
        Jout[o] = J;
        psiBarOut[o] = psiBar;
        if constexpr (kIBar) iBarOut[o] = iBar;
        isBarOut[o] = isBar;
    }
}

template <typename T>
int launch(const T* phiP, const T* chiCo, const T* etaCo, const T* bgChi,
           const T* bgEta, const T* scaJ, const T* dh, const T* muz,
           const T* wmuHalf, const T* bcUp, const T* bcLo, T* Iout, T* psi,
           T* ieffb, double* J, T* psiBar, T* iBar, T* isBar, int C, int NL,
           int Nmu, int Nk, int upKind, int loKind, int rowsPerBlock,
           void* stream) {
    Slots<T> sl{phiP, chiCo, etaCo, bgChi, bgEta, scaJ, C,
                static_cast<size_t>(2) * NL * Nmu * Nk,
                static_cast<size_t>(NL) * Nk};
    const int threads = rowsPerBlock * 2 * Nmu;
    const int blocks = (NL + rowsPerBlock - 1) / rowsPerBlock;
    fused_kernel<T><<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        sl, dh, muz, wmuHalf, bcUp, bcLo, Iout, psi, ieffb, J, psiBar, iBar,
        isBar, NL, Nmu, Nk, upKind, loKind, rowsPerBlock);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int lw_fused_f64(const double* phiP, const double* chiCo,
                            const double* etaCo, const double* bgChi,
                            const double* bgEta, const double* scaJ,
                            const double* dh, const double* muz,
                            const double* wmuHalf, const double* bcUp,
                            const double* bcLo, double* Iout, double* psi,
                            double* ieffb, double* J, double* psiBar,
                            double* isBar, int C, int NL, int Nmu, int Nk,
                            int upKind, int loKind, int rowsPerBlock,
                            void* stream) {
    return launch<double>(phiP, chiCo, etaCo, bgChi, bgEta, scaJ, dh, muz,
                          wmuHalf, bcUp, bcLo, Iout, psi, ieffb, J, psiBar,
                          nullptr, isBar, C, NL, Nmu, Nk, upKind, loKind,
                          rowsPerBlock, stream);
}

extern "C" int lw_fused_f32(const float* phiP, const float* chiCo,
                            const float* etaCo, const float* bgChi,
                            const float* bgEta, const float* scaJ,
                            const float* dh, const float* muz,
                            const float* wmuHalf, const float* bcUp,
                            const float* bcLo, float* Iout, float* psi,
                            float* ieffb, double* J, float* psiBar,
                            float* iBar, float* isBar, int C, int NL,
                            int Nmu, int Nk, int upKind, int loKind,
                            int rowsPerBlock, void* stream) {
    return launch<float>(phiP, chiCo, etaCo, bgChi, bgEta, scaJ, dh, muz,
                         wmuHalf, bcUp, bcLo, Iout, psi, ieffb, J, psiBar,
                         iBar, isBar, C, NL, Nmu, Nk, upKind, loKind,
                         rowsPerBlock, stream);
}
