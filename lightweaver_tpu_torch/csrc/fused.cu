// Fused lambda step: opacity/emissivity assembly, the Bezier-3 formal
// solution of every ray and its angular moments in one pass
// (iteration scheme 'mali_full_precond_fused').
//
// Replaces the TPU kernel lightweaver_tpu/ops/pallas_fused.py:
// _fused_kernel (launched by fused_lambda_step), in two instances: float64
// (lw_fused_f64) and float32 (lw_fused_f32), the precision the TPU runs it
// in.  Computes the same function as the plain PyTorch version
// lightweaver_tpu_torch/ops/fused.py:fused_lambda_step_plain:
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
// Design.  The sweep kernel's body (sweep_row.cuh) behind the slot
// assembly: one block per lambda row, a warp per ray walking depth in
// chunks of 32 (in passes past 16 rays per direction), the recurrence as
// a warp scan, the moments through a shared tile in the same pass.  Each
// lane assembles chi and srcNum of its depth from the background rows
// and the C slots in the order of ops/fused.py:assemble, so phiP is read
// in coalesced 32-depth runs and chiTot and srcNum are never written to
// device memory.  The row tensors (bgChi, bgEta, scaJ, chiCo_c, etaCo_c:
// (3 + 2C) Nk values) are the same for all 2 Nmu rays of a block and are
// left to L1 rather than staged in shared memory: the chunk barrier keeps
// a block's warps on the same 32 depths of each direction, so a row's
// values come from L2 once and from L1 for the other warps, while staging
// would cost (3 + 2C) Nk values of shared memory per block (28 KB at
// FALC-500 in f64, C = 2) and fewer blocks per SM.  The thermalised
// boundary needs the assembled chi at the ray's two outermost depths:
// lanes 0 and 1 of the first chunk, by shuffle (warp_ray's upwind).  J
// is a double sum of the working-type products w I, as in sweep.cu (the
// TPU kernel's TwoSum pair met the same contract); in float32 chi, eta
// and srcNum are assembled in float and the other moments accumulate in
// float, IBar = sum w I among them (in float64 IBar is J).
//
// Bound on an H100: bytes.  It reads phiP (83.7 MB at FALC-500 in f64,
// C = 2) and the rows, and writes I, Psi and IeffBase (125 MB): ~210 MB,
// ~63 us at 3.35 TB/s; half in float32.
//
// nvcc contracts the assembly's and the sweep's multiply-adds into FMAs,
// and the scan sums the recurrence in another order than the plain
// sequential loop; the comparison tolerance states this.

#include "sweep_row.cuh"

namespace {

enum BcKind { BC_ZERO = 0, BC_THERM = 1, BC_DATA = 2 };

// rays assembled from the background rows and C line slots
template <typename T>
struct SlotRays {
    const T* __restrict__ phiP;   // [C, 2, NL, Nmu, N]
    const T* __restrict__ chiCo;  // [C, NL, N]
    const T* __restrict__ etaCo;  // [C, NL, N]
    const T* __restrict__ bgChi;  // [NL, N]
    const T* __restrict__ bgEta;  // [NL, N]
    const T* __restrict__ scaJ;   // [NL, N]
    const T* __restrict__ dh;     // [N-1]
    const T* __restrict__ bcUp;   // by kind: [NL, Nmu] data, [NL, 2] therm
    const T* __restrict__ bcLo;
    int C, N, Nmu, upKind, loKind;
    size_t slotStride;  // 2 NL Nmu N
    size_t coStride;    // NL N

    __device__ __forceinline__ void load(size_t ray, int l, int k, T& chi,
                                         T& src) const {
        const size_t rowOff = static_cast<size_t>(l) * N + k;
        const size_t rayOff = ray * N + k;
        T c = bgChi[rowOff];
        T e = bgEta[rowOff];
        for (int s = 0; s < C; ++s) {
            const T p = phiP[s * slotStride + rayOff];
            c = c + chiCo[s * coStride + rowOff] * p;
            e = e + etaCo[s * coStride + rowOff] * p;
        }
        chi = c;
        src = e + scaJ[rowOff];
    }

    // c0, c1: the assembled chi at the ray's outermost and next depth
    __device__ __forceinline__ T upwind(size_t, int l, int dir, int imu,
                                        T mu, T c0, T c1) const {
        const int kind = dir == 0 ? upKind : loKind;
        const T* bc = dir == 0 ? bcUp : bcLo;
        if (kind == BC_DATA) return bc[static_cast<size_t>(l) * Nmu + imu];
        if (kind != BC_THERM) return T(0.0);
        // Planck rows [NL, 2] at the two depths; dtau between them as
        // context.formal_solve forms it
        const T dtau = T(0.5) * (c0 + c1) * dh[dir == 0 ? 0 : N - 2] / mu;
        const T b0 = bc[2 * static_cast<size_t>(l)];
        const T b1 = bc[2 * static_cast<size_t>(l) + 1];
        return b0 - (b1 - b0) / dtau;
    }
};

template <typename T>
__global__ void __launch_bounds__(1024)
    fused_kernel(SlotRays<T> rays, const T* __restrict__ dh,
                 const T* __restrict__ muz, const T* __restrict__ wmuHalf,
                 T* __restrict__ Iout, T* __restrict__ psiOut,
                 T* __restrict__ ieffbOut, double* __restrict__ Jout,
                 T* __restrict__ psiBarOut, T* __restrict__ iBarOut,
                 T* __restrict__ isBarOut, int NL, int Nmu, int N) {
    lw::sweep_row<lw::kBezier3, T>(rays, dh, muz, wmuHalf, Iout, psiOut, ieffbOut, Jout,
                     psiBarOut, iBarOut, isBarOut, NL, Nmu, N);
}

template <typename T>
int launch(const T* phiP, const T* chiCo, const T* etaCo, const T* bgChi,
           const T* bgEta, const T* scaJ, const T* dh, const T* muz,
           const T* wmuHalf, const T* bcUp, const T* bcLo, T* Iout, T* psi,
           T* ieffb, double* J, T* psiBar, T* iBar, T* isBar, int C, int NL,
           int Nmu, int Nk, int upKind, int loKind, void* stream) {
    if (C < 1) return static_cast<int>(cudaErrorInvalidValue);
    const SlotRays<T> rays{phiP, chiCo, etaCo, bgChi, bgEta, scaJ, dh,
                           bcUp, bcLo, C, Nk, Nmu, upKind, loKind,
                           static_cast<size_t>(2) * NL * Nmu * Nk,
                           static_cast<size_t>(NL) * Nk};
    return lw::launch_rows<T, fused_kernel<T>>(
        NL, Nmu, Nk, stream, rays, dh, muz, wmuHalf, Iout, psi, ieffb, J,
        psiBar, iBar, isBar, NL, Nmu, Nk);
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
                            int upKind, int loKind, void* stream) {
    return launch<double>(phiP, chiCo, etaCo, bgChi, bgEta, scaJ, dh, muz,
                          wmuHalf, bcUp, bcLo, Iout, psi, ieffb, J, psiBar,
                          nullptr, isBar, C, NL, Nmu, Nk, upKind, loKind,
                          stream);
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
                            void* stream) {
    return launch<float>(phiP, chiCo, etaCo, bgChi, bgEta, scaJ, dh, muz,
                         wmuHalf, bcUp, bcLo, Iout, psi, ieffb, J, psiBar,
                         iBar, isBar, C, NL, Nmu, Nk, upKind, loKind,
                         stream);
}
