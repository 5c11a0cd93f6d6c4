// The PRD subset solve's formal solution: chi and the source of the
// PRD-active wavelength rows assembled from their rho-free part and the
// PRD lines' rho, the sweep of every ray and the angular moments, in one
// pass (context.py:build_prd_subset_fn, one launch per PRD
// sub-iteration).
//
// It replaces no TPU kernel: the JAX package forms the subset's chi and
// srcNum in XLA and runs its sweep kernel on them.  It was added because
// the port formed them in eager torch on every sub-iteration: a clone of
// the background rows into two [2, Nsub, Nmu, Nk] tensors, every
// transition's terms added to them, then srcNum, ~1,400 launches and
// ~130 ms of device time on an H100 a sub-iteration of the hybrid-PRD
// column batch (428 rows, 5 rays, 512 columns of 82 depths; 13.8 ms with
// this kernel, against a 3.4 ms byte bound), although inside a
// redistribution only the PRD lines' rho and J change.  The rho-free part
// is formed once per redistribution (chiFix, etaFix); this kernel adds
// what changes.  It computes the same function as the plain PyTorch
// version ops/prd_subset.py:prd_subset_sweep_plain, which runs for CPU
// tensors:
//
//   per PRD line s whose rows [s0, s0 + nW) of the subset cover row l:
//     rc   = (1 - frac) rho[i0, k] + frac rho[i0 + 1, k]  (hybrid PRD: the
//            comoving-frame rho of the ray, i0 and frac [2, W, Nmu, Nk] at
//            window row off + l - s0), or rho[off + l - s0, k]
//            (angle-averaged PRD)
//     Vji  = (gS Vij) rc,  gS = Bji / Bij,  Vij [2, nW, Nmu, Nk]
//   chi    = chiFix - sum_s nj_s Vji_s
//   srcNum = (etaFix + sum_s nj_s (uS_s Vji_s)) + scaJ,  uS = Aji / Bji
//   (the lines in their order), then the sweep of sweep.cu by the solver
//   (linear, Bezier-3 or BESSER), its upwind boundary zero, data, or
//   thermalised from the Planck rows at the two outermost depths and the
//   dtau of the assembled chi there, as fused.cu forms it; and the
//   moments J, PsiBar (IBar in float) and IeffSrcBar of sweep_row.cuh.
//   Only I is stored of the ray outputs: the subset solve reads no Psi
//   and no IeffBase.
//
// The lines are a table of at most kMaxLines entries in the kernel's
// parameters, each with its own pointers, so overlapping windows (Mg II h
// and k) need no slots: a row adds every line that covers it, and a
// line's arrays are read where they lie (rho and the comoving
// coefficients are the Context's own tensors, never copied).
//
// Columns, as in sweep.cu and fused.cu: the depth axis holds Ncol
// independent columns of Nk depths (grid NL x Ncol), each with its own
// path lengths dh [Ncol, Nk-1] and boundary rows (data [NL, Nmu, Ncol],
// Planck rows [NL, Ncol, 2]).
//
// Design.  sweep_row.cuh's body behind the assembly: one block per row
// and column, a warp per ray along depth in chunks of 32, the recurrence
// as a warp scan, the moments through a shared tile.  Each lane assembles
// chi and srcNum of its depth in registers, so neither is written to
// device memory; the loop over the table is unrolled and its test of the
// row is the same for the whole block.  The row tensors (scaJ, nj) are
// left to L1, as in fused.cu.  J is summed in double in both instances
// (sweep.cu's contract); in float32 the assembly is in float.
//
// Bound on an H100: bytes.  Per sub-iteration of the column batch it
// reads chiFix and etaFix (2 x 1.44 GB), each line's Vij, i0 and frac on
// its rows (621 window rows, ~6.3 GB) and writes I (1.44 GB): ~10 GB,
// ~3 ms at 3.35 TB/s; the comoving gathers of rho hit L2.
//
// Rounding.  The assembly rounds each operation on its own, in the plain
// version's order (no FMA contraction): chi and srcNum, and with them the
// boundaries, are the plain version's to the bit, so the kernel's outputs
// are the sweep kernel's on the plain assembly (sweep.cu runs the same
// warp_ray).  The sweep itself contracts multiply-adds and sums the
// recurrence in the scan's order, not the plain sequential loop's; the
// comparison tolerance against the plain version states this.

#include "sweep_row.cuh"

#include <cstdint>

namespace {

enum BcKind { BC_ZERO = 0, BC_THERM = 1, BC_DATA = 2 };

// the PRD lines a launch takes (ops/prd_subset.py:MAX_LINES)
constexpr int kMaxLines = 8;

// the assembly's operations, each rounded on its own (no contraction into
// FMAs): chi and srcNum are then the plain version's to the bit
__device__ __forceinline__ double mul_rn(double a, double b) {
    return __dmul_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
    return __fmul_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
    return __dadd_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
    return __fadd_rn(a, b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
    return __dsub_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
    return __fsub_rn(a, b);
}

// one PRD line: its arrays and the offsets that map a ray's (rayOff,
// rowOff) into them, per direction
template <typename T>
struct Line {
    const T* __restrict__ vij;             // [2, nW, Nmu, NT]
    const T* __restrict__ rho;             // [W, NT]
    const int64_t* __restrict__ i0;        // [2, W, Nmu, NT], or null
    const T* __restrict__ frac;            // [2, W, Nmu, NT], or null
    const T* __restrict__ nj;              // [NT]
    long long vOff[2];                     // rayOff -> vij
    long long cOff[2];                     // rayOff -> i0, frac
    long long rOff;                        // rowOff -> rho (no i0)
    int s0, nW;
    T gS, uS;
};

template <typename T>
struct SubsetRays {
    const T* __restrict__ chiFix;   // [2, NL, Nmu, NT]
    const T* __restrict__ etaFix;   // [2, NL, Nmu, NT]
    const T* __restrict__ scaJ;     // [NL, NT]
    const T* __restrict__ dh;       // [Ncol, N-1]
    // by kind: [NL, Nmu, Ncol] data, [NL, Ncol, 2] therm
    const T* __restrict__ bcUp;
    const T* __restrict__ bcLo;
    Line<T> lines[kMaxLines];
    int nLines, N, Nmu, Ncol, upKind, loKind;
    size_t NT;     // Ncol N, a row's length
    size_t half;   // NL Nmu NT, the first index of the up direction

    __device__ __forceinline__ void load(size_t rayOff, size_t rowOff,
                                         T& chi, T& src) const {
        T c = chiFix[rayOff];
        T e = etaFix[rayOff];
        const int l = blockIdx.x;
        const int dir = rayOff >= half;
        const size_t kk = rowOff - static_cast<size_t>(l) * NT;
#pragma unroll
        for (int s = 0; s < kMaxLines; ++s) {
            const Line<T>& L = lines[s];
            if (s >= nLines || l < L.s0 || l >= L.s0 + L.nW) continue;
            const T v = L.vij[static_cast<long long>(rayOff) + L.vOff[dir]];
            T rc;
            if (L.i0 != nullptr) {
                const long long o = static_cast<long long>(rayOff)
                                    + L.cOff[dir];
                const size_t i = static_cast<size_t>(L.i0[o]);
                const T f = L.frac[o];
                rc = add_rn(mul_rn(sub_rn(T(1.0), f), L.rho[i * NT + kk]),
                            mul_rn(f, L.rho[(i + 1) * NT + kk]));
            } else {
                rc = L.rho[static_cast<long long>(rowOff) + L.rOff];
            }
            const T vji = mul_rn(mul_rn(L.gS, v), rc);
            const T nj = L.nj[kk];
            c = sub_rn(c, mul_rn(nj, vji));
            e = add_rn(e, mul_rn(nj, mul_rn(L.uS, vji)));
        }
        chi = c;
        src = add_rn(e, scaJ[rowOff]);
    }

    // c0, c1: the assembled chi at the ray's outermost and next depth of
    // its column (fused.cu's SlotRays::upwind)
    __device__ __forceinline__ T upwind(size_t, int l, int col, int dir,
                                        int imu, T mu, T c0, T c1) const {
        const int kind = dir == 0 ? upKind : loKind;
        const T* bc = dir == 0 ? bcUp : bcLo;
        if (kind == BC_DATA)
            return bc[(static_cast<size_t>(l) * Nmu + imu) * Ncol + col];
        if (kind != BC_THERM) return T(0.0);
        const T dtau = T(0.5) * (c0 + c1)
                       * dh[static_cast<size_t>(col) * (N - 1)
                            + (dir == 0 ? 0 : N - 2)] / mu;
        const size_t o = 2 * (static_cast<size_t>(l) * Ncol + col);
        const T b0 = bc[o];
        const T b1 = bc[o + 1];
        return b0 - (b1 - b0) / dtau;
    }
};

template <typename T, int S>
__global__ void __launch_bounds__(1024)
    prd_subset_kernel(SubsetRays<T> rays, const T* __restrict__ dh,
                      const T* __restrict__ muz,
                      const T* __restrict__ wmuHalf, T* __restrict__ Iout,
                      double* __restrict__ Jout, T* __restrict__ psiBarOut,
                      T* __restrict__ iBarOut, T* __restrict__ isBarOut,
                      int NL, int Nmu, int N) {
    lw::sweep_row<S, T, SubsetRays<T>, false>(
        rays, dh, muz, wmuHalf, Iout, nullptr, nullptr, Jout, psiBarOut,
        iBarOut, isBarOut, NL, Nmu, N);
}

template <typename T, int S>
int launch_solver(const SubsetRays<T>& rays, const T* dh, const T* muz,
                  const T* wmuHalf, T* Iout, double* J, T* psiBar, T* iBar,
                  T* isBar, int NL, int Nmu, int Nk, int Ncol,
                  void* stream) {
    return lw::launch_rows<T, prd_subset_kernel<T, S>>(
        NL, Nmu, Nk, Ncol, stream, rays, dh, muz, wmuHalf, Iout, J, psiBar,
        iBar, isBar, NL, Nmu, Nk);
}

// linePtrs: 5 per line (vij, rho, i0, frac, nj; i0 and frac null under
// angle-averaged PRD); lineConsts: 2 per line (gS, uS); lineInts: 4 per
// line (s0, nW, W, off: the line's first row among the NL, its rows,
// its window's rows and the window row of row s0)
template <typename T>
int launch(const T* chiFix, const T* etaFix, const T* scaJ, const T* dh,
           const T* muz, const T* wmuHalf, const T* bcUp, const T* bcLo,
           const void* const* linePtrs, const double* lineConsts,
           const int* lineInts, int nLines, T* Iout, double* J, T* psiBar,
           T* iBar, T* isBar, int NL, int Nmu, int Nk, int Ncol, int solver,
           int upKind, int loKind, void* stream) {
    if (nLines < 0 || nLines > kMaxLines)
        return static_cast<int>(cudaErrorInvalidValue);
    SubsetRays<T> rays{};
    rays.chiFix = chiFix;
    rays.etaFix = etaFix;
    rays.scaJ = scaJ;
    rays.dh = dh;
    rays.bcUp = bcUp;
    rays.bcLo = bcLo;
    rays.nLines = nLines;
    rays.N = Nk;
    rays.Nmu = Nmu;
    rays.Ncol = Ncol;
    rays.upKind = upKind;
    rays.loKind = loKind;
    const long long NT = static_cast<long long>(Ncol) * Nk;
    const long long MNT = static_cast<long long>(Nmu) * NT;
    const long long half = static_cast<long long>(NL) * MNT;
    rays.NT = static_cast<size_t>(NT);
    rays.half = static_cast<size_t>(half);
    for (int s = 0; s < nLines; ++s) {
        Line<T>& L = rays.lines[s];
        const void* const* p = linePtrs + 5 * s;
        L.vij = static_cast<const T*>(p[0]);
        L.rho = static_cast<const T*>(p[1]);
        L.i0 = static_cast<const int64_t*>(p[2]);
        L.frac = static_cast<const T*>(p[3]);
        L.nj = static_cast<const T*>(p[4]);
        const int* q = lineInts + 4 * s;
        const int s0 = q[0], nW = q[1], W = q[2], off = q[3];
        if (s0 < 0 || nW < 1 || s0 + nW > NL || off < 0 || off + nW > W
            || (L.i0 == nullptr) != (L.frac == nullptr))
            return static_cast<int>(cudaErrorInvalidValue);
        L.s0 = s0;
        L.nW = nW;
        for (int d = 0; d < 2; ++d) {
            L.vOff[d] = d * (nW * MNT - half) - s0 * MNT;
            L.cOff[d] = d * (W * MNT - half) + (off - s0) * MNT;
        }
        L.rOff = (off - s0) * NT;
        L.gS = static_cast<T>(lineConsts[2 * s]);
        L.uS = static_cast<T>(lineConsts[2 * s + 1]);
    }
    switch (solver) {
    case lw::kLinear:
        return launch_solver<T, lw::kLinear>(rays, dh, muz, wmuHalf, Iout,
                                             J, psiBar, iBar, isBar, NL, Nmu,
                                             Nk, Ncol, stream);
    case lw::kBezier3:
        return launch_solver<T, lw::kBezier3>(rays, dh, muz, wmuHalf, Iout,
                                              J, psiBar, iBar, isBar, NL,
                                              Nmu, Nk, Ncol, stream);
    case lw::kBesser:
        return launch_solver<T, lw::kBesser>(rays, dh, muz, wmuHalf, Iout,
                                             J, psiBar, iBar, isBar, NL, Nmu,
                                             Nk, Ncol, stream);
    default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

extern "C" int lw_prd_subset_f64(
    const double* chiFix, const double* etaFix, const double* scaJ,
    const double* dh, const double* muz, const double* wmuHalf,
    const double* bcUp, const double* bcLo, const void* const* linePtrs,
    const double* lineConsts, const int* lineInts, int nLines, double* Iout,
    double* J, double* psiBar, double* isBar, int NL, int Nmu, int Nk,
    int Ncol, int solver, int upKind, int loKind, void* stream) {
    return launch<double>(chiFix, etaFix, scaJ, dh, muz, wmuHalf, bcUp, bcLo,
                          linePtrs, lineConsts, lineInts, nLines, Iout, J,
                          psiBar, nullptr, isBar, NL, Nmu, Nk, Ncol, solver,
                          upKind, loKind, stream);
}

extern "C" int lw_prd_subset_f32(
    const float* chiFix, const float* etaFix, const float* scaJ,
    const float* dh, const float* muz, const float* wmuHalf,
    const float* bcUp, const float* bcLo, const void* const* linePtrs,
    const double* lineConsts, const int* lineInts, int nLines, float* Iout,
    double* J, float* psiBar, float* iBar, float* isBar, int NL, int Nmu,
    int Nk, int Ncol, int solver, int upKind, int loKind, void* stream) {
    return launch<float>(chiFix, etaFix, scaJ, dh, muz, wmuHalf, bcUp, bcLo,
                         linePtrs, lineConsts, lineInts, nLines, Iout, J,
                         psiBar, iBar, isBar, NL, Nmu, Nk, Ncol, solver,
                         upKind, loKind, stream);
}
