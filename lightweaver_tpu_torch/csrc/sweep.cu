// Depth-sweep formal solver for 1D short characteristics, with the
// angular moments of the MALI iteration.
//
// Replaces the TPU kernel lightweaver_tpu/ops/pallas_sweep.py:_sweep_kernel
// (body lane_sweep_affine; the pallas_call at line 297), in two
// precisions: float64 (lw_sweep_f64) and float32 (lw_sweep_f32), the
// precision the TPU runs it in.  The TPU kernel is cubic Bezier only; this
// one is instantiated for each 1D solver of the JAX package (the other two
// run in XLA there), chosen by the solver argument: piecewise linear (0),
// cubic Bezier (1) or BESSER (2), the codes of ops/sweep.py:SOLVER_CODES.
// Computes the same function as the plain PyTorch version in
// lightweaver_tpu_torch/ops/sweep.py (formal_solve_sweep_plain, built on
// ops/formal_solver.py:formal_sol_1d):
//
//   for every ray (lambda, mu, direction) of the direction-major
//   [2, NL, Nmu, Nk] layout (d = 0 sweeps down from k = 0, d = 1 up from
//   k = Nk-1):  S = srcNum / chi; the solver's coefficients along depth
//   (Steffen-limited Bezier-3 or BESSER's monotonic quadratic Bezier at the
//   interior points, the linear w2 step at the last point; the linear
//   solver's w2 step everywhere); the affine recurrence
//   I_m = A_m I_{m-1} + b_m from the upwind boundary value; Psi = psiN/chi
//   and IeffBase = A_m I_{m-1} + bNL_m.
//   Then, per (lambda, k), the moments with weights wmu/2:
//   J = sum_d sum_mu w I, PsiBar = sum w Psi,
//   IeffSrcBar = sum w (IeffBase + Psi srcNum).
//
// Design.  Each solver's coefficients at a depth depend on chi and S near
// it, never on I; only the recurrence is sequential, and it is
// associative.  The TPU kernel rode depth on the 128 vector lanes with a
// Kogge-Stone prefix; here one block takes one lambda row and each of its
// 2 Nmu rays gets a warp (320 threads at Nmu = 5; past 16 rays per
// direction the warps take the rays in passes), which walks the ray from
// its upwind end in chunks of 32 consecutive depths
// (bezier3.cuh:warp_ray): coalesced loads of chi and srcNum with
// the next chunk prefetched, the stencil neighbours by shuffles, each
// lane's (A, b, bNL, psiN), a 5-step warp scan of the affine maps with
// the last I carried into the next chunk, and coalesced stores of I, Psi
// and IeffBase.  The recurrence is summed in the order of
// ops/formal_solver.py:affine_solve(mode='chunked').  The moments never
// read a ray output back from device memory: sweep_row.cuh sums them per
// chunk through a shared tile into per-direction accumulators, mu
// ascending within a direction, and writes J, PsiBar, IBar and IeffSrcBar
// as down + up.  Deterministic, no atomics.  J is summed in double in
// both instances: in float32 from the float products fl32(w I), so J =
// sum fl32(w I) to double rounding (the TPU kernel's TwoSum pair Jhi +
// Jlo met the same contract, ~2^-48 relative, without f64).  The other
// moments accumulate in the working type; the float instance writes
// IBar = sum w I in float beside J, the double one has IBar = J.
//
// Any Nmu >= 1 and Nk >= 3: the dynamic shared memory grows as 48 Nk +
// 1536 R bytes in float64 (40 Nk + 768 R in float32; R the rays per pass,
// at most 32; ops/sweep.py:smem_bytes); past the 227 KB a block may have
// (Nk ~4,500 at Nmu = 5 in float64) the launch is refused.
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

#include "sweep_row.cuh"

namespace {

// rays read from chi and srcNum [2, NL, Nmu, N], boundary values from
// iupw [2, NL, Nmu]
template <typename T>
struct StoredRays {
    const T* __restrict__ chi;
    const T* __restrict__ src;
    const T* __restrict__ iupw;
    int N;

    __device__ __forceinline__ void load(size_t ray, int, int k, T& c,
                                         T& s) const {
        c = chi[ray * N + k];
        s = src[ray * N + k];
    }
    __device__ __forceinline__ T upwind(size_t ray, int, int, int, T, T,
                                        T) const {
        return iupw[ray];
    }
};

template <typename T, int S>
__global__ void __launch_bounds__(1024)
    sweep_kernel(StoredRays<T> rays, const T* __restrict__ dh,
                 const T* __restrict__ muz, const T* __restrict__ wmuHalf,
                 T* __restrict__ Iout, T* __restrict__ psiOut,
                 T* __restrict__ ieffbOut, double* __restrict__ Jout,
                 T* __restrict__ psiBarOut, T* __restrict__ iBarOut,
                 T* __restrict__ isBarOut, int NL, int Nmu, int N) {
    lw::sweep_row<S, T>(rays, dh, muz, wmuHalf, Iout, psiOut, ieffbOut, Jout,
                     psiBarOut, iBarOut, isBarOut, NL, Nmu, N);
}

template <typename T, int S>
int launch_solver(const T* chi, const T* src, const T* dh, const T* muz,
                  const T* wmuHalf, const T* iupw, T* Iout, T* psi, T* ieffb,
                  double* J, T* psiBar, T* iBar, T* isBar, int NL, int Nmu,
                  int Nk, void* stream) {
    return lw::launch_rows<T, sweep_kernel<T, S>>(
        NL, Nmu, Nk, stream, StoredRays<T>{chi, src, iupw, Nk}, dh, muz,
        wmuHalf, Iout, psi, ieffb, J, psiBar, iBar, isBar, NL, Nmu, Nk);
}

template <typename T>
int launch(const T* chi, const T* src, const T* dh, const T* muz,
           const T* wmuHalf, const T* iupw, T* Iout, T* psi, T* ieffb,
           double* J, T* psiBar, T* iBar, T* isBar, int NL, int Nmu, int Nk,
           int solver, void* stream) {
    switch (solver) {
    case lw::kLinear:
        return launch_solver<T, lw::kLinear>(chi, src, dh, muz, wmuHalf,
                                             iupw, Iout, psi, ieffb, J,
                                             psiBar, iBar, isBar, NL, Nmu,
                                             Nk, stream);
    case lw::kBezier3:
        return launch_solver<T, lw::kBezier3>(chi, src, dh, muz, wmuHalf,
                                              iupw, Iout, psi, ieffb, J,
                                              psiBar, iBar, isBar, NL, Nmu,
                                              Nk, stream);
    case lw::kBesser:
        return launch_solver<T, lw::kBesser>(chi, src, dh, muz, wmuHalf,
                                             iupw, Iout, psi, ieffb, J,
                                             psiBar, iBar, isBar, NL, Nmu,
                                             Nk, stream);
    default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

extern "C" int lw_sweep_f64(const double* chi, const double* src,
                            const double* dh, const double* muz,
                            const double* wmuHalf, const double* iupw,
                            double* Iout, double* psi, double* ieffb,
                            double* J, double* psiBar, double* isBar, int NL,
                            int Nmu, int Nk, int solver, void* stream) {
    return launch<double>(chi, src, dh, muz, wmuHalf, iupw, Iout, psi, ieffb,
                          J, psiBar, nullptr, isBar, NL, Nmu, Nk, solver,
                          stream);
}

extern "C" int lw_sweep_f32(const float* chi, const float* src,
                            const float* dh, const float* muz,
                            const float* wmuHalf, const float* iupw,
                            float* Iout, float* psi, float* ieffb, double* J,
                            float* psiBar, float* iBar, float* isBar, int NL,
                            int Nmu, int Nk, int solver, void* stream) {
    return launch<float>(chi, src, dh, muz, wmuHalf, iupw, Iout, psi, ieffb,
                         J, psiBar, iBar, isBar, NL, Nmu, Nk, solver, stream);
}
