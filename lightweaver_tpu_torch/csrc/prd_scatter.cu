// The angle-averaged PRD scattering integral of one line: rho [W, Nk] from
// the line window's emission frequencies and mean intensity, one thread
// per (window row, depth) pair, its fine-grid integral in registers.
//
// It replaces no TPU kernel: the JAX package leaves the integral to XLA
// (lightweaver_tpu/ops/prd.py has no Pallas kernel).  It was added
// because the plain PyTorch version (ops/prd.py:_scatter_rho_block, some
// 110 eager passes over a [depths, W, NFINE] tensor per block of depths)
// took 77 % of a MALI step of the hybrid-PRD column batch: 512 FAL-C
// columns (41,984 depths) and four PRD lines of 101 / 51 / 250 / 219
// window rows, 2.29e9 fine points a sub-iteration.  It computes the same
// function as that plain version, which runs for CPU tensors and is what
// the tests hold the kernel to (ref: Source/Prd.cpp:468-645):
//
//   for each pair (w, k), qE = qWave[w, k]: the fine grid qA = q0 + f DQ,
//   f < Np, of _scattering_range_start's range [q0, qN] (Np = floor((qN -
//   q0) / DQ) + 1, at most nFine points), the weights DQ x 5/12 at f = 0
//   and f = Np - 1, else 13/12 at f = 1 and f = Np - 2, else 1 (the plain
//   version's precedence); gII(aDamp[k], qE, qA) by Gouttebroze's
//   approximation with the plain version's clamps (exp arguments at most
//   50) and its zeros outside the core and wing ranges; J at qA by
//   interp's rule (jnp.interp's): i = clip(searchsorted(qWave[:, k], qA,
//   right), 1, W - 1), the left value where the interval is empty (|dx| <=
//   2^-104), J's end values past either end of the window; then gNorm =
//   sum g, scatInt = sum g J and rho = 1 + gammaPre[k] (scatInt / gNorm -
//   Jbar[k]).
//
// Bound by float64 operations.  Per pair it reads qWave, Jw's column as far
// as the fine grid walks it and four depth constants, and writes rho once
// (~24 B a pair, ~0.2 ms a sub-iteration of the column batch at 3.35
// TB/s); per fine point it spends one or two exponentials, one or two
// square roots and reciprocals (_G_zero), the interpolation's division and
// the sums, ~100 float64 instructions: ~1.7e9 fine points, ~10 ms a
// sub-iteration at the card's float64 issue rate.  So the design spends
// no instruction that the plain version's masks discard:
//
// - the fine loop stops at Np (the plain version evaluates NFINE = 88
//   points and weights those past Np by 0: ~65 points a pair, not 88);
// - gII evaluates only the branch that qE selects: the core (|qE| < 2),
//   the core and wing blended (2 <= |qE| < 4), or the far wing, each loop
//   a template instance (the plain version computes both and selects);
// - every pair constant (the range, Np, _G_zero(|qE|), 1 / max(|qE|,
//   1e-10), the blend's core factor) is formed once, before the loop;
// - the interpolation interval is found once per pair by a binary search
//   at q0, then walked forward (qA rises with f), its ends kept in
//   registers: one pair of loads per interval, not per fine point.
//
// Threads.  Pair t = w Nk + k: a warp covers 32 consecutive depths of one
// window row, so its loads of the [W, Nk] inputs (depth fastest) and its
// store of rho coalesce, and neighbouring depths of one column have
// nearly the same qE, so a warp seldom splits across the three branches.
// The inputs are read through the read-only cache (__ldg).
//
// Rounding.  The fine grid's qA = q0 + f DQ is rounded in two steps, as
// the plain version's separate product and sum (no contraction): the
// zeros at |qA - qE| > 5 and qA > qE + 5 and interp's interval are
// discontinuous in qA, and an ulp there would move a fine point across.
// Elsewhere nvcc contracts multiply-adds and the products by
// 1 / max(|qE|, 1e-10) and 1 / sqrt(pi) replace the plain version's
// quotients, each continuous, at the rounding level; the sums run in
// fine-point order.  The tests hold rho to the plain version within
// 1e-12 of its maximum.
//
// Limits, checked by launch (cudaErrorInvalidValue): W >= 1, Nk >= 1, W Nk
// pairs within an int.

#include <cuda_runtime.h>

namespace {

// ops/prd.py's constants (ref: Source/Prd.cpp:33-36)
constexpr double kQWing = 4.0;
constexpr double kQCore = 2.0;
constexpr double kQSpread = 5.0;
constexpr double kDQ = 0.15;
// math.sqrt(math.pi), as the plain version has it
constexpr double kSqrtPi = 1.7724538509055159;
constexpr double kInvSqrtPi = 1.0 / kSqrtPi;
// the quadrature weights, each rounded as the plain version's (c) x 0.15
constexpr double kW5 = 5.0 / 12.0 * kDQ;
constexpr double kW13 = 13.0 / 12.0 * kDQ;
constexpr double kW1 = 1.0 * kDQ;
// interp's empty interval: np.spacing(np.finfo(np.float64).eps)
constexpr double kDxEps = 0x1p-104;
constexpr int kThreads = 128;

// gII's branch, from |qE|
enum Regime : int { kCore = 0, kBlend = 1, kWing = 2 };

__device__ __forceinline__ double g_zero(double x) {
    return 1.0 / (fabs(x) + sqrt(x * x + 1.273239545));
}

// J of one pair's window column at rising abscissae (interp's rule)
struct Walk {
    const double* x;        // qWave[:, k], stride Nk
    const double* J;        // Jw[:, k]
    size_t stride;
    int i, last;            // the interval's right row; W - 1
    double xl, xr, fl, fr;  // the interval's ends

    // the interval of q0: i = clip(searchsorted(x, q0, right), 1, W - 1)
    __device__ Walk(const double* x_, const double* J_, int Nk, int W,
                    double q0)
        : x(x_), J(J_), stride(static_cast<size_t>(Nk)), last(W - 1) {
        int lo = 0, hi = W;
        while (lo < hi) {
            const int mid = (lo + hi) >> 1;
            if (__ldg(x + mid * stride) <= q0) lo = mid + 1;
            else hi = mid;
        }
        i = min(max(lo, 1), last);   // 0 where W = 1, as torch's clamp
        const int il = max(i - 1, 0);
        xl = __ldg(x + il * stride);
        fl = __ldg(J + il * stride);
        xr = __ldg(x + i * stride);
        fr = __ldg(J + i * stride);
    }

    // J at q, no less than every earlier q
    __device__ __forceinline__ double at(double q) {
        while (i < last && xr <= q) {
            ++i;
            xl = xr;
            fl = fr;
            xr = __ldg(x + i * stride);
            fr = __ldg(J + i * stride);
        }
        // past the ends (q > xr only at i = W - 1, q < xl only at i <= 1)
        if (q > xr) return fr;
        if (q < xl) return fl;
        const double dx = xr - xl;
        if (fabs(dx) <= kDxEps) return fl;
        return fl + (q - xl) / dx * (fr - fl);
    }
};

// the pair's constants of gII, in the flipped frame (qE = |qEmit|)
struct Pair {
    double qE, qE2, qEs;    // |qEmit|, its square, |qEmit| + kQSpread
    double g0E;             // _G_zero(|qEmit|)
    double invQE;           // 1 / max(|qEmit|, 1e-10)
    double cf, cw;          // the blend's core factor and 1 - it
};

// the wing value at the flipped qA (ratio of wavelengths 1)
__device__ __forceinline__ double gii_wing(const Pair& p, double qA) {
    const double u = fabs(qA - p.qE) / 2.0;
    const double r = qA * p.invQE;
    return (1.0 - 2.0 * u * g_zero(u)) * exp(-u * u) * kInvSqrtPi
        * (2.75 - (2.5 - 0.75 * r) * r);
}

// the core value at the flipped qA inside the core range
__device__ __forceinline__ double gii_core(const Pair& p, double qA) {
    return fabs(qA) <= p.qE ? p.g0E
                            : exp(fmin(p.qE2 - qA * qA, 50.0)) * g_zero(qA);
}

template <Regime R>
__device__ __forceinline__ double gii(const Pair& p, double qA) {
    if constexpr (R == kWing)
        return fabs(qA - p.qE) > kQSpread ? 0.0 : gii_wing(p, qA);
    if (qA < -kQWing || qA > p.qEs) return 0.0;   // outside the core range
    if constexpr (R == kCore) return gii_core(p, qA);
    return p.cf * gii_core(p, qA) + p.cw * gii_wing(p, qA);
}

// (gNorm, scatInt) of one pair over its Np fine points
template <Regime R>
__device__ double2 pair_sums(const Pair& p, Walk& walk, double q0, int Np,
                             int n, bool flip) {
    double gNorm = 0.0, scat = 0.0;
    for (int f = 0; f < n; ++f) {
        // two roundings, as q0 + (f * DQ) in the plain version
        const double qA = __dadd_rn(q0, __dmul_rn(static_cast<double>(f),
                                                  kDQ));
        const double wq = (f == 0 || f == Np - 1) ? kW5
                        : (f == 1 || f == Np - 2) ? kW13 : kW1;
        const double g = gii<R>(p, flip ? -qA : qA) * wq;
        gNorm += g;
        scat += g * walk.at(qA);
    }
    return make_double2(gNorm, scat);
}

__global__ void __launch_bounds__(kThreads)
prd_scatter_kernel(const double* __restrict__ qWave,
                   const double* __restrict__ aDamp,
                   const double* __restrict__ Jw,
                   const double* __restrict__ gammaPre,
                   const double* __restrict__ Jbar,
                   double* __restrict__ rho, int W, int Nk, int nFine) {
    const int t = blockIdx.x * kThreads + threadIdx.x;
    if (t >= W * Nk) return;
    const int k = t % Nk;
    const double qEmit = __ldg(qWave + t);

    // _scattering_range_start
    const double aq = fabs(qEmit);
    double q0, qN;
    if (aq < kQCore) {
        q0 = -kQWing;
        qN = kQWing;
    } else if (aq < kQWing) {
        q0 = qEmit > 0.0 ? -kQWing : qEmit - kQSpread;
        qN = qEmit > 0.0 ? qEmit + kQSpread : kQWing;
    } else {
        q0 = qEmit - kQSpread;
        qN = qEmit + kQSpread;
    }
    const int Np = static_cast<int>(floor((qN - q0) / kDQ)) + 1;
    const int n = min(Np, nFine);

    const bool flip = qEmit < 0.0;
    Pair p;
    p.qE = flip ? -qEmit : qEmit;
    p.qE2 = p.qE * p.qE;
    p.qEs = p.qE + kQSpread;
    p.g0E = g_zero(p.qE);
    p.invQE = 1.0 / fmax(p.qE, 1e-10);
    p.cf = 0.0;
    p.cw = 0.0;

    Walk walk(qWave + k, Jw + k, Nk, W, q0);
    double2 s;
    if (p.qE < kQCore) {
        s = pair_sums<kCore>(p, walk, q0, Np, n, flip);
    } else if (p.qE < kQWing) {
        const double a = __ldg(aDamp + k);
        const double phiCore = exp(-fmin(p.qE2, 50.0));
        const double phiWing = a / (kSqrtPi * (a * a + p.qE2));
        p.cf = phiCore / (phiCore + phiWing);
        p.cw = 1.0 - p.cf;
        s = pair_sums<kBlend>(p, walk, q0, Np, n, flip);
    } else {
        s = pair_sums<kWing>(p, walk, q0, Np, n, flip);
    }
    rho[t] = 1.0 + __ldg(gammaPre + k) * (s.y / s.x - __ldg(Jbar + k));
}

}  // namespace

// rho [W, Nk] of one PRD line (ops/prd.py:prd_scatter_cuda), on `stream`;
// returns the CUDA error of the launch
extern "C" int lw_prd_scatter_f64(const double* qWave, const double* aDamp,
                                  const double* Jw, const double* gammaPre,
                                  const double* Jbar, double* rho, int W,
                                  int Nk, int nFine, void* stream) {
    if (W < 1 || Nk < 1 || nFine < 1
        || static_cast<long long>(W) * Nk > 0x7fffffffLL - kThreads)
        return static_cast<int>(cudaErrorInvalidValue);
    const int pairs = W * Nk;
    prd_scatter_kernel<<<(pairs + kThreads - 1) / kThreads, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        qWave, aDamp, Jw, gammaPre, Jbar, rho, W, Nk, nFine);
    return static_cast<int>(cudaGetLastError());
}
