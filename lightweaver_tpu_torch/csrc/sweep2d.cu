// The 2D short-characteristics plane sweep of a group of rays of one
// direction (x periodic or with a fixed column, z stratified): one launch
// per group, the loop over the Nz - 1 planes inside each block.
//
// It replaces no TPU kernel: the JAX package leaves the plane sweep to
// XLA (lightweaver_tpu/ops/formal_solver2d.py has no Pallas kernel).  It
// was added because the plain PyTorch sweep (ops/formal_solver2d.py:
// sweep_rays_2d_plain, ~330 small torch ops per plane and direction) was
// bound by the host's launch rate on the 82 x 256 slab: 53,482 launches
// per MALI step, with the device idle for most of the step.  It computes
// the same function as that plain version, which runs for CPU tensors and
// is what the tests hold the kernel to:
//
//   for every (lambda, ray) row of chi [NL, R, Nz, Nx] (natural z order,
//   natural x), in the ray's dj = +1 frame (a ray with flip[r] set maps
//   frame column j to natural column Nx - 1 - j), the planes in sweep
//   order z0, z0 + dz, ...: the start plane's I is iupw, its Psi 0 and its
//   IeffBase iupw; at each later plane m, with S = srcNum / chi where the
//   source is given as srcNum, the upwind chi and S (linear or BESSER
//   interpolation, Interp), the along-ray step (linear w2 or BESSER,
//   Along; the linear step where dwZero marks no downwind point), then
//   the in-plane recurrence I_j = A_j I_{j-1} + b_j around the x ring
//   closed with I_last = b_tot / (1 - A_tot) (a fixed column, A = 0 and
//   b = ibc, breaks it into a chain), for BESSER interpolation a second
//   such solve with the control points frozen at the first one's I; out
//   I, Psi / chi and IeffBase = I - Psi S from the compensated split.
//
// Two kernels share the per-column arithmetic (local, besser_pass2,
// upwind_I), and one of them is built into a library (LW_SWEEP2D_COLS).
//
// The narrow kernel (rows of at most C x kMaxThreads columns).  One block
// per (lambda, ray) row, its threads over x: thread t owns the C
// consecutive frame columns from t C.  A thread keeps its columns' chi and
// S of planes m - 2 ... m + 1 in registers and loads plane m + 2 while
// plane m is computed, so every value is read from device memory once;
// the neighbours j - 1, j - 2 and j + 1 of its end columns come from the
// threads beside it through shared planes (a ring of 4 for chi and S, of
// 3 for I), which hold only the columns other threads read.  The geometry
// rows [Nz - 1, R, Nx], shared by every wavelength of a ray and read
// through L2, are loaded a plane ahead too.  The ring is solved as a
// block scan of the affine maps: each thread composes its own columns'
// maps in order, a warp scan composes the threads', one shared-memory
// pass the warps'; the ring closes with the total map and each thread
// runs its columns' recurrence from the I that enters them.  I, Psi / chi
// and IeffBase are written in place along x (the flipped rays' columns
// reversed within the same lines).
//
// The wide kernel (any Nx; built with LW_SWEEP2D_COLS = 0, for the rows
// the narrow one cannot take).  One block of kWideThreads per row, thread
// t taking frame column t + kWideThreads n of tile n.  It keeps nothing
// across planes: each plane reads chi, S and the earlier planes' I from
// device memory (through L1 and L2), and the row's work rows (p.work,
// kWideFields of [Nx]) hold what one pass over the tiles hands the next:
// each column's prefix map of the ring (the composition of the maps of
// columns 0 ... j) and the coefficients the later passes read.  Per
// plane: the local coefficients and the block scan of their maps tile by
// tile, the carry composed across tiles; the ring closure; I of every
// column from its prefix map; for BESSER interpolation the second pass
// the same way; IeffBase.
//
// Float64 divisions set the kernels' pace, so they take fewer than the
// plain version: one reciprocal of chi per point for S = srcNum / chi and
// Psi / chi, one quotient per BESSER control point (control_point) and
// products by reciprocals in the BESSER coefficients (coeffs).  With the
// ring scan's other association these are their only differences from
// the plain version, each at rounding level: the library is built with
// -fmad=false (ops/formal_solver2d.py:NVCC_FLAGS_2D), so every other
// operation is rounded as the plain version's separate torch ops round it
// (contracted multiply-adds would move w2's w1 = w0 - dtau e^-dtau, which
// cancels, at 1e-12 relative).
//
// Bound on an H100.  In one MALI step of the 82 x 256 slab (546 lambda x
// 12 rays per direction, 20,992 points) the kernel reads chi and srcNum
// and writes I, Psi and IeffBase once per (lambda, ray, point): 5 x 8 B x
// 546 x 12 x 20,992 x 2 directions = 11.0 GB in float64, 3.3 ms at 3.35
// TB/s.  The arithmetic counts ~150 float64 operations per point (~1.2
// ms at 34 TFLOP/s), but its divisions and exponentials expand to tens
// of instructions each in float64, and each block's planes form a serial
// chain, whose latency the 6,552 blocks per direction (546 lambda x 12
// rays) over 132 SMs have to cover: the arithmetic, not the bytes, is
// what the kernel waits on (PERF.md section 6).
//
// Limits, checked by launch (cudaErrorInvalidValue): Nz >= 2, Nx >= 2,
// NL R blocks in a grid; the narrow kernel Nx <= C x kMaxThreads and
// (11 Nx + 128) sizeof(T) bytes of shared memory (smem_bytes), within
// the default 48 KB at C = 2; the wide kernel a work array of at least
// NL R kWideFields Nx values.  Offsets are size_t.

#include "bezier3.cuh"

namespace {

constexpr int kMaxThreads = 256;    // the narrow kernel's widest block
constexpr int kWideThreads = 256;   // the wide kernel's block
// the wide kernel's work rows: the prefix maps (a, b), Ac, base, the
// source part of IeffBase and, for BESSER interpolation, the second
// pass's known part of the upwind I on a z grid line and across x
constexpr int kWideFields = 7;

// the upwind interpolation and the along-ray integration
// (ops/formal_solver2d.py:instance_flags passes these names)
enum Scheme : int { kLinear = 0, kBesser = 1 };

template <typename T>
struct Sweep2dArgs {
    const T* chi;            // [NL, R, Nz, Nx], natural z and x
    const T* src;            // S, or srcNum (srcIsNum), the same shape
    const T* iupw;           // [NL, R, Nx] natural: the start plane's I
    const T* ibc;            // [NL, R, Nz] natural z, or null (zero)
    const bool* axisZ;       // [Nz - 1, R, Nx] frame, sweep order
    const T* w;
    const T* ds;
    const bool* dwAxisZ;
    const T* dwW;
    const T* dwDs;
    const bool* dwZero;
    const bool* fixed;       // [R, Nx] frame
    const bool* flip;        // [R]
    T* Iout;                 // [NL, R, Nz, Nx] natural
    T* psiOut;
    T* ieffOut;
    T* work;                 // wide kernel: [NL R, kWideFields, Nx] frame
    int R, Nz, Nx, z0, dz;
    bool srcIsNum;
};

template <typename T>
constexpr size_t smem_bytes(int Nx) {
    return (11 * static_cast<size_t>(Nx) + 128) * sizeof(T);
}

// x -> a x + b
template <typename T>
struct Affine {
    T a, b;
};

// m applied after `first`
template <typename T>
__device__ __forceinline__ Affine<T> after(Affine<T> m, Affine<T> first) {
    return {m.a * first.a, m.a * first.b + m.b};
}

template <typename T>
__device__ __forceinline__ Affine<T> warp_inclusive(Affine<T> m, int lane) {
#pragma unroll
    for (int s = 1; s < 32; s <<= 1) {
        const T a = __shfl_up_sync(lw::kFullWarp, m.a, s);
        const T b = __shfl_up_sync(lw::kFullWarp, m.b, s);
        if (lane >= s) m = after(m, Affine<T>{a, b});
    }
    return m;
}

// The block's scan of one map per thread in thread order: the
// composition of the maps of the threads before this one and of all of
// them.  scratch: 64 T of shared memory, not reused before a barrier
// that follows this scan.
template <typename T>
__device__ __forceinline__ void block_scan(Affine<T> own, T* scratch,
                                           Affine<T>& before,
                                           Affine<T>& total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int nw = blockDim.x >> 5;
    const Affine<T> inc = warp_inclusive(own, lane);
    Affine<T> lanes{__shfl_up_sync(lw::kFullWarp, inc.a, 1),
                    __shfl_up_sync(lw::kFullWarp, inc.b, 1)};
    if (lane == 0) lanes = {T(1), T(0)};
    if (lane == 31) {
        scratch[warp] = inc.a;
        scratch[32 + warp] = inc.b;
    }
    __syncthreads();
    if (warp == 0) {
        Affine<T> wm = lane < nw ? Affine<T>{scratch[lane], scratch[32 + lane]}
                                 : Affine<T>{T(1), T(0)};
        wm = warp_inclusive(wm, lane);
        if (lane < nw) {
            scratch[lane] = wm.a;
            scratch[32 + lane] = wm.b;
        }
    }
    __syncthreads();
    const Affine<T> warps = warp > 0
        ? Affine<T>{scratch[warp - 1], scratch[31 + warp]}
        : Affine<T>{T(1), T(0)};
    before = after(lanes, warps);
    total = {scratch[nw - 1], scratch[31 + nw]};
}

// The cyclic recurrence I_j = A_j I_{j-1} + b_j over the block's columns
// in ring order, of this thread's c columns; Iin is the I that enters
// them (I_{j0 - 1}, around the ring for thread 0).
template <int C, typename T>
__device__ __forceinline__ void ring_solve(const T (&A)[C], const T (&b)[C],
                                           int c, T* scratch, T (&I)[C],
                                           T& Iin) {
    Affine<T> own{T(1), T(0)};
#pragma unroll
    for (int k = 0; k < C; ++k)
        if (k < c) own = after(Affine<T>{A[k], b[k]}, own);
    Affine<T> before, total;
    block_scan(own, scratch, before, total);
    const T Ilast = total.b / (T(1) - total.a);
    Iin = before.a * Ilast + before.b;
    T prev = Iin;
#pragma unroll
    for (int k = 0; k < C; ++k)
        if (k < c) {
            I[k] = A[k] * prev + b[k];
            prev = I[k];
        }
}

// Put the columns of v that other threads read (the first, the last and
// the one before it) in the shared plane.
template <int C, typename T>
__device__ __forceinline__ void put_edges(T* plane, const T (&v)[C], int j0,
                                          int c) {
#pragma unroll
    for (int k = 0; k < C; ++k)
        if (k < c && (k == 0 || k >= c - 2)) plane[j0 + k] = v[k];
}

// v at column j0 + k - d (d = 1, 2) around the ring: this thread's
// register or the shared plane
template <int C, typename T>
__device__ __forceinline__ T left(const T (&v)[C], const T* plane, int k,
                                  int d, int j0, int Nx) {
    if (k >= d) return v[k >= d ? k - d : 0];
    int j = j0 + k - d;
    if (j < 0) j += Nx;
    return plane[j];
}

// v at column j0 + k + 1 around the ring
template <int C, typename T>
__device__ __forceinline__ T right(const T (&v)[C], const T* plane, int k,
                                   int c, int j0, int Nx) {
    if (k + 1 < C && k + 1 < c) return v[k + 1 < C ? k + 1 : k];
    int j = j0 + k + 1;
    if (j >= Nx) j -= Nx;
    return plane[j];
}

// lw::besser_control_point with one quotient where it takes three: for
// hM, hP > 0, dM dP <= 0 is (yO - yM)(yP - yO) <= 0, dM >= 0 is
// yO >= yM, and yO' = (hM^2 (yP - yO) + hP^2 (yO - yM)) / (hM hP (hM +
// hP)); the fixed cM's quotient is formed only where it is used.  The
// same value to rounding (bit for bit at hM = hP = 1).
template <typename T>
__device__ __forceinline__ T control_point(T hM, T hP, T yM, T yO, T yP) {
    const T eM = yO - yM, eP = yP - yO;
    if (eM * eP <= T(0.0)) return yO;
    const T yOp = (hM * hM * eP + hP * hP * eM) / (hM * hP * (hM + hP));
    const T cM = yO - T(0.5) * hM * yOp;
    const T cP = yO + T(0.5) * hP * yOp;
    const bool incr = eM >= T(0.0);
    const T minYMO = incr ? yM : yO, maxYMO = incr ? yO : yM;
    const T minYOP = incr ? yO : yP, maxYOP = incr ? yP : yO;
    if (cM < minYMO || cM > maxYMO) return yM;
    if (cP < minYOP || cP > maxYOP)
        return yO - T(0.5) * hM * (eP / (T(0.5) * hP));
    return cM;
}

// lw::besser_coeffs with its divisions turned into products: the Taylor
// branch multiplies by the reciprocals of its constant divisors, the
// closed forms by 1 / t^2; the two agree to rounding.
template <typename T>
__device__ __forceinline__ void coeffs(T t, T& M, T& O, T& C, T& e) {
    if (t < T(0.14)) {
        M = (t * (t * (t * (t * (t * (t * ((T(140.0) - T(18.0) * t) * t
             - T(945.0)) + T(5400.0)) - T(25200.0)) + T(90720.0))
             - T(226800.0)) + T(302400.0))) * T(1.0 / 907200.0);
        O = (t * (t * (t * (t * (t * (t * ((T(10.0) - t) * t - T(90.0))
             + T(720.0)) - T(5040.0)) + T(30240.0)) - T(151200.0))
             + T(604800.0))) * T(1.0 / 1814400.0);
        C = (t * (t * (t * (t * (t * (t * ((T(35.0) - T(4.0) * t) * t
             - T(270.0)) + T(1800.0)) - T(10080.0)) + T(45360.0))
             - T(151200.0)) + T(302400.0))) * T(1.0 / 907200.0);
        const T t3 = t * t * t;
        e = T(1.0) - t + T(0.5) * t * t - t3 * T(1.0 / 6.0)
            + t * t3 * T(1.0 / 24.0) - t * t * t3 * T(1.0 / 120.0)
            + t3 * t3 * T(1.0 / 720.0) - t3 * t3 * t * T(1.0 / 5040.0);
    } else {
        const T t2 = t * t;
        const T r2 = T(1.0) / t2;
        const T edt = exp(-fmin(t, T(200.0)));
        M = (T(2.0) - edt * (t2 + T(2.0) * t + T(2.0))) * r2;
        O = T(1.0) - T(2.0) * (edt + t - T(1.0)) * r2;
        C = T(2.0) * (t - T(2.0) + edt * (t + T(2.0))) * r2;
        e = edt;
    }
}

// Monotonic quadratic-Bezier interpolation between yM (u = 0) and yO
// (u = 1), the control point shaped by yP
// (ops/formal_solver2d.py:_besser_interp).
template <typename T>
__device__ __forceinline__ T besser_interp(T yM, T yO, T yP, T u) {
    const T cM = control_point(T(1), T(1), yM, yO, yP);
    const T omu = T(1) - u;
    return omu * omu * yM + T(2) * u * omu * cM + u * u * yO;
}

// chi or S at the points column j's step on plane m reads upwind (frame
// columns): the upwind interpolation's u0, u1, u2 ((m, j-1), (m-1, j-1),
// (m-2, j-1) where the upwind point lies on a z grid line, axisZ; else
// (m-1, j), (m-1, j-1), (m-1, j-2); u2 for BESSER only) and the point
// itself c.
template <typename T>
struct Stencil {
    T u0, u1, u2, c;
};

// chi and S at the BESSER downwind interpolation's points: (m, j+1) where
// the downwind point lies on a z grid line (dwAxisZ), else (m+1, j); and
// (m+1, j+1).  Read only where the step needs them (local's dw), so that
// they are not held while the upwind part is computed.
template <typename T>
struct Downwind {
    T chi0, chi1, s0, s1;
};

// a column's geometry on one plane (ray_group's rows)
template <typename T>
struct Geom {
    T w, ds, dwW, dwDs;
    bool az, dwA, dwZ;
};

template <typename T, int Along>
__device__ __forceinline__ Geom<T> load_geom(const Sweep2dArgs<T>& p,
                                             size_t g) {
    Geom<T> o{};
    o.az = p.axisZ[g];
    o.w = p.w[g];
    o.ds = p.ds[g];
    o.dwZ = true;
    if (Along == kBesser) {
        o.dwZ = p.dwZero[g];
        o.dwA = p.dwAxisZ[g];
        o.dwW = p.dwW[g];
        o.dwDs = p.dwDs[g];
    }
    return o;
}

template <typename T, int Interp>
__device__ __forceinline__ T upwind(const Stencil<T>& s, T w) {
    if (Interp == kBesser) return besser_interp(s.u0, s.u1, s.u2, w);
    return (T(1) - w) * s.u0 + w * s.u1;
}

// One column's local coefficients on a plane (the plain version's
// _plane_step up to its ring solve): its map I = A I_{j-1} + b, the
// upwind I's weight Ac, the known part base, Psi (times chi) and the
// source part of IeffBase.  Ip, IPP: I of the plane before at j, j - 1;
// dw(): the column's Downwind values.
template <typename T>
struct Local {
    T A, b, Ac, base, psi, ieffS;
};

template <typename T, int Interp, int Along, typename DW>
__device__ __forceinline__ Local<T> local(const Stencil<T>& chi,
                                          const Stencil<T>& S,
                                          const Geom<T>& g, T Ip, T IPP,
                                          bool fixed, T ibc, DW dw) {
    Local<T> o;
    const T w = g.w, ds = g.ds;
    const T omw = T(1) - w;
    const T chiUw = upwind<T, Interp>(chi, w);
    const T SUw = upwind<T, Interp>(S, w);
    const T chiC = chi.c, SC = S.c;
    if (Along != kBesser || g.dwZ) {
        // linear along-ray step (w2)
        const T dtau = T(0.5) * (chiUw + chiC) * ds;
        T w0, w1;
        lw::w2(dtau, w0, w1);
        const T c1 = (SUw - SC) / dtau;
        o.Ac = T(1) - w0;
        o.base = w0 * SC + w1 * c1;
        o.psi = w0 - w1 / dtau;
        o.ieffS = w1 * SUw / dtau;
    } else {
        // BESSER along the ray: chi and S control points from the
        // downwind intersection
        const T omdw = T(1) - g.dwW;
        const Downwind<T> d = dw();
        const T chiDw = omdw * d.chi0 + g.dwW * d.chi1;
        const T SDw = omdw * d.s0 + g.dwW * d.s1;
        const T chiCtrl = control_point(ds, g.dwDs, chiUw, chiC, chiDw);
        const T dtauUw = (T(1) / T(3)) * (chiUw + chiCtrl + chiC) * ds;
        const T dtauDw = T(0.5) * (chiC + chiDw) * g.dwDs;
        const T SCtrl = control_point(dtauUw, dtauDw, SUw, SC, SDw);
        T M, O, Cc, edt;
        coeffs(dtauUw, M, O, Cc, edt);
        o.Ac = edt;
        o.base = M * SUw + O * SC + Cc * SCtrl;
        o.psi = O + Cc;
        o.ieffS = M * SUw + Cc * (SCtrl - SC);
    }
    // the known part of Ac Iuw; the (current, j - 1) term is the in-plane
    // coupling A
    const T IuwX = omw * Ip + w * IPP;
    o.b = g.az ? o.base + o.Ac * w * IPP : o.base + o.Ac * IuwX;
    o.A = g.az ? o.Ac * omw : T(0);
    if (fixed) {
        o.A = T(0);
        o.b = ibc;
        o.psi = T(0);
    }
    return o;
}

// BESSER interpolation's second pass of one column: its map with the
// upwind I's control point frozen at the first pass's I (prevI, at
// j - 1), and the parts of the upwind I this leaves known (knownZ on a z
// grid line, IuwX across x).  IPm2: I of the plane before at j - 2;
// Ip2m1: I of the plane before that at j - 1.
template <typename T>
struct Pass2 {
    T A, b, knownZ, IuwX;
};

template <typename T>
__device__ __forceinline__ Pass2<T> besser_pass2(const Geom<T>& g, T Ac,
                                                 T base, bool fixed, T ibc,
                                                 T Ip, T IPP, T IPm2,
                                                 T Ip2m1, T prevI) {
    Pass2<T> o;
    const T w = g.w, omw = T(1) - w;
    o.IuwX = besser_interp(Ip, IPP, IPm2, w);
    const T cM = control_point(T(1), T(1), prevI, IPP, Ip2m1);
    o.knownZ = T(2) * w * omw * cM + w * w * IPP;
    o.b = g.az ? base + Ac * o.knownZ : base + Ac * o.IuwX;
    o.A = g.az ? Ac * (omw * omw) : T(0);
    if (fixed) {
        o.A = T(0);
        o.b = ibc;
    }
    return o;
}

// The upwind I of the along-ray step once the plane's I is solved (prevI
// at j - 1), for IeffBase = ieffS + Ac Iuw.
template <typename T, int Interp>
__device__ __forceinline__ T upwind_I(const Geom<T>& g, T prevI, T Ip,
                                      T IPP, T knownZ, T IuwX) {
    const T w = g.w, omw = T(1) - w;
    if (Interp == kBesser) return g.az ? (omw * omw) * prevI + knownZ : IuwX;
    return g.az ? omw * prevI + w * IPP : omw * Ip + w * IPP;
}

template <typename T, int Interp, int Along, int C>
__global__ void __launch_bounds__(kMaxThreads)
    sweep2d_kernel(const Sweep2dArgs<T> p) {
    extern __shared__ __align__(16) unsigned char smemRaw[];
    const int Nx = p.Nx, Nz = p.Nz, R = p.R;
    // shared planes: chi and S [4][Nx] (plane m at m & 3), I [3][Nx]
    // (plane m at m % 3), the two scans' [2][64]
    T* const chiPl = reinterpret_cast<T*>(smemRaw);
    T* const sPl = chiPl + 4 * Nx;
    T* const iPl = chiPl + 8 * Nx;
    T* const scratch = chiPl + 11 * Nx;

    const int row = blockIdx.x;   // l R + r
    const int r = row % R;
    const bool flip = p.flip[r];
    const size_t rowOff = static_cast<size_t>(row) * Nz * Nx;
    const int j0 = threadIdx.x * C;
    const int c = max(0, min(C, Nx - j0));
    int nat[C];
#pragma unroll
    for (int k = 0; k < C; ++k) nat[k] = flip ? Nx - 1 - (j0 + k) : j0 + k;

    auto zOf = [&](int m) { return p.z0 + m * p.dz; };
    auto load = [&](int m, T (&cv)[C], T (&sv)[C]) {
        const size_t off = rowOff + static_cast<size_t>(zOf(m)) * Nx;
#pragma unroll
        for (int k = 0; k < C; ++k)
            if (k < c) {
                cv[k] = p.chi[off + nat[k]];
                sv[k] = p.src[off + nat[k]];
            }
    };
    auto source = [&](const T (&cv)[C], T (&sv)[C], T (&rv)[C]) {
#pragma unroll
        for (int k = 0; k < C; ++k)
            if (k < c) {
                rv[k] = T(1) / cv[k];
                if (p.srcIsNum) sv[k] = sv[k] * rv[k];
            }
    };

    // planes m - 2, m - 1, m, m + 1 (m - 2 the first plane at m = 1, the
    // next plane the current one past the last), the next load, the
    // intensities of planes m - 1 and m - 2
    T cP2[C], cP[C], cC[C], cN[C], cX[C];
    T sP2[C], sP[C], sC[C], sN[C], sX[C];
    T Ip[C], Ip2[C];
    T rC[C], rN[C], rX[C];   // 1 / chi of planes m, m + 1, m + 2

    // the geometry of a computed plane, loaded a plane ahead
    auto loadGeom = [&](int m, Geom<T> (&gv)[C]) {
        const size_t g = (static_cast<size_t>(m - 1) * R + r) * Nx + j0;
#pragma unroll
        for (int k = 0; k < C; ++k)
            if (k < c) gv[k] = load_geom<T, Along>(p, g + k);
    };
    auto loadIbc = [&](int m) {
        return p.ibc ? p.ibc[static_cast<size_t>(row) * Nz + zOf(m)] : T(0);
    };
    bool fx[C];
#pragma unroll
    for (int k = 0; k < C; ++k)
        fx[k] = k < c && p.fixed[static_cast<size_t>(r) * Nx + j0 + k];
    Geom<T> gN[C];
    loadGeom(1, gN);
    T ibcN = loadIbc(1);

    // the start plane
    {
        const size_t o = rowOff + static_cast<size_t>(p.z0) * Nx;
        const size_t ob = static_cast<size_t>(row) * Nx;
#pragma unroll
        for (int k = 0; k < C; ++k)
            if (k < c) {
                Ip[k] = Ip2[k] = p.iupw[ob + nat[k]];
                p.Iout[o + nat[k]] = Ip[k];
                p.psiOut[o + nat[k]] = T(0);
                p.ieffOut[o + nat[k]] = Ip[k];
            }
    }
    load(0, cP, sP);
    load(1, cC, sC);
    if (Nz > 2) load(2, cN, sN);
    {
        T r0[C];
        source(cP, sP, r0);
    }
    source(cC, sC, rC);
#pragma unroll
    for (int k = 0; k < C; ++k) {
        cP2[k] = cP[k];
        sP2[k] = sP[k];
    }
    if (Nz > 2) {
        source(cN, sN, rN);
    } else {
#pragma unroll
        for (int k = 0; k < C; ++k) {
            cN[k] = cC[k];
            sN[k] = sC[k];
            rN[k] = rC[k];
        }
    }
    put_edges(chiPl, cP, j0, c);
    put_edges(sPl, sP, j0, c);
    put_edges(chiPl + Nx, cC, j0, c);
    put_edges(sPl + Nx, sC, j0, c);
    put_edges(iPl, Ip, j0, c);

    for (int m = 1; m < Nz; ++m) {
        const bool hasNext = m + 1 < Nz;
        if (hasNext) {
            put_edges(chiPl + ((m + 1) & 3) * Nx, cN, j0, c);
            put_edges(sPl + ((m + 1) & 3) * Nx, sN, j0, c);
        }
        if (m + 2 < Nz) load(m + 2, cX, sX);
        Geom<T> gC[C];
#pragma unroll
        for (int k = 0; k < C; ++k) gC[k] = gN[k];
        const T ibcP = ibcN;
        if (hasNext) {
            loadGeom(m + 1, gN);
            ibcN = loadIbc(m + 1);
        }
        __syncthreads();

        const T* chiP2s = chiPl + (max(m - 2, 0) & 3) * Nx;
        const T* chiPs = chiPl + ((m - 1) & 3) * Nx;
        const T* chiCs = chiPl + (m & 3) * Nx;
        const T* chiNs = chiPl + ((hasNext ? m + 1 : m) & 3) * Nx;
        const T* sP2s = sPl + (max(m - 2, 0) & 3) * Nx;
        const T* sPs = sPl + ((m - 1) & 3) * Nx;
        const T* sCs = sPl + (m & 3) * Nx;
        const T* sNs = sPl + ((hasNext ? m + 1 : m) & 3) * Nx;
        const T* iPs = iPl + ((m - 1) % 3) * Nx;
        const T* iP2s = iPl + (max(m - 2, 0) % 3) * Nx;
        const size_t oz = rowOff + static_cast<size_t>(zOf(m)) * Nx;

        // chi or S at column k's stencil: registers or the shared planes
        auto stencil = [&](const T (&P2)[C], const T (&P)[C],
                           const T (&Cu)[C], const T* P2s, const T* Ps,
                           const T* Cs, int k, bool az) {
            Stencil<T> s{};
            s.u0 = az ? left(Cu, Cs, k, 1, j0, Nx) : P[k];
            s.u1 = left(P, Ps, k, 1, j0, Nx);
            if (Interp == kBesser)
                s.u2 = az ? left(P2, P2s, k, 1, j0, Nx)
                          : left(P, Ps, k, 2, j0, Nx);
            s.c = Cu[k];
            return s;
        };

        // the local coefficients of every column
        T A[C], b[C], Ac[C], base[C], ieffS[C], IPP[C], Icur[C];
#pragma unroll
        for (int k = 0; k < C; ++k) {
            if (k >= c) continue;
            IPP[k] = left(Ip, iPs, k, 1, j0, Nx);
            const bool dwA = gC[k].dwA;
            const Local<T> l = local<T, Interp, Along>(
                stencil(cP2, cP, cC, chiP2s, chiPs, chiCs, k, gC[k].az),
                stencil(sP2, sP, sC, sP2s, sPs, sCs, k, gC[k].az), gC[k],
                Ip[k], IPP[k], fx[k], ibcP, [&] {
                    return Downwind<T>{
                        dwA ? right(cC, chiCs, k, c, j0, Nx) : cN[k],
                        right(cN, chiNs, k, c, j0, Nx),
                        dwA ? right(sC, sCs, k, c, j0, Nx) : sN[k],
                        right(sN, sNs, k, c, j0, Nx)};
                });
            A[k] = l.A;
            b[k] = l.b;
            Ac[k] = l.Ac;
            base[k] = l.base;
            ieffS[k] = l.ieffS;
            p.psiOut[oz + nat[k]] = l.psi * rC[k];
        }
        T Iin;
        ring_solve(A, b, c, scratch, Icur, Iin);

        T knownZ[C], IuwX[C];
        if (Interp == kBesser) {
            // second pass: BESSER-interpolated upwind I, the control point
            // frozen at the first pass's solution
#pragma unroll
            for (int k = 0; k < C; ++k) {
                if (k >= c) continue;
                const T prevI = k == 0 ? Iin : Icur[k > 0 ? k - 1 : 0];
                const Pass2<T> q = besser_pass2(
                    gC[k], Ac[k], base[k], fx[k], ibcP, Ip[k], IPP[k],
                    left(Ip, iPs, k, 2, j0, Nx),
                    left(Ip2, iP2s, k, 1, j0, Nx), prevI);
                A[k] = q.A;
                b[k] = q.b;
                knownZ[k] = q.knownZ;
                IuwX[k] = q.IuwX;
            }
            ring_solve(A, b, c, scratch + 64, Icur, Iin);
        }
#pragma unroll
        for (int k = 0; k < C; ++k) {
            if (k >= c) continue;
            const T prevI = k == 0 ? Iin : Icur[k > 0 ? k - 1 : 0];
            const T Iuw = upwind_I<T, Interp>(
                gC[k], prevI, Ip[k], IPP[k],
                Interp == kBesser ? knownZ[k] : T(0),
                Interp == kBesser ? IuwX[k] : T(0));
            // compensated split: I - Psi S from non-cancelling terms
            p.Iout[oz + nat[k]] = Icur[k];
            p.ieffOut[oz + nat[k]] = fx[k] ? Icur[k] : ieffS[k] + Ac[k] * Iuw;
        }
        put_edges(iPl + (m % 3) * Nx, Icur, j0, c);

        // slide the window by one plane
        if (m + 2 < Nz) source(cX, sX, rX);
#pragma unroll
        for (int k = 0; k < C; ++k) {
            cP2[k] = cP[k];
            cP[k] = cC[k];
            cC[k] = cN[k];
            cN[k] = m + 2 < Nz ? cX[k] : cC[k];
            sP2[k] = sP[k];
            sP[k] = sC[k];
            sC[k] = sN[k];
            sN[k] = m + 2 < Nz ? sX[k] : sC[k];
            Ip2[k] = Ip[k];
            Ip[k] = Icur[k];
            rC[k] = rN[k];
            rN[k] = m + 2 < Nz ? rX[k] : rC[k];
        }
    }
}

template <typename T, int Interp, int Along>
__global__ void __launch_bounds__(kWideThreads)
    sweep2d_wide_kernel(const Sweep2dArgs<T> p) {
    __shared__ T scratch[64];
    const int Nx = p.Nx, Nz = p.Nz, R = p.R;
    const int row = blockIdx.x;   // l R + r
    const int r = row % R;
    const bool flip = p.flip[r];
    const size_t rowOff = static_cast<size_t>(row) * Nz * Nx;
    T* const qa = p.work + static_cast<size_t>(row) * kWideFields * Nx;
    T* const qb = qa + Nx;
    T* const wAc = qa + 2 * Nx;
    T* const wBase = qa + 3 * Nx;
    T* const wIeffS = qa + 4 * Nx;
    T* const wKnownZ = qa + 5 * Nx;
    T* const wIuwX = qa + 6 * Nx;

    // the offset of frame column j (around the ring) of sweep plane m
    auto at = [&](int m, int j) {
        if (j < 0) j += Nx;
        if (j >= Nx) j -= Nx;
        return rowOff + static_cast<size_t>(p.z0 + m * p.dz) * Nx
            + (flip ? Nx - 1 - j : j);
    };
    auto chiAt = [&](int m, int j) { return p.chi[at(m, j)]; };
    auto sAt = [&](int m, int j) {
        const size_t o = at(m, j);
        return p.srcIsNum ? p.src[o] * (T(1) / p.chi[o]) : p.src[o];
    };
    auto iAt = [&](int m, int j) { return p.Iout[at(m, j)]; };
    auto fixedAt = [&](int j) {
        return p.fixed[static_cast<size_t>(r) * Nx + j];
    };

    for (int j = threadIdx.x; j < Nx; j += kWideThreads) {
        const T i0 = p.iupw[static_cast<size_t>(row) * Nx
                            + (flip ? Nx - 1 - j : j)];
        const size_t o = at(0, j);
        p.Iout[o] = i0;
        p.psiOut[o] = T(0);
        p.ieffOut[o] = i0;
    }
    __syncthreads();

    for (int m = 1; m < Nz; ++m) {
        const int mP2 = max(m - 2, 0), mN = m + 1 < Nz ? m + 1 : m;
        const T ibc = p.ibc
            ? p.ibc[static_cast<size_t>(row) * Nz + p.z0 + m * p.dz] : T(0);
        const size_t g0 = (static_cast<size_t>(m - 1) * R + r) * Nx;
        auto stencil = [&](auto val, int j, bool az) {
            Stencil<T> s{};
            s.u0 = az ? val(m, j - 1) : val(m - 1, j);
            s.u1 = val(m - 1, j - 1);
            if (Interp == kBesser)
                s.u2 = az ? val(mP2, j - 1) : val(m - 1, j - 2);
            s.c = val(m, j);
            return s;
        };
        // the ring's maps of every column (mapOf), scanned tile by tile
        // into the prefix maps; returns the total map
        auto scan = [&](auto mapOf) {
            Affine<T> carry{T(1), T(0)};
            for (int t0 = 0; t0 < Nx; t0 += kWideThreads) {
                const int j = t0 + static_cast<int>(threadIdx.x);
                const Affine<T> own =
                    j < Nx ? mapOf(j) : Affine<T>{T(1), T(0)};
                Affine<T> before, total;
                block_scan(own, scratch, before, total);
                if (j < Nx) {
                    const Affine<T> q = after(after(own, before), carry);
                    qa[j] = q.a;
                    qb[j] = q.b;
                }
                carry = after(total, carry);
                __syncthreads();
            }
            return carry;
        };
        // the plane's I from the prefix maps and the ring's closure
        auto solve = [&](Affine<T> total) {
            const T Ilast = total.b / (T(1) - total.a);
            for (int j = threadIdx.x; j < Nx; j += kWideThreads)
                p.Iout[at(m, j)] = qa[j] * Ilast + qb[j];
            __syncthreads();
        };

        solve(scan([&](int j) {
            const Geom<T> g = load_geom<T, Along>(p, g0 + j);
            const Local<T> l = local<T, Interp, Along>(
                stencil(chiAt, j, g.az), stencil(sAt, j, g.az), g,
                iAt(m - 1, j), iAt(m - 1, j - 1), fixedAt(j), ibc, [&] {
                    const int m0 = g.dwA ? m : mN, j0 = g.dwA ? j + 1 : j;
                    return Downwind<T>{chiAt(m0, j0), chiAt(mN, j + 1),
                                       sAt(m0, j0), sAt(mN, j + 1)};
                });
            p.psiOut[at(m, j)] = l.psi * (T(1) / chiAt(m, j));
            wAc[j] = l.Ac;
            wBase[j] = l.base;
            wIeffS[j] = l.ieffS;
            return Affine<T>{l.A, l.b};
        }));
        if (Interp == kBesser) {
            // second pass, from the first pass's I of this plane
            solve(scan([&](int j) {
                const Geom<T> g = load_geom<T, kLinear>(p, g0 + j);
                const Pass2<T> q = besser_pass2(
                    g, wAc[j], wBase[j], fixedAt(j), ibc, iAt(m - 1, j),
                    iAt(m - 1, j - 1), iAt(m - 1, j - 2), iAt(mP2, j - 1),
                    iAt(m, j - 1));
                wKnownZ[j] = q.knownZ;
                wIuwX[j] = q.IuwX;
                return Affine<T>{q.A, q.b};
            }));
        }
        for (int j = threadIdx.x; j < Nx; j += kWideThreads) {
            const Geom<T> g = load_geom<T, kLinear>(p, g0 + j);
            const T I = iAt(m, j);
            const T Iuw = upwind_I<T, Interp>(
                g, iAt(m, j - 1), iAt(m - 1, j), iAt(m - 1, j - 1),
                Interp == kBesser ? wKnownZ[j] : T(0),
                Interp == kBesser ? wIuwX[j] : T(0));
            p.ieffOut[at(m, j)] = fixedAt(j) ? I : wIeffS[j] + wAc[j] * Iuw;
        }
        __syncthreads();
    }
}

template <typename T, int Interp, int Along, int C>
int launch(const Sweep2dArgs<T>& p, int NL, long long workElems,
           void* stream) {
    if (NL < 1 || p.R < 1 || p.Nz < 2 || p.Nx < 2
        || (p.dz != 1 && p.dz != -1)
        || static_cast<long long>(NL) * p.R > 0x7fffffffLL)
        return static_cast<int>(cudaErrorInvalidValue);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if constexpr (C > 0) {
        const int threads = ((p.Nx + C - 1) / C + 31) / 32 * 32;
        if (threads > kMaxThreads)
            return static_cast<int>(cudaErrorInvalidValue);
        sweep2d_kernel<T, Interp, Along, C>
            <<<NL * p.R, threads, smem_bytes<T>(p.Nx), s>>>(p);
    } else {
        if (p.work == nullptr || workElems < static_cast<long long>(NL)
                * p.R * kWideFields * p.Nx)
            return static_cast<int>(cudaErrorInvalidValue);
        sweep2d_wide_kernel<T, Interp, Along><<<NL * p.R, kWideThreads, 0,
                                                s>>>(p);
    }
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One instance per library, chosen when the library is built
// (ops/formal_solver2d.py:instance_flags): the working type
// LW_SWEEP2D_REAL, the upwind interpolation LW_SWEEP2D_INTERP and the
// along-ray integration LW_SWEEP2D_ALONG (Scheme names) and the narrow
// kernel's columns per thread LW_SWEEP2D_COLS, 0 for the wide kernel; so
// a scheme's first use builds one kernel.
#if !defined(LW_SWEEP2D_REAL) || !defined(LW_SWEEP2D_INTERP) \
    || !defined(LW_SWEEP2D_ALONG) || !defined(LW_SWEEP2D_COLS)
#error "build csrc/sweep2d.cu with ops/formal_solver2d.py:instance_flags"
#endif

extern "C" int lw_sweep2d(
    const LW_SWEEP2D_REAL* chi, const LW_SWEEP2D_REAL* src,
    const LW_SWEEP2D_REAL* iupw, const LW_SWEEP2D_REAL* ibc,
    const bool* axisZ, const LW_SWEEP2D_REAL* w, const LW_SWEEP2D_REAL* ds,
    const bool* dwAxisZ, const LW_SWEEP2D_REAL* dwW,
    const LW_SWEEP2D_REAL* dwDs, const bool* dwZero, const bool* fixed,
    const bool* flip, LW_SWEEP2D_REAL* Iout, LW_SWEEP2D_REAL* psi,
    LW_SWEEP2D_REAL* ieff, LW_SWEEP2D_REAL* work, long long workElems,
    int NL, int R, int Nz, int Nx, int z0, int dz, int srcIsNum,
    void* stream) {
    using T = LW_SWEEP2D_REAL;
    const Sweep2dArgs<T> p{chi, src, iupw, ibc, axisZ, w, ds, dwAxisZ, dwW,
                           dwDs, dwZero, fixed, flip, Iout, psi, ieff, work,
                           R, Nz, Nx, z0, dz, srcIsNum != 0};
    return launch<T, LW_SWEEP2D_INTERP, LW_SWEEP2D_ALONG, LW_SWEEP2D_COLS>(
        p, NL, workElems, stream);
}
