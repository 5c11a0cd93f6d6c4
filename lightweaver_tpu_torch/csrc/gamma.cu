// Line part of the MALI Gamma/rate accumulation for every same-atom
// overlap group of lines of every active atom, in one launch.
//
// Replaces the TPU kernel lightweaver_tpu/ops/pallas_gamma.py:
// group_gamma_rates (inner `kernel`, the pallas_call at line 249), in two
// instances: float64 (lw_line_gamma_f64) and float32 (lw_line_gamma_f32),
// the precision the TPU runs it in.  Computes the same function as the
// plain PyTorch version lightweaver_tpu_torch/ops/gamma.py:
// line_gamma_rates_plain (group_gamma_rates_plain per group).  For a group
// of K lines, every row r of its union window (global wavelength row
// l = row0 + r), depth k and ray (d, mu), with w = wmu/2:
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
// Design.  The TPU kernel ran each group's union window as a sequential
// grid of row blocks with depth on the lanes, one pallas_call per group.
// Here a group table (ops/gamma.py:line_table, built once per Context)
// holds every group's statics and its offsets into packed inputs and
// outputs, and one launch covers a flat list of work items (group, BW-row
// block, 32-depth tile), one item per thread block.  K is uniform within
// a block: the kernel switches to a device function templated on K =
// 1..4 (line_block) and, for larger groups, to one where K is a runtime
// value up to KMAX = 16 (line_block_any).  A block is 32 depths x BW =
// 8 rows, one thread per (depth, row): each warp reads one row at 32
// neighbouring depths, coalesced in the direction-major [2, Nlam, Nmu,
// Nk] layout.  A thread loops over the
// 2 Nmu rays and the K members of its row; the block then sums the 8
// rows' G4 partials in shared memory in row order (deterministic, no
// atomics) and writes one partial per (member, quantity, block, depth);
// the caller sums the blocks in f64 as the JAX caller does.  In float32
// that is the TPU kernel's contract: products and partials in float over
// at most BW rows x 2 Nmu rays.  PPB and PairPPB are written per row.
// The per-member continuum rows (chi_i, chi_j, U_i, U_j of the thread's
// own row and depth) and the members' coefficient rows live in shared
// memory, not in per-thread arrays, which keeps the float64 K = 4 path
// under 255 registers without spills; the shared continuum slab is
// reused for the row reduction.
//
// Index widths.  The kernel is pointwise in depth, so a batch of columns
// laid end to end along Nk runs through it as one wide atmosphere.  Ray
// tensor, continuum-row and etaC offsets are size_t; the packed per-group
// offsets (phi, rho, wphi, G4, PPB, pair) and Nlam, Nmu, Nk are int,
// which ops/gamma.py keeps below 2^31 (LineTable refuses larger packed
// buffers, line_gamma_rates a ray tensor past 2^31 - 1 elements).
//
// Bound on an H100: bytes.  Every group reads Psi, IeffBase, I and srcNum
// on its window rows (4 x 2 Nmu Nk values per row) plus phi and rho of
// each member and its levels' continuum rows; at falc_h6mg (Nk = 82) all
// groups read ~36 MB in f64, ~11 us at 3.35 TB/s, half in float32.  The
// old per-group launches left the card idle between 13 small grids; one
// launch of a few hundred to a few thousand 256-thread blocks fills the
// 132 SMs.

#include <cuda_runtime.h>

namespace {

constexpr int KMAX = 16;  // largest group the table holds
constexpr int KTPL = 4;   // largest group with a path templated on K
constexpr int BW = 8;     // rows per block of G4
constexpr int TK = 32;    // depths per thread block

// one group of the table; mirrors ops/gamma.py:_META (int32 fields)
struct LineGroup {
    int K, row0, Wu, nBlk, atom;
    int phiOff, coefOff, wphiOff, rhoOff, g4Off, ppbOff, pairOff;
    int levels[KMAX][2];   // global (i, j) rows of n / chiCL / UCL
    // per member m, bit m2 of the low / high 16 bits: [0] +chi_m2 / -chi_m2
    // in chi_i, [1] the same in chi_j, [2] U_m2 in U_i / U_j
    int masks[KMAX][3];
};
constexpr int NMETA = sizeof(LineGroup) / sizeof(int);
static_assert(NMETA == 12 + 5 * KMAX, "ops/gamma.py:_META");

template <typename T>
struct Args {
    const T* phi;      // packed [K, 2, Wu, Nmu, Nk] per group
    const T* rho;      // packed [K, Wu, Nk] per group
    const T* psi;      // [2, Nlam, Nmu, Nk]
    const T* ieffb;    // [2, Nlam, Nmu, Nk]
    const T* I;        // [2, Nlam, Nmu, Nk]
    const T* src;      // [2, Nlam, Nmu, Nk]
    const T* chiCL;    // [nLev, Nlam, Nk], the active atoms' levels stacked
    const T* UCL;      // [nLev, Nlam, Nk]
    const T* etaC;     // [nAtoms, Nlam, Nk]
    const T* n;        // [nLev, Nk]
    const T* coef;     // packed [K, Wu, 4]: a1, g, u, wlambda 4pi/hc
    const T* wphi;     // packed [K, Nk]
    const T* wmuHalf;  // [Nmu]
    T* G4;             // packed [K, 4, nBlk, Nk]
    T* PPB;            // packed [K, Wu, Nk]
    T* pair;           // packed [max(P, 1), Wu, Nk]
    int Nlam, Nmu, Nk;
};

__device__ __forceinline__ bool bit(int mask, int b) {
    return (mask >> b) & 1;
}

// the K <= 4 paths' one-word mask of member m: bits over m2, [0,4) +chi_m2
// in chi_i, [4,8) -chi_m2 in chi_i, [8,12) and [12,16) the same in chi_j,
// [16,20) U_m2 in U_i, [20,24) U_m2 in U_j
__device__ __forceinline__ int compact_mask(const int* mk) {
    auto half = [](int w, int h) { return (w >> (16 * h)) & 0xF; };
    return half(mk[0], 0) | half(mk[0], 1) << 4 | half(mk[1], 0) << 8
           | half(mk[1], 1) << 12 | half(mk[2], 0) << 16
           | half(mk[2], 1) << 20;
}

// One work item: rows [blk BW, blk BW + BW) of group G at depths
// [tile TK, tile TK + TK).  sm: 4 K BW TK + 3 K BW values of T.
template <typename T, int K>
__device__ __forceinline__ void line_block(const Args<T>& a,
                                           const LineGroup& G, int blk,
                                           int tile, T* sm) {
    constexpr int P = K * (K - 1) / 2;
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int t = ty * TK + tx;
    const int Nk = a.Nk, Nlam = a.Nlam, Nmu = a.Nmu, Wu = G.Wu;
    const int k = tile * TK + tx;
    const int r = blk * BW + ty;
    const bool live = k < Nk && r < Wu;
    // [4][K][BW][TK]: chi_i, chi_j, U_i, U_j continuum rows per member of
    // this thread's (row, depth); afterwards the [4K][BW][TK] reduction
    T* sCont = sm;
    T* sCoef = sm + 4 * K * BW * TK;     // [K][BW][3]: a1, g, u
    auto cont = [&](int q, int m) -> T& {
        return sCont[((q * K + m) * BW + ty) * TK + tx];
    };

    for (int q = t; q < K * BW; q += BW * TK) {
        const int m = q / BW, rr = blk * BW + q % BW;
        for (int c = 0; c < 3; ++c)
            sCoef[q * 3 + c] =
                rr < Wu ? a.coef[G.coefOff + (m * Wu + rr) * 4 + c] : T(0.0);
    }

    T acc[K][4];
#pragma unroll
    for (int m = 0; m < K; ++m)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[m][c] = T(0.0);
    T nI[K], nJ[K], rh[K], wl[K];
    int mask[K];
    T etaCb = T(0.0);
    const int l = G.row0 + r;
    if (live) {
#pragma unroll
        for (int m = 0; m < K; ++m) {
            const int li = G.levels[m][0], lj = G.levels[m][1];
            nI[m] = a.n[li * Nk + k];
            nJ[m] = a.n[lj * Nk + k];
            rh[m] = a.rho[G.rhoOff + (m * Wu + r) * Nk + k];
            wl[m] = a.coef[G.coefOff + (m * Wu + r) * 4 + 3]
                    * a.wphi[G.wphiOff + m * Nk + k];
            mask[m] = compact_mask(G.masks[m]);
            const size_t oi = (static_cast<size_t>(li) * Nlam + l) * Nk + k;
            const size_t oj = (static_cast<size_t>(lj) * Nlam + l) * Nk + k;
            cont(0, m) = a.chiCL[oi];
            cont(1, m) = a.chiCL[oj];
            cont(2, m) = a.UCL[oi];
            cont(3, m) = a.UCL[oj];
        }
        etaCb = a.etaC[(static_cast<size_t>(G.atom) * Nlam + l) * Nk + k];
    }
    __syncthreads();   // sCoef

    if (live) {
        const T* cf = sCoef + ty * 3;   // member m at cf[m BW 3 + c]
        T ppb[K], pp[P > 0 ? P : 1];
#pragma unroll
        for (int m = 0; m < K; ++m) ppb[m] = T(0.0);
#pragma unroll
        for (int p = 0; p < P; ++p) pp[p] = T(0.0);

        for (int d = 0; d < 2; ++d) {
            for (int mu = 0; mu < Nmu; ++mu) {
                const T w = a.wmuHalf[mu];
                const size_t off =
                    ((static_cast<size_t>(d) * Nlam + l) * Nmu + mu) * Nk + k;
                const T ps = a.psi[off];
                T ph[K], v1[K], v2[K], chiM[K];
                T etaA = etaCb;
#pragma unroll
                for (int m = 0; m < K; ++m) {
                    ph[m] = a.phi[G.phiOff
                                  + (((m * 2 + d) * Wu + r) * Nmu + mu) * Nk
                                  + k];
                    v1[m] = cf[m * BW * 3] * ph[m];
                    v2[m] = cf[m * BW * 3 + 1] * v1[m] * rh[m];
                    chiM[m] = nI[m] * v1[m] - nJ[m] * v2[m];
                    etaA = etaA + nJ[m] * (cf[m * BW * 3 + 2] * v2[m]);
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
                const T Ieff = a.ieffb[off] + ps * (a.src[off] - etaA);
                const T Iw = a.I[off];
#pragma unroll
                for (int m = 0; m < K; ++m) {
                    T chi_i = cont(0, m), chi_j = cont(1, m);
                    T U_i = cont(2, m), U_j = cont(3, m);
#pragma unroll
                    for (int m2 = 0; m2 < K; ++m2) {
                        if (bit(mask[m], m2)) chi_i += chiM[m2];
                        if (bit(mask[m], 4 + m2)) chi_i -= chiM[m2];
                        if (bit(mask[m], 8 + m2)) chi_j += chiM[m2];
                        if (bit(mask[m], 12 + m2)) chi_j -= chiM[m2];
                        const T u2 = cf[m2 * BW * 3 + 2] * v2[m2];
                        if (bit(mask[m], 16 + m2)) U_i += u2;
                        if (bit(mask[m], 20 + m2)) U_j += u2;
                    }
                    const T u2m = cf[m * BW * 3 + 2] * v2[m];
                    const T wlw = w * wl[m];
                    acc[m][0] += ((u2m + v2[m] * Ieff) - ps * chi_i * U_j)
                                 * wlw;
                    acc[m][1] += (v1[m] * Ieff - ps * chi_j * U_i) * wlw;
                    acc[m][2] += Iw * v1[m] * wlw;
                    acc[m][3] += (u2m + Iw * v2[m]) * wlw;
                }
            }
        }
#pragma unroll
        for (int m = 0; m < K; ++m)
            a.PPB[G.ppbOff + (m * Wu + r) * Nk + k] = ppb[m];
        if (P == 0)
            a.pair[G.pairOff + r * Nk + k] = T(0.0);
#pragma unroll
        for (int p = 0; p < P; ++p)
            a.pair[G.pairOff + (p * Wu + r) * Nk + k] = pp[p];
    }

    // G4: the block's 8 rows summed in row order
    __syncthreads();   // every thread is done with its continuum rows
#pragma unroll
    for (int m = 0; m < K; ++m)
#pragma unroll
        for (int c = 0; c < 4; ++c)
            sCont[((m * 4 + c) * BW + ty) * TK + tx] = acc[m][c];
    __syncthreads();
    // 4 K TK sums: more than the block's threads for K >= 3
    for (int qk = t; qk < 4 * K * TK; qk += BW * TK) {
        const int q = qk / TK, kk = qk % TK, kq = tile * TK + kk;
        if (kq < Nk) {
            T s = T(0.0);
#pragma unroll
            for (int rr = 0; rr < BW; ++rr) s += sCont[(q * BW + rr) * TK + kk];
            a.G4[G.g4Off + (q * G.nBlk + blk) * Nk + kq] = s;
        }
    }
}

// A group of K > KTPL members, K a runtime value: the same function and
// order of terms as line_block, with no per-member arrays.  The members'
// coefficient rows are in shared memory; PPB and each pair's moment take
// their own pass over the rays; G4 goes member by member, each pass over
// the rays forming etaAtom and member m's level sums from all K members
// again (K^2 member terms per ray instead of K, no registers per member),
// and the block's 8 rows are summed per member in a [4][BW][TK] shared
// tile.  sm: 3 K BW + 4 BW TK values of T.
template <typename T>
__device__ __forceinline__ void line_block_any(const Args<T>& a,
                                               const LineGroup& G, int blk,
                                               int tile, T* sm) {
    const int K = G.K;
    const int tx = threadIdx.x, ty = threadIdx.y;
    const int t = ty * TK + tx;
    const int Nk = a.Nk, Nlam = a.Nlam, Nmu = a.Nmu, Wu = G.Wu;
    const int k = tile * TK + tx;
    const int r = blk * BW + ty;
    const bool live = k < Nk && r < Wu;
    const int l = G.row0 + r;
    T* sCoef = sm;                 // [K][BW][3]: a1, g, u
    T* sRed = sm + 3 * K * BW;     // [4][BW][TK]
    for (int q = t; q < K * BW; q += BW * TK) {
        const int m = q / BW, rr = blk * BW + q % BW;
        for (int c = 0; c < 3; ++c)
            sCoef[q * 3 + c] =
                rr < Wu ? a.coef[G.coefOff + (m * Wu + rr) * 4 + c] : T(0.0);
    }
    __syncthreads();
    const T* cf = sCoef + ty * 3;   // member m at cf[m BW 3 + c]
    auto rayOff = [&](int d, int mu) {
        return ((static_cast<size_t>(d) * Nlam + l) * Nmu + mu) * Nk + k;
    };
    auto phiAt = [&](int m, int d, int mu) {
        return a.phi[G.phiOff + (((m * 2 + d) * Wu + r) * Nmu + mu) * Nk + k];
    };

    if (live) {
        for (int m = 0; m < K; ++m) {
            T s = T(0.0);
            for (int d = 0; d < 2; ++d)
                for (int mu = 0; mu < Nmu; ++mu)
                    s += a.wmuHalf[mu] * phiAt(m, d, mu)
                         * a.psi[rayOff(d, mu)];
            a.PPB[G.ppbOff + (m * Wu + r) * Nk + k] = s;
        }
        int p = 0;
        for (int m = 0; m < K; ++m) {
            for (int m2 = m + 1; m2 < K; ++m2, ++p) {
                T s = T(0.0);
                for (int d = 0; d < 2; ++d)
                    for (int mu = 0; mu < Nmu; ++mu)
                        s += a.wmuHalf[mu] * phiAt(m, d, mu)
                             * phiAt(m2, d, mu) * a.psi[rayOff(d, mu)];
                a.pair[G.pairOff + (p * Wu + r) * Nk + k] = s;
            }
        }
    }

    for (int m = 0; m < K; ++m) {
        T acc[4] = {T(0.0), T(0.0), T(0.0), T(0.0)};
        if (live) {
            const int li = G.levels[m][0], lj = G.levels[m][1];
            const size_t oi = (static_cast<size_t>(li) * Nlam + l) * Nk + k;
            const size_t oj = (static_cast<size_t>(lj) * Nlam + l) * Nk + k;
            const int mkI = G.masks[m][0], mkJ = G.masks[m][1],
                      mkU = G.masks[m][2];
            const T wl = a.coef[G.coefOff + (m * Wu + r) * 4 + 3]
                         * a.wphi[G.wphiOff + m * Nk + k];
            const T etaCb =
                a.etaC[(static_cast<size_t>(G.atom) * Nlam + l) * Nk + k];
            for (int d = 0; d < 2; ++d) {
                for (int mu = 0; mu < Nmu; ++mu) {
                    const T w = a.wmuHalf[mu];
                    const size_t off = rayOff(d, mu);
                    const T ps = a.psi[off];
                    T etaA = etaCb;
                    T chi_i = a.chiCL[oi], chi_j = a.chiCL[oj];
                    T U_i = a.UCL[oi], U_j = a.UCL[oj];
                    T v1m = T(0.0), v2m = T(0.0);
                    for (int m2 = 0; m2 < K; ++m2) {
                        const T v1 = cf[m2 * BW * 3] * phiAt(m2, d, mu);
                        const T v2 = cf[m2 * BW * 3 + 1] * v1
                            * a.rho[G.rhoOff + (m2 * Wu + r) * Nk + k];
                        const T nI = a.n[G.levels[m2][0] * Nk + k];
                        const T nJ = a.n[G.levels[m2][1] * Nk + k];
                        const T chiM = nI * v1 - nJ * v2;
                        const T u2 = cf[m2 * BW * 3 + 2] * v2;
                        etaA = etaA + nJ * u2;
                        if (bit(mkI, m2)) chi_i += chiM;
                        if (bit(mkI, 16 + m2)) chi_i -= chiM;
                        if (bit(mkJ, m2)) chi_j += chiM;
                        if (bit(mkJ, 16 + m2)) chi_j -= chiM;
                        if (bit(mkU, m2)) U_i += u2;
                        if (bit(mkU, 16 + m2)) U_j += u2;
                        if (m2 == m) {
                            v1m = v1;
                            v2m = v2;
                        }
                    }
                    const T Ieff = a.ieffb[off] + ps * (a.src[off] - etaA);
                    const T Iw = a.I[off];
                    const T u2m = cf[m * BW * 3 + 2] * v2m;
                    const T wlw = w * wl;
                    acc[0] += ((u2m + v2m * Ieff) - ps * chi_i * U_j) * wlw;
                    acc[1] += (v1m * Ieff - ps * chi_j * U_i) * wlw;
                    acc[2] += Iw * v1m * wlw;
                    acc[3] += (u2m + Iw * v2m) * wlw;
                }
            }
        }
        for (int c = 0; c < 4; ++c) sRed[(c * BW + ty) * TK + tx] = acc[c];
        __syncthreads();
        if (t < 4 * TK) {
            const int c = t / TK, kk = t % TK, kq = tile * TK + kk;
            if (kq < Nk) {
                T s = T(0.0);
                for (int rr = 0; rr < BW; ++rr)
                    s += sRed[(c * BW + rr) * TK + kk];
                a.G4[G.g4Off + ((m * 4 + c) * G.nBlk + blk) * Nk + kq] = s;
            }
        }
        __syncthreads();   // sRed is the next member's
    }
}

template <typename T>
__global__ void __launch_bounds__(BW * TK)
    line_gamma_kernel(Args<T> a, const int* __restrict__ groups,
                      const int* __restrict__ items) {
    extern __shared__ __align__(16) unsigned char smRaw[];
    __shared__ LineGroup sG;
    const int* item = items + 3 * blockIdx.x;
    const int t = threadIdx.y * TK + threadIdx.x;
    if (t < NMETA)
        reinterpret_cast<int*>(&sG)[t] = groups[item[0] * NMETA + t];
    __syncthreads();
    T* sm = reinterpret_cast<T*>(smRaw);
    switch (sG.K) {
        case 1: line_block<T, 1>(a, sG, item[1], item[2], sm); break;
        case 2: line_block<T, 2>(a, sG, item[1], item[2], sm); break;
        case 3: line_block<T, 3>(a, sG, item[1], item[2], sm); break;
        case 4: line_block<T, 4>(a, sG, item[1], item[2], sm); break;
        default: line_block_any<T>(a, sG, item[1], item[2], sm); break;
    }
}

template <typename T>
int launch(const Args<T>& a, const int* groups, const int* items,
           int nItems, int maxK, void* stream) {
    if (maxK < 1 || maxK > KMAX || nItems < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    // the templated paths' slab for the groups of K <= KTPL, the runtime
    // path's for larger ones: at most 33.5 KB (float64, K = KTPL), under
    // the 48 KB a launch may take without opting in
    const int kT = maxK < KTPL ? maxK : KTPL;
    size_t smem = sizeof(T) * (4 * kT * BW * TK + 3 * kT * BW);
    if (maxK > KTPL) {
        const size_t any = sizeof(T) * (3 * maxK * BW + 4 * BW * TK);
        smem = any > smem ? any : smem;
    }
    line_gamma_kernel<T><<<nItems, dim3(TK, BW), smem,
                           static_cast<cudaStream_t>(stream)>>>(a, groups,
                                                                items);
    return static_cast<int>(cudaGetLastError());
}

template <typename T>
Args<T> make_args(const T* phi, const T* rho, const T* psi, const T* ieffb,
                  const T* I, const T* src, const T* chiCL, const T* UCL,
                  const T* etaC, const T* n, const T* coef, const T* wphi,
                  const T* wmuHalf, T* G4, T* PPB, T* pair, int Nlam, int Nmu,
                  int Nk) {
    return Args<T>{phi,  rho,  psi,     ieffb, I,   src,  chiCL, UCL, etaC,
                   n,    coef, wphi,    wmuHalf, G4, PPB, pair,  Nlam, Nmu,
                   Nk};
}

}  // namespace

extern "C" int lw_line_gamma_f64(
    const double* phi, const double* rho, const double* psi,
    const double* ieffb, const double* I, const double* src,
    const double* chiCL, const double* UCL, const double* etaC,
    const double* n, const double* coef, const double* wphi,
    const double* wmuHalf, double* G4, double* PPB, double* pair,
    const int* groups, const int* items, int nItems, int maxK, int Nlam,
    int Nmu, int Nk, void* stream) {
    return launch<double>(
        make_args<double>(phi, rho, psi, ieffb, I, src, chiCL, UCL, etaC, n,
                          coef, wphi, wmuHalf, G4, PPB, pair, Nlam, Nmu, Nk),
        groups, items, nItems, maxK, stream);
}

extern "C" int lw_line_gamma_f32(
    const float* phi, const float* rho, const float* psi, const float* ieffb,
    const float* I, const float* src, const float* chiCL, const float* UCL,
    const float* etaC, const float* n, const float* coef, const float* wphi,
    const float* wmuHalf, float* G4, float* PPB, float* pair,
    const int* groups, const int* items, int nItems, int maxK, int Nlam,
    int Nmu, int Nk, void* stream) {
    return launch<float>(
        make_args<float>(phi, rho, psi, ieffb, I, src, chiCL, UCL, etaC, n,
                         coef, wphi, wmuHalf, G4, PPB, pair, Nlam, Nmu, Nk),
        groups, items, nItems, maxK, stream);
}
