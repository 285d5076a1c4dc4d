// Blocked semi-parallel coordinate-descent cycle on Gram tiles, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/blocked_cd.py blocked_cd_pallas
// (its pl.pallas_call at line 132; body _make_blocked_cd_kernel at line
// 41). The F coordinates of each tile run as F/B blocks of width B, each
// with a mode from the Gershgorin safeguard on G alone
// (core.subproblem.blocked_cycle_modes):
//   mode 0: one B-wide proximal-Jacobi step from the shared snapshot
//           g = c - s, then s_k += sum_{j in block} delta_j G[j, k];
//   mode 1: two such steps of width B/2;
//   mode 2: the sequential chain over the block (as gram_cd.cu).
//
// Bound on the H100: latency, as gram_cd: F/B (mode 0) to F (mode 2)
// dependent steps; bytes and flops are tiny.
//
// The design is gram_cd's (one warp per feature block, all M in one
// launch, lane l owning k = l + 32 i with s_k in registers, G in shared
// memory by 1-D TMA behind per-chunk mbarriers, no block barrier), with
// the safeguard computed in the kernel, so one launch is the whole call:
//   prologue -- on the shared-memory G, chunk by chunk as it lands, lane
//     r of each 32 rows computes h_j = G_jj + nu and the Gershgorin ratios
//     of row j over its B block and its B/2 half, summing |G_jk| over the
//     block's columns in ascending order (the lanes start at staggered
//     columns so that they hit different banks); then each block's mode
//     from the rows' maxima against the threshold dom_tol, an argument
//     (0.9 by default in the wrappers; NaN counts as failing, as in the
//     plain version's amax). Where G does not fit in shared
//     memory the prologue streams it once through the ring and the cycle
//     streams it again.
//   cycle -- where B divides 32 (B = 1 .. 32) the blocks tile each 32-row
//     slab and the cycle is gram_cd's loop: every lane runs cd_delta on
//     its coordinate of the slab (held in registers) from the snapshot,
//     the step's deltas go to all lanes by __shfl_sync, and each lane
//     applies them row by row with one fused multiply-add each (row
//     order, as gram_cd, so at B = 1 the two kernels agree bit for bit);
//     a mode-2 block runs gram_cd's chain over its rows. B that do not
//     divide 32 find each step's coordinates at run time, and steps wider
//     than 32 pass their deltas through shared memory.
//   division -- every step divides with div_fast (cd_common.cuh); in the
//     rare tile where an owner's division leaves its range, the whole
//     cycle runs again with __fdiv_rn, so the result is always IEEE's.
#include "cd_common.cuh"

#define VECTORS 7            // c, h, base, rho (block), rho (half), deltas, modes

__device__ __forceinline__ float max_nan(float a, float b) {
    return (b > a || b != b) ? b : a;
}

// Row rr of the ring, wrapped at ring_rows (rr < 2 ring_rows).
__device__ __forceinline__ const float* ring_row(const CdRing& ring, int rr, int ring_rows) {
    return ring.ring + (size_t)(rr >= ring_rows ? rr - ring_rows : rr) * ring.F;
}

// s_k += delta * G[j, k] for the lane's k, from row Gr = G[j, :].
template <int NPL>
__device__ __forceinline__ void fma_row(float (&s)[NPL], float delta, const float* Gr,
                                        int F, int lane) {
#pragma unroll
    for (int ii = 0; ii < NPL; ++ii) {
        const int k = lane + 32 * ii;
        if (k < F) s[ii] = __fmaf_rn(delta, Gr[k], s[ii]);
    }
}

// The W rows of a Jacobi step from lo, in order: s_k += delta_j G[j, k],
// delta_j from lane j % 32.
template <int NPL>
__device__ __forceinline__ void jacobi_rows(float (&s)[NPL], float dl, const CdRing& ring,
                                            int r0, int ring_rows, int lo, int W, int F,
                                            int lane) {
#pragma unroll 4
    for (int j = lo; j < lo + W; ++j)
        fma_row<NPL>(s, __shfl_sync(FULL_MASK, dl, j & 31),
                     ring_row(ring, r0 + j, ring_rows), F, lane);
}

// What a cycle of blocked_cd reads and writes besides the ring.
struct CdTile {
    const float *c, *h, *base;    // shared: c, h = G_jj + nu, beta + dbeta0
    float* delta;                 // shared: deltas of steps wider than 32
    const int* mode;              // shared: the blocks' modes
    float* d;                     // global: this tile's output row
    int F, B;
    float lam;
    int lane;
};

// One blocked cycle, reading G's chunks v0 + q of the ring. IEEE: every
// step divides with __fdiv_rn; else with div_fast, and the return value
// says whether an owner's division left its range (the caller then runs
// the cycle again with IEEE).
template <int NPL, bool IEEE>
__device__ __forceinline__ bool blocked_cycle(CdRing& ring, int v0, const CdTile& t) {
    const int F = t.F, B = t.B, rows = ring.rows, stages = ring.stages, lane = t.lane;
    const int half = B / 2;
    float s[NPL];
#pragma unroll
    for (int i = 0; i < NPL; ++i) s[i] = 0.0f;
    bool bad = false;

    const int U = max(rows, B);
    if (!IEEE && 32 % B == 0 && U / rows <= stages) {
        // blocks tile each 32-row slab: the lane's coordinate of the slab
        // is in registers, as in gram_cd. The rows go in units of whole
        // chunks and whole blocks (U = max(rows, B), which divides 32 or is
        // F), each unit's chunks waited for before it and released after
        // (the chunk plan leaves room for a unit's chunks at every B <= 32).
        const int ring_rows = stages * rows;
        int b = 0;
#pragma unroll
        for (int i = 0; i < NPL; ++i) {
            const int j0 = 32 * i;
            if (j0 >= F) break;
            const int k = j0 + lane;
            const int kc = min(k, F - 1);
            const float ck = t.c[kc], hk = t.h[kc], bk = t.base[kc] + 0.0f;
            const float yk = __frcp_rn(hk);
            float dk = 0.0f;                         // the lane's d, stored after the slab
            for (int u0 = j0; u0 < min(j0 + 32, F); u0 += U) {
                const int uend = min(u0 + U, F);
                const int q0 = u0 / rows, q1 = (uend - 1) / rows;
                for (int q = q0; q <= q1; ++q) ring.wait(v0 + q);
                const int r0 = (v0 + q0) % stages * rows - u0;   // ring row of row j: r0 + j
                for (int start = u0; start < uend; start += B, ++b) {
                    const int mode = t.mode[b];
                    if (mode == 2 || B == 1) {
                        // the chain, gram_cd's step on each row of the block
                        for (int j = start; j < start + B; ++j) {
                            const int owner = j & 31;
                            bool slow;
                            const float dl = cd_delta(ck - s[i], hk, yk, bk, t.lam, slow);
                            bad |= slow & (lane == owner);
                            const float delta = __shfl_sync(FULL_MASK, dl, owner);
                            dk = lane == owner ? delta : dk;
                            fma_row<NPL>(s, delta, ring_row(ring, r0 + j, ring_rows), F, lane);
                        }
                        continue;
                    }
                    // Jacobi steps of width W: every owner's delta from the
                    // snapshot, then the W rows in order
                    const int W = mode == 0 ? B : half;
                    for (int lo = start; lo < start + B; lo += W) {
                        const bool owns = k >= lo && k < lo + W;
                        bool slow;
                        const float dl = cd_delta(ck - s[i], hk, yk, bk, t.lam, slow);
                        bad |= slow & owns;
                        dk = owns ? dl : dk;
                        jacobi_rows<NPL>(s, dl, ring, r0, ring_rows, lo, W, F, lane);
                    }
                }
                for (int q = q0; q <= q1; ++q) ring.release(v0 + q);
            }
            if (k < F) t.d[k] = 0.0f + dk;
        }
        return __any_sync(FULL_MASK, bad);
    }

    // any other B, and the rare IEEE pass (kept to one loop, as it needs
    // no speed): a step's coordinates are found at run time
    RowCursor cur{&ring, v0, -1, 0, nullptr};
    for (int b = 0; b < F / B; ++b) {
        const int start = b * B;
        const int mode = t.mode[b];
        const int W = mode == 0 ? B : (mode == 1 ? half : 1);
        for (int lo = start; lo < start + B; lo += W) {
            const int hi = lo + W;
            float dl = 0.0f;
            for (int k0 = lo; k0 < hi; k0 += 32) {
                const int k = k0 + ((lane - k0) & 31);   // the lane's coordinate
                const int kc = min(k, F - 1);             // every lane steps, in step
                const float hk = t.h[kc], gk = t.c[kc] - pick(s, kc >> 5);
                const float bk = t.base[kc] + 0.0f;
                if (IEEE) {
                    dl = cd_delta_ieee(gk, hk, bk, t.lam);
                } else {
                    bool slow;
                    dl = cd_delta(gk, hk, __frcp_rn(hk), bk, t.lam, slow);
                    bad |= slow & (k < hi);
                }
                if (k < hi) {
                    t.delta[k] = dl;
                    t.d[k] = 0.0f + dl;
                }
            }
            __syncwarp();
            for (int j = lo; j < hi; ++j) {
                const float* Gr = cur.next();
                const float delta = W <= 32 ? __shfl_sync(FULL_MASK, dl, j & 31)
                                            : t.delta[j];
#pragma unroll
                for (int ii = 0; ii < NPL; ++ii) {
                    const int k = lane + 32 * ii;
                    if (k < F) s[ii] = __fmaf_rn(delta, Gr[k], s[ii]);
                }
                cur.done();
            }
        }
    }
    return __any_sync(FULL_MASK, bad);
}

template <int NPL>
__global__ void __launch_bounds__(32, 1)
blocked_cd_kernel(const float* __restrict__ G, long long g_stride,
                  const float* __restrict__ c, long long c_stride,
                  const float* __restrict__ beta, long long b_stride,
                  const float* __restrict__ dbeta0, long long d0_stride,
                  float* __restrict__ d_out, int* __restrict__ modes_out,
                  int F, int B, int rows, int stages, int bulk, float lam,
                  float nu, float dom_tol) {
    extern __shared__ __align__(128) float sm[];
    const int lane = threadIdx.x;
    const int m = blockIdx.x;
    const float* Gm = G + (size_t)m * g_stride;
    float* c_sh = sm + (size_t)stages * rows * F;
    float* h_sh = c_sh + F;
    float* base_sh = h_sh + F;
    float* rf_sh = base_sh + F;        // row ratio over the B block
    float* rh_sh = rf_sh + F;          // row ratio over the B/2 half
    float* delta_sh = rh_sh + F;       // deltas of steps wider than 32
    int* mode_sh = reinterpret_cast<int*>(delta_sh + F);
    const int nchunks = (F + rows - 1) / rows;
    const bool resident = stages >= nchunks;
    CdRing ring{Gm, sm, cd_smem_u32(sm) + (uint32_t)cd_bar_offset(F, rows, stages, VECTORS),
                F, rows, stages, nchunks, resident ? nchunks : 2 * nchunks, lane,
                bulk != 0};
    ring.init();

    for (int k = lane; k < F; k += 32) {
        c_sh[k] = c[(size_t)m * c_stride + k];
        base_sh[k] = beta[(size_t)m * b_stride + k] + dbeta0[(size_t)m * d0_stride + k];
    }

    // ---- prologue: h and the row ratios, chunk by chunk ----
    const int half = B / 2;
    const bool even = (B % 2) == 0;
    const int span = B + (B < 32 ? B : 32) - 1;       // staggered sweep length
    for (int q = 0; q < nchunks; ++q) {
        ring.wait(q);
        const float* chunk = ring.stage(q);
        const int nr = ring.rows_of(q);
        for (int r = lane; r < nr; r += 32) {
            const int j = q * rows + r;
            const float* Gr = chunk + (size_t)r * F;
            const float gjj = Gr[j];
            const float h = gjj + nu;
            h_sh[j] = h;
            if (B > 1) {
                const int bs = j - j % B;                 // the block's first column
                const int hs = even ? j - j % half : 0;   // the half's first column
                const int skew = B <= 32 ? j % B : lane;
                const int plo = hs - bs;                 // the half within the block
                float full = 0.0f, part = 0.0f;
                // branch-free: a lane outside its columns adds an exact 0
                // (the sums are >= +0, so x + 0 == x bit for bit)
#pragma unroll 4
                for (int t = 0; t < span; ++t) {
                    const int k = t - skew;
                    // outside [0, B) read a column of the block anyway (wrapped, so
                    // the lanes stay on distinct banks) and add 0 for it
                    const int kk = k < 0 ? k + B : (k >= B ? k - B : k);
                    const float g = fabsf(Gr[bs + kk]);
                    const float a = k == kk ? g : 0.0f;
                    full = __fadd_rn(full, a);
                    part = __fadd_rn(part, (k >= plo && k < plo + half) ? a : 0.0f);
                }
                const float ad = fabsf(gjj);
                const float y = __frcp_rn(h);
                rf_sh[j] = div_rn(__fsub_rn(full, ad), h, y);
                rh_sh[j] = div_rn(__fsub_rn(part, ad), h, y);
            }
        }
        ring.release(q);
    }
    __syncwarp();

    const int nb = F / B;
    for (int b = lane; b < nb; b += 32) {
        int mode = 0;
        if (B > 1) {
            float rf = rf_sh[b * B], rh = rh_sh[b * B];
#pragma unroll 4
            for (int r = 1; r < B; ++r) {
                rf = max_nan(rf, rf_sh[b * B + r]);
                rh = max_nan(rh, rh_sh[b * B + r]);
            }
            mode = rf <= dom_tol ? 0 : ((even && rh <= dom_tol) ? 1 : 2);
        }
        mode_sh[b] = mode;
        if (modes_out != nullptr) modes_out[(size_t)m * nb + b] = mode;
    }
    __syncwarp();

    // ---- the cycle (again with IEEE division in the rare tile where an
    // owner's fast division left its range) ----
    float* dm = d_out + (size_t)m * F;
    const CdTile t{c_sh, h_sh, base_sh, delta_sh, mode_sh, dm, F, B, lam, lane};
    if (blocked_cycle<NPL, false>(ring, resident ? 0 : nchunks, t)) {
        const int v1 = resident ? 0 : 2 * nchunks;
        if (v1) ring.restart(v1);
        blocked_cycle<NPL, true>(ring, v1, t);
    }
}

// Plain C entry point for ctypes. Device pointers as gram_cd_launch, plus
// modes_out, an int32 (M, F/B) contiguous buffer the kernel fills with
// the per-block modes, or null, and dom_tol, the safeguard's threshold.
// rows, stages and smem come from kernels/gram_cd.py chunk_plan(F, 7). Returns cudaGetLastError() after
// the launch (0 = launched).
#define BLOCKED_CASE(N)                                                          \
    if (npl <= N) {                                                              \
        static int set = 0;                                                      \
        return cd_launch(blocked_cd_kernel<N>, set, M, smem, stream, G, g_stride, \
                         c, c_stride, beta, b_stride, dbeta0, d0_stride, d,      \
                         modes_out, F, B, rows, stages, bulk, lam, nu, dom_tol); \
    }

extern "C" int blocked_cd_launch(const float* G, long long g_stride,
                                 const float* c, long long c_stride,
                                 const float* beta, long long b_stride,
                                 const float* dbeta0, long long d0_stride,
                                 float* d, int* modes_out, int M, int F, int B,
                                 int rows, int stages, int smem, int bulk,
                                 float lam, float nu, float dom_tol,
                                 void* stream) {
    const int npl = (F + 31) / 32;
    BLOCKED_CASE(1)
    BLOCKED_CASE(2)
    BLOCKED_CASE(4)
    BLOCKED_CASE(8)
    BLOCKED_CASE(16)
    BLOCKED_CASE(32)
    return (int)cudaErrorInvalidValue;
}
