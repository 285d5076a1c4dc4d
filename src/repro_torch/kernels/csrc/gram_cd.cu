// Sequential coordinate-descent cycle on Gram tiles, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/gram_cd.py gram_cd_pallas (its
// pl.pallas_call at line 66). For each of M feature blocks, one cycle
// over the F coordinates of the tile G = X_F^T diag(w) X_F:
//   for j = 0..F-1:  g = c_j - s_j,  h = G_jj + nu,  b_old = beta_j +
//   dbeta0_j + d_j,  delta = T(g + b_old h, lam)/h - b_old,
//   d_j += delta,  s_k += delta * G[j, k] for every k.
// G is read by row j, as the TPU kernel does.
//
// Bound on the H100: the latency of the chain, not bytes or flops. The
// cycle is F dependent scalar steps; its bytes (G once, four F-vectors:
// 0.32 us at F = 128, M = 16) and flops (2 M F^2) are tiny, and no chain
// of F steps can come near that byte bound. Tensor cores do not apply
// (rank-1 updates between dependent scalar steps).
//
// The design shortens each step's critical path: one warp per feature
// block (all M in one launch), no block barrier in the loop. Lane l owns
// the coordinates k = l + 32 i, s_k in registers; the kernel is templated
// on F/32 and unrolled, so no register array is indexed at run time.
// c, base = beta + dbeta0 and h = G_jj + nu are staged in shared memory
// and held in registers for the lane's coordinate of the current 32-row
// slab. At step j every lane runs cd_delta on its own coordinate of the
// slab; the owner's (lane j % 32) result goes to all lanes by __shfl_sync
// (nothing on the step's critical path touches memory or branches: the
// division is div_fast, and in the rare tile where an owner's division
// leaves its range the whole cycle runs again with __fdiv_rn), and each lane
// updates its s_k with __fmaf_rn(delta, G[j, k], s_k) in row order. G
// arrives by 1-D TMA in chunks of rows, each behind its own mbarrier
// (cd_common.cuh CdRing): at F = 128 the whole tile is resident and step j
// waits only for the chunk of row j; where F F 4 bytes exceed a block's
// shared memory (F >= 256) the chunks form a ring refilled behind the
// chain.
#include "cd_common.cuh"

// One cycle over the tile, reading G's chunks v0 + q of the ring. IEEE:
// every step divides with __fdiv_rn; else with div_fast, and the return
// value says whether an owner's division left its range (the caller then
// runs the cycle again with IEEE, so the result is always __fdiv_rn's).
template <int NPL, bool IEEE>
__device__ __forceinline__ bool gram_cycle(CdRing& ring, int v0, const float* c_sh,
                                           const float* h_sh, const float* base_sh,
                                           float* dm, int F, float lam, int lane) {
    const int rows = ring.rows;
    float s[NPL];
#pragma unroll
    for (int i = 0; i < NPL; ++i) s[i] = 0.0f;
    bool bad = false;

#pragma unroll
    for (int i = 0; i < NPL; ++i) {                 // slab of rows 32 i ..
        const int j0 = 32 * i;
        if (j0 >= F) break;
        // the lane's coordinate of this slab: every lane runs the step on
        // its own, the owner's result is broadcast
        const int kl = j0 + lane;
        const int k = min(kl, F - 1);
        const float ck = c_sh[k], hk = h_sh[k], bk = base_sh[k] + 0.0f;
        const float yk = __frcp_rn(hk);
        float dk = 0.0f;                             // the lane's d, stored after the slab
        for (int l0 = 0; l0 < 32 && j0 + l0 < F; l0 += rows) {
            const int q = (j0 + l0) / rows;          // rows divides 32 or is F
            ring.wait(v0 + q);
            const int jend = min(min(j0 + l0 + rows, j0 + 32), F);
            const float* Gr = ring.stage(v0 + q) + (size_t)(j0 + l0 - q * rows) * F;
            for (int j = j0 + l0; j < jend; ++j, Gr += F) {
                const int owner = j & 31;
                float dl;
                if (IEEE) {
                    dl = cd_delta_ieee(ck - s[i], hk, bk, lam);
                } else {
                    bool slow;
                    dl = cd_delta(ck - s[i], hk, yk, bk, lam, slow);
                    bad |= slow & (lane == owner);
                }
                const float delta = __shfl_sync(FULL_MASK, dl, owner);
                dk = lane == owner ? delta : dk;
#pragma unroll
                for (int ii = 0; ii < NPL; ++ii) {
                    const int kk = lane + 32 * ii;
                    if (kk < F) s[ii] = __fmaf_rn(delta, Gr[kk], s[ii]);
                }
            }
            ring.release(v0 + q);
        }
        if (kl < F) dm[kl] = 0.0f + dk;
    }
    return __any_sync(FULL_MASK, bad);
}

template <int NPL>
__global__ void __launch_bounds__(32, 1)
gram_cd_kernel(const float* __restrict__ G, long long g_stride,
               const float* __restrict__ c, long long c_stride,
               const float* __restrict__ beta, long long b_stride,
               const float* __restrict__ dbeta0, long long d0_stride,
               float* __restrict__ d_out,
               int F, int rows, int stages, int bulk, float lam, float nu) {
    extern __shared__ __align__(128) float sm[];
    const int lane = threadIdx.x;
    const int m = blockIdx.x;
    const float* Gm = G + (size_t)m * g_stride;
    float* c_sh = sm + (size_t)stages * rows * F;
    float* h_sh = c_sh + F;
    float* base_sh = h_sh + F;
    const int nchunks = (F + rows - 1) / rows;
    CdRing ring{Gm, sm, cd_smem_u32(sm) + (uint32_t)cd_bar_offset(F, rows, stages, 3),
                F, rows, stages, nchunks, nchunks, lane, bulk != 0};
    ring.init();

#pragma unroll
    for (int i = 0; i < NPL; ++i) {                 // all loads in flight at once
        const int k = lane + 32 * i;
        if (k < F) {
            c_sh[k] = c[(size_t)m * c_stride + k];
            base_sh[k] = beta[(size_t)m * b_stride + k] + dbeta0[(size_t)m * d0_stride + k];
            h_sh[k] = Gm[(size_t)k * F + k] + nu;
        }
    }
    __syncwarp();

    float* dm = d_out + (size_t)m * F;
    if (gram_cycle<NPL, false>(ring, 0, c_sh, h_sh, base_sh, dm, F, lam, lane)) {
        // rare (zero or extreme h, tiny or huge numerators): again, IEEE
        const int v0 = ring.resident() ? 0 : nchunks;
        if (v0) ring.restart(v0);
        gram_cycle<NPL, true>(ring, v0, c_sh, h_sh, base_sh, dm, F, lam, lane);
    }
}

// Plain C entry point for ctypes. Device pointers: G (M, F, F) with rows
// of F floats and tile stride g_stride; c, beta, dbeta0 (M, F) with unit
// inner stride and the given row strides; d (M, F) contiguous. rows,
// stages and smem come from kernels/gram_cd.py chunk_plan(F, 3); bulk
// says G's rows may be copied by TMA (F % 4 == 0, G 16-byte aligned).
// Returns cudaGetLastError() after the launch (0 = launched).
#define GRAM_CASE(N)                                                          \
    if (npl <= N) {                                                           \
        static int set = 0;                                                   \
        return cd_launch(gram_cd_kernel<N>, set, M, smem, stream, G, g_stride, \
                         c, c_stride, beta, b_stride, dbeta0, d0_stride, d, F, \
                         rows, stages, bulk, lam, nu);                        \
    }

extern "C" int gram_cd_launch(const float* G, long long g_stride,
                              const float* c, long long c_stride,
                              const float* beta, long long b_stride,
                              const float* dbeta0, long long d0_stride,
                              float* d, int M, int F, int rows, int stages,
                              int smem, int bulk, float lam, float nu,
                              void* stream) {
    const int npl = (F + 31) / 32;
    GRAM_CASE(1)
    GRAM_CASE(2)
    GRAM_CASE(4)
    GRAM_CASE(8)
    GRAM_CASE(16)
    GRAM_CASE(32)
    return (int)cudaErrorInvalidValue;
}

// Check of div_rn against __fdiv_rn on n pseudo-random pairs (t, h): the
// three quarters of them with exponents in [-70, 70] (h > 0) exercise the
// fast sequence and its guard's edges; the rest are random bit patterns
// (zeros, subnormals, infinities, NaNs), which take the other branches.
// Adds the number of pairs whose results differ in their bits (NaNs
// compare equal to NaNs) to *bad.
__device__ __forceinline__ unsigned long long cd_mix64(unsigned long long z) {
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    return z ^ (z >> 31);
}

__global__ void cd_div_check_kernel(unsigned long long n, unsigned long long seed,
                                    unsigned long long* bad) {
    unsigned long long count = 0;
    const unsigned long long step = (unsigned long long)gridDim.x * blockDim.x;
    for (unsigned long long i = (unsigned long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += step) {
        const unsigned long long z = cd_mix64(seed + 0x9e3779b97f4a7c15ULL * (i + 1));
        unsigned int a = (unsigned int)z, b = (unsigned int)(z >> 32);
        if ((i & 3) != 3) {
            const unsigned int ea = 57 + (a >> 23) % 141, eb = 57 + (b >> 23) % 141;
            a = (a & 0x807fffffu) | (ea << 23);
            b = (b & 0x007fffffu) | (eb << 23);
        }
        const float t = __uint_as_float(a), h = __uint_as_float(b);
        const float x = div_rn(t, h, __frcp_rn(h)), y = __fdiv_rn(t, h);
        count += (__float_as_uint(x) != __float_as_uint(y)) && !(x != x && y != y);
    }
    if (count) atomicAdd(bad, count);
}

extern "C" int cd_div_check_launch(unsigned long long n, unsigned long long seed,
                                   unsigned long long* bad, void* stream) {
    cd_div_check_kernel<<<1056, 256, 0, (cudaStream_t)stream>>>(n, seed, bad);
    return (int)cudaGetLastError();
}
