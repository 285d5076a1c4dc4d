// Weighted Gram tile and correlation straight from a feature slab, with
// the gathers fused, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/sparse_slab.py slab_gram_pallas
// (its pl.pallas_call at line 81). For each batch row (a feature block) and
// a tile of T features with K slots each (local example rows, sentinels
// >= n_loc), from rows, vals, the weights w (n_loc) and the batch row's
// residuals r (n_loc):
//   G[a, b] = sum over slot pairs (ka, kb) with rows[a, ka] == rows[b, kb]
//             < n_loc of wv[a, ka] * va[b, kb]      (= X_F^T diag(w) X_F)
//   c[b]    = sum_k cva[b, k]                      (= X_F^T (w r))
// with va = v, wv = w[x] * v and cva = v * (w[x] * r[x]) at a live slot of
// row x and all three 0 at a sentinel, each rounded as the plain path's
// gathers round them (kernels/ops.py _sentinel_zeroed), so the operands are
// bit-equal to the plain path's. Duplicate rows within a feature sum;
// sentinel slots, and any value parked on them, contribute nothing.
//
// Bound on the H100: bytes (each slot's row and value, the gathered w and
// r, G and c written once). The TPU kernel is a match join, T^2 K^2
// compare-and-FMA per tile; a merge of each pair of row-sorted slot lists
// is T^2 (live_a + live_b) dependent loads, latency-bound.
// The products the function needs are far fewer: for each example row x,
// every pair of the tile's slots on x (at webspam's density mostly a slot
// with itself, the diagonal).
//
// The design: each feature's slots are sorted by row (rows_sorted, the
// solve's layout) and the tile's T*K slots come with their row-sorted
// order (rows_s, perm: a stable sort, the order slab_spmv already uses),
// so the slots on one row form one run of that order. A block of 1024
// threads takes one batch row and a slice of TA rows a of G, and
//   A. walks the sorted order, U positions per thread at a time so their
//      loads overlap: for position j it keeps the feature b of the slot
//      and a run-start flag (jb) and the slot's value (jv) in shared
//      memory, and for the slots of its own features the position (inv);
//   B. for each own slot, gathers w[x] and r[x]: wv = w[x] * v, cva =
//      v * (w[x] * r[x]) and, when the slot is alone in its run (at
//      webspam's density most are), its one product wv * v, which only
//      the diagonal G[a, a] receives, else the run's start and length;
//   C. gives each of its features a one lane of a warp of its own, which
//      walks a's slots in order: it adds the lone slots' products to the
//      diagonal and expands the other runs, G[a, b] += wv[a, ka] *
//      va[b, kb] for every slot (b, kb) of the run, in shared memory (the
//      diagonal in a register).
//      Runs of equal rows in increasing row order, a's slots outer and b's
//      inner: the sum order of a merge of the two row-sorted lists, bit
//      for bit (a sentinel adds +0, which changes no sum). The same
//      thread sums c[a] over a's K slots in slot order;
//   D. writes its TA rows of G, coalesced.
// Products are rounded before they are added (__fmul_rn, __fadd_rn), as
// the plain match join rounds them. No atomics: two launches are
// bit-equal. A tile whose sorted-order arrays do not fit in shared memory
// keeps them in a global scratch buffer (the `big` flag) with the same code.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int U = 8;                      // positions a thread loads at a time
// TA <= THREADS / 32: phase C gives each feature of the slice a warp
constexpr uint32_t START = 0x80000000u;   // jb: first position of a run
constexpr int SMEM_LIMIT = 200 * 1024;    // staged arrays above this go to scratch

__global__ void __launch_bounds__(THREADS)
slab_gram_kernel(const int* __restrict__ rows, long long rows_bs,
                 const float* __restrict__ vals, long long vals_bs,
                 const float* __restrict__ w, const float* __restrict__ r, long long r_bs,
                 const int* __restrict__ rows_s, long long rs_bs,
                 const int* __restrict__ perm, long long perm_bs,
                 float* __restrict__ G, float* __restrict__ c, int* __restrict__ scratch,
                 int T, int K, int n_loc, int TA, int big) {
    extern __shared__ float4 smem4[];
    const int TK = T * K;
    const int bi = blockIdx.y, a0 = blockIdx.x * TA;
    const int na = min(TA, T - a0);
    float* Gs = reinterpret_cast<float*>(smem4);        // (TA, T)
    float* dp = Gs + (size_t)TA * T;                    // (TA, K)
    float* cvs = dp + (size_t)TA * K;                   // (TA, K)
    float* wvs = cvs + (size_t)TA * K;                  // (TA, K)
    int* inv = reinterpret_cast<int*>(wvs + (size_t)TA * K);   // (TA, K)
    int* run = inv + (size_t)TA * K;                    // (TA, K)
    uint32_t* jb;
    float* jv;
    if (big) {
        int* mine = scratch + ((long long)bi * gridDim.x + blockIdx.x) * 2 * (long long)TK;
        jb = reinterpret_cast<uint32_t*>(mine);
        jv = reinterpret_cast<float*>(mine + TK);
    } else {
        jb = reinterpret_cast<uint32_t*>(run + (size_t)TA * K);
        jv = reinterpret_cast<float*>(jb + TK);
    }
    const int* R = rows + bi * rows_bs;
    const float* V = vals + bi * vals_bs;
    const float* rr = r + bi * r_bs;
    const int* RS = rows_s + bi * rs_bs;
    const int* P = perm + bi * perm_bs;
    const int tid = threadIdx.x;
    const int own0 = a0 * K, nown = na * K;

    for (int i = tid; i < na * T; i += THREADS) Gs[i] = 0.0f;
    // A: the tile's row-sorted order, U positions per thread at a time so
    // that their loads, and then their gathers of the values, overlap
    for (int j0 = tid; j0 < TK; j0 += THREADS * U) {
        int x[U], xp[U], p[U];
        float v[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int j = j0 + u * THREADS;
            const bool in = j < TK;
            x[u] = in ? RS[j] : n_loc;
            xp[u] = in && j > 0 ? RS[j - 1] : -1;
            p[u] = in ? P[j] : 0;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) v[u] = x[u] < n_loc ? V[p[u]] : 0.0f;
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int j = j0 + u * THREADS;
            if (j >= TK) break;
            jb[j] = (xp[u] != x[u] ? START : 0u) | (uint32_t)(p[u] / K);
            if (x[u] < n_loc) {
                jv[j] = v[u];
                if (p[u] >= own0 && p[u] < own0 + nown) inv[p[u] - own0] = j;
            }
        }
    }
    __syncthreads();

    // B: per own slot, cva, wv, and the slot's product with itself when
    // its row's run holds it alone (dp, run = 0), else the run's first
    // position (inv) and length (run); a sentinel adds 0 to both sums
    for (int q0 = tid; q0 < nown; q0 += THREADS * U) {
        int x[U];
        float v[U], wx[U], rx[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int q = q0 + u * THREADS;
            x[u] = q < nown ? R[own0 + q] : n_loc;
            v[u] = q < nown ? V[own0 + q] : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            wx[u] = x[u] < n_loc ? w[x[u]] : 0.0f;
            rx[u] = x[u] < n_loc ? rr[x[u]] : 0.0f;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int q = q0 + u * THREADS;
            if (q >= nown) break;
            if (x[u] < n_loc) {
                const float wv = __fmul_rn(wx[u], v[u]);
                cvs[q] = __fmul_rn(v[u], __fmul_rn(wx[u], rx[u]));
                wvs[q] = wv;
                const int i = inv[q];
                int j0 = i, j1 = i + 1;
                while (!(jb[j0] & START)) --j0;
                while (j1 < TK && !(jb[j1] & START)) ++j1;
                dp[q] = j1 - j0 == 1 ? __fmul_rn(wv, jv[i]) : 0.0f;
                run[q] = j1 - j0 == 1 ? 0 : j1 - j0;
                inv[q] = j0;
            } else {
                cvs[q] = 0.0f;
                dp[q] = 0.0f;
                run[q] = 0;
            }
        }
    }
    __syncthreads();

    // C: one lane of warp t per feature a0 + t of the slice (its own warp,
    // so the features' runs never serialize each other), its slots in order
    const int t = tid >> 5;
    if ((tid & 31) == 0 && t < na) {
        const int a = a0 + t;
        const int q0 = t * K;
        float cs = 0.0f, diag = 0.0f;
        float* Ga = Gs + (size_t)t * T;
        for (int k = 0; k < K; ++k) {
            cs = __fadd_rn(cs, cvs[q0 + k]);
            const int len = run[q0 + k];
            if (len == 0) {                   // alone in its run (or a sentinel: + 0)
                diag = __fadd_rn(diag, dp[q0 + k]);
                continue;
            }
            const float wa = wvs[q0 + k];
            for (int j = inv[q0 + k], e = j + len; j < e; ++j) {
                const int b = (int)(jb[j] & ~START);
                const float prod = __fmul_rn(wa, jv[j]);
                if (b == a) diag = __fadd_rn(diag, prod);
                else Ga[b] = __fadd_rn(Ga[b], prod);
            }
        }
        c[(long long)bi * T + a] = cs;
        Ga[a] = diag;
    }
    __syncthreads();

    // D: the slice's rows of G
    float* Gb = G + ((long long)bi * T + a0) * T;
    for (int i = tid; i < na * T; i += THREADS) Gb[i] = Gs[i];
}

// Rows a of G per block, and whether the order's arrays go to scratch.
void plan(int T, int K, int* TA, int* big, size_t* smem) {
    const size_t per_a = 4 * ((size_t)T + 5 * (size_t)K);
    int ta = 16;
    while (ta > 1 && per_a * ta > (size_t)SMEM_LIMIT) ta /= 2;
    if (ta > T) ta = T;
    const size_t own = per_a * ta, order = 8 * (size_t)T * K;
    *TA = ta;
    *big = own + order > (size_t)SMEM_LIMIT;
    *smem = own + (*big ? 0 : order);
}

}  // namespace

// Ints of scratch slab_gram_launch needs: 2 * T * K per block when the
// tile's order does not fit in shared memory beside the block's rows of G,
// else 0.
extern "C" long long slab_gram_scratch_ints(int B, int T, int K) {
    if (B == 0 || T == 0 || K == 0) return 0;
    int ta, big;
    size_t smem;
    plan(T, K, &ta, &big, &smem);
    if (!big) return 0;
    return (long long)B * ((T + ta - 1) / ta) * 2 * (long long)T * K;
}

// Plain C entry point for ctypes. Per batch row (B of them, each at the
// given batch stride in elements, inner (T, K) contiguous): rows int32
// with each feature's slots sorted by row (sentinels >= n_loc last), vals
// float32, r (n_loc) float32, and the row-sorted order of the tile's T*K
// slots, rows_s and perm int32 (a stable sort); w (n_loc) float32. G
// (B, T, T) and c (B, T) float32 out, contiguous; scratch as
// slab_gram_scratch_ints says. T + 5 K <= 51200. Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int slab_gram_launch(const int* rows, long long rows_bs, const float* vals,
                                long long vals_bs, const float* w, const float* r,
                                long long r_bs, const int* rows_s, long long rs_bs,
                                const int* perm, long long perm_bs, float* G, float* c,
                                int* scratch, int B, int T, int K, int n_loc, void* stream) {
    if (B == 0 || T == 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    if (K == 0) {
        cudaMemsetAsync(G, 0, sizeof(float) * (size_t)B * T * T, st);
        cudaMemsetAsync(c, 0, sizeof(float) * (size_t)B * T, st);
        return (int)cudaGetLastError();
    }
    if (4 * ((size_t)T + 5 * (size_t)K) > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    int ta, big;
    size_t smem;
    plan(T, K, &ta, &big, &smem);
    cudaError_t err = cudaFuncSetAttribute(
        slab_gram_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((unsigned)((T + ta - 1) / ta), (unsigned)B);
    slab_gram_kernel<<<grid, THREADS, smem, st>>>(
        rows, rows_bs, vals, vals_bs, w, r, r_bs, rows_s, rs_bs, perm, perm_bs, G, c, scratch,
        T, K, n_loc, ta, big);
    return (int)cudaGetLastError();
}
