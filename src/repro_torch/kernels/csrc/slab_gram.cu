// Weighted Gram tile and correlation straight from a feature slab, as a
// merge join over row-sorted slots, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/sparse_slab.py slab_gram_pallas
// (its pl.pallas_call at line 81). For each batch row (a feature block) and
// a tile of T features with K slots each (local example rows, sentinel
// n_loc, operands gathered and sentinel-zeroed by the caller):
//   G[a, b] = sum over slot pairs (ka, kb) with rows[a, ka] == rows[b, kb]
//             < n_loc of wv[a, ka] * va[b, kb]      (= X_F^T diag(w) X_F)
//   c[b]    = sum_k cva[b, k]                      (= X_F^T (w r))
// Duplicate rows within a feature sum; sentinel slots contribute nothing.
//
// Bound on the H100: by operations as the TPU computes it, by bytes as
// this kernel does. The TPU kernel is a match join: every slot pair of
// the tile, T^2 K^2 compare-and-FMA (1.5e8 per tile at T=128, K=95), which
// is what a vector unit with no gather does well. Here the slots of each
// feature are sorted by row (once per design, by the caller), so G[a, b] is
// a merge of two sorted lists: O(live_a + live_b) steps, about 2.4e6 per
// tile at the same shape, 60 times fewer; the matched pairs the function
// truly needs are fewer still (a few per feature at webspam's density). The
// operands (four T x K arrays) and G are read and written once from the
// kernel's view; repeated reads of a feature's list hit L1/L2.
//
// The design: one thread per (a, b) pair; a block of 128 threads takes
// one row a of one batch row's G and every column b, so the grid is
// (T, batch): 2048 blocks at the cell's shapes, enough warps in flight to
// hide the latency of the list walks, which is what bounds the kernel in
// practice. Thread b walks the lists of features a and b in step; on equal
// rows it sums the two runs' pairs (duplicates) in a fixed order. Every
// sum runs in increasing row order, so two launches give bit-equal
// results; products are rounded before they are added, as the plain match
// join rounds them. The block of row a = 0 also sums c in slot order.
// Sentinels (rows >= n_loc) end a walk: they sort last.
#include <cuda_runtime.h>

constexpr int THREADS = 128;

__global__ void slab_gram_kernel(const int* __restrict__ rows,
                                 const float* __restrict__ wv,
                                 const float* __restrict__ va,
                                 const float* __restrict__ cva,
                                 float* __restrict__ G,
                                 float* __restrict__ c,
                                 int T, int K, int n_loc) {
    const long long base = (long long)blockIdx.y * T * K;
    const int a = blockIdx.x;
    const int* R = rows + base;
    const int* ra = R + (long long)a * K;
    const float* wa = wv + base + (long long)a * K;
    float* Ga = G + ((long long)blockIdx.y * T + a) * T;
    for (int b = threadIdx.x; b < T; b += blockDim.x) {
        const int* rb = R + (long long)b * K;
        const float* vb = va + base + (long long)b * K;
        if (a == 0) {
            const float* cb = cva + base + (long long)b * K;
            float s = 0.0f;
            for (int k = 0; k < K; ++k) s = __fadd_rn(s, cb[k]);
            c[(long long)blockIdx.y * T + b] = s;
        }
        float acc = 0.0f;
        int ia = 0, ib = 0;
        while (ia < K && ib < K) {
            const int x = ra[ia], y = rb[ib];
            if (x >= n_loc || y >= n_loc) break;
            if (x < y) {
                ++ia;
            } else if (y < x) {
                ++ib;
            } else {
                int ea = ia + 1, eb = ib + 1;
                while (ea < K && ra[ea] == x) ++ea;
                while (eb < K && rb[eb] == x) ++eb;
                for (int s = ia; s < ea; ++s)
                    for (int u = ib; u < eb; ++u)
                        acc = __fadd_rn(acc, __fmul_rn(wa[s], vb[u]));
                ia = ea;
                ib = eb;
            }
        }
        Ga[b] = acc;
    }
}

// Plain C entry point for ctypes. rows (B, T, K) int32, each feature's K
// slots sorted by row (sentinels clamped to n_loc, last); wv, va, cva
// (B, T, K) float32; G (B, T, T) and c (B, T) float32 out; all contiguous.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int slab_gram_launch(const int* rows, const float* wv,
                                const float* va, const float* cva, float* G,
                                float* c, int B, int T, int K, int n_loc,
                                void* stream) {
    if (B == 0 || T == 0) return 0;
    dim3 grid((unsigned)T, (unsigned)B);
    slab_gram_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        rows, wv, va, cva, G, c, T, K, n_loc);
    return (int)cudaGetLastError();
}
