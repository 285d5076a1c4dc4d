// Slab sparse matrix-vector product X_F d as a row-sorted segmented sum,
// for sm_90a.
//
// Replaces the TPU kernel repro/kernels/sparse_slab.py slab_spmv_pallas
// (its pl.pallas_call at line 126). For each batch row b (a feature block)
// and each example row i:
//   out[b, i] += sign * sum over slots (j, k) with rows[b, j, k] == i of
//                vals[b, j, k] * d[b, j],
// where slots with rows >= n_loc (sentinels) contribute nothing. sign is
// +1 (margins, into a zeroed output) or -1 (the residual update r -= X_F d
// of every feature block in one launch).
//
// Bound on the H100: device memory, and mostly its latency. Each live
// slot is read once (row, permutation index, value: 12 bytes) and each
// touched example row costs one scattered 4-byte read-modify-write; the
// flops (one multiply-add per slot) are nothing. The TPU kernel compares
// every slot with every 256-row output block, O(slots * n_loc / 256); that
// is wasteful at n_loc = 252,000 and is not carried over.
//
// The design: the slots of each batch row are sorted by example row once,
// when the slabs are laid out (ops.slab_order: rows_s, the sorted rows, and
// perm, the slot each sorted position came from). Thread j of the grid
// owns sorted position j; if j starts a run of equal rows it sums the run
// in sorted order and writes that one example row. Every output row is
// written by exactly one thread and each sum has a fixed order, so there
// are no atomics and two launches give bit-equal results (what the
// serving layer's bit-equality with decision_function will rely on).
// Products are rounded before they are added (no contraction), as the
// plain scatter form rounds them.
#include <cuda_runtime.h>

__global__ void slab_spmv_kernel(const int* __restrict__ rows_s,
                                 const int* __restrict__ perm,
                                 long long s_stride,
                                 const float* __restrict__ vals,
                                 long long v_stride,
                                 const float* __restrict__ d,
                                 long long d_stride,
                                 float* __restrict__ out,
                                 long long o_stride,
                                 int S, int K, int n_loc, float sign) {
    const long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= S) return;
    const int b = blockIdx.y;
    const int* rs = rows_s + b * s_stride;
    const int row = rs[j];
    if (row < 0 || row >= n_loc) return;            // sentinels sort last
    if (j > 0 && rs[j - 1] == row) return;          // not the run's start
    const int* pm = perm + b * s_stride;
    const float* v = vals + b * v_stride;
    const float* db = d + b * d_stride;
    float acc = 0.0f;
    for (long long q = j; q < S && rs[q] == row; ++q) {
        const int slot = pm[q];
        acc = __fadd_rn(acc, __fmul_rn(v[slot], db[slot / K]));
    }
    float* o = out + b * o_stride + row;
    *o = __fadd_rn(*o, sign * acc);
}

// Plain C entry point for ctypes. rows_s/perm (B, S) int32 with batch
// stride s_stride; vals (B, S) float32 (S = T * K slots of T features,
// slot = feature * K + k) with batch stride v_stride; d (B, T) with batch
// stride d_stride; out (B, n_out) with batch stride o_stride, n_loc <=
// n_out. Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int slab_spmv_launch(const int* rows_s, const int* perm,
                                long long s_stride, const float* vals,
                                long long v_stride, const float* d,
                                long long d_stride, float* out,
                                long long o_stride, int B, int S, int K,
                                int n_loc, float sign, void* stream) {
    if (B == 0 || S == 0) return 0;
    const int threads = 256;
    dim3 grid((unsigned)((S + threads - 1) / threads), (unsigned)B);
    slab_spmv_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
        rows_s, perm, s_stride, vals, v_stride, d, d_stride, out, o_stride,
        S, K, n_loc, sign);
    return (int)cudaGetLastError();
}
