// Slab sparse matrix-vector product X_F d as a row-sorted segmented sum
// over coalesced streams, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/sparse_slab.py slab_spmv_pallas
// (its pl.pallas_call at line 126). For each batch row b (a feature block)
// and each example row i:
//   out[b, i] += sign * sum over slots (j, k) with rows[b, j, k] == i of
//                vals[b, j, k] * d[b, j],
// where slots with rows >= n_loc (sentinels) contribute nothing. sign is
// +1 (margins, into a zeroed output) or -1 (the residual update r -= X_F d
// of every feature block in one launch). Given dbeta, the same launch also
// advances the tile's coefficient update: dbeta[b, t] += d[b, t].
//
// The path mode (lam_idx not null) is the serving product behind
// repro/kernels/ops.py slab_path_spmv: each example row i (a request)
// picks its own coefficient row of a stacked path, so the coefficient of a
// live slot (b, j, k) of row i is d[b * d_stride + lam_idx[i] * ldb + j]
// (the (L, M * T) stack of M feature blocks of T, row stride ldb), read
// from device memory: a stack of L x 2^20 floats does not fit in shared
// memory. Sentinel slots never read lam_idx. The product and the sum order
// are the margins mode's, so at a uniform lam_idx == l the result is bit
// for bit that of d = the stack's row l.
//
// Bound on the H100: device memory, and mostly its latency. Each slot is
// read once as three 4-byte streams in sorted order (row, slot index,
// value) and each touched example row costs one scattered 4-byte
// read-modify-write; the flops (one multiply-add per slot) are nothing.
// The TPU kernel compares every slot with every 256-row output block,
// O(slots * n_loc / 256); that is wasteful at n_loc = 252,000 and is not
// carried over.
//
// The design: the slots of each batch row are sorted by example row once
// per fit, when the slabs are laid out (ops.slab_order: rows_s, the sorted
// rows; perm, the slot each sorted position came from, feature = perm / K;
// vals_s, the values in the same sorted order). So every read of the slab
// is unit-stride, and a launch is about two dependent trips to memory:
//   1. each block owns a chunk of CHUNK consecutive sorted positions of one
//      batch row; its threads load rows_s, perm and vals_s at once
//      (coalesced), with the row before each position and the row just
//      after the chunk. A position whose row differs from the row before
//      it starts a run, and its thread loads out[row] right away, so that
//      this scattered read overlaps the rest;
//   2. the batch row's T coefficients of d are staged in shared memory
//      (read from device memory when T is too wide for it), and each
//      position's product vals_s * d[perm / K] is rounded (__fmul_rn) and
//      stored, beside its row, in shared memory;
//   3. the sum order: the thread that owns the first position of a run of
//      equal rows sums the run's products left to right in sorted order,
//      starting from 0.0f, one __fadd_rn at a time, from shared memory; a
//      run that goes on past the chunk's end is finished by that same
//      thread, reading the three streams past the chunk from device
//      memory. It then writes its example row once: out = out + sign * sum,
//      from the value it loaded in step 1 (no other thread writes that
//      row).
// That is the sum order of the row-sorted kernel this one replaces (one
// thread per sorted position, summing its run from scattered loads), so
// results are bit for bit those of that kernel. Every output row has
// exactly one writer and every sum a fixed order: no float atomics, and
// two launches give bit-equal results.
#include <cuda_runtime.h>

constexpr int THREADS = 256;
constexpr int ITEMS = 2;                      // positions per thread
constexpr int CHUNK = THREADS * ITEMS;        // sorted positions per block
constexpr int D_SHARED_MAX = 8192;            // widest d staged in shared memory

__global__ void __launch_bounds__(THREADS)
slab_spmv_kernel(const int* __restrict__ rows_s, const int* __restrict__ perm,
                 long long s_stride, const float* __restrict__ vals_s,
                 long long v_stride, const float* __restrict__ d,
                 long long d_stride, float* __restrict__ out,
                 long long o_stride, float* __restrict__ dbeta,
                 long long db_stride, const int* __restrict__ lam_idx,
                 long long ldb, int S, int T, int K, int n_loc, float sign) {
    extern __shared__ float sm[];
    int* row_sh = reinterpret_cast<int*>(sm);   // [lim]: the row after the chunk
    float* prod_sh = sm + CHUNK + 1;
    float* d_sh = prod_sh + CHUNK;
    const int b = blockIdx.y;
    const int tid = threadIdx.x;
    const long long c0 = (long long)blockIdx.x * CHUNK;
    const int lim = (int)min((long long)CHUNK, (long long)S - c0);
    const int* rs = rows_s + b * s_stride;
    const int* pm = perm + b * s_stride;
    const float* vs = vals_s + b * v_stride;
    const float* db = d + b * d_stride;
    float* ob = out + b * o_stride;
    const bool path = lam_idx != nullptr;        // per-row coefficient rows
    const bool staged = !path && T <= D_SHARED_MAX;

    // 1. the chunk's three streams and the rows around them, unit stride
    int row[ITEMS], prev[ITEMS], slot[ITEMS];
    float val[ITEMS], old[ITEMS];
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
        const long long q = c0 + tid + k * THREADS;
        row[k] = -1;
        prev[k] = -1;
        slot[k] = 0;
        val[k] = 0.0f;
        old[k] = 0.0f;
        if (q < c0 + lim) {
            row[k] = rs[q];
            prev[k] = q > 0 ? rs[q - 1] : -1;
            slot[k] = pm[q];
            val[k] = vs[q];
        }
    }
    const float d0 = staged && tid < T ? db[tid] : 0.0f;
    if (tid == THREADS - 1) row_sh[lim] = c0 + lim < S ? rs[c0 + lim] : -1;
    bool start[ITEMS];
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
        start[k] = row[k] >= 0 && row[k] < n_loc && row[k] != prev[k];
        if (start[k]) old[k] = ob[row[k]];
    }

    // 2. d in shared memory (and, in one block per batch row, dbeta += d)
    float* dbb = dbeta != nullptr && blockIdx.x == 0 ? dbeta + b * db_stride : nullptr;
    if (staged && tid < T) d_sh[tid] = d0;
    if (staged || dbb != nullptr) {
        for (int t = tid; t < T; t += THREADS) {
            const float dv = staged && t == tid ? d0 : db[t];
            if (staged && t != tid) d_sh[t] = dv;
            if (dbb != nullptr) dbb[t] = __fadd_rn(dbb[t], dv);
        }
    }
    const float* dsrc = staged ? d_sh : db;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
        const int i = tid + k * THREADS;
        if (i < lim) {
            row_sh[i] = row[k];
            const bool live = row[k] >= 0 && row[k] < n_loc;
            const float* coef = path && live ? dsrc + lam_idx[row[k]] * ldb : dsrc;
            prod_sh[i] = live ? __fmul_rn(val[k], coef[slot[k] / K]) : 0.0f;
        }
    }
    __syncthreads();

    // 3. each run summed left to right by the thread owning its start
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
        if (!start[k]) continue;
        const int r = row[k];
        float acc = 0.0f;
        int e = tid + k * THREADS;
        while (e < lim && row_sh[e] == r) {
            acc = __fadd_rn(acc, prod_sh[e]);
            ++e;
        }
        if (e == lim && row_sh[lim] == r) {    // the run goes on past the chunk
            const float* coef = path ? dsrc + lam_idx[r] * ldb : dsrc;
            for (long long q = c0 + lim; q < S && rs[q] == r; ++q)
                acc = __fadd_rn(acc, __fmul_rn(vs[q], coef[pm[q] / K]));
        }
        ob[r] = __fadd_rn(old[k], sign * acc);
    }
}

// Plain C entry point for ctypes. rows_s/perm (B, S) int32 with batch
// stride s_stride and vals_s (B, S) float32 with batch stride v_stride:
// the S = T * K slots of T features (slot = feature * K + k) in row-sorted
// order; d (B, T) with batch stride d_stride; out (B, n_out) with batch
// stride o_stride, n_loc <= n_out; dbeta (B, T) with batch stride
// db_stride, or null. The path mode: lam_idx (n_loc,) int32 and d the
// (L, ...) stack with row stride ldb, batch row b's block at b * d_stride
// (dbeta must then be null); lam_idx null is the margins mode. Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int slab_spmv_launch(const int* rows_s, const int* perm,
                                long long s_stride, const float* vals_s,
                                long long v_stride, const float* d,
                                long long d_stride, float* out,
                                long long o_stride, float* dbeta,
                                long long db_stride, const int* lam_idx,
                                long long ldb, int B, int S, int T, int K,
                                int n_loc, float sign, void* stream) {
    if (B == 0 || (S == 0 && dbeta == nullptr)) return 0;
    if (lam_idx != nullptr && dbeta != nullptr) return (int)cudaErrorInvalidValue;
    const int chunks = S > 0 ? (S + CHUNK - 1) / CHUNK : 1;
    const bool staged = lam_idx == nullptr && T <= D_SHARED_MAX;
    const size_t smem = (size_t)(2 * CHUNK + 1 + (staged ? T : 0)) * 4;
    dim3 grid((unsigned)chunks, (unsigned)B);
    slab_spmv_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        rows_s, perm, s_stride, vals_s, v_stride, d, d_stride, out, o_stride,
        dbeta, db_stride, lam_idx, ldb, S, T, K, n_loc, sign);
    return (int)cudaGetLastError();
}
