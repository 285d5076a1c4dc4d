// Fused logistic working statistics with the NLL reduced in the same
// launch, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/logistic_stats.py
// logistic_stats_pallas (its pl.pallas_call at line 50). One pass over the
// margin cache m and the labels y computes (paper eq. (4))
//   p = clip(sigmoid(m), 1e-5, 1 - 1e-5), w = max(p (1 - p), 1e-6),
//   z = ((y + 1)/2 - p) / w,   nll = sum_i softplus(-y_i m_i).
//
// Bound on the H100: device memory. Each example moves 16 bytes (m and y
// in, w and z out) for some twenty flops, far below the card's ratio of
// operations to bytes; at n = 320,000 that is about 1.5 us at 3.35 TB/s.
//
// The design:
//   pass -- a grid-stride loop over a grid sized to the SM count, with
//     float4 loads and stores when all four arrays are 16-byte aligned
//     (then a scalar loop over the ragged tail of n % 4), scalar otherwise;
//   rounding -- p is computed as PyTorch's CUDA sigmoid computes it,
//     1 / (1 + expf(-m)) with libdevice's expf and IEEE division (nvcc's
//     defaults: no fast-math flag), and every other product, sum and
//     quotient is written as __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn,
//     so that nvcc cannot contract them into multiply-adds that the plain
//     PyTorch ops (one kernel per op) do not use; the clamps propagate NaN
//     as torch.clamp does; softplus(t) = max(t, 0) + log1pf(expf(-|t|)),
//     which does not overflow at any |m|. So w and z match the plain
//     version to rounding;
//   the NLL, in one launch and a fixed order -- each thread sums its own
//     elements in its grid-stride order (the four lanes of a float4 in
//     order x, y, z, w, then its tail element); each block reduces its
//     threads by a fixed tree (block_sum below) and writes one partial;
//     the last block to finish, found by an integer ticket taken after
//     __threadfence(), sums the partials in block order (thread i takes
//     partials i, i + 256, ..., then the same tree) into the 0-d output
//     and resets the ticket to 0 for the next launch, so no memset is
//     needed. No float atomics: the order depends only on n and the grid,
//     so launches are bit-equal.
// The ticket and the partials are the wrapper's per-device buffers: two
// launches on one device must not run concurrently (one stream).
#include <cuda_runtime.h>

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL_MASK = 0xffffffffu;

// The constants as PyTorch rounds its Python-float scalars to float32.
#define P_LO ((float)1e-5)
#define P_HI ((float)(1.0 - 1e-5))
#define W_MIN ((float)1e-6)

// w, z of one example and its softplus(-y m).
__device__ __forceinline__ float stats(float m, float y, float& w, float& z) {
    float p = __fdiv_rn(1.0f, __fadd_rn(1.0f, expf(-m)));
    p = p < P_LO ? P_LO : (p > P_HI ? P_HI : p);
    const float ww = __fmul_rn(p, __fsub_rn(1.0f, p));
    w = ww < W_MIN ? W_MIN : ww;
    z = __fdiv_rn(__fsub_rn(__fmul_rn(__fadd_rn(y, 1.0f), 0.5f), p), w);
    const float t = __fmul_rn(-y, m);
    return __fadd_rn(t < 0.0f ? 0.0f : t, log1pf(expf(-fabsf(t))));
}

// The block's fixed tree: each warp by shuffles down (offsets 16 .. 1),
// then warp 0 over the warps' sums (zeros past the last warp), the same
// offsets. The result is valid in thread 0.
__device__ __forceinline__ float block_sum(float v, float* warp_sh) {
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v = __fadd_rn(v, __shfl_down_sync(FULL_MASK, v, off));
    if (lane == 0) warp_sh[warp] = v;
    __syncthreads();
    if (warp == 0) {
        v = lane < WARPS ? warp_sh[lane] : 0.0f;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            v = __fadd_rn(v, __shfl_down_sync(FULL_MASK, v, off));
    }
    return v;
}

__global__ void __launch_bounds__(THREADS)
logistic_stats_kernel(const float* __restrict__ m, const float* __restrict__ y,
                      float* __restrict__ w, float* __restrict__ z, long long n,
                      int vec, float* __restrict__ partials,
                      unsigned* __restrict__ ticket, float* __restrict__ nll) {
    __shared__ float warp_sh[WARPS];
    __shared__ bool last;
    const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
    const long long stride = (long long)gridDim.x * THREADS;
    float acc = 0.0f;
    long long head = 0;
    if (vec) {
        const long long n4 = n / 4;
        const float4* m4 = reinterpret_cast<const float4*>(m);
        const float4* y4 = reinterpret_cast<const float4*>(y);
        float4* w4 = reinterpret_cast<float4*>(w);
        float4* z4 = reinterpret_cast<float4*>(z);
        for (long long i = tid; i < n4; i += stride) {
            const float4 mv = m4[i], yv = y4[i];
            float4 wv, zv;
            acc = __fadd_rn(acc, stats(mv.x, yv.x, wv.x, zv.x));
            acc = __fadd_rn(acc, stats(mv.y, yv.y, wv.y, zv.y));
            acc = __fadd_rn(acc, stats(mv.z, yv.z, wv.z, zv.z));
            acc = __fadd_rn(acc, stats(mv.w, yv.w, wv.w, zv.w));
            w4[i] = wv;
            z4[i] = zv;
        }
        head = n4 * 4;
    }
    for (long long i = head + tid; i < n; i += stride)
        acc = __fadd_rn(acc, stats(m[i], y[i], w[i], z[i]));

    const float s = block_sum(acc, warp_sh);
    if (threadIdx.x == 0) {
        partials[blockIdx.x] = s;
        __threadfence();
        last = atomicAdd(ticket, 1u) == gridDim.x - 1;
    }
    __syncthreads();
    if (!last) return;
    // the last block: every other block's partial is visible (each was
    // written before its block's fence and ticket)
    __threadfence();
    float v = 0.0f;
    for (int i = threadIdx.x; i < (int)gridDim.x; i += THREADS)
        v = __fadd_rn(v, __ldcg(partials + i));
    __syncthreads();                             // warp_sh is reused
    v = block_sum(v, warp_sh);
    if (threadIdx.x == 0) {
        *nll = v;
        *ticket = 0u;
    }
}

// Plain C entry point for ctypes. m, y (n,) float32 device arrays; w, z
// (n,) outputs; vec != 0 when all four are 16-byte aligned; blocks from
// kernels/logistic_stats.py grid(); partials (>= blocks floats) and ticket
// (one unsigned, 0 before the first launch) the per-device buffers; nll a
// 0-d float32 output. Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int logistic_stats_launch(const float* m, const float* y, float* w,
                                     float* z, long long n, int vec, int blocks,
                                     float* partials, unsigned* ticket,
                                     float* nll, void* stream) {
    logistic_stats_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        m, y, w, z, n, vec, partials, ticket, nll);
    return (int)cudaGetLastError();
}
