// One truncated-gradient pass per machine (the paper's comparison system,
// section 4.3), for sm_90a.
//
// Replaces no Pallas kernel: the reference's pass is a lax.scan
// (repro/core/truncated_gradient.py _tg_pass, lines 33-44) that XLA
// compiles into one device loop. In eager PyTorch the same pass is a host
// loop of about seven launches per example, so a pass over the epsilon
// cell (20,000 dependent steps per machine) would cost about a second of
// launch time. This kernel runs the whole pass in one launch.
//
// For each machine m (one thread block) and each of its examples i, in
// order (Langford et al. 2009, with VW's gravity = lam / n):
//   margin = x_i . beta
//   g      = sigmoid(margin) - (y_i + 1) / 2
//   beta   = beta - eta * (g * x_i)
//   beta   = where(|beta| <= theta, sign(beta) max(|beta| - shrink, 0), beta)
// with shrink = eta * gravity (rounded to float32 by the wrapper) and
// theta possibly +inf.
//
// Bound on the H100: the chain of dependent steps. Each step's dot
// product must finish before the next step's update, so a pass is `steps`
// block-wide reductions in a row; the bytes (X read once: 2.56 GB for an
// epsilon pass, 0.76 ms at 3.35 TB/s) are far below that.
//
// The design:
//   beta in registers -- thread t owns coordinates j = k * THREADS + t,
//     k < PER (PER a template value, the smallest of 1, 2, 4, 8, 16 with
//     PER * THREADS >= p), so p <= 8192 fits and the wrapper refuses a
//     wider X; coordinates past p hold 0 and contribute exact zeros;
//   prefetch -- row i + 1 (and its label) is loaded into registers while
//     step i reduces; rows do not depend on beta;
//   the margin, in a fixed order -- each thread sums its own products in
//     k order; each warp reduces by shuffles down (offsets 16 .. 1); lane
//     0 of each warp writes its sum to a double-buffered shared array;
//     after the one __syncthreads of the step, every warp reduces the
//     WARPS sums by the same shuffle tree and broadcasts lane 0's total,
//     so every thread holds the same margin and no second barrier is
//     needed (the buffer alternates with the step, so step i + 1's writes
//     never meet step i's reads);
//   rounding -- every product, sum and quotient is written as __fmul_rn /
//     __fadd_rn / __fsub_rn / __fdiv_rn, so nvcc contracts nothing into a
//     multiply-add; exp is taken in double and rounded to float, which
//     makes the step the same on the card and on the host. The plain
//     version (kernels/ref.py tg_pass_ref) repeats this order and this
//     rounding op for op, because the pass is chaotic at epsilon's width:
//     one rounding difference in a margin grows to 1e-1 in beta within a
//     pass.
// No atomics, so two launches are bit-equal.
#include <cuda_runtime.h>

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL_MASK = 0xffffffffu;

__device__ __forceinline__ float warp_tree(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v = __fadd_rn(v, __shfl_down_sync(FULL_MASK, v, off));
    return v;
}

template <int PER>
__global__ void __launch_bounds__(THREADS)
tg_pass_kernel(const float* __restrict__ X, const float* __restrict__ y,
               const float* __restrict__ beta0, float* __restrict__ out,
               int steps, int p, float eta, float shrink, float theta) {
    __shared__ float warp_sh[2][WARPS];
    const int t = threadIdx.x;
    const int lane = t & 31;
    const int warp = t >> 5;
    const float* Xm = X + (long long)blockIdx.x * steps * p;
    const float* ym = y + (long long)blockIdx.x * steps;

    float b[PER], xc[PER], xn[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
        const int j = k * THREADS + t;
        b[k] = j < p ? beta0[j] : 0.0f;
        xn[k] = (j < p && steps > 0) ? Xm[j] : 0.0f;
    }
    float yn = steps > 0 ? ym[0] : 0.0f;

    for (int i = 0; i < steps; ++i) {
#pragma unroll
        for (int k = 0; k < PER; ++k) xc[k] = xn[k];
        const float yc = yn;
        if (i + 1 < steps) {
            const float* row = Xm + (long long)(i + 1) * p;
#pragma unroll
            for (int k = 0; k < PER; ++k) {
                const int j = k * THREADS + t;
                xn[k] = j < p ? row[j] : 0.0f;
            }
            yn = ym[i + 1];
        }

        float v = __fmul_rn(xc[0], b[0]);
#pragma unroll
        for (int k = 1; k < PER; ++k) v = __fadd_rn(v, __fmul_rn(xc[k], b[k]));
        v = warp_tree(v);
        if (lane == 0) warp_sh[i & 1][warp] = v;
        __syncthreads();
        float s = lane < WARPS ? warp_sh[i & 1][lane] : 0.0f;
        s = warp_tree(s);
        const float margin = __shfl_sync(FULL_MASK, s, 0);

        const float e = __double2float_rn(exp(-(double)margin));
        const float pr = __fdiv_rn(1.0f, __fadd_rn(1.0f, e));
        const float g = __fsub_rn(pr, __fmul_rn(__fadd_rn(yc, 1.0f), 0.5f));
#pragma unroll
        for (int k = 0; k < PER; ++k) {
            float bb = __fsub_rn(b[k], __fmul_rn(eta, __fmul_rn(g, xc[k])));
            const float a = fabsf(bb);
            if (a <= theta) {
                const float sg = bb > 0.0f ? 1.0f : (bb < 0.0f ? -1.0f : 0.0f);
                bb = __fmul_rn(sg, fmaxf(__fsub_rn(a, shrink), 0.0f));
            }
            b[k] = bb;
        }
    }

    float* om = out + (long long)blockIdx.x * p;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
        const int j = k * THREADS + t;
        if (j < p) om[j] = b[k];
    }
}

// Plain C entry point for ctypes. X (machines, steps, p) and y (machines,
// steps) float32 device arrays, contiguous; beta0 (p,) the shared warm
// start; out (machines, p) each machine's beta after its pass. per is the
// registers per thread (1, 2, 4, 8 or 16, with per * 512 >= p). Returns
// cudaGetLastError() after the launch (0 = launched), or -1 for a per
// with no instantiation.
extern "C" int tg_pass_launch(const float* X, const float* y, const float* beta0,
                              float* out, int machines, int steps, int p, int per,
                              float eta, float shrink, float theta, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    switch (per) {
        case 1: tg_pass_kernel<1><<<machines, THREADS, 0, s>>>(X, y, beta0, out, steps, p, eta, shrink, theta); break;
        case 2: tg_pass_kernel<2><<<machines, THREADS, 0, s>>>(X, y, beta0, out, steps, p, eta, shrink, theta); break;
        case 4: tg_pass_kernel<4><<<machines, THREADS, 0, s>>>(X, y, beta0, out, steps, p, eta, shrink, theta); break;
        case 8: tg_pass_kernel<8><<<machines, THREADS, 0, s>>>(X, y, beta0, out, steps, p, eta, shrink, theta); break;
        case 16: tg_pass_kernel<16><<<machines, THREADS, 0, s>>>(X, y, beta0, out, steps, p, eta, shrink, theta); break;
        default: return -1;
    }
    return (int)cudaGetLastError();
}
