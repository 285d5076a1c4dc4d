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
// Bound on the H100: latency. F dependent steps, each a handful of flops
// and one barrier; the bytes (G once, four F-vectors) and flops (2 M F^2)
// are tiny. The design: one thread block per feature block m, all M in
// one launch so the M chains run side by side on M SMs; thread k owns s_k
// and d_k in registers; the owner of coordinate j publishes delta through
// shared memory (one slot per coordinate, so one __syncthreads per step
// suffices); G's row j comes from global memory (L2), loaded one step
// ahead so its latency hides behind the current step. F=256 (256 KiB of
// G) would not fit in shared memory, and this path serves every F <= 1024.
#include "cd_common.cuh"

__global__ void gram_cd_kernel(const float* __restrict__ G,
                               const float* __restrict__ c,
                               const float* __restrict__ beta,
                               const float* __restrict__ dbeta0,
                               float* __restrict__ d_out,
                               int F, float lam, float nu) {
    extern __shared__ float delta_sh[];           // F floats
    const int k = threadIdx.x;
    const float* Gm = G + (size_t)blockIdx.x * F * F;
    const size_t off = (size_t)blockIdx.x * F + k;

    const float ck = c[off];
    const float base = beta[off] + dbeta0[off];
    const float h = Gm[(size_t)k * F + k] + nu;
    float s = 0.0f, d = 0.0f;

    float g_next = Gm[k];                         // row 0
    for (int j = 0; j < F; ++j) {
        const float gjk = g_next;
        if (j + 1 < F) g_next = Gm[(size_t)(j + 1) * F + k];
        if (k == j) {
            const float delta = cd_delta(ck - s, h, base + d, lam);
            d += delta;
            delta_sh[j] = delta;
        }
        __syncthreads();
        s = __fmaf_rn(delta_sh[j], gjk, s);
    }
    d_out[off] = d;
}

// Plain C entry point for ctypes. Pointers are device pointers of
// contiguous float32 tensors: G (M, F, F), c/beta/dbeta0/d (M, F).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int gram_cd_launch(const float* G, const float* c,
                              const float* beta, const float* dbeta0,
                              float* d, int M, int F, float lam, float nu,
                              void* stream) {
    gram_cd_kernel<<<M, F, F * sizeof(float), (cudaStream_t)stream>>>(
        G, c, beta, dbeta0, d, F, lam, nu);
    return (int)cudaGetLastError();
}
