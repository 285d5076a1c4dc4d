// Blocked semi-parallel coordinate-descent cycle on Gram tiles, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/blocked_cd.py blocked_cd_pallas
// (its pl.pallas_call at line 132; body _make_blocked_cd_kernel at line
// 41). The F coordinates of each tile run as F/B blocks of width B, each
// with a mode computed outside the kernel from G alone (the Gershgorin
// safeguard, core.subproblem.blocked_cycle_modes):
//   mode 0: one B-wide proximal-Jacobi step from the shared snapshot
//           g = c - s, then s_k += sum_{j in block} delta_j G[j, k];
//   mode 1: two such steps of width B/2;
//   mode 2: the sequential chain over the block (as gram_cd.cu).
// h = diag(G) + nu comes in precomputed. G is read by row.
//
// Bound on the H100: latency, as gram_cd: F/B (mode 0) to F (mode 2)
// dependent steps with one barrier each. One thread block per feature
// block m (all M in one launch), thread k owns s_k and d_k in registers,
// deltas go through shared memory (one slot per coordinate, so one
// __syncthreads per step); the B rows of a block are read from global
// memory (L2) by each thread after the barrier. Accumulation into s is a
// chain of fused multiply-adds in row order, which at B=1 is exactly
// gram_cd's update.
#include "cd_common.cuh"

__global__ void blocked_cd_kernel(const float* __restrict__ G,
                                  const float* __restrict__ h,
                                  const float* __restrict__ c,
                                  const float* __restrict__ beta,
                                  const float* __restrict__ dbeta0,
                                  const int* __restrict__ modes,
                                  float* __restrict__ d_out,
                                  int F, int B, float lam) {
    extern __shared__ float delta_sh[];           // F floats
    const int k = threadIdx.x;
    const int nb = F / B;
    const float* Gm = G + (size_t)blockIdx.x * F * F;
    const int* mm = modes + (size_t)blockIdx.x * nb;
    const size_t off = (size_t)blockIdx.x * F + k;

    const float ck = c[off];
    const float hk = h[off];
    const float base = beta[off] + dbeta0[off];
    float s = 0.0f, d = 0.0f;

    for (int b = 0; b < nb; ++b) {
        const int start = b * B;
        const int mode = mm[b];
        // width of one Jacobi step; mode 2 is a chain of 1-wide steps
        const int width = mode == 0 ? B : (mode == 1 ? B / 2 : 1);
        for (int lo = start; lo < start + B; lo += width) {
            if (k >= lo && k < lo + width) {
                const float delta = cd_delta(ck - s, hk, base + d, lam);
                d += delta;
                delta_sh[k] = delta;
            }
            __syncthreads();
            for (int j = lo; j < lo + width; ++j)
                s = __fmaf_rn(delta_sh[j], Gm[(size_t)j * F + k], s);
        }
    }
    d_out[off] = d;
}

// Plain C entry point for ctypes. Device pointers of contiguous tensors:
// G (M, F, F), h/c/beta/dbeta0/d (M, F) float32, modes (M, F/B) int32.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int blocked_cd_launch(const float* G, const float* h,
                                 const float* c, const float* beta,
                                 const float* dbeta0, const int* modes,
                                 float* d, int M, int F, int B, float lam,
                                 void* stream) {
    blocked_cd_kernel<<<M, F, F * sizeof(float), (cudaStream_t)stream>>>(
        G, h, c, beta, dbeta0, modes, d, F, B, lam);
    return (int)cudaGetLastError();
}
