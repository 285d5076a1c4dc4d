// Shared device code of the Gram-tile coordinate-descent kernels
// (gram_cd.cu, blocked_cd.cu). Both kernels take every coordinate step
// through cd_delta, so at block width 1 the blocked cycle reproduces the
// sequential chain bit for bit.
#pragma once

#include <cuda_runtime.h>

// One soft-threshold coordinate step (paper eq. (6)):
//   u = g + b_old * h,  b_new = sign(u) * max(|u| - lam, 0) / h,
// returns delta = b_new - b_old. NaN in u propagates, as sign(NaN) does.
__device__ __forceinline__ float cd_delta(float g, float h, float b_old,
                                          float lam) {
    const float u = __fmaf_rn(b_old, h, g);
    const float a = fmaxf(fabsf(u) - lam, 0.0f);
    const float t = u > 0.0f ? a : (u < 0.0f ? -a : u * a);
    return __fdiv_rn(t, h) - b_old;
}
