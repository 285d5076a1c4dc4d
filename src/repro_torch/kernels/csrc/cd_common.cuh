// Shared device code of the Gram-tile coordinate-descent kernels
// (gram_cd.cu, blocked_cd.cu): the coordinate step, the mbarrier and bulk
// copy helpers, and the ring of G chunks in shared memory.
//
// Both kernels run one warp per tile: lane l owns the coordinates
// k = l + 32 i, s_k in registers. G arrives in shared memory by 1-D TMA
// (cp.async.bulk) in chunks of `rows` rows, each stage of the ring behind
// its own mbarrier; a row is read only after its chunk has landed, so the
// load overlaps the first steps. Both kernels take every coordinate step
// through cd_delta and update s_k by one fused multiply-add per row in row
// order, so at block width 1 the blocked cycle reproduces the sequential
// chain bit for bit.
//
// Shared-memory layout (kernels/gram_cd.py chunk_plan computes the same
// sizes and passes them in):
//   [ring: stages * rows * F floats][vectors * F words][pad to 16 bytes]
//   [stages mbarriers of 8 bytes]
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define FULL_MASK 0xffffffffu

// t / h rounded to nearest, bit for bit as __fdiv_rn(t, h), from y =
// __frcp_rn(h) computed ahead: q = t y and two corrections
// q += (t - h q) y, the last of which rounds correctly by Markstein's
// theorem (y within half an ulp of 1/h, q within one ulp of t/h) while no
// step leaves the normal range. Zero numerators give t y (the signed
// zero). *slow is set where neither holds (h or t out of range, NaN, inf):
// there the caller divides again with __fdiv_rn. On the chain this is one
// multiply and four dependent fused multiply-adds, and the range test runs
// beside them; __fdiv_rn checks its operands and branches per lane to a
// slow path, which zero and tiny numerators take (most steps of an L1 fit
// soft-threshold to zero).
__device__ __forceinline__ float div_fast(float t, float h, float y, bool& slow) {
    const float q = __fmul_rn(t, y);
    const float q1 = __fmaf_rn(__fmaf_rn(-h, q, t), y, q);
    float q2 = __fmaf_rn(__fmaf_rn(-h, q1, t), y, q1);
    asm("" : "+f"(q2));                 // computed on every lane: a select, not a branch
    // bitwise, not short-circuit, operators: predicates, not branches
    const bool h_ok = (h >= 0x1p-60f) & (h <= 0x1p60f);
    const float at = fabsf(t);
    const bool zero = h_ok & (t == 0.0f);
    slow = !(zero | (h_ok & (at >= 0x1p-60f) & (at <= 0x1p60f)));
    return zero ? q : q2;
}

// div_fast with its fallback, per lane (off the chain: the prologue's
// ratios, the check kernel).
__device__ __forceinline__ float div_rn(float t, float h, float y) {
    bool slow;
    const float r = div_fast(t, h, y, slow);
    return slow ? __fdiv_rn(t, h) : r;
}

// The soft threshold's numerator: sign(u) * max(|u| - lam, 0), NaN for NaN.
__device__ __forceinline__ float cd_shrink(float u, float lam) {
    const float a = fmaxf(fabsf(u) - lam, 0.0f);
    return u > 0.0f ? a : (u < 0.0f ? -a : u * a);
}

// One soft-threshold coordinate step (paper eq. (6)):
//   u = g + b_old * h,  b_new = sign(u) * max(|u| - lam, 0) / h,
// returns delta = b_new - b_old, with y = __frcp_rn(h). NaN in u
// propagates, as sign(NaN) does. Where *slow comes back set, the step's
// value is cd_delta_ieee's, which the caller computes instead (one branch
// for the warp, rarely taken).
__device__ __forceinline__ float cd_delta(float g, float h, float y, float b_old,
                                          float lam, bool& slow) {
    const float u = __fmaf_rn(b_old, h, g);
    return div_fast(cd_shrink(u, lam), h, y, slow) - b_old;
}

__device__ __forceinline__ float cd_delta_ieee(float g, float h, float b_old, float lam) {
    const float u = __fmaf_rn(b_old, h, g);
    return __fdiv_rn(cd_shrink(u, lam), h) - b_old;
}

// s[i] for a run-time i < N without indexing the register array at run
// time (which would put it on the stack).
template <int N>
__device__ __forceinline__ float pick(const float (&s)[N], int i) {
    float v = s[0];
#pragma unroll
    for (int q = 1; q < N; ++q) v = (i == q) ? s[q] : v;
    return v;
}

// Byte offset of the mbarriers in the dynamic shared memory.
__host__ __device__ inline size_t cd_bar_offset(int F, int rows, int stages,
                                                int vectors) {
    const size_t b = 4 * ((size_t)stages * rows * F + (size_t)vectors * F);
    return (b + 15) & ~(size_t)15;
}

__device__ __forceinline__ uint32_t cd_smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cd_mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar), "r"(count)
                 : "memory");
}

__device__ __forceinline__ void cd_mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(bytes) : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`. A
// transfer that never lands fails the launch (trap) instead of hanging.
__device__ __forceinline__ void cd_mbar_wait(uint32_t bar, uint32_t parity) {
    const long long t0 = clock64();
    while (true) {
        uint32_t done;
        asm volatile(
            "{\n.reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n}\n"
            : "=r"(done) : "r"(bar), "r"(parity) : "memory");
        if (done) return;
        if (clock64() - t0 > 20000000000LL) __trap();
    }
}

// 1-D TMA: `bytes` (a multiple of 16) from global `src` to shared `dst`
// (both 16-byte aligned), completing on `bar`.
__device__ __forceinline__ void cd_bulk_load(uint32_t dst, const void* src,
                                             uint32_t bytes, uint32_t bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];"
        :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// The ring of G chunks. Chunk q holds rows [q rows, (q + 1) rows). The
// chunks stream in a virtual order v = 0 .. total - 1 (chunk v % nchunks,
// stage v % stages): total = nchunks for one pass over G, 2 nchunks for
// two (blocked_cd's prologue, then its cycle, when G does not fit). With
// stages == nchunks the tile is resident and nothing is refilled. Every
// method is called by the whole warp.
struct CdRing {
    const float* src;     // the tile's G in global memory, rows of F floats
    float* ring;          // shared memory, stages * rows * F floats
    uint32_t bar0;        // shared address of the first mbarrier
    int F, rows, stages, nchunks, total, lane;
    bool bulk;            // 1-D TMA; else plain loads (F % 4 or alignment)

    __device__ int rows_of(int q) const { return min(rows, F - q * rows); }

    __device__ bool resident() const { return stages >= nchunks; }

    __device__ float* stage(int v) const {
        return ring + (size_t)(v % stages) * rows * F;
    }

    __device__ void init() {
        if (bulk) {                     // one lane per barrier
            for (int s = lane; s < stages; s += 32) cd_mbar_init(bar0 + 8 * s, 1);
            asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
            __syncwarp();
        }
        fill(0);
    }

    // Chunks v0 .. into the stages, all of which are free (one lane per
    // chunk for TMA).
    __device__ void fill(int v0) {
        const int n = min(stages, total - v0);
        if (bulk) {
            for (int v = v0 + lane; v < v0 + n; v += 32) load(v);
        } else {
            for (int v = v0; v < v0 + n; ++v) copy(v);
        }
    }

    // Another pass over G after one has ended (its chunks all released):
    // stream the chunks again as v0 .. v0 + nchunks - 1.
    __device__ void restart(int v0) {
        total = v0 + nchunks;
        if (bulk) asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        __syncwarp();
        fill(v0);
    }

    // 1-D TMA of chunk v % nchunks into stage v % stages (one lane).
    __device__ void load(int v) {
        const int q = v % nchunks;
        const uint32_t bar = bar0 + 8 * (v % stages);
        const uint32_t bytes = 4u * rows_of(q) * F;
        cd_mbar_expect_tx(bar, bytes);
        cd_bulk_load(cd_smem_u32(stage(v)), src + (size_t)q * rows * F, bytes, bar);
    }

    // The same by plain loads of the whole warp.
    __device__ void copy(int v) {
        const int q = v % nchunks;
        float* dst = stage(v);
        const float* from = src + (size_t)q * rows * F;
        const int n = rows_of(q) * F;
        for (int i = lane; i < n; i += 32) dst[i] = from[i];
        __syncwarp();
    }

    __device__ void wait(int v) const {
        if (bulk) cd_mbar_wait(bar0 + 8 * (v % stages), (v / stages) & 1);
    }

    // Chunk v has been read by every lane: its stage takes chunk v + stages.
    __device__ void release(int v) {
        if (v + stages < total) {
            if (bulk) {     // this lane's reads of the stage before the copy's writes
                asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
            }
            __syncwarp();
            if (!bulk) copy(v + stages);
            else if (lane == 0) load(v + stages);
        }
    }
};

// The rows of G in order, for a loop that reads each row once: next()
// waits for a chunk at its first row, done() releases it after its last.
struct RowCursor {
    CdRing* ring;
    int voff;             // virtual index of chunk 0 in this pass
    int q, left;          // current chunk, its rows not yet read
    const float* row;

    __device__ const float* next() {
        if (left == 0) {
            ++q;
            ring->wait(voff + q);
            row = ring->stage(voff + q);
            left = ring->rows_of(q);
        }
        return row;
    }

    __device__ void done() {
        row += ring->F;
        if (--left == 0) ring->release(voff + q);
    }
};

// Launch helper: raise the dynamic shared-memory limit of `kern` once to
// what this launch needs, launch one warp per tile, report the error.
template <typename K, typename... Args>
static int cd_launch(K kern, int& smem_set, int M, int smem, void* stream,
                     Args... args) {
    if (smem > 48 * 1024 && smem > smem_set) {
        const cudaError_t err = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return (int)err;
        smem_set = smem;
    }
    kern<<<M, 32, smem, (cudaStream_t)stream>>>(args...);
    return (int)cudaGetLastError();
}
