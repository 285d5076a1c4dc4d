// Forward attention with an online softmax over KV tiles, for sm_90a.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py
// flash_attention_pallas (its pl.pallas_call at line 84, body _flash_kernel).
// For each batch b, query head h and query row i:
//   o[b, i, h] = sum_j softmax_j(q[b, i, h] . k[b, j, g] * scale) v[b, j, g]
// with g = h / (H / Hk) (grouped-query attention: query head h reads KV
// head h // group, the head jnp.repeat(k, group, axis=2) gives it), scale =
// 1 / sqrt(D), and under `causal` the keys j > i masked to -1e30 (not -inf,
// as the reference). Sums and the softmax statistics are float32 for
// float32 and bfloat16 inputs alike; the output is acc / max(l, 1e-30),
// cast to the input type once, round to nearest.
//
// Bound on the H100: operations. At the serving cell's shape (B=8,
// S=2048, H=32, Hk=4, D=64, causal) the useful work is 1.37e11 FLOP
// against about 151 MB moved: 0.139 ms at the bf16 tensor-core peak.
//
// Two routes, one per input type. Both take one 64-row query tile of one
// head per block and walk its 64-key KV tiles with the running max m,
// denominator l and float32 accumulator in registers; both read q, k and v
// in place in (B, S, H, D) layout through their strides (nothing folded or
// copied, the GQA expansion never built), skip the KV tiles wholly above
// the diagonal under `causal` (tile 0 holds a valid key of every row, so
// such a tile would only multiply in exp(-1e30 - m) = 0), run the longest
// query tiles first and use no atomics: two launches are bit-equal.
//
// bfloat16 (the serving cell's route) runs on the tensor cores. A block is
// one consumer warpgroup (128 threads) and one producer warp. The producer
// loads the query tile once and the K and V tiles into a ring of NSTAGE
// stages in shared memory with TMA (cp.async.bulk.tensor through 4D tensor
// maps of the (B, S, H|Hk, D) tensors, 128-byte swizzle, 64-byte for
// D = 32), each stage guarded by a full and an empty mbarrier. The
// consumer computes S = Q K^T with wgmma m64n64k16 (bf16 in, float32
// accumulate: bf16 x bf16 products are exact in float32, so only the
// order of the sum differs from the reference), keeps the softmax state in
// the wgmma accumulator layout (thread t holds rows 16 (t / 32) + (t % 32)
// / 4 and + 8, row max and sum by quad shuffles), and accumulates P V with
// wgmma m64nDk16, P from registers. The reference multiplies float32
// probabilities: rounding P to bf16 would cost up to 2^-9 relative per
// probability, so P is split into P_hi = bf16(P) and P_lo = bf16(P - P_hi)
// (residual <= 2^-17 relative) and both products go into the same float32
// accumulator (V is bf16 and exact). That is 1.5x the useful tensor-core
// work. Heads run fastest in the grid, so the query heads that share a KV
// head read the same K/V tiles while they are in L2.
//
// float32 runs float32 FMA on the CUDA cores (67 TFLOP/s
// peak), K/V tiles staged in shared memory as float32 by all 128 threads,
// thread (ty, tx) = (t / 8, t % 8) owning query rows 4 ty .. 4 ty + 3 and
// keys tx + 8 j, the probabilities through shared memory (transposed) into
// the P V product.
#include <cuda.h>               // CUtensorMap and its enums; the encoder is
                                // looked up in libcuda at run time
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per KV tile
constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// float32: CUDA-core FMA
// ---------------------------------------------------------------------------

constexpr int NT = 128;         // threads per block
constexpr int LP = BQ + 4;      // row stride of the transposed P tile

__device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
}

// 64 rows of D elements from global memory (rows row_stride elements
// apart) into a float32 shared tile of row stride D + 4.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src,
                                          long long row_stride, int tid) {
    constexpr int V = D / 4;                       // 4-element vectors per row
#pragma unroll
    for (int it = 0; it < BK * V / NT; ++it) {
        const int idx = tid + it * NT;
        const int r = idx / V, c = (idx % V) * 4;
        store4(dst + r * (D + 4) + c, load4(src + r * row_stride + c));
    }
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 long long qsb, long long qss, long long qsh,
                 long long ksb, long long kss, long long ksh,
                 long long vsb, long long vss, long long vsh,
                 long long osb, long long oss, long long osh,
                 int S, int group, int causal, float scale) {
    constexpr int LD = D + 4;       // row stride of the Q, K and V tiles
    constexpr int C4 = D / 32;      // float4 column groups a thread owns
    extern __shared__ float4 smem4[];
    float* Qs = reinterpret_cast<float*>(smem4);
    float* Ks = Qs + BQ * LD;
    float* Vs = Ks + BK * LD;
    float* Pt = Vs + BK * LD;       // probabilities, [key][row]

    const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
    const int qt = gridDim.x - 1 - blockIdx.x;     // longest causal rows first
    const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
    const int q0 = qt * BQ;

    load_tile<D>(Qs, q + b * qsb + (long long)q0 * qss + h * qsh, qss, tid);

    float m[4], l[4], acc[4][4 * C4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = NEG_INF;
        l[i] = 0.0f;
#pragma unroll
        for (int c = 0; c < 4 * C4; ++c) acc[i][c] = 0.0f;
    }

    const int nk = causal ? qt + 1 : S / BK;
    for (int kt = 0; kt < nk; ++kt) {
        const int k0 = kt * BK;
        __syncthreads();            // the last tile's readers are done
        load_tile<D>(Ks, k + b * ksb + (long long)k0 * kss + hk * ksh, kss, tid);
        load_tile<D>(Vs, v + b * vsb + (long long)k0 * vss + hk * vsh, vss, tid);
        __syncthreads();

        float s[4][8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
#pragma unroll 4
        for (int d = 0; d < D; d += 4) {
            float4 qv[4], kv[8];
#pragma unroll
            for (int i = 0; i < 4; ++i) qv[i] = load4(Qs + (ty * 4 + i) * LD + d);
#pragma unroll
            for (int j = 0; j < 8; ++j) kv[j] = load4(Ks + (tx + 8 * j) * LD + d);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) {
                    s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
                    s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
                    s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
                    s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
                }
        }

        const bool diag = causal && kt == qt;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int row = ty * 4 + i;
            float cur = NEG_INF;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                float x = s[i][j] * scale;
                if (diag && tx + 8 * j > row) x = NEG_INF;
                s[i][j] = x;
                cur = fmaxf(cur, x);
            }
            cur = fmaxf(cur, __shfl_xor_sync(0xffffffffu, cur, 1));
            cur = fmaxf(cur, __shfl_xor_sync(0xffffffffu, cur, 2));
            cur = fmaxf(cur, __shfl_xor_sync(0xffffffffu, cur, 4));
            const float m_new = fmaxf(m[i], cur);
            const float alpha = expf(m[i] - m_new);
            float rs = 0.0f;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const float p = expf(s[i][j] - m_new);
                s[i][j] = p;
                rs += p;
            }
            rs += __shfl_xor_sync(0xffffffffu, rs, 1);
            rs += __shfl_xor_sync(0xffffffffu, rs, 2);
            rs += __shfl_xor_sync(0xffffffffu, rs, 4);
            l[i] = alpha * l[i] + rs;
            m[i] = m_new;
#pragma unroll
            for (int c = 0; c < 4 * C4; ++c) acc[i][c] *= alpha;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
            store4(Pt + (tx + 8 * j) * LP + ty * 4,
                   make_float4(s[0][j], s[1][j], s[2][j], s[3][j]));
        __syncthreads();

#pragma unroll 8
        for (int key = 0; key < BK; ++key) {
            const float4 p = load4(Pt + key * LP + ty * 4);
#pragma unroll
            for (int c = 0; c < C4; ++c) {
                const float4 w = load4(Vs + key * LD + tx * 4 + 32 * c);
                const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    acc[i][4 * c + 0] = fmaf(pr[i], w.x, acc[i][4 * c + 0]);
                    acc[i][4 * c + 1] = fmaf(pr[i], w.y, acc[i][4 * c + 1]);
                    acc[i][4 * c + 2] = fmaf(pr[i], w.z, acc[i][4 * c + 2]);
                    acc[i][4 * c + 3] = fmaf(pr[i], w.w, acc[i][4 * c + 3]);
                }
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float den = fmaxf(l[i], 1e-30f);
        float* dst = o + b * osb + (long long)(q0 + ty * 4 + i) * oss + h * osh;
#pragma unroll
        for (int c = 0; c < C4; ++c)
            store4(dst + tx * 4 + 32 * c,
                   make_float4(acc[i][4 * c + 0] / den, acc[i][4 * c + 1] / den,
                               acc[i][4 * c + 2] / den, acc[i][4 * c + 3] / den));
    }
}

// ---------------------------------------------------------------------------
// bfloat16: TMA ring + wgmma
// ---------------------------------------------------------------------------

constexpr int NSTAGE = 2;               // K/V stages in the ring
constexpr int CONSUMERS = 128;          // one warpgroup
constexpr int BF_THREADS = CONSUMERS + 32;
constexpr float LOG2E = 1.4426950408889634f;
// launch_bf16's return value when an operand cannot be described as a
// tensor map (nothing is launched)
constexpr int TMA_ENCODE_FAILED = -1;

template <int D>
struct BfLayout {
    static constexpr int PANEL = D >= 64 ? 64 : 32;     // columns per swizzle panel
    static constexpr int NPANEL = D / PANEL;
    static constexpr int ROWB = PANEL * 2;              // bytes per panel row: 128 or 64
    static constexpr int PANEL_BYTES = BQ * ROWB;       // one 64-row panel
    static constexpr int TILE = BQ * D * 2;             // one 64-row tile
    static constexpr int BAR = TILE * (1 + 2 * NSTAGE); // Q, K stages, V stages, barriers
    static constexpr int SMEM = BAR + 8 * (1 + 2 * NSTAGE) + 1024;   // + alignment slack
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(bar) : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`. A
// transfer that never lands fails the launch (trap) instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
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

// One box of a 4D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4, %5, %6}], [%2];"
        :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
           "r"(c0), "r"(c1), "r"(c2), "r"(c3)
        : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle of ROWB-byte rows (128B: 1, 64B: 2).
// Stride = 8 rows; leading = the distance between 64-column panels (read
// only for an MN-major operand wider than one panel).
template <int ROWB>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lead) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(lead >> 4) << 16)
         | (static_cast<uint64_t>((8 * ROWB) >> 4) << 32)
         | (static_cast<uint64_t>(ROWB == 128 ? 1 : 2) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait0() {
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from touching wgmma operands before the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

// d (64 x 64, f32) += A (64 x 16, shared) * B (16 x 64, shared), both K-major.
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1));
}

// d (64 x 32, f32) += A (64 x 16, registers) * B (16 x 32, shared, MN-major).
__device__ __forceinline__ void wgmma_rs_m64n32k16(float (&d)[16], const uint32_t (&a)[4],
                                                   uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
        ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64, f32) += A (64 x 16, registers) * B (16 x 64, shared, MN-major).
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 128, f32) += A (64 x 16, registers) * B (16 x 128, shared, MN-major).
__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[64], const uint32_t (&a)[4],
                                                   uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
        ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&d)[D / 2], const uint32_t (&a)[4], uint64_t db) {
    if constexpr (D == 32) wgmma_rs_m64n32k16(d, a, db);
    else if constexpr (D == 64) wgmma_rs_m64n64k16(d, a, db);
    else wgmma_rs_m64n128k16(d, a, db);
}

// 2^x, one MUFU op (relative error about 2^-22; 2^-huge flushes to 0).
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// (a, b) -> bf16 pairs hi = RN(a, b) and lo = RN((a, b) - hi); a in the
// low half, as the wgmma A fragment wants the lower column there.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
    const float2 hf = __bfloat1622float2(h);
    const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = *reinterpret_cast<const uint32_t*>(&l);
}

// TMA coordinates of (row, head) in a map whose second and third axes are
// (sequence, heads), or (heads, sequence) when `head_first`.
__device__ __forceinline__ void tile_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int col, int row, int head, int b, bool head_first) {
    if (head_first) tma_load_4d(dst, map, bar, col, head, row, b);
    else tma_load_4d(dst, map, bar, col, row, head, b);
}

template <int D>
__global__ void __launch_bounds__(BF_THREADS)
flash_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                  const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap,
                  __nv_bfloat16* __restrict__ o, long long osb, long long oss, long long osh,
                  int S, int group, int causal, float scale_log2, int head_first) {
    using L = BfLayout<D>;
    extern __shared__ uint8_t smem_raw[];
    const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
    const uint32_t sQ = base;
    const uint32_t bar = base + L::BAR;        // q, full[NSTAGE], empty[NSTAGE]
    const int h = blockIdx.x, b = blockIdx.y;
    const int qt = gridDim.z - 1 - blockIdx.z;  // longest causal rows first
    const int hk = h / group, q0 = qt * BQ;
    const int nk = causal ? qt + 1 : S / BK;
    const int tid = threadIdx.x;

    if (tid == 0) {
        mbar_init(bar, 1);
        for (int s = 0; s < NSTAGE; ++s) {
            mbar_init(bar + 8 * (1 + s), 1);
            mbar_init(bar + 8 * (1 + NSTAGE + s), CONSUMERS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    if (tid >= CONSUMERS) {                    // the producer warp
        if (tid == CONSUMERS) {
            mbar_expect_tx(bar, L::TILE);
            for (int p = 0; p < L::NPANEL; ++p)
                tile_load(sQ + p * L::PANEL_BYTES, &qmap, bar, p * L::PANEL, q0, h, b,
                          head_first & 1);
            for (int kt = 0; kt < nk; ++kt) {
                const int s = kt % NSTAGE;
                const uint32_t full = bar + 8 * (1 + s);
                if (kt >= NSTAGE) mbar_wait(bar + 8 * (1 + NSTAGE + s), (kt / NSTAGE - 1) & 1);
                mbar_expect_tx(full, 2 * L::TILE);
                const uint32_t sK = base + L::TILE * (1 + s);
                const uint32_t sV = base + L::TILE * (1 + NSTAGE + s);
                for (int p = 0; p < L::NPANEL; ++p) {
                    tile_load(sK + p * L::PANEL_BYTES, &kmap, full, p * L::PANEL, kt * BK, hk,
                              b, head_first & 2);
                    tile_load(sV + p * L::PANEL_BYTES, &vmap, full, p * L::PANEL, kt * BK, hk,
                              b, head_first & 4);
                }
            }
        }
        return;
    }

    // the consumer warpgroup: thread t holds rows r0 and r0 + 8, columns
    // 8 j + cq and + 1 of each 8-column group j of the accumulators
    const int warp = tid >> 5, lane = tid & 31;
    const int r0 = warp * 16 + (lane >> 2);
    const int cq = 2 * (lane & 3);
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
    float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.0f, l1 = 0.0f;
    mbar_wait(bar, 0);

    for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % NSTAGE;
        const uint32_t sK = base + L::TILE * (1 + s);
        const uint32_t sV = base + L::TILE * (1 + NSTAGE + s);
        mbar_wait(bar + 8 * (1 + s), (kt / NSTAGE) & 1);

        // scores S = Q K^T, 64 x 64, in float32
        float sc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < D / 16; ++k) {
            const uint32_t off = (k / (L::PANEL / 16)) * L::PANEL_BYTES + (k % (L::PANEL / 16)) * 32;
            wgmma_ss_m64n64k16(sc, smem_desc<L::ROWB>(sQ + off, 16),
                               smem_desc<L::ROWB>(sK + off, 16));
        }
        wgmma_commit();
        wgmma_wait0();
        fence_regs(sc);

        // online softmax on the raw scores, m in their units: p = 2^(s c -
        // m c) with c = scale * log2(e), one FMA and one ex2 per score
        if (causal && kt == qt) {                  // the diagonal tile
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int col = 8 * j + cq + e;
                    if (col > r0) sc[4 * j + e] = NEG_INF;
                    if (col > r0 + 8) sc[4 * j + 2 + e] = NEG_INF;
                }
        }
        float mn0 = m0, mn1 = m1;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                mn0 = fmaxf(mn0, sc[4 * j + e]);
                mn1 = fmaxf(mn1, sc[4 * j + 2 + e]);
            }
        mn0 = fmaxf(mn0, __shfl_xor_sync(0xffffffffu, mn0, 1));
        mn0 = fmaxf(mn0, __shfl_xor_sync(0xffffffffu, mn0, 2));
        mn1 = fmaxf(mn1, __shfl_xor_sync(0xffffffffu, mn1, 1));
        mn1 = fmaxf(mn1, __shfl_xor_sync(0xffffffffu, mn1, 2));
        const float mc0 = mn0 * scale_log2, mc1 = mn1 * scale_log2;
        const float al0 = ex2(fmaf(m0, scale_log2, -mc0));
        const float al1 = ex2(fmaf(m1, scale_log2, -mc1));
        float rs0 = 0.0f, rs1 = 0.0f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const float p0 = ex2(fmaf(sc[4 * j + e], scale_log2, -mc0));
                const float p1 = ex2(fmaf(sc[4 * j + 2 + e], scale_log2, -mc1));
                sc[4 * j + e] = p0;
                sc[4 * j + 2 + e] = p1;
                rs0 += p0;
                rs1 += p1;
            }
        rs0 += __shfl_xor_sync(0xffffffffu, rs0, 1);
        rs0 += __shfl_xor_sync(0xffffffffu, rs0, 2);
        rs1 += __shfl_xor_sync(0xffffffffu, rs1, 1);
        rs1 += __shfl_xor_sync(0xffffffffu, rs1, 2);
        l0 = al0 * l0 + rs0;
        l1 = al1 * l1 + rs1;
        m0 = mn0;
        m1 = mn1;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
            acc[4 * j + 0] *= al0;
            acc[4 * j + 1] *= al0;
            acc[4 * j + 2] *= al1;
            acc[4 * j + 3] *= al1;
        }

        // P V with P = P_hi + P_lo, both bf16, from registers: 16 keys per
        // wgmma, A fragment q of key group kk = scores 8 kk + 2 q, + 1
        uint32_t phi[4][4], plo[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int q = 0; q < 4; ++q)
                split_bf16(sc[8 * kk + 2 * q], sc[8 * kk + 2 * q + 1], phi[kk][q], plo[kk][q]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            const uint64_t dv = smem_desc<L::ROWB>(sV + kk * 16 * L::ROWB, L::PANEL_BYTES);
            wgmma_pv<D>(acc, phi[kk], dv);
            wgmma_pv<D>(acc, plo[kk], dv);
        }
        wgmma_commit();
        wgmma_wait0();
        fence_regs(acc);
        fence_regs(phi);
        fence_regs(plo);
        mbar_arrive(bar + 8 * (1 + NSTAGE + s));   // stage s may be refilled
    }

    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    __nv_bfloat16* row0 = o + b * osb + (long long)(q0 + r0) * oss + h * osh;
    __nv_bfloat16* row1 = row0 + 8 * oss;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(row0 + 8 * j + cq) =
            __floats2bfloat162_rn(acc[4 * j + 0] / d0, acc[4 * j + 1] / d0);
        *reinterpret_cast<__nv_bfloat162*>(row1 + 8 * j + cq) =
            __floats2bfloat162_rn(acc[4 * j + 2] / d1, acc[4 * j + 3] / d1);
    }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult found;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found)
                == cudaSuccess && found == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

// A 4D tensor map of a (B, S, heads, D) bf16 tensor with strides (in
// elements) sb, ss, sh and a unit last axis: boxes of one panel of columns
// x 64 rows of one head. The sequence and head axes go in order of their
// strides (`head_first` when the heads' stride is the smaller).
template <int D>
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int heads, long long sb,
              long long ss, long long sh, bool* head_first) {
    using L = BfLayout<D>;
    EncodeTiled enc = encoder();
    if (enc == nullptr) return false;
    *head_first = sh < ss;
    const cuuint64_t seq_dim = (cuuint64_t)S, head_dim = (cuuint64_t)heads;
    const cuuint64_t seq_b = (cuuint64_t)ss * 2, head_b = (cuuint64_t)sh * 2;
    cuuint64_t dims[4] = {(cuuint64_t)D, *head_first ? head_dim : seq_dim,
                          *head_first ? seq_dim : head_dim, (cuuint64_t)B};
    cuuint64_t strides[3] = {*head_first ? head_b : seq_b, *head_first ? seq_b : head_b,
                             (cuuint64_t)sb * 2};
    cuuint32_t box[4] = {(cuuint32_t)L::PANEL, *head_first ? 1u : (cuuint32_t)BQ,
                         *head_first ? (cuuint32_t)BQ : 1u, 1u};
    cuuint32_t estr[4] = {1, 1, 1, 1};
    return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
               box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
               L::ROWB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE)
           == CUDA_SUCCESS;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o, const long long* st,
                int B, int S, int H, int Hk, int causal, float scale, cudaStream_t stream) {
    using L = BfLayout<D>;
    CUtensorMap maps[3];
    const void* ptrs[3] = {q, k, v};
    const int heads[3] = {H, Hk, Hk};
    int head_first = 0;
    for (int i = 0; i < 3; ++i) {
        bool hf;
        if (!make_map<D>(&maps[i], ptrs[i], B, S, heads[i], st[3 * i], st[3 * i + 1],
                         st[3 * i + 2], &hf))
            return TMA_ENCODE_FAILED;
        head_first |= (hf ? 1 : 0) << i;
    }
    auto kern = flash_bf16_kernel<D>;
    cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           L::SMEM);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((unsigned)H, (unsigned)B, (unsigned)(S / BQ));
    kern<<<grid, BF_THREADS, L::SMEM, stream>>>(
        maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(o), st[9], st[10], st[11], S,
        H / Hk, causal, scale * LOG2E, head_first);
    return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, const long long* st,
               int B, int S, int H, int Hk, int causal, float scale, cudaStream_t stream) {
    const size_t smem = sizeof(float) * (size_t)(BQ * (D + 4) + 2 * BK * (D + 4) + BK * LP);
    auto kern = flash_f32_kernel<D>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((unsigned)(S / BQ), (unsigned)H, (unsigned)B);
    kern<<<grid, NT, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), st[0], st[1], st[2], st[3],
        st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11], S, H / Hk, causal, scale);
    return (int)cudaGetLastError();
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, const long long* st, int B,
           int S, int H, int Hk, int causal, float scale, int dtype, cudaStream_t stream) {
    if (dtype == 0) return launch_f32<D>(q, k, v, o, st, B, S, H, Hk, causal, scale, stream);
    if (dtype == 1) return launch_bf16<D>(q, k, v, o, st, B, S, H, Hk, causal, scale, stream);
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point for ctypes. q and o (B, S, H, D), k and v (B, S, Hk,
// D), all of one type (dtype 0 = float32, 1 = bfloat16), last axis
// contiguous; strides (in elements) of the batch, sequence and head axes,
// in the order q, k, v, o, each a multiple of 4 (of 8, with 16-byte aligned
// data, for bfloat16 q, k and v: TMA's rule). S % 64 == 0, H % Hk == 0,
// D in {32, 64, 128}. Returns cudaGetLastError() after the launch
// (0 = launched), or -1 if a bfloat16 operand could not be described as
// a tensor map (nothing was launched).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* o, const long long* strides, int B,
                                      int S, int H, int Hk, int D, int causal,
                                      float scale, int dtype, void* stream) {
    if (B == 0 || S == 0 || H == 0) return 0;
    if (S % BQ != 0 || Hk <= 0 || H % Hk != 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    switch (D) {
        case 32: return launch<32>(q, k, v, o, strides, B, S, H, Hk, causal, scale, dtype, s);
        case 64: return launch<64>(q, k, v, o, strides, B, S, H, Hk, causal, scale, dtype, s);
        case 128: return launch<128>(q, k, v, o, strides, B, S, H, Hk, causal, scale, dtype, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
