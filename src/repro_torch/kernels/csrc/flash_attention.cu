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
// cast to the input type once.
//
// Bound on the H100: operations. At the serving cell's shape (B=8,
// S=2048, H=32, D=64, causal) the useful work is 1.37e11 FLOP against
// about 151 MB moved. This first kernel does float32 FMA on the CUDA cores
// (67 TFLOP/s peak), not the tensor cores; the bf16 mma path is later work.
//
// The design: one block of 128 threads per (64-row query tile, head,
// batch). q, k and v are read in place in (B, S, H, D) layout through
// their strides; nothing is folded or copied, and the 8x GQA expansion is
// never built. The query tile stays in shared memory; each 64-key K and V
// tile is staged in shared memory as float32. Thread (ty, tx) = (t / 8,
// t % 8) owns query rows 4 ty .. 4 ty + 3: it computes their scores
// against keys tx + 8 j (j < 8) from float4 reads, reduces each row's max
// and sum across the 8 threads of the row group with butterfly shuffles
// (every lane ends with the same value), and keeps the running max m,
// denominator l and the f32 accumulator of columns 4 tx + 32 c (+0..3) in
// registers. The probabilities go through shared memory (transposed) into
// the P V product, in float32. Under `causal` the KV tiles wholly above
// the diagonal are not visited: tile 0 always holds a valid key of every
// row, so such a tile would only multiply in exp(-1e30 - m) = 0. Query
// tiles run longest first. No atomics: two launches are bit-equal.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per KV tile
constexpr int NT = 128;         // threads per block
constexpr int LP = BQ + 4;      // row stride of the transposed P tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    __nv_bfloat162 lo, hi;
    *reinterpret_cast<unsigned*>(&lo) = u.x;
    *reinterpret_cast<unsigned*>(&hi) = u.y;
    const float2 a = __bfloat1622float2(lo);
    const float2 b = __bfloat1622float2(hi);
    return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 u;
    u.x = *reinterpret_cast<const unsigned*>(&lo);
    u.y = *reinterpret_cast<const unsigned*>(&hi);
    *reinterpret_cast<uint2*>(p) = u;
}

// 64 rows of D elements from global memory (rows row_stride elements
// apart) into a float32 shared tile of row stride D + 4.
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          long long row_stride, int tid) {
    constexpr int V = D / 4;                       // 4-element vectors per row
#pragma unroll
    for (int it = 0; it < BK * V / NT; ++it) {
        const int idx = tid + it * NT;
        const int r = idx / V, c = (idx % V) * 4;
        store4(dst + r * (D + 4) + c, load4(src + r * row_stride + c));
    }
}

template <int D, typename T>
__global__ void __launch_bounds__(NT)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o,
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
        T* dst = o + b * osb + (long long)(q0 + ty * 4 + i) * oss + h * osh;
#pragma unroll
        for (int c = 0; c < C4; ++c)
            store4(dst + tx * 4 + 32 * c,
                   make_float4(acc[i][4 * c + 0] / den, acc[i][4 * c + 1] / den,
                               acc[i][4 * c + 2] / den, acc[i][4 * c + 3] / den));
    }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, void* o,
           const long long* st, int B, int S, int H, int Hk, int causal,
           float scale, cudaStream_t stream) {
    const size_t smem = sizeof(float) * (size_t)(BQ * (D + 4) + 2 * BK * (D + 4) + BK * LP);
    auto kern = flash_attention_kernel<D, T>;
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((unsigned)(S / BQ), (unsigned)H, (unsigned)B);
    kern<<<grid, NT, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
        st[8], st[9], st[10], st[11], S, H / Hk, causal, scale);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o,
             const long long* st, int B, int S, int H, int Hk, int D, int causal,
             float scale, cudaStream_t stream) {
    switch (D) {
        case 32: return launch<32, T>(q, k, v, o, st, B, S, H, Hk, causal, scale, stream);
        case 64: return launch<64, T>(q, k, v, o, st, B, S, H, Hk, causal, scale, stream);
        case 128: return launch<128, T>(q, k, v, o, st, B, S, H, Hk, causal, scale, stream);
        default: return (int)cudaErrorInvalidValue;
    }
}

}  // namespace

// Plain C entry point for ctypes. q and o (B, S, H, D), k and v (B, S, Hk,
// D), all of one type (dtype 0 = float32, 1 = bfloat16), last axis
// contiguous; strides (in elements) of the batch, sequence and head axes,
// in the order q, k, v, o, each a multiple of 4. S % 64 == 0, H % Hk == 0,
// D in {32, 64, 128}. Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v,
                                      void* o, const long long* strides, int B,
                                      int S, int H, int Hk, int D, int causal,
                                      float scale, int dtype, void* stream) {
    if (B == 0 || S == 0 || H == 0) return 0;
    if (S % BQ != 0 || Hk <= 0 || H % Hk != 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0)
        return launch_d<float>(q, k, v, o, strides, B, S, H, Hk, D, causal, scale, s);
    if (dtype == 1)
        return launch_d<__nv_bfloat16>(q, k, v, o, strides, B, S, H, Hk, D, causal,
                                       scale, s);
    return (int)cudaErrorInvalidValue;
}
