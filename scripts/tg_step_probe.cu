// The latencies any design of src/repro_torch/kernels/csrc/tg_pass.cu
// must pay on the card, each measured by a dependent chain in one warp or
// block; from them this design's chain (the least dependent step of the
// kernel as written, its bit-exact float sigmoid included) and the least
// step (the same with the hardware exp and one division in place of that
// sigmoid); and the kernel's time over the epsilon cell's shape (16
// machines x 20,000 steps x p = 2000, random rows).
//
// Build and run on a machine with the card, from the root of the repo:
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
//        -o build/tg_step_probe scripts/tg_step_probe.cu && build/tg_step_probe
// (scripts/tg_step_probe.sh does both).

#include "../src/repro_torch/kernels/csrc/tg_pass.cu"

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <vector>

#define CK(x) do { cudaError_t e_ = (x); if (e_ != cudaSuccess) { \
    printf("CUDA %s at line %d\n", cudaGetErrorString(e_), __LINE__); exit(1); } } while (0)

__device__ __forceinline__ long long clk() {
    long long t; asm volatile("mov.u64 %0, %%clock64;" : "=l"(t) :: "memory"); return t;
}
__device__ __forceinline__ unsigned long long gtimer() {
    unsigned long long t; asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t) :: "memory"); return t;
}

// ------------------------------------------------------------------ data
__global__ void fill_x(float* X, long long n, unsigned seed) {
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
         i += (long long)gridDim.x * blockDim.x) {
        unsigned h = (unsigned)i * 2654435761u ^ seed;
        h ^= h >> 15; h *= 2246822519u; h ^= h >> 13; h *= 3266489917u; h ^= h >> 16;
        unsigned g = h * 668265263u + 374761393u;
        g ^= g >> 15; g *= 2246822519u; g ^= g >> 13;
        X[i] = ((h & 0xffffff) / 16777216.0f + (g & 0xffffff) / 16777216.0f - 1.0f) * 2.449f;
    }
}
__global__ void fill_y(float* y, long long n) {
    long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    if (i < n) { unsigned h = (unsigned)i * 2654435761u; h ^= h >> 13; y[i] = (h & 1) ? 1.f : -1.f; }
}

// ------------------------------------------------------------------ micro-latencies
// r[0] cycles and r[1] ns per iteration of thread 0's chain
#define MICRO_BEGIN long long c0 = clk(); unsigned long long g0 = gtimer();
#define MICRO_END(N) long long c1 = clk(); unsigned long long g1 = gtimer(); \
    if (threadIdx.x == 0) { r[0] = (double)(c1 - c0) / (N); r[1] = (double)(g1 - g0) / (N); } \
    sink[threadIdx.x] = v;

__global__ void m_fadd(double* r, float* sink, int N) {
    float v = threadIdx.x; MICRO_BEGIN
    for (int i = 0; i < N; ++i) v = __fadd_rn(v, 1e-7f);
    MICRO_END(N)
}
__global__ void m_shfl(double* r, float* sink, int N) {   // shuffle-and-add, then a multiply
    float v = threadIdx.x; MICRO_BEGIN
    for (int i = 0; i < N; ++i) v = __fmul_rn(__fadd_rn(v, __shfl_xor_sync(FULL_MASK, v, 1)), 0.5f);
    MICRO_END(N)
}
__global__ void m_bar(double* r, float* sink, int N) {    // store, __syncthreads, load, add, multiply
    __shared__ float sh[2][1024];
    float v = threadIdx.x; const int T = blockDim.x;
    MICRO_BEGIN
    for (int i = 0; i < N; ++i) {
        sh[i & 1][threadIdx.x] = v;
        __syncthreads();
        v = __fmul_rn(__fadd_rn(v, sh[i & 1][(threadIdx.x + 32) % T]), 0.5f);
    }
    MICRO_END(N)
}
__global__ void m_dexp(double* r, float* sink, int N) {   // PR 22: float -> double exp -> float
    float v = 0.3f + threadIdx.x * 1e-3f; MICRO_BEGIN
    for (int i = 0; i < N; ++i) v = __double2float_rn(exp(-(double)v));
    MICRO_END(N)
}
__global__ void m_expf(double* r, float* sink, int N) {   // CUDA's expf, for scale
    float v = 0.3f + threadIdx.x * 1e-3f; MICRO_BEGIN
    for (int i = 0; i < N; ++i) v = expf(-v);
    MICRO_END(N)
}
__global__ void m_fdiv(double* r, float* sink, float num, int N) {
    float v = 0.3f + threadIdx.x * 1e-3f; MICRO_BEGIN
    for (int i = 0; i < N; ++i) v = __fdiv_rn(num, __fadd_rn(v, 1.f));
    MICRO_END(N)
}
__global__ void m_frcp(double* r, float* sink, int N) {
    float v = 0.3f + threadIdx.x * 1e-3f; MICRO_BEGIN
    for (int i = 0; i < N; ++i) v = __frcp_rn(__fadd_rn(v, 1.f));
    MICRO_END(N)
}
__global__ void m_old_sigmoid(double* r, float* sink, int N) {
    float v = 0.3f + threadIdx.x * 1e-3f; MICRO_BEGIN
    for (int i = 0; i < N; ++i) {
        const float e = __double2float_rn(exp(-(double)v));
        v = __fdiv_rn(1.f, __fadd_rn(1.f, e));
    }
    MICRO_END(N)
}
__global__ void m_sigmoid(double* r, float* sink, float scale, int N) {   // tg_pass.cu's tg_sigmoid
    float v = 0.3f + threadIdx.x * 1e-3f; MICRO_BEGIN
    for (int i = 0; i < N; ++i) v = tg_sigmoid(__fmul_rn(__fsub_rn(v, 0.5f), scale));
    MICRO_END(N)
}
__global__ void m_update(double* r, float* sink, int N) {  // c x, b - c x, the truncation, the next product
    float v = 0.3f + threadIdx.x * 1e-3f; MICRO_BEGIN
    for (int i = 0; i < N; ++i) {
        const float bb = __fsub_rn(v, __fmul_rn(v, 0.001f));
        v = __fmul_rn(copysignf(max_nan(__fsub_rn(fabsf(bb), 1e-6f), 0.0f), bb), 1.0001f);
    }
    MICRO_END(N)
}
template <int C>
__global__ void __cluster_dims__(C, 1, 1) m_cluster(double* r, float* sink, int N) {
    // thread 0 of each block stores into the next block's shared slot, then
    // the cluster barrier (arrive.release / wait.acquire), then a local load
    __shared__ float slot[2][8];
    unsigned rank; asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank));
    const unsigned local = (unsigned)__cvta_generic_to_shared(&slot[0][0]);
    unsigned remote;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(local), "r"((rank + 1) % C));
    asm volatile("barrier.cluster.arrive.release.aligned; barrier.cluster.wait.acquire.aligned;" ::: "memory");
    float v = threadIdx.x + rank;
    MICRO_BEGIN
    for (int i = 0; i < N; ++i) {
        if (threadIdx.x == 0)
            asm volatile("st.shared::cluster.f32 [%0], %1;" :: "r"(remote + 4u * (8u * (i & 1) + rank)), "f"(v) : "memory");
        asm volatile("barrier.cluster.arrive.release.aligned; barrier.cluster.wait.acquire.aligned;" ::: "memory");
        float w;
        asm volatile("ld.shared.f32 %0, [%1];" : "=f"(w) : "r"(local + 4u * (8u * (i & 1) + (rank + C - 1) % C)) : "memory");
        v = __fmul_rn(__fadd_rn(v, w), 0.5f);
    }
    if (rank != 0) return;
    MICRO_END(N)
}
__global__ void m_chase(double* r, float* sink, const unsigned* nxt, int N) {   // global load latency
    unsigned j = 0; float v = 0; MICRO_BEGIN
    for (int i = 0; i < N; ++i) j = nxt[j];
    v = j; MICRO_END(N)
}

static double* dr;
static float* dsink;
static const unsigned* dchase;
static double micro(const char* name, void (*launch)(int, int), int T, int N) {
    launch(T, 8); CK(cudaDeviceSynchronize());
    launch(T, N); CK(cudaDeviceSynchronize());
    double h[2]; CK(cudaMemcpy(h, dr, sizeof h, cudaMemcpyDeviceToHost));
    printf("[micro] %-46s %4d threads: %8.2f cycles %8.2f ns per iteration\n", name, T, h[0], h[1]);
    return h[0];
}

int main() {
    cudaDeviceProp prop; CK(cudaGetDeviceProperties(&prop, 0));
    printf("[probe] %s, %d SMs, %d kHz\n", prop.name, prop.multiProcessorCount, prop.clockRate);
    CK(cudaMalloc(&dr, 2 * sizeof(double))); CK(cudaMalloc(&dsink, 1024 * sizeof(float)));
    const int N = 20000;
#define L1(fn) [](int T, int n) { fn<<<1, T>>>(dr, dsink, n); }
    const double fadd = micro("fadd chain", L1(m_fadd), 32, N);
    const double fmul_add = 2 * fadd;
    const double shfl = micro("xor shuffle + fadd + fmul", L1(m_shfl), 32, N) - fadd;
    double bar128 = 0;
    for (int T : {128, 256, 512}) {
        const double c = micro("store + __syncthreads + load + fadd + fmul", L1(m_bar), T, N);
        if (T == 128) bar128 = c - fmul_add;
    }
    micro("exp in double with conversions (PR 22)", L1(m_dexp), 32, N);
    const double hexp = micro("expf (CUDA's, for scale)", L1(m_expf), 32, N);
    const double div = micro("__fdiv_rn(1, x + 1)", [](int T, int n) { m_fdiv<<<1, T>>>(dr, dsink, 1.0f, n); }, 32, N);
    micro("__fdiv_rn(1e-30, x + 1)", [](int T, int n) { m_fdiv<<<1, T>>>(dr, dsink, 1e-30f, n); }, 32, N);
    micro("__frcp_rn(x + 1)", L1(m_frcp), 32, N);
    micro("sigmoid, PR 22 (double exp, __fdiv_rn)", L1(m_old_sigmoid), 32, N);
    const double sig = micro("sigmoid, tg_sigmoid (float), + sub + mul", [](int T, int n) { m_sigmoid<<<1, T>>>(dr, dsink, 4.0f, n); }, 32, N) - fmul_add;
    micro("tg_sigmoid at |m| up to 60 (e down to 1e-26)", [](int T, int n) { m_sigmoid<<<1, T>>>(dr, dsink, -120.0f, n); }, 32, N);
    micro("tg_sigmoid at |m| up to 100 (e subnormal)", [](int T, int n) { m_sigmoid<<<1, T>>>(dr, dsink, -200.0f, n); }, 32, N);
    const double upd = micro("update chain (5 ops) + fmul", L1(m_update), 32, N);
    micro("cluster of 2: DSMEM store + barrier + load", [](int T, int n) { m_cluster<2><<<2, T>>>(dr, dsink, n); }, 128, N);
    micro("cluster of 4: DSMEM store + barrier + load", [](int T, int n) { m_cluster<4><<<4, T>>>(dr, dsink, n); }, 128, N);
    {
        const size_t n_big = 256u << 20;
        std::vector<unsigned> h(n_big);
        for (size_t i = 0; i < n_big; ++i) h[i] = (unsigned)((i + 4u * 1048576u + 4099u) % n_big);
        unsigned* d; CK(cudaMalloc(&d, n_big * 4)); CK(cudaMemcpy(d, h.data(), n_big * 4, cudaMemcpyHostToDevice));
        dchase = d;
        micro("global load, 1 GB pointer chase (DRAM)", [](int T, int n) { m_chase<<<1, T>>>(dr, dsink, dchase, n); }, 1, 4000);
        CK(cudaFree(d));
    }
    // this design's chain at p = 2000, 128 threads x 16: 4 fold levels in
    // the thread, LEVELS = 3 shuffles, one store / barrier / load, 4 fold
    // levels of the 16 sums, the sigmoid, g and c = eta g (2 ops), the
    // update and the next product (the update chain)
    const double ghz = prop.clockRate * 1e-6;
    const double chain = 4 * fadd + 3 * shfl + bar128 + 4 * fadd + sig + 2 * fadd + upd;
    printf("[chain] this design's step at p = 2000: %.1f cycles, %.1f ns (fadd %.2f, shuffle-add %.2f, "
           "128-thread exchange %.2f, bit-exact float sigmoid %.2f, update %.2f)\n",
           chain, chain / ghz, fadd, shfl, bar128, sig, upd);
    // the least step: the same reduction and update, the sigmoid as the
    // hardware exp, an add and one division (not bit-reproducible on the host)
    const double least = chain - sig + hexp + div;
    printf("[chain] least step at p = 2000: %.1f cycles, %.1f ns (expf %.2f, add and __fdiv_rn %.2f "
           "in place of the float sigmoid)\n", least, least / ghz, hexp, div);

    const int M = 16, S = 20000, p = 2000;
    float *X, *y, *b0, *out;
    CK(cudaMalloc(&X, (size_t)M * S * p * 4)); CK(cudaMalloc(&y, (size_t)M * S * 4));
    CK(cudaMalloc(&b0, p * 4)); CK(cudaMemset(b0, 0, p * 4));
    CK(cudaMalloc(&out, (size_t)M * p * 4));
    fill_x<<<1024, 256>>>(X, (long long)M * S * p, 1234u);
    fill_y<<<(M * S + 255) / 256, 256>>>(y, (long long)M * S);
    CK(cudaDeviceSynchronize());
    cudaEvent_t e0, e1; cudaEventCreate(&e0); cudaEventCreate(&e1);
    float best = 1e30f;
    for (int rep = 0; rep < 5; ++rep) {
        cudaEventRecord(e0);
        CK((cudaError_t)tg_pass_launch(X, y, b0, out, M, S, p, 128, 16, 0.1f, 1e-4f, INFINITY, 0));
        cudaEventRecord(e1); CK(cudaEventSynchronize(e1));
        float ms; cudaEventElapsedTime(&ms, e0, e1); best = ms < best ? ms : best;
    }
    printf("[time] tg_pass_launch, M=%d steps=%d p=%d: %.4f ms, %.1f ns per step (best of 5); "
           "%.2fx this design's chain, %.2fx the least step\n", M, S, p, best, best * 1e6 / S,
           best * 1e6 / S / (chain / ghz), best * 1e6 / S / (least / ghz));
    printf("[probe] done\n");
    return 0;
}
