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
//   beta   = beta - (eta g) x_i
//   beta   = where(|beta| <= theta, copysign(max(|beta| - shrink, 0), beta), beta)
// with shrink = eta * gravity (rounded to float32 by the wrapper) and
// theta possibly +inf.
//
// Bound on the H100: the chain of dependent steps. Each step's margin
// must be known before the step's update, and the update before the next
// margin, so a pass is `steps` times the latency of one step: a dot over
// p reduced to a value every thread holds, a sigmoid and one update. From
// the latencies scripts/tg_step_probe.cu measures on the card, the least
// such step at p = 2000 is about 314 cycles (159 ns, 3.2 ms an epsilon
// pass) with the hardware exp, an add and one division; this design's chain is
// about 341 cycles (172 ns, 3.4 ms), since its float sigmoid (136 cycles
// against 109) is one the host can repeat bit for bit. The bytes (X read
// once: 2.56 GB, 0.77 ms at 3.35 TB/s) are below both. Measured: a
// shuffle-and-add costs about 29 cycles, a 128-thread store / barrier /
// load round trip 46, a cluster barrier about 770 (so splitting p over a
// thread-block cluster costs more than the update it would share out),
// exp in double 184, __fdiv_rn 60 and __frcp_rn 80 (so the sigmoid
// divides).
//
// A pass may take any number of steps: the producer's watchdog (a trap
// after 2e10 cycles) times only the wait since a row last moved.
//
// The design:
//   one block per machine: THREADS consumer threads (128, or 256 past p
//     = 4096) and one producer warp; beta in registers, PER coordinates
//     a thread in groups of four consecutive ones: thread t owns j = 4 (g
//     THREADS + t) + c, g < PER / 4, c < 4; coordinates past p hold 0;
//   rows streamed SLOTS - 1 steps ahead into a shared-memory ring of
//     SLOTS rows (each slot's floats past p zero). When rows are 16-byte
//     aligned (p % 4 == 0) the producer warp's one lane copies each row
//     by one 1-D TMA into its slot once the consumers have released it,
//     waits for the rows in order on their mbarriers and publishes how
//     many have landed; the consumers read that count early in the step
//     and touch no mbarrier (issuing the copies or waiting on mbarriers
//     from a consumer warp cost it some 800 cycles a row). Otherwise each
//     consumer copies its own coordinates by 4-byte cp.async (p = 4099).
//     The label of step i + 2 is loaded into a register at step i. No
//     global load waits on the chain;
//   the margin, in one fixed order: a balanced tree of adjacent pairs
//     over the THREADS * PER products in the order t * PER + 4 g + c (the
//     padding's exact zeros included). Each thread folds its own products;
//     LEVELS xor shuffles fold groups of 2^LEVELS threads (every lane of
//     a group then holds the same bits, since a + b == b + a); the NPART
//     group sums go through shared memory (double-buffered by the step's
//     parity) across the step's one barrier; every thread folds them the
//     same way, so every thread holds the same margin;
//   the sigmoid from correctly rounded float operations only: exp(-|m|)
//     by a two-constant ln 2 reduction and a degree-6 polynomial (Estrin's
//     scheme), scaled by an exact power of two (subnormals included), then
//     one __fdiv_rn: 1 / (1 + e) for m >= 0, e / (1 + e) below. At most 3
//     ulps from the correctly rounded value, and the same bits as the
//     plain version's float32 torch ops, since every step is a basic IEEE
//     operation. Every product, sum and quotient is written as __fmul_rn /
//     __fadd_rn / __fsub_rn / __fdiv_rn, so nvcc contracts nothing into a
//     multiply-add;
//   the update takes c = eta g once per step, then b - c x and the
//     truncation per coordinate; with theta = +inf the compare and select
//     are skipped (NaN still propagates).
// The plain version (kernels/ref.py tg_margin, tg_sigmoid, tg_pass_ref)
// repeats this order and rounding op for op, because the pass is chaotic
// at epsilon's width: one rounding difference in a margin grows to 1e-1
// in beta within a pass. No atomics, so two launches are bit-equal.
#include "cd_common.cuh"    // FULL_MASK, the mbarrier and 1-D TMA helpers

constexpr int NPART = 16;          // group sums exchanged through shared memory
constexpr unsigned POLL_NS = 500;  // the producer's sleep between polls

constexpr int ilog2(int v) { return v <= 1 ? 0 : 1 + ilog2(v / 2); }

template <int THREADS, int PER>
struct TgShape {
    static constexpr int W = THREADS * PER;              // coordinates a block holds
    static constexpr int SLOTS = W <= 4096 ? 8 : 4;      // ring slots, one row each
    static constexpr int AHEAD = SLOTS - 1;              // rows the cp.async path copies ahead
    static constexpr int LEVELS = ilog2(THREADS / NPART);
    // float offsets: ring, group sums, then the mbarriers and counters
    static constexpr int PART = SLOTS * W;
    static constexpr int BAR = PART + 2 * NPART;
    static constexpr size_t SMEM = 4 * (size_t)BAR + 8 * SLOTS + 16;
    static_assert(PER % 4 == 0 && THREADS % 32 == 0 && (1 << LEVELS) * NPART == THREADS,
                  "tg_pass shape");
};

// sigmoid constants, exact float32 values (kernels/ref.py repeats them):
// log2(e), ln 2 in two parts (k ln2_hi is exact), the clamp of -|m| (so k
// >= -149), the least |m| whose exp(-|m|) rounds to 0 (150 ln 2 rounded
// up), and the polynomial for exp on [-ln2/2, ln2/2] (a near-minimax fit
// of relative error)
constexpr float L2E = 0x1.715476p+0f;
constexpr float LN2_HI = 0x1.62e4p-1f;
constexpr float LN2_LO = 0x1.7f7d1cp-20f;
constexpr float X_CLAMP = -103.5f;
constexpr float M_ZERO = 0x1.9fe36ap+6f;
constexpr float P0 = 1.0f, P1 = 1.0f, P2 = 0x1.fffffap-2f, P3 = 0x1.55540ap-3f,
                P4 = 0x1.55589ap-5f, P5 = 0x1.126d3p-7f, P6 = 0x1.6ab95ap-10f;

__device__ __forceinline__ float max_nan(float a, float b) {
    float d;
    asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
    return d;
}

__device__ __forceinline__ float tg_sigmoid(float m) {
    const float x = max_nan(-fabsf(m), X_CLAMP);
    const float k = rintf(__fmul_rn(x, L2E));
    const float r = __fsub_rn(__fsub_rn(x, __fmul_rn(k, LN2_HI)), __fmul_rn(k, LN2_LO));
    const float r2 = __fmul_rn(r, r);
    const float a0 = __fadd_rn(P0, __fmul_rn(P1, r));
    const float a1 = __fadd_rn(P2, __fmul_rn(P3, r));
    const float a2 = __fadd_rn(P4, __fmul_rn(P5, r));
    const float r4 = __fmul_rn(r2, r2);
    const float b0 = __fadd_rn(a0, __fmul_rn(a1, r2));
    const float b1 = __fadd_rn(a2, __fmul_rn(P6, r2));
    const float q = __fadd_rn(b0, __fmul_rn(b1, r4));
    const int ki = (int)k;
    const int nb = max(ki + 127, 0) << 23;
    const int sb = 1 << min(max(ki + 149, 0), 30);
    const float e = __fmul_rn(q, __int_as_float(ki >= -126 ? nb : sb));
    const float num = m >= 0.0f ? 1.0f : (m <= -M_ZERO ? 0.0f : e);
    const float den = __fadd_rn(1.0f, e);
    // num / 1 is num: where e is below half an ulp of 1 the quotient is
    // taken as num, and the division gets 1 instead of a numerator that
    // may be subnormal (__fdiv_rn's slow path); a select, not a branch
    const float quo = __fdiv_rn(den == 1.0f ? 1.0f : num, den);
    return den == 1.0f ? num : quo;
}

__device__ __forceinline__ void cp4(float* dst, const float* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" :: "r"(cd_smem_u32(dst)), "l"(src)
                 : "memory");
}
__device__ __forceinline__ void cp_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
    asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}
// release store and acquire load of a shared int (the producer's count
// of landed rows; its store follows the mbarrier wait that saw them land)
__device__ __forceinline__ void st_release(int* p, int v) {
    asm volatile("st.release.cta.shared.s32 [%0], %1;" :: "r"(cd_smem_u32(p)), "r"(v) : "memory");
}
__device__ __forceinline__ int ld_acquire(const int* p) {
    int v;
    asm volatile("ld.acquire.cta.shared.s32 %0, [%1];" : "=r"(v) : "r"(cd_smem_u32(p)) : "memory");
    return v;
}

template <int THREADS, int PER, bool BULK>
struct TgBlock {
    using S = TgShape<THREADS, PER>;
    const float* Xm;
    const float* ym;
    float* ring;              // SLOTS slots of one row
    float* part;              // 2 x NPART group sums
    uint32_t full0;           // shared address of the SLOTS "row landed" mbarriers (bulk)
    volatile int* released;   // steps whose rows every consumer has read
    int* landed;              // rows landed, in order (bulk)
    int steps, p, t;

    __device__ __forceinline__ float* row(int r) const { return ring + (r % S::SLOTS) * S::W; }
    // bulk: the producer warp's one lane streams every row into its slot
    // once the consumers have passed the barrier of the step that read the
    // slot's previous row, waits for the rows in order (the mbarrier wait
    // sleeps in hardware) and publishes how many have landed. The
    // consumers then touch no mbarrier: warp 0 reads the count, and the
    // step's barrier passes the rows on to the other warps.
    // The watchdog times the wait since the last row issued or landed, not
    // the pass, so a pass may be as long as it likes.
    __device__ __forceinline__ void produce() const {
        long long t0 = clock64();
        int issued = 0;
        for (int done = 0; done < steps;) {
            if (issued < steps && issued - S::SLOTS < *released) {
                if (issued >= S::SLOTS) asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
                const uint32_t full = full0 + 8 * (issued % S::SLOTS);
                cd_mbar_expect_tx(full, 4u * p);
                cd_bulk_load(cd_smem_u32(row(issued)), Xm + (long long)issued * p, 4u * p, full);
                ++issued;
                t0 = clock64();
            } else if (done < issued) {
                cd_mbar_wait(full0 + 8 * (done % S::SLOTS), (done / S::SLOTS) & 1);
                st_release(landed, ++done);
                t0 = clock64();
            } else {
                // every slot waits on the consumers: sleep, so as to take
                // neither issue slots nor the shared-memory pipe from them
                __nanosleep(POLL_NS);
                if (clock64() - t0 > 20000000000LL) __trap();
            }
        }
    }
    // otherwise this thread's coordinates of row r by 4-byte cp.async (the
    // slots' padding past p stays zero)
    __device__ __forceinline__ void copy_row(int r) const {
        float* dst = row(r);
        const float* src = Xm + (long long)r * p;
#pragma unroll
        for (int g = 0; g < PER / 4; ++g) {
            const int j = 4 * (g * THREADS + t);
#pragma unroll
            for (int c = 0; c < 4; ++c)
                if (j + c < p) cp4(dst + j + c, src + j + c);
        }
    }
    // warp 0 waits until the producer has published row r (bulk)
    __device__ __forceinline__ void wait_row(int r, int seen) const {
        if (seen > r) return;
        const long long t0 = clock64();
        while (seen <= r) {
            seen = ld_acquire(landed);
            if (clock64() - t0 > 20000000000LL) __trap();
        }
    }
    // this thread's coordinates of row r (a slot's floats past p are zero)
    __device__ __forceinline__ void load_row(int r, float (&x)[PER]) const {
        const float* from = row(r);
#pragma unroll
        for (int g = 0; g < PER / 4; ++g) {
            const float4 v = *reinterpret_cast<const float4*>(from + 4 * (g * THREADS + t));
            x[4 * g] = v.x;
            x[4 * g + 1] = v.y;
            x[4 * g + 2] = v.z;
            x[4 * g + 3] = v.w;
        }
    }
};

// fold v[0..N) by adjacent pairs into v[0]
template <int N>
__device__ __forceinline__ float pair_fold(float (&v)[N]) {
#pragma unroll
    for (int w = 1; w < N; w <<= 1)
#pragma unroll
        for (int n = 0; n < N; n += 2 * w) v[n] = __fadd_rn(v[n], v[n + w]);
    return v[0];
}

// One step: the margin of row i (xc, label yc) against b, the sigmoid,
// the update. Copies row i + AHEAD (cp.async path), loads row i + 1 into
// xn and the label of row i + 2 into yc.
template <int THREADS, int PER, bool BULK>
__device__ __forceinline__ void tg_step(const TgBlock<THREADS, PER, BULK>& B, int i, float (&b)[PER],
                                        const float (&xc)[PER], float (&xn)[PER], float& yc,
                                        float eta, float shrink, float theta, bool all) {
    using S = TgShape<THREADS, PER>;
    // warp 0 reads early how many rows have landed (the value is used
    // just before the barrier, so its latency hides behind the products)
    const bool check = BULK && B.t < 32 && i + 1 < B.steps;
    const int seen = check ? ld_acquire(B.landed) : 0;
    float q[PER];
#pragma unroll
    for (int n = 0; n < PER; ++n) q[n] = __fmul_rn(xc[n], b[n]);
    float v = pair_fold(q);
#pragma unroll
    for (int o = 1; o < (1 << S::LEVELS); o <<= 1)
        v = __fadd_rn(v, __shfl_xor_sync(FULL_MASK, v, o));
    float* pb = B.part + (i & 1) * NPART;
    pb[B.t >> S::LEVELS] = v;
    if (check) B.wait_row(i + 1, seen);
    asm volatile("bar.sync 1, %0;" :: "n"(THREADS) : "memory");   // the consumers only
    float s[NPART];
#pragma unroll
    for (int n = 0; n < NPART; n += 4) {
        const float4 w = *reinterpret_cast<const float4*>(pb + n);
        s[n] = w.x;
        s[n + 1] = w.y;
        s[n + 2] = w.z;
        s[n + 3] = w.w;
    }
    // every consumer has passed this barrier, so row i (read into xc a
    // step ago) is free
    if (BULK) {
        if (B.t < 32) *B.released = i + 1;      // warp 0, one value
    } else {
        if (i + S::AHEAD < B.steps) B.copy_row(i + S::AHEAD);
        cp_commit();
        cp_wait<S::AHEAD - 1>();
    }
    if (i + 1 < B.steps) B.load_row(i + 1, xn);
    const float yh = __fmul_rn(__fadd_rn(yc, 1.0f), 0.5f);
    if (i + 2 < B.steps) yc = __ldg(B.ym + i + 2);

    const float margin = pair_fold(s);
    const float c = __fmul_rn(eta, __fsub_rn(tg_sigmoid(margin), yh));
    if (all) {
#pragma unroll
        for (int n = 0; n < PER; ++n) {
            const float bb = __fsub_rn(b[n], __fmul_rn(c, xc[n]));
            b[n] = copysignf(max_nan(__fsub_rn(fabsf(bb), shrink), 0.0f), bb);
        }
    } else {
#pragma unroll
        for (int n = 0; n < PER; ++n) {
            const float bb = __fsub_rn(b[n], __fmul_rn(c, xc[n]));
            const float tr = copysignf(max_nan(__fsub_rn(fabsf(bb), shrink), 0.0f), bb);
            b[n] = fabsf(bb) <= theta ? tr : bb;
        }
    }
}

// bulk: rows 16-byte aligned (p % 4 == 0), streamed by 1-D TMA from the
// producer warp; else copied by each thread with cp.async
template <int THREADS, int PER, bool BULK>
__global__ void __launch_bounds__(THREADS + 32)
tg_pass_kernel(const float* __restrict__ X, const float* __restrict__ y,
               const float* __restrict__ beta0, float* __restrict__ out,
               int steps, int p, float eta, float shrink, float theta) {
    using S = TgShape<THREADS, PER>;
    extern __shared__ __align__(16) float smem[];
    TgBlock<THREADS, PER, BULK> B;
    B.Xm = X + (long long)blockIdx.x * steps * p;
    B.ym = y + (long long)blockIdx.x * steps;
    B.ring = smem;
    B.part = smem + S::PART;
    B.full0 = cd_smem_u32(smem + S::BAR);
    B.released = reinterpret_cast<volatile int*>(smem + S::BAR + 2 * S::SLOTS);
    B.landed = reinterpret_cast<int*>(smem + S::BAR + 2 * S::SLOTS + 1);
    B.steps = steps;
    B.p = p;
    B.t = threadIdx.x;
    const int t = threadIdx.x;
    const bool all = theta > 3.40282347e38f;   // theta == +inf

    // every slot's padding past p is zero for the whole pass; rows only
    // ever land in [0, p)
    for (int n = t; n < S::SLOTS * S::W; n += THREADS + 32)
        if (n % S::W >= p) B.ring[n] = 0.0f;
    if (t == 0) {
        *B.released = 0;
        *B.landed = 0;
        if (BULK) {
            for (int s = 0; s < S::SLOTS; ++s) cd_mbar_init(B.full0 + 8 * s, 1);
            asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
        }
    }
    __syncthreads();
    if (t >= THREADS) {                        // the producer warp
        if (BULK && t == THREADS) B.produce();
        return;
    }
    float b[PER];
#pragma unroll
    for (int g = 0; g < PER / 4; ++g)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const int j = 4 * (g * THREADS + t) + c;
            b[4 * g + c] = j < p ? beta0[j] : 0.0f;
        }
    if (!BULK) {
#pragma unroll 1
        for (int r = 0; r < S::AHEAD; ++r) {
            if (r < steps) B.copy_row(r);
            cp_commit();
        }
        cp_wait<S::AHEAD - 1>();
    }
    float xa[PER], xb[PER];
    float ya = steps > 0 ? B.ym[0] : 0.0f, yb = steps > 1 ? B.ym[1] : 0.0f;
    if (steps > 0) {
        if (BULK && t < 32) B.wait_row(0, 0);
        asm volatile("bar.sync 1, %0;" :: "n"(THREADS) : "memory");
        B.load_row(0, xa);
    }

    int i = 0;
    for (; i + 1 < steps; i += 2) {
        tg_step(B, i, b, xa, xb, ya, eta, shrink, theta, all);
        tg_step(B, i + 1, b, xb, xa, yb, eta, shrink, theta, all);
    }
    if (i < steps) tg_step(B, i, b, xa, xb, ya, eta, shrink, theta, all);
    if (!BULK) cp_wait<0>();

    float* om = out + (long long)blockIdx.x * p;
#pragma unroll
    for (int g = 0; g < PER / 4; ++g)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const int j = 4 * (g * THREADS + t) + c;
            if (j < p) om[j] = b[4 * g + c];
        }
}

template <int THREADS, int PER, bool BULK>
static int launch_as(const float* X, const float* y, const float* beta0, float* out,
                     int machines, int steps, int p, float eta, float shrink, float theta,
                     cudaStream_t s) {
    using S = TgShape<THREADS, PER>;
    static bool ready = false;
    if (!ready) {
        const cudaError_t err = cudaFuncSetAttribute(
            tg_pass_kernel<THREADS, PER, BULK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)S::SMEM);
        if (err != cudaSuccess) return (int)err;
        ready = true;
    }
    tg_pass_kernel<THREADS, PER, BULK><<<machines, THREADS + 32, S::SMEM, s>>>(
        X, y, beta0, out, steps, p, eta, shrink, theta);
    return (int)cudaGetLastError();
}

template <int THREADS, int PER>
static int launch(const float* X, const float* y, const float* beta0, float* out,
                  int machines, int steps, int p, float eta, float shrink, float theta,
                  cudaStream_t s) {
    if (p % 4 == 0 && reinterpret_cast<uintptr_t>(X) % 16 == 0)
        return launch_as<THREADS, PER, true>(X, y, beta0, out, machines, steps, p, eta, shrink,
                                             theta, s);
    return launch_as<THREADS, PER, false>(X, y, beta0, out, machines, steps, p, eta, shrink,
                                          theta, s);
}

// Plain C entry point for ctypes. X (machines, steps, p) and y (machines,
// steps) float32 device arrays, contiguous; beta0 (p,) the shared warm
// start; out (machines, p) each machine's beta after its pass. threads
// and per are the launch shape the wrapper chose (kernels/tg_pass.py
// launch_shape: 128 x 4, 8, 16, 32 or 256 x 32, with threads * per >=
// p). Returns cudaGetLastError() after the launch (0 = launched), or -1
// for a shape with no instantiation.
extern "C" int tg_pass_launch(const float* X, const float* y, const float* beta0,
                              float* out, int machines, int steps, int p, int threads,
                              int per, float eta, float shrink, float theta, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (threads == 128) {
        switch (per) {
            case 4: return launch<128, 4>(X, y, beta0, out, machines, steps, p, eta, shrink, theta, s);
            case 8: return launch<128, 8>(X, y, beta0, out, machines, steps, p, eta, shrink, theta, s);
            case 16: return launch<128, 16>(X, y, beta0, out, machines, steps, p, eta, shrink, theta, s);
            case 32: return launch<128, 32>(X, y, beta0, out, machines, steps, p, eta, shrink, theta, s);
        }
    } else if (threads == 256 && per == 32) {
        return launch<256, 32>(X, y, beta0, out, machines, steps, p, eta, shrink, theta, s);
    }
    return -1;
}
