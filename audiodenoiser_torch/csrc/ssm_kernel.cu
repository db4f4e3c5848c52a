// The Mamba-1 mixer's two sequential passes, channel-last, for SEMamba's
// bidirectional TF-Mamba blocks (d_state 16, d_conv 4, dt_rank 4):
//
//   conv:  u[n, t, c] = silu(b[c] + sum_k w[c, k] * x[n, t + k - 3, c])   (causal, k < 4;
//                                                         x = 0 outside [0, L))
//          with x = xz[..., :D], the first half of in_proj's output (N, L, 2D);
//   scan:  delta[t, c] = softplus(dt_bias[c] + sum_r dt_w[c, r] * x_dbl[t, r])   (r < 4)
//          h[t, c, s]  = exp(delta[t, c] * A[c, s]) * h[t - 1, c, s]
//                        + delta[t, c] * B[t, s] * u[t, c]            (A = -exp(A_log))
//          y[t, c]     = (sum_s C[t, s] * h[t, c, s] + D[c] * u[t, c]) * silu(z[t, c])
//          with B = x_dbl[..., 4:20], C = x_dbl[..., 20:36], z = xz[..., D:], h[-1] = 0.
//
// `reverse` runs the backward direction of a bidirectional block: the
// published one flips the sequence, runs the mixer and flips the answer
// back. Every other step of the mixer is per token, so here the conv takes
// its taps anti-causally (x[t + 3 - k]) and the scan walks t from L - 1 down
// to 0: no flipped copy is made.
//
// Replaces: no TPU kernel. SEMamba exists only in the port, and no PyTorch
// operation computes a selective scan: a loop of PyTorch operations at the
// cell's shapes (3,200 sequences of 1,601 frames, 51,232 of 100 bins, 256
// channels, 16 states) launches several kernels a step and holds the
// states in device memory, and a scan materialised whole would be the
// (N, L, 256, 16) tensor: 84 GB for one time-axis scan in float32.
//
// What bounds it on the H100. The scan: the special-function units. Each
// (token, channel) takes 16 exponentials of delta * A, one for the
// softplus and one exponential and one reciprocal for the gate: 19 SFU
// operations against 16 an SM a clock, about 6 ms a mixer at the cell's
// 5,123,200 tokens, beside about 100 other instructions (64 FMA-pipe
// operations of the states) against 128 an SM a clock. The bytes a mixer
// must move, x and z in and y out (1,536 bytes a token in bf16: 7.87 GB,
// 2.35 ms at 3.35 TB/s), bound the two entries together. The conv: bytes
// (x in, u out: 1.31 ms a mixer at the cell's shape).
//
// Design:
// - Conv (ssm_conv_kernel): a thread takes 16 bytes of channels (8 bf16)
//   and a run of RUN = 16 tokens of one sequence; it loads the run's rows
//   and its 3 halo rows before it computes (19 independent 16-byte loads in
//   flight), slides the 4-tap window through registers and stores each
//   output once, a warp a whole row of 256 channels (512 contiguous bytes).
//   x is read straight from xz by its row stride 2D: no chunk copy.
// - Scan (ssm_scan_kernel): a block takes one sequence and SCAN_CH = 128
//   channels, one a thread; each thread keeps its channel's 16 states, its
//   16 A * log2(e) and its dt_proj row in registers for the whole sequence:
//   the states are never written to memory. The sequence is staged through
//   shared memory CHUNK = 16 tokens at a time by cp.async, double-buffered,
//   so that the next chunk's u, z and x_dbl rows are in flight while this
//   one is scanned; a chunk's x_dbl rows (dt, B, C: 36 values a token, read
//   by every thread) are converted once to float32, and a thread reads them
//   as broadcast 16-byte shared loads. Static shared memory (20.6 KB in
//   bf16), so no per-device opt-in.
// All arithmetic is float32; the exponentials are the SFU's ex2 (2 float32
// ulps), the softplus log1pf(expf(x)) below 20 as mamba_ssm takes it; each
// output is rounded once to the input's dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int D_STATE = 16;
constexpr int DT_RANK = 4;
constexpr int XW = DT_RANK + 2 * D_STATE;  // 36 values of x_dbl a token
constexpr int TAPS = 4;
constexpr int RUN = 16;                    // tokens a conv thread computes
constexpr int CONV_THREADS = 128;
constexpr int SCAN_CH = 128;               // channels a scan block takes, one a thread
constexpr int CHUNK = 16;                  // tokens a scan block stages at a time
constexpr float LOG2E = 1.4426950408889634f;

template <typename T> struct Pack;  // a 16-byte vector as float values, and one value each way

template <> struct Pack<__nv_bfloat16> {
    static constexpr int N = 8;
    __device__ __forceinline__ static void unpack(const uint4& r, float* f) {
        const unsigned w[4] = {r.x, r.y, r.z, r.w};  // a bf16 is a float's top half
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            f[2 * i] = __uint_as_float(w[i] << 16);
            f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
        }
    }
    __device__ __forceinline__ static uint4 pack(const float* f) {
        uint4 r;
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
        for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
        return r;
    }
    __device__ __forceinline__ static float scalar(__nv_bfloat16 v) { return __bfloat162float(v); }
    __device__ __forceinline__ static __nv_bfloat16 from_float(float v) {
        return __float2bfloat16_rn(v);
    }
};

template <> struct Pack<float> {
    static constexpr int N = 4;
    __device__ __forceinline__ static void unpack(const uint4& r, float* f) {
        f[0] = __uint_as_float(r.x);
        f[1] = __uint_as_float(r.y);
        f[2] = __uint_as_float(r.z);
        f[3] = __uint_as_float(r.w);
    }
    __device__ __forceinline__ static uint4 pack(const float* f) {
        return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                          __float_as_uint(f[3]));
    }
    __device__ __forceinline__ static float scalar(float v) { return v; }
    __device__ __forceinline__ static float from_float(float v) { return v; }
};

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// 1 / (1 + e^-x) from the SFU's exp2 and reciprocal (2 and 1 float32 ulps)
__device__ __forceinline__ float sigmoid(float x) {
    float r;
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.0f + ex2(x * -LOG2E)));
    return r;
}

__device__ __forceinline__ float silu(float x) { return x * sigmoid(x); }

// mamba_ssm's softplus: log(1 + e^x), and x itself past 20
__device__ __forceinline__ float softplus(float x) {
    return x > 20.f ? x : log1pf(ex2(x * LOG2E));
}

// ---------------------------------------------------------------- conv

template <typename T>
struct ConvArgs {
    const T* xz;      // (n, len, 2d)
    const T* weight;  // (d, 4)
    const T* bias;    // (d,)
    T* u;             // (n, len, d)
    int n, len, d;
    int runs;         // runs a sequence: ceil(len / RUN)
    long long total;  // threads with work: n * runs * d / E
    int reverse;
};

template <typename T>
__global__ void __launch_bounds__(CONV_THREADS)
ssm_conv_kernel(ConvArgs<T> a)
{
    constexpr int E = Pack<T>::N;
    const long long idx = (long long)blockIdx.x * CONV_THREADS + threadIdx.x;
    if (idx >= a.total) return;
    const int vecs = a.d / E;                  // 16-byte vectors of a row's d channels
    const int v = (int)(idx % vecs);
    const long long run = idx / vecs;
    const int seq = (int)(run / a.runs);
    const int t0 = (int)(run % a.runs) * RUN;
    const int cnt = min(RUN, a.len - t0);
    const int c0 = v * E;
    const int dir = a.reverse ? -1 : 1;
    // the run in scan order: first, first + dir, ...; output t reads the
    // taps t + dir * (k - 3), k < 4, the last of them t itself
    const int first = a.reverse ? t0 + cnt - 1 : t0;
    const T* src = a.xz + (long long)seq * a.len * (2 * a.d) + c0;
    uint4 raw[RUN + TAPS - 1];
#pragma unroll
    for (int i = 0; i < RUN + TAPS - 1; ++i) {
        const int t = first + dir * (i - (TAPS - 1));
        raw[i] = (i < cnt + TAPS - 1 && t >= 0 && t < a.len)
                     ? *reinterpret_cast<const uint4*>(src + (long long)t * (2 * a.d))
                     : make_uint4(0u, 0u, 0u, 0u);
    }
    float w[TAPS][E], b[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
        b[e] = Pack<T>::scalar(a.bias[c0 + e]);
#pragma unroll
        for (int k = 0; k < TAPS; ++k) w[k][e] = Pack<T>::scalar(a.weight[(c0 + e) * TAPS + k]);
    }
    T* dst = a.u + (long long)seq * a.len * a.d + c0;
#pragma unroll
    for (int i = 0; i < RUN; ++i) {
        if (i >= cnt) break;
        float acc[E];
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] = b[e];
#pragma unroll
        for (int k = 0; k < TAPS; ++k) {
            float x[E];
            Pack<T>::unpack(raw[i + k], x);
#pragma unroll
            for (int e = 0; e < E; ++e) acc[e] = fmaf(w[k][e], x[e], acc[e]);
        }
#pragma unroll
        for (int e = 0; e < E; ++e) acc[e] = silu(acc[e]);
        const int t = first + dir * i;
        *reinterpret_cast<uint4*>(dst + (long long)t * a.d) = Pack<T>::pack(acc);
    }
}

// ---------------------------------------------------------------- scan

template <typename T>
struct ScanArgs {
    const T* u;       // (n, len, d)
    const T* xz;      // (n, len, 2d): z is its second half
    const T* x_dbl;   // (n, len, 36)
    const T* dt_w;    // (d, 4)
    const T* dt_b;    // (d,)
    const T* a_log;   // (d, 16)
    const T* d_skip;  // (d,)
    T* y;             // (n, len, d)
    int n, len, d;
    int reverse;
};

template <typename T>
struct ScanSmem {
    T u[2][CHUNK][SCAN_CH];       // the chunks' u and z rows, as copied
    T z[2][CHUNK][SCAN_CH];
    T xd[2][CHUNK * XW];          // their x_dbl rows, as copied
    float xf[CHUNK][XW];          // this chunk's x_dbl rows in float32: dt, B, C
};

__device__ __forceinline__ void copy16(void* smem, const void* gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void copy8(void* smem, const void* gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void copy_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// the token at scan position s of the sequence
__device__ __forceinline__ int token(int s, int len, int reverse) {
    return reverse ? len - 1 - s : s;
}

// Chunk k's rows (scan positions k * CHUNK ..) into buffer b: u's and z's
// channels [c0, c0 + SCAN_CH) that exist, and the whole x_dbl row
template <typename T>
__device__ __forceinline__ void load_chunk(const ScanArgs<T>& a, ScanSmem<T>& sm, int b, int k,
                                           long long row0, int c0) {
    constexpr int E = Pack<T>::N;
    constexpr int VECS = SCAN_CH / E;                 // 16-byte vectors of a row's channels
    constexpr int XV = XW * (int)sizeof(T) / 8;       // 8-byte pieces of an x_dbl row
    const int s0 = k * CHUNK;
    const int cnt = min(CHUNK, a.len - s0);
    const int live = min(VECS, (a.d - c0) / E);
    for (int i = threadIdx.x; i < cnt * VECS; i += SCAN_CH) {
        const int j = i / VECS, v = i % VECS;
        if (v >= live) continue;
        const long long r = row0 + token(s0 + j, a.len, a.reverse);
        copy16(&sm.u[b][j][v * E], a.u + r * a.d + c0 + v * E);
        copy16(&sm.z[b][j][v * E], a.xz + r * (2 * a.d) + a.d + c0 + v * E);
    }
    for (int i = threadIdx.x; i < cnt * XV; i += SCAN_CH) {
        const int j = i / XV, p = i % XV;
        const long long r = row0 + token(s0 + j, a.len, a.reverse);
        copy8(reinterpret_cast<char*>(&sm.xd[b][j * XW]) + 8 * p,
              reinterpret_cast<const char*>(a.x_dbl + r * XW) + 8 * p);
    }
}

template <typename T>
__global__ void __launch_bounds__(SCAN_CH)
ssm_scan_kernel(ScanArgs<T> a)
{
    __shared__ __align__(16) ScanSmem<T> sm;
    const int groups = (a.d + SCAN_CH - 1) / SCAN_CH;
    const int seq = blockIdx.x / groups;
    const int c0 = (blockIdx.x % groups) * SCAN_CH;
    const int c = c0 + threadIdx.x;
    const bool live = c < a.d;
    const long long row0 = (long long)seq * a.len;

    // the channel's constants, float32, in registers for the whole sequence
    float a2[D_STATE], w[DT_RANK], bias = 0.f, dskip = 0.f;
#pragma unroll
    for (int s = 0; s < D_STATE; ++s)
        a2[s] = live ? -expf(Pack<T>::scalar(a.a_log[c * D_STATE + s])) * LOG2E : 0.f;
#pragma unroll
    for (int r = 0; r < DT_RANK; ++r) w[r] = live ? Pack<T>::scalar(a.dt_w[c * DT_RANK + r]) : 0.f;
    if (live) {
        bias = Pack<T>::scalar(a.dt_b[c]);
        dskip = Pack<T>::scalar(a.d_skip[c]);
    }
    float h[D_STATE];
#pragma unroll
    for (int s = 0; s < D_STATE; ++s) h[s] = 0.f;

    const int chunks = (a.len + CHUNK - 1) / CHUNK;
    load_chunk(a, sm, 0, 0, row0, c0);
    copy_commit();
    for (int k = 0; k < chunks; ++k) {
        const int b = k & 1;
        copy_wait_all();
        __syncthreads();  // chunk k is in; every thread is done with chunk k - 1
        if (k + 1 < chunks) load_chunk(a, sm, b ^ 1, k + 1, row0, c0);
        copy_commit();
        const int cnt = min(CHUNK, a.len - k * CHUNK);
        for (int i = threadIdx.x; i < cnt * XW; i += SCAN_CH)
            sm.xf[i / XW][i % XW] = Pack<T>::scalar(sm.xd[b][i]);
        __syncthreads();
        if (!live) continue;
        for (int j = 0; j < cnt; ++j) {
            const float uu = Pack<T>::scalar(sm.u[b][j][threadIdx.x]);
            const float zz = Pack<T>::scalar(sm.z[b][j][threadIdx.x]);
            const float4* xq = reinterpret_cast<const float4*>(sm.xf[j]);
            const float4 dt = xq[0];
            const float delta =
                softplus(fmaf(w[0], dt.x, fmaf(w[1], dt.y, fmaf(w[2], dt.z, fmaf(w[3], dt.w, bias)))));
            const float du = delta * uu;
            float acc = 0.f;
#pragma unroll
            for (int q = 0; q < D_STATE / 4; ++q) {
                const float4 bq = xq[1 + q], cq = xq[1 + D_STATE / 4 + q];
                const float bv[4] = {bq.x, bq.y, bq.z, bq.w}, cv[4] = {cq.x, cq.y, cq.z, cq.w};
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int s = 4 * q + e;
                    h[s] = fmaf(ex2(delta * a2[s]), h[s], du * bv[e]);
                    acc = fmaf(cv[e], h[s], acc);
                }
            }
            acc = fmaf(dskip, uu, acc) * silu(zz);
            const long long r = row0 + token(k * CHUNK + j, a.len, a.reverse);
            a.y[r * a.d + c] = Pack<T>::from_float(acc);
        }
    }
}

template <typename T>
int conv(const void* xz, const void* weight, const void* bias, void* u, int n, int len, int d,
         int reverse, cudaStream_t stream) {
    ConvArgs<T> a{static_cast<const T*>(xz), static_cast<const T*>(weight),
                  static_cast<const T*>(bias), static_cast<T*>(u), n, len, d,
                  (len + RUN - 1) / RUN, 0, reverse};
    a.total = (long long)n * a.runs * (d / Pack<T>::N);
    const long long blocks = (a.total + CONV_THREADS - 1) / CONV_THREADS;
    if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    ssm_conv_kernel<T><<<(unsigned)blocks, CONV_THREADS, 0, stream>>>(a);
    return (int)cudaGetLastError();
}

template <typename T>
int scan(const void* u, const void* xz, const void* x_dbl, const void* dt_w, const void* dt_b,
         const void* a_log, const void* d_skip, void* y, int n, int len, int d, int reverse,
         cudaStream_t stream) {
    ScanArgs<T> a{static_cast<const T*>(u), static_cast<const T*>(xz),
                  static_cast<const T*>(x_dbl), static_cast<const T*>(dt_w),
                  static_cast<const T*>(dt_b), static_cast<const T*>(a_log),
                  static_cast<const T*>(d_skip), static_cast<T*>(y), n, len, d, reverse};
    const long long blocks = (long long)n * ((d + SCAN_CH - 1) / SCAN_CH);
    if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    ssm_scan_kernel<T><<<(unsigned)blocks, SCAN_CH, 0, stream>>>(a);
    return (int)cudaGetLastError();
}

}  // namespace

// xz: (n, len, 2d), u: (n, len, d), contiguous and 16-byte aligned, f32
// (is_bf16 0) or bf16 (is_bf16 1); weight (d, 4) and bias (d,) in xz's
// dtype; d a multiple of 8; n, len at least 1. Returns cudaGetLastError()
// after the launch.
extern "C" int ssm_conv_launch(const void* xz, const void* weight, const void* bias, void* u,
                               int is_bf16, int n, int len, int d, int reverse, void* stream)
{
    if (n < 1 || len < 1 || d < 8 || d % 8 != 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16) return conv<__nv_bfloat16>(xz, weight, bias, u, n, len, d, reverse, s);
    return conv<float>(xz, weight, bias, u, n, len, d, reverse, s);
}

// u, y: (n, len, d); xz: (n, len, 2d); x_dbl: (n, len, 36); dt_w: (d, 4);
// dt_b, d_skip: (d,); a_log: (d, 16); contiguous, u, xz and x_dbl 16-byte
// aligned, all in one dtype, f32 (is_bf16 0) or bf16 (is_bf16 1); d a
// multiple of 8; n, len at least 1. Returns cudaGetLastError() after the
// launch.
extern "C" int ssm_scan_launch(const void* u, const void* xz, const void* x_dbl,
                               const void* dt_w, const void* dt_b, const void* a_log,
                               const void* d_skip, void* y, int is_bf16, int n, int len, int d,
                               int reverse, void* stream)
{
    if (n < 1 || len < 1 || d < 8 || d % 8 != 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16)
        return scan<__nv_bfloat16>(u, xz, x_dbl, dt_w, dt_b, a_log, d_skip, y, n, len, d,
                                   reverse, s);
    return scan<float>(u, xz, x_dbl, dt_w, dt_b, a_log, d_skip, y, n, len, d, reverse, s);
}
