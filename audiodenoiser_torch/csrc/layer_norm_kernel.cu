// LayerNorm over the last dimension of (rows, C): y = (x - mean) * rstd * gamma + beta.
//
// Replaces: no TPU kernel. MP-SENet exists only in the port; its conformers
// went through PyTorch's `vectorized_layer_norm_kernel`, which took 26.7% of
// a batch of 32 clips of 10 s at 16 kHz (40 LayerNorms a forward, each over
// 5,123,200 rows of C = 64 bf16) at about 7% of HBM bandwidth: it puts one
// block on each row, 5.1 M blocks each reducing 64 values with most of its
// threads idle.
//
// What bounds it on the H100: bytes. Each element is read once and written
// once (4 * rows * C bytes in bf16: 1.31 GB, 0.392 ms at 3.35 TB/s at the
// shape above); the work is a handful of float operations an element.
//
// Design: a row of C = 64 bf16 is 128 bytes, eight 16-byte vectors. LANES
// neighbouring lanes of a warp share a row, each holding VPL vectors of
// 16 bytes (8 bf16 or 4 float) in registers, so every load and store is a
// full 16-byte transaction on neighbouring addresses; at C = 64 a warp
// covers 4 bf16 rows (8 lanes a row) or 2 float rows (16 lanes) a step. The
// row layout (LANES, VPL) is a compile-time parameter, the exact C a
// run-time one: vectors past C / (16 / sizeof(T)) are masked, so any C that
// is a multiple of 8 up to 512 takes one of seven instantiations in bf16
// and eight in float.
// Statistics are float32, from registers: the lane's partial sum, reduced
// by log2(LANES) xor shuffles inside the group, gives the mean; a second
// pass over the same registers gives sum((x - mean)^2), reduced the same
// way, and rstd = rsqrt(var / C + eps) with the biased variance, as
// nn.LayerNorm takes it. The row is read from memory once; no shared
// memory, no barrier. The affine transform is float32, rounded once to the
// input's dtype; gamma and beta are loaded once a thread and kept in
// registers. The grid is persistent (as many blocks as fit on the SMs at
// once) and walks the rows with a grid stride; each thread issues the loads
// of UNROLL row-steps before it reduces the first, to keep bytes in flight
// across HBM's latency. The loop runs on warp-uniform row bases, so every
// lane of a warp reaches every shuffle; rows past the end are masked. No
// mean or rstd is written: serving needs neither.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 2;  // row-steps whose loads a thread issues together

template <typename T> struct Pack;  // a 16-byte vector as float values

template <> struct Pack<__nv_bfloat16> {
    static constexpr int N = 8;
    __device__ __forceinline__ static void unpack(const uint4& r, float* f) {
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float2 v = __bfloat1622float2(h[i]);
            f[2 * i] = v.x;
            f[2 * i + 1] = v.y;
        }
    }
    __device__ __forceinline__ static uint4 pack(const float* f) {
        uint4 r;
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
        for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
        return r;
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
};

template <int LANES>
__device__ __forceinline__ float group_sum(float s) {
#pragma unroll
    for (int o = LANES / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    return s;
}

template <typename T, int LANES, int VPL>
__global__ void __launch_bounds__(THREADS)
layer_norm_rows(const T* __restrict__ x, const T* __restrict__ gamma,
                const T* __restrict__ beta, T* __restrict__ y, long long rows, int c,
                float eps)
{
    constexpr int E = Pack<T>::N;
    constexpr int ROWS_PER_WARP = 32 / LANES;
    constexpr int WARPS = THREADS / 32;
    const int lane = threadIdx.x % LANES;
    const int group = (threadIdx.x % 32) / LANES;
    const int nvec = c / E;
    const float inv_c = 1.0f / c;

    bool live[VPL];
    float g[VPL][E], b[VPL][E];
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
        const int j = v * LANES + lane;
        live[v] = j < nvec;
        uint4 rg = make_uint4(0, 0, 0, 0), rb = rg;
        if (live[v]) {
            rg = __ldg(reinterpret_cast<const uint4*>(gamma) + j);
            rb = __ldg(reinterpret_cast<const uint4*>(beta) + j);
        }
        Pack<T>::unpack(rg, g[v]);
        Pack<T>::unpack(rb, b[v]);
    }

    // the warp's first row at each step, the same for all its lanes
    const long long stride = (long long)gridDim.x * WARPS * ROWS_PER_WARP;
    long long base = ((long long)blockIdx.x * WARPS + threadIdx.x / 32) * ROWS_PER_WARP;
    for (; base < rows; base += UNROLL * stride) {
        uint4 raw[UNROLL][VPL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const long long r = base + u * stride + group;
            const uint4* src = reinterpret_cast<const uint4*>(x + r * c);
#pragma unroll
            for (int v = 0; v < VPL; ++v) {
                raw[u][v] = make_uint4(0, 0, 0, 0);
                if (r < rows && live[v]) raw[u][v] = __ldg(src + v * LANES + lane);
            }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const long long r = base + u * stride + group;
            float f[VPL][E];
            float s = 0.f;
#pragma unroll
            for (int v = 0; v < VPL; ++v) {
                Pack<T>::unpack(raw[u][v], f[v]);  // masked vectors are zeros
#pragma unroll
                for (int i = 0; i < E; ++i) s += f[v][i];
            }
            const float mean = group_sum<LANES>(s) * inv_c;
            float q = 0.f;
#pragma unroll
            for (int v = 0; v < VPL; ++v) {
                if (!live[v]) continue;
#pragma unroll
                for (int i = 0; i < E; ++i) {
                    const float d = f[v][i] - mean;
                    q += d * d;
                }
            }
            const float rstd = rsqrtf(group_sum<LANES>(q) * inv_c + eps);
            if (r >= rows) continue;
            uint4* dst = reinterpret_cast<uint4*>(y + r * c);
#pragma unroll
            for (int v = 0; v < VPL; ++v) {
                if (!live[v]) continue;
                float o[E];
#pragma unroll
                for (int i = 0; i < E; ++i) o[i] = (f[v][i] - mean) * rstd * g[v][i] + b[v][i];
                dst[v * LANES + lane] = Pack<T>::pack(o);  // one rounding
            }
        }
    }
}

template <typename T, int LANES, int VPL>
int run(const void* x, const void* gamma, const void* beta, void* y, long long rows, int c,
        float eps, int sm_count, cudaStream_t s)
{
    static int per_sm = 0;  // resident blocks an SM, read once per instantiation
    if (per_sm == 0) {
        const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, layer_norm_rows<T, LANES, VPL>, THREADS, 0);
        if (e != cudaSuccess) return (int)e;
        if (per_sm < 1) per_sm = 1;
    }
    const long long rows_per_block = (long long)THREADS / LANES * UNROLL;
    long long blocks = (rows + rows_per_block - 1) / rows_per_block;
    if (blocks > (long long)per_sm * sm_count) blocks = (long long)per_sm * sm_count;
    layer_norm_rows<T, LANES, VPL><<<(unsigned)blocks, THREADS, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(gamma), static_cast<const T*>(beta),
        static_cast<T*>(y), rows, c, eps);
    return (int)cudaGetLastError();
}

// the row layout for nvec 16-byte vectors a row: lanes a row (a power of
// two up to 32) and vectors a lane; a bf16 row of at most 512 values has
// 1-64 vectors, a float row of 8-512 values 2-128
template <typename T>
int dispatch(const void* x, const void* gamma, const void* beta, void* y, long long rows,
             int c, float eps, int sm_count, cudaStream_t s)
{
    const int nvec = c / Pack<T>::N;
    if constexpr (Pack<T>::N == 8) {
        if (nvec <= 1) return run<T, 1, 1>(x, gamma, beta, y, rows, c, eps, sm_count, s);
    }
    if (nvec <= 2) return run<T, 2, 1>(x, gamma, beta, y, rows, c, eps, sm_count, s);
    if (nvec <= 4) return run<T, 4, 1>(x, gamma, beta, y, rows, c, eps, sm_count, s);
    if (nvec <= 8) return run<T, 8, 1>(x, gamma, beta, y, rows, c, eps, sm_count, s);
    if (nvec <= 16) return run<T, 16, 1>(x, gamma, beta, y, rows, c, eps, sm_count, s);
    if (nvec <= 32) return run<T, 32, 1>(x, gamma, beta, y, rows, c, eps, sm_count, s);
    if constexpr (Pack<T>::N == 8) {
        return run<T, 32, 2>(x, gamma, beta, y, rows, c, eps, sm_count, s);
    } else {
        if (nvec <= 64) return run<T, 32, 2>(x, gamma, beta, y, rows, c, eps, sm_count, s);
        if (nvec <= 96) return run<T, 32, 3>(x, gamma, beta, y, rows, c, eps, sm_count, s);
        return run<T, 32, 4>(x, gamma, beta, y, rows, c, eps, sm_count, s);
    }
}

}  // namespace

// x, y: (rows, c) contiguous, 16-byte aligned, f32 (is_bf16 0) or bf16
// (is_bf16 1); gamma, beta: (c,) in the same dtype. c a multiple of 8 in
// [8, 512], rows >= 1. Returns cudaGetLastError() after the launch.
extern "C" int layer_norm_launch(const void* x, const void* gamma, const void* beta, void* y,
                                 int is_bf16, long long rows, int c, float eps, int sm_count,
                                 void* stream)
{
    if (rows < 1 || c < 8 || c > 512 || c % 8 != 0 || sm_count < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16)
        return dispatch<__nv_bfloat16>(x, gamma, beta, y, rows, c, eps, sm_count, s);
    return dispatch<float>(x, gamma, beta, y, rows, c, eps, sm_count, s);
}
