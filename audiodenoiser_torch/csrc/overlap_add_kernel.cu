// Overlap-add of windowed frames: (B, T, n_fft) -> (B, (T-1)*hop + n_fft).
//
// Replaces: audiodenoiser_tpu/ops/pallas/overlap_add_kernel.py::overlap_add_pallas
// (_ola_kernel). The Pallas kernel holds an 8-row tile of the output in
// VMEM and adds the T frames into it one after another, a read-modify-write
// sweep that relies on its single core. On the GPU that sweep would need
// atomics or a carry between blocks.
//
// What bounds it on the H100: bytes. Every frame sample is read once and
// every output sample written once (4*B*T*n_fft + 4*B*L bytes: 83 MB,
// ~0.025 ms at 3.35 TB/s for B=256, T=126, n_fft=512); the work is one add
// per frame sample.
//
// Design: the gather form. Each thread owns one output sample n of one row
// b and sums the frames t in [max(0, ceil((n-n_fft+1)/hop)),
// min(T-1, floor(n/hop))] in increasing t, reading frames[b, t, n - t*hop].
// Every output is written by exactly one thread: no atomics, and the sum's
// order is fixed, so the result is deterministic. Consecutive n of a warp
// read consecutive addresses of each frame, so loads and stores coalesce.
// Any hop works, including one that does not divide n_fft and one of at
// least n_fft (its gaps are sums over no frame: zeros). Any batch: rows are
// the grid's y axis, with no padding to a tile. bf16 frames are loaded as
// bf16, summed in fp32 and rounded to bf16 once; B4 sums in the frames'
// dtype, so the two agree within a few bf16 roundings.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
overlap_add_kernel(const T* __restrict__ frames, T* __restrict__ out,
                   int n_frames, int n_fft, int hop, int out_len)
{
    const int n = blockIdx.x * THREADS + threadIdx.x;
    if (n >= out_len) return;
    const size_t b = blockIdx.y;
    const T* fb = frames + b * (size_t)n_frames * n_fft;
    // first frame whose span [t*hop, t*hop + n_fft) reaches n
    const int t_first = n >= n_fft ? (n - n_fft) / hop + 1 : 0;
    const int t_last = min(n / hop, n_frames - 1);
    float y = 0.f;
    for (int t = t_first; t <= t_last; ++t)
        y += load_f32(fb + (size_t)t * n_fft + (n - t * hop));
    store_as(out + b * out_len + n, y);  // one rounding
}

}  // namespace

// frames: (batch, n_frames, n_fft) contiguous, f32 (is_bf16 0) or bf16
// (is_bf16 1); out: (batch, (n_frames-1)*hop + n_fft) contiguous in the
// same dtype. Returns cudaGetLastError() after the launch.
extern "C" int overlap_add_launch(const void* frames, void* out, int is_bf16, int batch,
                                  int n_frames, int n_fft, int hop, void* stream)
{
    if (batch < 1 || n_frames < 1 || n_fft < 1 || hop < 1)
        return (int)cudaErrorInvalidValue;
    const long long out_len = (long long)(n_frames - 1) * hop + n_fft;
    if (out_len > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    const dim3 grid((unsigned)((out_len + THREADS - 1) / THREADS), batch);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16)
        overlap_add_kernel<<<grid, THREADS, 0, s>>>(
            static_cast<const __nv_bfloat16*>(frames), static_cast<__nv_bfloat16*>(out),
            n_frames, n_fft, hop, (int)out_len);
    else
        overlap_add_kernel<<<grid, THREADS, 0, s>>>(
            static_cast<const float*>(frames), static_cast<float*>(out),
            n_frames, n_fft, hop, (int)out_len);
    return (int)cudaGetLastError();
}
