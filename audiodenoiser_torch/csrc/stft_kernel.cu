// Fused framing + analysis window + real DFT (the STFT front end).
//
// Replaces: audiodenoiser_tpu/ops/pallas/stft_kernel.py::stft_pallas
// (_stft_kernel), which frames a pre-padded (B, L) signal in 16-frame
// chunks in VMEM and multiplies by n_fft x F cos/sin bases on the MXU at
// Precision.HIGHEST (full fp32).
//
// What bounds it on the H100: the function itself is bound by its bytes
// (83 MB at B=256, T=126, n_fft=512: ~0.025 ms at 3.35 TB/s; an FFT's
// operations take a quarter of that). This kernel's algorithm, a direct
// DFT, does 4*n_fft*F*T*B flops (17 GFLOP), ~0.25 ms at the 67 TFLOP/s
// fp32 non-tensor rate, so the kernel is bound by fp32 FMA issue and by
// the shared-memory loads that feed it, ten times above the function's
// bound. Full fp32 FMA (no TF32, no bf16) keeps the Precision.HIGHEST
// accuracy.
//
// Design: one block owns one batch row and TT=16 consecutive frames. It
// stages the windowed frames once in shared memory, transposed to
// [n][TT] with a float4-aligned padded row, so the inner loop reads the 16
// frame values of one sample position with four broadcast float4 loads.
// A single n_fft-entry (cos, sin) table replaces the 1 MB DFT basis: the
// twiddle of (n, k) is entry (n*k) mod n_fft, walked incrementally. Each
// thread owns one frequency bin and accumulates its 16 frames in
// registers, so one twiddle load feeds 32 FMAs. Results go straight into
// the (B, F, T) layout through the caller's strides (no transpose pass;
// the wrapper points them at the real and imaginary lanes of one
// complex64 tensor).

#include <cuda_runtime.h>

namespace {

constexpr int TT = 16;        // frames per block
constexpr int ROW = TT + 4;   // padded row of the frame tile, in floats
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
stft_kernel(const float* __restrict__ x, const float* __restrict__ window,
            float* __restrict__ re, float* __restrict__ im,
            int length, int n_fft, int hop, int n_freq, int n_frames,
            long long sb, long long sk, long long st)
{
    extern __shared__ float4 smem4[];
    float* tile = reinterpret_cast<float*>(smem4);                    // [n_fft][ROW]
    float2* tw = reinterpret_cast<float2*>(tile + (size_t)n_fft * ROW);  // [n_fft]

    const int b = blockIdx.y;
    const int t0 = blockIdx.x * TT;
    const float* xb = x + (size_t)b * length;

    for (int m = threadIdx.x; m < n_fft; m += THREADS) {
        double s, c;
        sincospi(2.0 * m / n_fft, &s, &c);
        tw[m] = make_float2((float)c, (float)s);
    }
    // n runs fastest across threads: coalesced reads of the signal row
    for (int i = threadIdx.x; i < n_fft * TT; i += THREADS) {
        const int t = i / n_fft;
        const int n = i - t * n_fft;
        const int frame = t0 + t;
        float v = 0.f;
        if (frame < n_frames) v = xb[(size_t)frame * hop + n] * window[n];
        tile[n * ROW + t] = v;
    }
    __syncthreads();

    for (int k = threadIdx.x; k < n_freq; k += THREADS) {
        float acc_re[TT], acc_im[TT];
#pragma unroll
        for (int t = 0; t < TT; ++t) {
            acc_re[t] = 0.f;
            acc_im[t] = 0.f;
        }
        int idx = 0;  // (n * k) mod n_fft
        for (int n = 0; n < n_fft; ++n) {
            const float2 cs = tw[idx];
            const float4* row = reinterpret_cast<const float4*>(tile + n * ROW);
#pragma unroll
            for (int q = 0; q < TT / 4; ++q) {
                const float4 v = row[q];
                acc_re[4 * q + 0] = fmaf(v.x, cs.x, acc_re[4 * q + 0]);
                acc_re[4 * q + 1] = fmaf(v.y, cs.x, acc_re[4 * q + 1]);
                acc_re[4 * q + 2] = fmaf(v.z, cs.x, acc_re[4 * q + 2]);
                acc_re[4 * q + 3] = fmaf(v.w, cs.x, acc_re[4 * q + 3]);
                acc_im[4 * q + 0] = fmaf(v.x, cs.y, acc_im[4 * q + 0]);
                acc_im[4 * q + 1] = fmaf(v.y, cs.y, acc_im[4 * q + 1]);
                acc_im[4 * q + 2] = fmaf(v.z, cs.y, acc_im[4 * q + 2]);
                acc_im[4 * q + 3] = fmaf(v.w, cs.y, acc_im[4 * q + 3]);
            }
            idx += k;
            if (idx >= n_fft) idx -= n_fft;
        }
        float* rp = re + b * sb + k * sk;
        float* ip = im + b * sb + k * sk;
#pragma unroll
        for (int t = 0; t < TT; ++t) {
            if (t0 + t < n_frames) {
                rp[(long long)(t0 + t) * st] = acc_re[t];
                ip[(long long)(t0 + t) * st] = -acc_im[t];  // e^{-i theta}
            }
        }
    }
}

}  // namespace

extern "C" size_t stft_smem_bytes(int n_fft)
{
    return ((size_t)n_fft * ROW + 2 * (size_t)n_fft) * sizeof(float);
}

// x: (batch, length) contiguous f32, already centre-padded; window: (n_fft,)
// f32. re/im: output (batch, n_freq, n_frames) addressed through the
// element strides (sb, sk, st). Returns cudaGetLastError() after the launch.
extern "C" int stft_launch(const void* x, const void* window, void* re, void* im,
                           int batch, int length, int n_fft, int hop,
                           long long sb, long long sk, long long st, void* stream)
{
    const int n_freq = n_fft / 2 + 1;
    const int n_frames = 1 + (length - n_fft) / hop;
    const size_t smem = stft_smem_bytes(n_fft);
    cudaError_t err = cudaFuncSetAttribute(
        stft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((n_frames + TT - 1) / TT, batch);
    stft_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(window),
        static_cast<float*>(re), static_cast<float*>(im),
        length, n_fft, hop, n_freq, n_frames, sb, sk, st);
    return (int)cudaGetLastError();
}
