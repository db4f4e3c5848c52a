// Fused framing + analysis window + real DFT (the STFT front end).
//
// Replaces: audiodenoiser_tpu/ops/pallas/stft_kernel.py::stft_pallas
// (_stft_kernel), which frames a pre-padded (B, L) signal in 16-frame
// chunks in VMEM and multiplies by n_fft x F cos/sin bases on the MXU at
// Precision.HIGHEST (full fp32).
//
// What bounds it on the H100: its bytes (83 MB at B=256, T=126, n_fft=512:
// ~0.025 ms at 3.35 TB/s). A direct DFT does 4*n_fft*F*T*B flops (17 GFLOP,
// ~0.25 ms of fp32 FMA) and sits ten times above that bound; an FFT does
// about 0.4 GFLOP and stays under it. Everything is fp32 FMA (no TF32, no
// bf16), as accurate as the Precision.HIGHEST bases.
//
// Two entries, chosen by the wrapper from the shape:
//
// stft_fft (power-of-two n_fft). A block owns one batch row and TT
// consecutive frames (TT a power of two <= 8, chosen by the wrapper so that
// small batches still spread over the SMs). It loads the frames' contiguous
// segment, (TT-1)*hop + n_fft samples, once into shared memory with 16-byte
// loads (a padded layout keeps the frame-strided reads off one bank), packs
// each windowed frame as M = n_fft/2 complex points (even samples real, odd
// imaginary), runs the M-point complex FFT of all TT frames in shared memory
// (fft.cuh: Stockham radix-16 stages, [point][frame] layout), and untangles
// the n_fft/2 + 1 bins of the real transform. Each bin row k is written as TT
// consecutive complex64 values through the caller's strides. Twiddles come
// from one fp32 table the host computes in float64 once per (n_fft, device).
//
// stft_direct (any other n_fft, e.g. 400 or 255). The direct DFT: a block
// owns one row, TT=16 frames and a slice of the bins; it stages the windowed
// frames transposed to [n][TT] in shared memory and each thread accumulates
// one bin of all 16 frames in registers from an n_fft-entry twiddle table.
// The bins are split evenly over gridDim.z blocks of at most 256 threads,
// so no warp runs the n_fft-step loop twice for a tail bin.

#include <cstdint>
#include <cuda_runtime.h>

#include "fft.cuh"

namespace {

constexpr int THREADS = 256;

// segment sample s lives at pad(s): one spare word per 32 keeps the TT
// frame starts (multiples of hop) on different banks
__device__ __forceinline__ int pad(int s) { return s + (s >> 5); }

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

struct FftSmem {
    size_t tw, buf0, buf1, win, seg, total;
};

__host__ __device__ inline FftSmem fft_smem(int n_fft, int hop, int tt)
{
    FftSmem s;
    const size_t pts = (size_t)(n_fft / 2) * tt;
    const size_t seg_len = (size_t)(tt - 1) * hop + n_fft;
    s.tw = 0;
    s.buf0 = align16(s.tw + 8 * (size_t)n_fft);
    s.buf1 = align16(s.buf0 + 8 * pts);
    s.win = align16(s.buf1 + 8 * pts);
    s.seg = align16(s.win + 4 * (size_t)n_fft);
    s.total = align16(s.seg + 4 * (seg_len + (seg_len >> 5) + 1));
    return s;
}

__global__ void __launch_bounds__(THREADS)
stft_fft_kernel(const float* __restrict__ x, const float* __restrict__ window,
                const float2* __restrict__ twiddle, float2* __restrict__ out,
                int length, int n_fft, int hop, int n_frames, int log_tt,
                long long sb, long long sk, long long st)
{
    extern __shared__ float4 smem4[];
    unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
    const int tt = 1 << log_tt;
    const FftSmem lay = fft_smem(n_fft, hop, tt);
    float2* tw = reinterpret_cast<float2*>(smem + lay.tw);
    float2* buf0 = reinterpret_cast<float2*>(smem + lay.buf0);
    float2* buf1 = reinterpret_cast<float2*>(smem + lay.buf1);
    float* win = reinterpret_cast<float*>(smem + lay.win);
    float* seg = reinterpret_cast<float*>(smem + lay.seg);

    const int m = n_fft >> 1;
    const int b = blockIdx.y;
    const int t0 = blockIdx.x << log_tt;
    const int nt = min(tt, n_frames - t0);
    const int seg_len = (nt - 1) * hop + n_fft;
    const float* src = x + (size_t)b * length + (size_t)t0 * hop;

    for (int i = threadIdx.x; i < n_fft; i += THREADS) {
        tw[i] = twiddle[i];
        win[i] = window[i];
    }
    // the segment in 16-byte chunks of the aligned address space; the
    // partial chunks at either end element by element
    const int head = (int)((reinterpret_cast<uintptr_t>(src) & 15) >> 2);
    const float4* base = reinterpret_cast<const float4*>(src - head);
    const int n_chunks = (head + seg_len + 3) >> 2;
    for (int c = threadIdx.x; c < n_chunks; c += THREADS) {
        const int s0 = 4 * c - head;
        if (s0 >= 0 && s0 + 4 <= seg_len) {
            const float4 v = base[c];
            seg[pad(s0)] = v.x;
            seg[pad(s0 + 1)] = v.y;
            seg[pad(s0 + 2)] = v.z;
            seg[pad(s0 + 3)] = v.w;
        } else {
            for (int e = 0; e < 4; ++e) {
                const int s = s0 + e;
                if (s >= 0 && s < seg_len) seg[pad(s)] = src[s];
            }
        }
    }
    __syncthreads();

    // z[n] = x[2n] w[2n] + i x[2n+1] w[2n+1] of every frame, [n][TT]
    for (int i = threadIdx.x; i < (m << log_tt); i += THREADS) {
        const int t = i & (tt - 1);
        const int n = i >> log_tt;
        float2 z = make_float2(0.f, 0.f);
        if (t < nt) {
            const int s = t * hop + 2 * n;
            z = make_float2(seg[pad(s)] * win[2 * n], seg[pad(s + 1)] * win[2 * n + 1]);
        }
        buf0[i] = z;
    }
    __syncthreads();

    const float2* spec = fft::fft_frames(buf0, buf1, m, log_tt, tw);

    // bins k = 0..m, frames fastest: row k of the output gets nt
    // consecutive complex values
    float2* ob = out + (long long)b * sb + (long long)t0 * st;
    for (int i = threadIdx.x; i < ((m + 1) << log_tt); i += THREADS) {
        const int t = i & (tt - 1);
        const int k = i >> log_tt;
        if (t < nt) ob[k * sk + t * st] = fft::untangle(spec, k, t, m, log_tt, tw);
    }
}

constexpr int TT = 16;        // frames per block of the direct DFT
constexpr int ROW = TT + 4;   // padded row of its frame tile, in floats

__global__ void __launch_bounds__(THREADS)
stft_direct_kernel(const float* __restrict__ x, const float* __restrict__ window,
                   float* __restrict__ re, float* __restrict__ im,
                   int length, int n_fft, int hop, int n_freq, int n_frames, int bins_per_block,
                   long long sb, long long sk, long long st)
{
    extern __shared__ float4 smem4[];
    float* tile = reinterpret_cast<float*>(smem4);                       // [n_fft][ROW]
    float2* tw = reinterpret_cast<float2*>(tile + (size_t)n_fft * ROW);  // [n_fft]

    const int b = blockIdx.y;
    const int t0 = blockIdx.x * TT;
    const float* xb = x + (size_t)b * length;

    for (int m = threadIdx.x; m < n_fft; m += blockDim.x) {
        double s, c;
        sincospi(2.0 * m / n_fft, &s, &c);
        tw[m] = make_float2((float)c, (float)s);
    }
    // n runs fastest across threads: coalesced reads of the signal row
    for (int i = threadIdx.x; i < n_fft * TT; i += blockDim.x) {
        const int t = i / n_fft;
        const int n = i - t * n_fft;
        const int frame = t0 + t;
        float v = 0.f;
        if (frame < n_frames) v = xb[(size_t)frame * hop + n] * window[n];
        tile[n * ROW + t] = v;
    }
    __syncthreads();

    // one bin per thread: the bins are spread evenly over gridDim.z
    const int k = blockIdx.z * bins_per_block + threadIdx.x;
    if (threadIdx.x >= bins_per_block || k >= n_freq) return;
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

// Lets both entries take up to the block's opt-in shared memory (the
// wrapper never asks for more), once per device rather than every launch.
cudaError_t opt_in_smem()
{
    static int ready_dev = -1;
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess || dev == ready_dev) return err;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(stft_fft_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(stft_direct_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err == cudaSuccess) ready_dev = dev;
    return err;
}

}  // namespace

extern "C" size_t stft_fft_smem_bytes(int n_fft, int hop, int tt)
{
    return fft_smem(n_fft, hop, tt).total;
}

// x: (batch, length) contiguous f32, already centre-padded; window: (n_fft,)
// f32; twiddle: (n_fft,) complex64, exp(-2 pi i k / n_fft); out: complex64
// (batch, n_fft/2 + 1, n_frames) addressed through the complex strides (sb,
// sk, st). n_fft a power of two >= 2; 2**log_tt frames per block. Returns
// cudaGetLastError() after the launch.
extern "C" int stft_fft_launch(const void* x, const void* window, const void* twiddle, void* out,
                               int batch, int length, int n_fft, int hop, int log_tt,
                               long long sb, long long sk, long long st, void* stream)
{
    if (n_fft < 2 || (n_fft & (n_fft - 1)) != 0 || log_tt < 0 || log_tt > 4)
        return (int)cudaErrorInvalidValue;
    const int n_frames = 1 + (length - n_fft) / hop;
    const size_t smem = stft_fft_smem_bytes(n_fft, hop, 1 << log_tt);
    const cudaError_t err = opt_in_smem();
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((n_frames + (1 << log_tt) - 1) >> log_tt, batch);
    stft_fft_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(window),
        static_cast<const float2*>(twiddle), static_cast<float2*>(out),
        length, n_fft, hop, n_frames, log_tt, sb, sk, st);
    return (int)cudaGetLastError();
}

extern "C" size_t stft_direct_smem_bytes(int n_fft)
{
    return ((size_t)n_fft * ROW + 2 * (size_t)n_fft) * sizeof(float);
}

// The direct DFT for any n_fft. re/im: output (batch, n_freq, n_frames)
// addressed through the element strides (sb, sk, st). Returns
// cudaGetLastError() after the launch.
extern "C" int stft_direct_launch(const void* x, const void* window, void* re, void* im,
                                  int batch, int length, int n_fft, int hop,
                                  long long sb, long long sk, long long st, void* stream)
{
    const int n_freq = n_fft / 2 + 1;
    const int n_frames = 1 + (length - n_fft) / hop;
    const size_t smem = stft_direct_smem_bytes(n_fft);
    const cudaError_t err = opt_in_smem();
    if (err != cudaSuccess) return (int)err;
    const int nz = (n_freq + THREADS - 1) / THREADS;
    const int per = (n_freq + nz - 1) / nz;
    const int threads = (per + 31) / 32 * 32;
    const dim3 grid((n_frames + TT - 1) / TT, batch, nz);
    stft_direct_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(window),
        static_cast<float*>(re), static_cast<float*>(im),
        length, n_fft, hop, n_freq, n_frames, per, sb, sk, st);
    return (int)cudaGetLastError();
}
