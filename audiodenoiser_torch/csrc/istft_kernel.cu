// Fused inverse real DFT + synthesis window + overlap-add (the iSTFT back
// end, before the squared-window envelope and the centre trim).
//
// Replaces: audiodenoiser_tpu/ops/pallas/istft_kernel.py::istft_pallas
// (_istft_kernel). The Pallas kernel sweeps 16-frame chunks as a
// sequential grid axis and carries the n_fft - hop overlap-add spill from
// one grid step to the next in VMEM scratch. CUDA blocks run in no order,
// so that carry cannot be copied.
//
// What bounds it on the H100: the function is bound by its 83 MB of bytes
// (~0.025 ms at 3.35 TB/s, B=256, T=126, n_fft=512). Its algorithm here,
// a direct inverse DFT like the forward one, does 4*n_fft*F*T*B flops
// (17 GFLOP), ~0.25 ms at the 67 TFLOP/s fp32 non-tensor rate: the kernel
// is bound by fp32 FMA issue and the shared-memory loads that feed it.
// Full fp32 FMA keeps the accuracy of the Pallas kernel's
// Precision.HIGHEST matmuls.
//
// Design: each block owns one batch row and a segment of P = TF - H output
// samples-hops, where H = floor((n_fft - 1) / hop) is the number of earlier
// frames that spill into a segment (3 at 512/128) and TF = 16 frames are
// computed per block. The block recomputes those H halo frames itself, so
// every output sample is written by exactly one block: no atomics, no
// carry, a deterministic sum. The spectrum columns of the TF frames are
// staged once in shared memory, pre-scaled by the Hermitian fold weights
// (1 at DC and Nyquist, 2 elsewhere) over n_fft. Each thread owns two time
// samples n of every frame and accumulates the TF frames in registers from
// an n_fft-entry (cos, sin) table indexed by (k*n) mod n_fft, so one
// broadcast float4 load of the spectrum feeds eight FMAs. The windowed
// frames go to shared memory and each thread then sums the frames that
// cover its output samples, writing them coalesced.

#include <cuda_runtime.h>

namespace {

constexpr int TF = 16;  // frames computed per block (segment + halo)
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
istft_kernel(const float* __restrict__ re, const float* __restrict__ im,
             const float* __restrict__ window, float* __restrict__ out,
             long long sb, long long sk, long long st,
             int n_fft, int hop, int n_freq, int n_frames, int out_len,
             int seg_frames, int halo)
{
    extern __shared__ float4 smem4[];
    float* sp_re = reinterpret_cast<float*>(smem4);            // [n_freq][TF]
    float* sp_im = sp_re + (size_t)n_freq * TF;                // [n_freq][TF]
    float* frames = sp_im + (size_t)n_freq * TF;               // [TF][n_fft]
    float2* tw = reinterpret_cast<float2*>(frames + (size_t)TF * n_fft);

    const int b = blockIdx.y;
    const int s0 = blockIdx.x * seg_frames * hop;
    const int s1 = min(s0 + seg_frames * hop, out_len);
    const int t_lo = blockIdx.x * seg_frames - halo;  // may be < 0
    const float inv_n = 1.0f / (float)n_fft;

    for (int m = threadIdx.x; m < n_fft; m += THREADS) {
        double s, c;
        sincospi(2.0 * m / n_fft, &s, &c);
        tw[m] = make_float2((float)c, (float)s);
    }
    for (int i = threadIdx.x; i < n_freq * TF; i += THREADS) {
        const int k = i / TF;
        const int t = t_lo + (i - k * TF);
        float r = 0.f, q = 0.f;
        if (t >= 0 && t < n_frames) {
            const bool edge = (k == 0) || ((n_fft & 1) == 0 && k == n_fft / 2);
            const float scale = (edge ? 1.0f : 2.0f) * inv_n;
            const long long off = b * sb + k * sk + (long long)t * st;
            r = re[off] * scale;
            q = im[off] * scale;
        }
        sp_re[i] = r;
        sp_im[i] = q;
    }
    __syncthreads();

    for (int n0 = threadIdx.x; n0 < n_fft; n0 += 2 * THREADS) {
        const int n1 = n0 + THREADS;
        const int step1 = n1 < n_fft ? n1 : 0;
        float a0[TF], a1[TF];
#pragma unroll
        for (int t = 0; t < TF; ++t) {
            a0[t] = 0.f;
            a1[t] = 0.f;
        }
        int idx0 = 0, idx1 = 0;  // (k * n) mod n_fft
        for (int k = 0; k < n_freq; ++k) {
            const float2 w0 = tw[idx0];
            const float2 w1 = tw[idx1];
            const float4* r4 = reinterpret_cast<const float4*>(sp_re + k * TF);
            const float4* i4 = reinterpret_cast<const float4*>(sp_im + k * TF);
#pragma unroll
            for (int q = 0; q < TF / 4; ++q) {
                const float4 r = r4[q];
                const float4 v = i4[q];
                // frame[n] += Re*cos(2 pi k n / N) - Im*sin(2 pi k n / N)
                a0[4 * q + 0] = fmaf(-v.x, w0.y, fmaf(r.x, w0.x, a0[4 * q + 0]));
                a0[4 * q + 1] = fmaf(-v.y, w0.y, fmaf(r.y, w0.x, a0[4 * q + 1]));
                a0[4 * q + 2] = fmaf(-v.z, w0.y, fmaf(r.z, w0.x, a0[4 * q + 2]));
                a0[4 * q + 3] = fmaf(-v.w, w0.y, fmaf(r.w, w0.x, a0[4 * q + 3]));
                a1[4 * q + 0] = fmaf(-v.x, w1.y, fmaf(r.x, w1.x, a1[4 * q + 0]));
                a1[4 * q + 1] = fmaf(-v.y, w1.y, fmaf(r.y, w1.x, a1[4 * q + 1]));
                a1[4 * q + 2] = fmaf(-v.z, w1.y, fmaf(r.z, w1.x, a1[4 * q + 2]));
                a1[4 * q + 3] = fmaf(-v.w, w1.y, fmaf(r.w, w1.x, a1[4 * q + 3]));
            }
            idx0 += n0;
            if (idx0 >= n_fft) idx0 -= n_fft;
            idx1 += step1;
            if (idx1 >= n_fft) idx1 -= n_fft;
        }
        const float g0 = window[n0];
#pragma unroll
        for (int t = 0; t < TF; ++t) frames[t * n_fft + n0] = a0[t] * g0;
        if (n1 < n_fft) {
            const float g1 = window[n1];
#pragma unroll
            for (int t = 0; t < TF; ++t) frames[t * n_fft + n1] = a1[t] * g1;
        }
    }
    __syncthreads();

    float* ob = out + (size_t)b * out_len;
    for (int s = s0 + threadIdx.x; s < s1; s += THREADS) {
        // frames t with t*hop <= s < t*hop + n_fft, inside [t_lo, t_lo + TF)
        int t_first = s - n_fft + 1 > 0 ? (s - n_fft + hop) / hop : 0;
        t_first = max(t_first, max(t_lo, 0));
        const int t_last = min(s / hop, min(t_lo + TF - 1, n_frames - 1));
        float y = 0.f;
        for (int t = t_first; t <= t_last; ++t)
            y += frames[(t - t_lo) * n_fft + (s - t * hop)];
        ob[s] = y;
    }
}

}  // namespace

extern "C" size_t istft_smem_bytes(int n_fft)
{
    const size_t n_freq = n_fft / 2 + 1;
    return (2 * n_freq * TF + (size_t)TF * n_fft + 2 * (size_t)n_fft) * sizeof(float);
}

// Frames computed per block, halo included; the wrapper checks that
// floor((n_fft - 1) / hop) < istft_block_frames().
extern "C" int istft_block_frames() { return TF; }

// re/im: (batch, n_fft/2+1, n_frames) f32 addressed through the shared
// element strides (sb, sk, st); window: (n_fft,) f32; out: (batch,
// (n_frames-1)*hop + n_fft) contiguous f32, the raw overlap-add signal.
// Returns cudaGetLastError() after the launch.
extern "C" int istft_launch(const void* re, const void* im, const void* window, void* out,
                            int batch, int n_frames, int n_fft, int hop,
                            long long sb, long long sk, long long st, void* stream)
{
    const int n_freq = n_fft / 2 + 1;
    const int out_len = (n_frames - 1) * hop + n_fft;
    const int halo = (n_fft - 1) / hop;
    const int seg_frames = TF - halo;
    if (seg_frames < 1) return (int)cudaErrorInvalidValue;
    const int seg = seg_frames * hop;
    const size_t smem = istft_smem_bytes(n_fft);
    cudaError_t err = cudaFuncSetAttribute(
        istft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((out_len + seg - 1) / seg, batch);
    istft_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(re), static_cast<const float*>(im),
        static_cast<const float*>(window), static_cast<float*>(out),
        sb, sk, st, n_fft, hop, n_freq, n_frames, out_len, seg_frames, halo);
    return (int)cudaGetLastError();
}
