// Fused inverse real DFT + synthesis window + overlap-add (the iSTFT back
// end, before the squared-window envelope and the centre trim).
//
// Replaces: audiodenoiser_tpu/ops/pallas/istft_kernel.py::istft_pallas
// (_istft_kernel). The Pallas kernel multiplies 16-frame chunks by
// Hermitian-fold cos/sin bases at Precision.HIGHEST, sweeps the chunks as a
// sequential grid axis and carries the n_fft - hop overlap-add spill from
// one grid step to the next in VMEM scratch. CUDA blocks run in no order,
// so that carry cannot be copied.
//
// What bounds it on the H100: its bytes (83 MB at B=256, T=126, n_fft=512:
// ~0.025 ms at 3.35 TB/s). A direct inverse DFT does 4*n_fft*F*T*B flops
// (17 GFLOP, ~0.25 ms of fp32 FMA), ten times that bound; an FFT does about
// 0.4 GFLOP and stays under it. Everything is fp32 FMA (no TF32, no bf16),
// as accurate as the Pallas kernel's Precision.HIGHEST bases.
//
// Both entries own output segments the same way: a block owns one batch
// row and P = TT - H frames' worth of output samples (P * hop), where
// H = floor((n_fft - 1) / hop) earlier frames spill into the segment (3 at
// 512/128). The block computes TT frames, its own P and the H halo frames,
// so every output sample is written by exactly one block and summed over
// its frames in increasing t: no atomics, no carry, a deterministic sum.
//
// istft_fft (power-of-two n_fft). Per block, TT (a power of two <= 16,
// TT > H, chosen by the wrapper from the shape: 16 at the bench batch)
// frames:
//  - the twiddle table and the window go to shared memory by cp.async while
//    each thread loads the bins k and M - k (M = n_fft/2) of up to 4 items
//    (k, frame) at once, as float2 when re and im are the interleaved lanes
//    of one complex64 tensor, and packs the Hermitian spectrum into M
//    complex points, Z[k] = (X[k] + conj X[M-k]) + i e^{+2 pi i k/N} (X[k] -
//    conj X[M-k]), with the imaginary parts of DC and Nyquist dropped as
//    irfft drops them; it stores conj Z in the [point][frame] layout of
//    fft.cuh;
//  - the forward M-point FFT (fft.cuh's radix-16 Stockham stages) of all TT
//    frames gives conj(z) * n_fft, where x[2n] = Re z[n], x[2n+1] = Im z[n];
//    its last stage unpacks each point, windows the two samples and stores
//    them into a [frame][sample] buffer whose rows are padded by 32/TT
//    words, so the TT frames a half-warp stores land on distinct banks
//    (the [point][frame] layout would put them 2*TT words apart);
//  - each thread then sums the frames that cover one output sample of the
//    block's segment and stores it: consecutive threads, consecutive
//    samples, coalesced, and no integer division.
// Twiddles come from the host's table exp(-2 pi i k/N), computed in
// float64 once per (n_fft, device); e^{+2 pi i k/N} is its conjugate.
//
// istft_direct (any other n_fft, e.g. 400 or 255). The direct inverse DFT
// with TT = 16: the spectrum columns are staged in shared memory pre-scaled
// by the Hermitian fold weights (1 at DC and Nyquist, 2 elsewhere) over
// n_fft; each thread owns two time samples of every frame and accumulates
// the 16 frames in registers from an n_fft-entry (cos, sin) table indexed
// by (k*n) mod n_fft; the windowed frames go to shared memory and each
// thread sums the frames that cover its output samples.

#include <cuda_runtime.h>

#include "fft.cuh"

namespace {

constexpr int THREADS = 256;

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }

// floats in a row of the FFT entry's [frame][sample] buffer
__host__ __device__ inline int frame_row(int n_fft, int log_tt) { return n_fft + (32 >> log_tt); }

struct FftSmem {
    size_t tw, win, buf0, buf1, total;
};

// Two working buffers, each large enough for the [point][frame] spectrum
// (n_fft/2 * TT complex) and for the padded [frame][sample] frames.
__host__ __device__ inline FftSmem fft_smem(int n_fft, int log_tt)
{
    FftSmem s;
    const size_t buf = 4 * ((size_t)frame_row(n_fft, log_tt) << log_tt);
    s.tw = 0;
    s.win = align16(8 * (size_t)n_fft);
    s.buf0 = align16(s.win + 4 * (size_t)n_fft);
    s.buf1 = align16(s.buf0 + buf);
    s.total = align16(s.buf1 + buf);
    return s;
}

template <bool INTERLEAVED>
__device__ __forceinline__ float2 load_bin(const float* __restrict__ re,
                                           const float* __restrict__ im, long long off)
{
    if (INTERLEAVED) return *reinterpret_cast<const float2*>(re + off);
    return make_float2(re[off], im[off]);
}

// an asynchronous global -> shared copy of N = 4, 8 or 16 bytes
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src)
{
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src), "n"(N));
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

constexpr int PACK_UNROLL = 4;  // bin pairs a thread loads before it packs any

template <bool INTERLEAVED>
__global__ void __launch_bounds__(THREADS)
istft_fft_kernel(const float* __restrict__ re, const float* __restrict__ im,
                 const float* __restrict__ window, const float2* __restrict__ twiddle,
                 float* __restrict__ out, long long sb, long long sk, long long st,
                 int n_fft, int hop, int n_frames, int out_len, int log_tt, int halo)
{
    extern __shared__ float4 smem4[];
    unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
    const FftSmem lay = fft_smem(n_fft, log_tt);
    float2* tw = reinterpret_cast<float2*>(smem + lay.tw);
    float* win = reinterpret_cast<float*>(smem + lay.win);
    float2* buf0 = reinterpret_cast<float2*>(smem + lay.buf0);
    float2* buf1 = reinterpret_cast<float2*>(smem + lay.buf1);

    const int tt = 1 << log_tt;
    const int m = n_fft >> 1;
    const int b = blockIdx.y;
    const int seg_frames = tt - halo;
    const int s0 = blockIdx.x * seg_frames * hop;
    const int s1 = min(s0 + seg_frames * hop, out_len);
    const int t_lo = blockIdx.x * seg_frames - halo;  // may be < 0

    // the FFT stages' twiddles and the window, copied while the spectrum loads
    for (int i = threadIdx.x; i < (n_fft >> 1); i += THREADS) cp_async<16>(tw + 2 * i, twiddle + 2 * i);
    for (int i = threadIdx.x; i < n_fft; i += THREADS) cp_async<4>(win + i, window + i);

    // conj Z[k] of every frame, [k][TT]. Item (k, t), k < max(m/2, 1), takes
    // bins k and m - k of frame t and writes Z[k] and Z[m-k]; the item k = 0
    // also writes Z[m/2] = 2 conj X[m/2]. A thread issues the loads of up to
    // PACK_UNROLL items before it packs any of them.
    const float* rb = re + b * sb;
    const float* ib = im + b * sb;
    const int half = m >> 1;
    const int n_items = max(half, 1) << log_tt;
    for (int base = threadIdx.x; base < n_items; base += PACK_UNROLL * THREADS) {
        float2 a[PACK_UNROLL], c[PACK_UNROLL], w[PACK_UNROLL];  // X[k], X[m-k], e^{-2 pi i k/N}
#pragma unroll
        for (int u = 0; u < PACK_UNROLL; ++u) {
            const int i = base + u * THREADS;
            const int t = i & (tt - 1);
            const int k = i >> log_tt;
            const int frame = t_lo + t;
            a[u] = c[u] = make_float2(0.f, 0.f);
            w[u] = twiddle[k & (m - 1)];
            if (i < n_items && frame >= 0 && frame < n_frames) {
                const long long off = (long long)frame * st;
                a[u] = load_bin<INTERLEAVED>(rb, ib, k * sk + off);
                c[u] = load_bin<INTERLEAVED>(rb, ib, (m - k) * sk + off);
            }
        }
        // Z[m/2] = 2 conj X[m/2] of frame t, by the items k = 0
        float2 mid = make_float2(0.f, 0.f);
        const bool has_mid = base < tt && half > 0;
        if (has_mid && t_lo + base >= 0 && t_lo + base < n_frames)
            mid = load_bin<INTERLEAVED>(rb, ib, half * sk + (long long)(t_lo + base) * st);
#pragma unroll
        for (int u = 0; u < PACK_UNROLL; ++u) {
            const int i = base + u * THREADS;
            if (i >= n_items) break;
            const int t = i & (tt - 1);
            const int k = i >> log_tt;
            if (k == 0) {  // irfft ignores the imaginary parts of DC and Nyquist
                a[u].y = 0.f;
                c[u].y = 0.f;
            }
            // With s = a + conj c and d = a - conj c:
            //   Z[k]   = s + i conj(w) d
            //   Z[m-k] = (c + conj a) + i e^{+2 pi i (m-k)/N} (c - conj a) = conj s + i w conj d
            const float2 s = make_float2(a[u].x + c[u].x, a[u].y - c[u].y);
            const float2 d = make_float2(a[u].x - c[u].x, a[u].y + c[u].y);
            const float2 p = fft::cmul(make_float2(w[u].x, -w[u].y), d);
            buf0[i] = make_float2(s.x - p.y, -(s.y + p.x));  // conj Z[k]
            if (k != 0) {
                const float2 q = fft::cmul(w[u], make_float2(d.x, -d.y));
                buf0[((m - k) << log_tt) | t] = make_float2(s.x - q.y, s.y - q.x);  // conj Z[m-k]
            }
        }
        if (has_mid) buf0[(half << log_tt) | base] = make_float2(2.f * mid.x, 2.f * mid.y);
    }
    cp_async_wait_all();
    __syncthreads();

    // The forward FFT of conj Z is conj(z) * n_fft: its last stage unpacks
    // point n of frame t into samples 2n and 2n+1, windows them (1/n_fft is
    // an exact power of two) and stores them into the free buffer as
    // [frame][sample] rows padded by 32/TT words, so that the TT frames a
    // half-warp stores land on distinct banks.
    const int row = frame_row(n_fft, log_tt);
    const float2* win2 = reinterpret_cast<const float2*>(win);
    const float inv_n = 1.0f / (float)n_fft;
    const float* frm = reinterpret_cast<const float*>(
        fft::fft_frames_to(buf0, buf1, m, log_tt, tw, [&](float2* dst, int n, int t, float2 v) {
            const float2 g = win2[n];
            *reinterpret_cast<float2*>(reinterpret_cast<float*>(dst) + t * row + 2 * n) =
                make_float2(v.x * inv_n * g.x, -v.y * inv_n * g.y);
        }));

    // Sample s0 + i, i = c*hop + r, lies in frame t_lo + l at offset
    // (c + H - l)*hop + r for c + H - D(r) <= l <= c + H, with D(r) =
    // floor((n_fft - 1 - r) / hop) <= H (none when r >= n_fft); the frames
    // outside [0, n_frames) add nothing. The frames are summed in increasing
    // t. Both quotients come from a float product, floor((x + 0.5) *
    // RN(1/hop)), which is exact for x + 0.5 < 2^22 (the launcher holds hop
    // and n_fft below 2^18, and x < 16 * hop or x < n_fft): the true quotient
    // lies 0.5/hop or more from an integer, the two roundings move it less.
    const float inv_hop = 1.0f / (float)hop;
    const int l_first = max(0, -t_lo), l_last = min(tt, n_frames - t_lo) - 1;
    float* ob = out + (size_t)b * out_len + s0;
    for (int i = threadIdx.x; i < s1 - s0; i += THREADS) {
        const int c = (int)(((float)i + 0.5f) * inv_hop);
        const int r = i - c * hop;
        const int d = r < n_fft ? (int)(((float)(n_fft - 1 - r) + 0.5f) * inv_hop) : -1;
        const int hi = min(c + halo, l_last);
        float acc = 0.f;
        for (int l = max(c + halo - d, l_first); l <= hi; ++l)
            acc += frm[l * row + (c + halo - l) * hop + r];
        ob[i] = acc;
    }
}

constexpr int TF = 16;  // frames computed per block of the direct entry (segment + halo)

__global__ void __launch_bounds__(THREADS)
istft_direct_kernel(const float* __restrict__ re, const float* __restrict__ im,
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

// Lets every entry take up to the block's opt-in shared memory (the wrapper
// never asks for more), once per device rather than every launch.
cudaError_t opt_in_smem()
{
    static int ready_dev = -1;
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess || dev == ready_dev) return err;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(istft_fft_kernel<true>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(istft_fft_kernel<false>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(istft_direct_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err == cudaSuccess) ready_dev = dev;
    return err;
}

}  // namespace

extern "C" size_t istft_fft_smem_bytes(int n_fft, int log_tt)
{
    return fft_smem(n_fft, log_tt).total;
}

// re/im: (batch, n_fft/2+1, n_frames) f32 addressed through the shared
// element strides (sb, sk, st); interleaved != 0 says that im == re + 1,
// st == 2 and re is 8-byte aligned with even sb and sk (the lanes of one
// complex64 tensor), so a bin is one float2 load. window: (n_fft,) f32;
// twiddle: (n_fft,) complex64, exp(-2 pi i k / n_fft); out: (batch,
// (n_frames-1)*hop + n_fft) contiguous f32, the raw overlap-add signal.
// n_fft a power of two >= 2; 2**log_tt frames per block, more than
// floor((n_fft-1)/hop). Returns cudaGetLastError() after the launch.
extern "C" int istft_fft_launch(const void* re, const void* im, const void* window,
                                const void* twiddle, void* out, int batch, int n_frames,
                                int n_fft, int hop, int log_tt, int interleaved,
                                long long sb, long long sk, long long st, void* stream)
{
    const int halo = (n_fft - 1) / hop;
    if (n_fft < 2 || (n_fft & (n_fft - 1)) != 0 || n_fft >= (1 << 18) || hop >= (1 << 18) ||
        log_tt < 0 || log_tt > 4 || (1 << log_tt) <= halo)
        return (int)cudaErrorInvalidValue;
    const int out_len = (n_frames - 1) * hop + n_fft;
    const int seg = ((1 << log_tt) - halo) * hop;
    const size_t smem = istft_fft_smem_bytes(n_fft, log_tt);
    const cudaError_t err = opt_in_smem();
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((out_len + seg - 1) / seg, batch);
    auto kernel = interleaved ? istft_fft_kernel<true> : istft_fft_kernel<false>;
    kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(re), static_cast<const float*>(im),
        static_cast<const float*>(window), static_cast<const float2*>(twiddle),
        static_cast<float*>(out), sb, sk, st, n_fft, hop, n_frames, out_len, log_tt, halo);
    return (int)cudaGetLastError();
}

extern "C" size_t istft_direct_smem_bytes(int n_fft)
{
    const size_t n_freq = n_fft / 2 + 1;
    return (2 * n_freq * TF + (size_t)TF * n_fft + 2 * (size_t)n_fft) * sizeof(float);
}

// Frames computed per block of the direct entry, halo included; the
// wrapper checks that floor((n_fft - 1) / hop) < istft_direct_block_frames().
extern "C" int istft_direct_block_frames() { return TF; }

// The direct inverse DFT for any n_fft; arguments as istft_fft_launch's.
extern "C" int istft_direct_launch(const void* re, const void* im, const void* window, void* out,
                                   int batch, int n_frames, int n_fft, int hop,
                                   long long sb, long long sk, long long st, void* stream)
{
    const int n_freq = n_fft / 2 + 1;
    const int out_len = (n_frames - 1) * hop + n_fft;
    const int halo = (n_fft - 1) / hop;
    const int seg_frames = TF - halo;
    if (seg_frames < 1) return (int)cudaErrorInvalidValue;
    const int seg = seg_frames * hop;
    const size_t smem = istft_direct_smem_bytes(n_fft);
    const cudaError_t err = opt_in_smem();
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((out_len + seg - 1) / seg, batch);
    istft_direct_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(re), static_cast<const float*>(im),
        static_cast<const float*>(window), static_cast<float*>(out),
        sb, sk, st, n_fft, hop, n_freq, n_frames, out_len, seg_frames, halo);
    return (int)cudaGetLastError();
}
