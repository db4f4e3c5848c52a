// Shared-memory FFT building blocks for the STFT kernels (fp32, FMA only).
//
// A block transforms TT frames at once. Its working buffers hold M complex
// points of each frame in the layout [p][TT] (point p of frame t at
// p * TT + t), so that the TT threads that handle the same butterfly of TT
// frames touch consecutive words: every stage reads and writes shared
// memory without bank conflicts, whatever its stride. TT is a power of two
// given as log_tt.
//
// The transform is a Stockham autosort FFT (no bit reversal) of radix-16
// stages, after one radix-2, -4 or -8 stage for what the 16s leave: two
// passes over shared memory for M = 256. Each stage's R-point DFTs run in
// registers (16 = 4 x 4 and 8 = 4 x 2, with exact constant twiddles).
// Stage twiddles come from one table tw[k] = exp(-2*pi*i*k / N) of N = 2M
// entries, which the host computes in float64 and rounds once; W_M^e is
// tw[2e].

#pragma once

#include <cuda_runtime.h>

namespace fft {

__device__ __forceinline__ float2 cmul(float2 a, float2 b)
{
    return make_float2(fmaf(a.x, b.x, -a.y * b.y), fmaf(a.x, b.y, a.y * b.x));
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }

template <int R>
__device__ __forceinline__ void butterfly(float2* v);

template <>
__device__ __forceinline__ void butterfly<2>(float2* v)
{
    const float2 a = v[0], b = v[1];
    v[0] = cadd(a, b);
    v[1] = csub(a, b);
}

// forward 4-point DFT, natural order: X_k = sum_n a_n (-i)^{nk}
template <>
__device__ __forceinline__ void butterfly<4>(float2* v)
{
    const float2 s02 = cadd(v[0], v[2]), d02 = csub(v[0], v[2]);
    const float2 s13 = cadd(v[1], v[3]), d13 = csub(v[1], v[3]);
    const float2 md13 = make_float2(d13.y, -d13.x);  // -i * (a1 - a3)
    v[0] = cadd(s02, s13);
    v[1] = cadd(d02, md13);
    v[2] = csub(s02, s13);
    v[3] = csub(d02, md13);
}

// exp(-2 pi i j / 16) for the j a radix-8 or -16 DFT needs (j <= 9)
__device__ __forceinline__ float2 w16(int j)
{
    constexpr float c1 = 0.92387953251128674f, s1 = 0.38268343236508977f;
    constexpr float h = 0.70710678118654752f;
    switch (j) {
    case 0: return make_float2(1.f, 0.f);
    case 1: return make_float2(c1, -s1);
    case 2: return make_float2(h, -h);
    case 3: return make_float2(s1, -c1);
    case 4: return make_float2(0.f, -1.f);
    case 5: return make_float2(-s1, -c1);
    case 6: return make_float2(-h, -h);
    case 7: return make_float2(-c1, -s1);
    case 8: return make_float2(-1.f, 0.f);
    default: return make_float2(-c1, s1);  // 9
    }
}

// R = 4Q points, n = Q*n1 + n2, k = k1 + 4*k2: 4-point DFTs over n1, the
// twiddles W_R^{n2 k1}, then Q-point DFTs over n2; natural order out
template <int R>
__device__ __forceinline__ void butterfly_4q(float2* v)
{
    constexpr int Q = R / 4;
    float2 y[R];
#pragma unroll
    for (int n2 = 0; n2 < Q; ++n2) {
        float2 t[4] = {v[n2], v[Q + n2], v[2 * Q + n2], v[3 * Q + n2]};
        butterfly<4>(t);
#pragma unroll
        for (int k1 = 0; k1 < 4; ++k1)
            y[4 * n2 + k1] = (n2 == 0 || k1 == 0) ? t[k1] : cmul(t[k1], w16(n2 * k1 * (16 / R)));
    }
#pragma unroll
    for (int k1 = 0; k1 < 4; ++k1) {
        float2 u[Q];
#pragma unroll
        for (int n2 = 0; n2 < Q; ++n2) u[n2] = y[4 * n2 + k1];
        butterfly<Q>(u);
#pragma unroll
        for (int k2 = 0; k2 < Q; ++k2) v[k1 + 4 * k2] = u[k2];
    }
}

template <>
__device__ __forceinline__ void butterfly<8>(float2* v) { butterfly_4q<8>(v); }

template <>
__device__ __forceinline__ void butterfly<16>(float2* v) { butterfly_4q<16>(v); }

// One Stockham stage of radix R over TT frames of m points: sub-transforms
// of length ns are merged into ones of length ns * R. in and out are
// [m][TT] buffers; tw is the N = 2m table.
template <int R>
__device__ __forceinline__ void stockham_stage(const float2* __restrict__ in,
                                               float2* __restrict__ out, int m, int ns,
                                               int log_tt, const float2* __restrict__ tw)
{
    const int tt_mask = (1 << log_tt) - 1;
    const int span = (m / R) << log_tt;    // offset between the R inputs
    const int tw_step = 2 * (m / (R * ns));   // W_N exponent per unit of r * k
    for (int i = threadIdx.x; i < span; i += blockDim.x) {
        const int t = i & tt_mask;
        const int j = i >> log_tt;
        const int k = j & (ns - 1);           // position inside the sub-transform
        float2 v[R];
#pragma unroll
        for (int r = 0; r < R; ++r) v[r] = in[i + r * span];
#pragma unroll
        for (int r = 1; r < R; ++r) v[r] = cmul(v[r], tw[r * k * tw_step]);
        butterfly<R>(v);
        const int dst = (((j - k) * R + k) << log_tt) | t;
#pragma unroll
        for (int r = 0; r < R; ++r) out[dst + ((r * ns) << log_tt)] = v[r];
    }
}

// stockham_stage with each result, point p of frame t, handed to
// store(p, t, value) instead of stored in a buffer.
template <int R, class Store>
__device__ __forceinline__ void stockham_stage_to(const float2* __restrict__ in, int m, int ns,
                                                  int log_tt, const float2* __restrict__ tw,
                                                  Store store)
{
    const int tt_mask = (1 << log_tt) - 1;
    const int span = (m / R) << log_tt;
    const int tw_step = 2 * (m / (R * ns));
    for (int i = threadIdx.x; i < span; i += blockDim.x) {
        const int t = i & tt_mask;
        const int j = i >> log_tt;
        const int k = j & (ns - 1);
        float2 v[R];
#pragma unroll
        for (int r = 0; r < R; ++r) v[r] = in[i + r * span];
#pragma unroll
        for (int r = 1; r < R; ++r) v[r] = cmul(v[r], tw[r * k * tw_step]);
        butterfly<R>(v);
        const int dst = (j - k) * R + k;
#pragma unroll
        for (int r = 0; r < R; ++r) store(dst + r * ns, t, v[r]);
    }
}

// The M-point complex FFT of every frame in buf; returns the buffer that
// holds the result (buf or spare). Ends on a barrier.
__device__ __forceinline__ float2* fft_frames(float2* buf, float2* spare, int m, int log_tt,
                                              const float2* __restrict__ tw)
{
    int ns = 1;
    const int rest = (__ffs(m) - 1) % 4;  // log2(m) mod 4: the first stage's radix
    if (rest != 0) {
        if (rest == 1) stockham_stage<2>(buf, spare, m, ns, log_tt, tw);
        else if (rest == 2) stockham_stage<4>(buf, spare, m, ns, log_tt, tw);
        else stockham_stage<8>(buf, spare, m, ns, log_tt, tw);
        float2* tmp = buf; buf = spare; spare = tmp;
        ns = 1 << rest;
        __syncthreads();
    }
    for (; ns < m; ns *= 16) {
        stockham_stage<16>(buf, spare, m, ns, log_tt, tw);
        float2* tmp = buf; buf = spare; spare = tmp;
        __syncthreads();
    }
    return buf;
}

// A stage into spare, or, if it is the transform's last, through last.
template <int R, class Last>
__device__ __forceinline__ void stage_or_last(const float2* __restrict__ in, float2* spare, int m,
                                              int ns, int log_tt, const float2* __restrict__ tw,
                                              Last last)
{
    if (ns * R == m)
        stockham_stage_to<R>(in, m, ns, log_tt, tw,
                             [=](int p, int t, float2 v) { last(spare, p, t, v); });
    else
        stockham_stage<R>(in, spare, m, ns, log_tt, tw);
}

// fft_frames with the last stage's results handed to last(dst, p, t,
// value) instead of stored, so the caller's epilogue runs in that stage's
// registers; dst is the buffer (buf or spare) that the last stage does not
// read, which last may overwrite; returns dst. Ends on a barrier.
template <class Last>
__device__ __forceinline__ float2* fft_frames_to(float2* buf, float2* spare, int m, int log_tt,
                                              const float2* __restrict__ tw, Last last)
{
    if (m == 1) {  // no stage: the points are the transform
        for (int i = threadIdx.x; i < (1 << log_tt); i += blockDim.x) last(spare, 0, i, buf[i]);
        __syncthreads();
        return spare;
    }
    int ns = 1;
    const int rest = (__ffs(m) - 1) % 4;
    if (rest != 0) {
        if (rest == 1) stage_or_last<2>(buf, spare, m, ns, log_tt, tw, last);
        else if (rest == 2) stage_or_last<4>(buf, spare, m, ns, log_tt, tw, last);
        else stage_or_last<8>(buf, spare, m, ns, log_tt, tw, last);
        float2* tmp = buf; buf = spare; spare = tmp;
        ns = 1 << rest;
        __syncthreads();
    }
    for (; ns < m; ns *= 16) {
        stage_or_last<16>(buf, spare, m, ns, log_tt, tw, last);
        float2* tmp = buf; buf = spare; spare = tmp;
        __syncthreads();
    }
    return buf;  // the last stage's spare
}

// Bin k (0..m) of the N = 2m-point real DFT of frame t, from the m-point
// complex FFT Z of z[n] = x[2n] + i x[2n+1]:
//   X[k] = (Z[k] + conj Z[m-k]) / 2 - i W_N^k (Z[k] - conj Z[m-k]) / 2
__device__ __forceinline__ float2 untangle(const float2* __restrict__ z, int k, int t, int m,
                                           int log_tt, const float2* __restrict__ tw)
{
    const float2 a = z[((k & (m - 1)) << log_tt) | t];
    const float2 b = z[(((m - k) & (m - 1)) << log_tt) | t];
    const float2 e = make_float2(0.5f * (a.x + b.x), 0.5f * (a.y - b.y));
    const float2 o = make_float2(0.5f * (a.y + b.y), -0.5f * (a.x - b.x));
    return cadd(e, cmul(tw[k], o));
}

}  // namespace fft
