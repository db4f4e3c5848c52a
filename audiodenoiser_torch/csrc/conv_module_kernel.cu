// The middle of a conformer's conv module, channel-last, in one pass:
//
//   g[n, l, c]   = h[n, l, c] * sigmoid(h[n, l, C + c])                 (GLU over the last axis)
//   d[n, l, c]   = dw_bias[c] + sum_k dw_weight[c, k] * g[n, l + k - 15, c]   (depthwise, k = 31;
//                                                              g = 0 outside [0, L))
//   out[n, l, c] = silu((d - mean[c]) * bn_weight[c] / sqrt(var[c] + eps) + bn_bias[c])
//
// from h, (N, L, 2C), to out, (N, L, C), both contiguous.
//
// Replaces: no TPU kernel. MP-SENet exists only in the port; each of its 8
// conformer conv modules went from the first pointwise GEMM's output through
// F.glu, a transposed copy, PyTorch's generic depthwise conv
// (`conv_depthwise2d_forward`: 99.5 ms of a 645 ms batch of 32 clips of 10 s
// on an H100 80GB HBM3 at 700 W, about 6% of its HBM bandwidth), BatchNorm,
// SiLU and a second transposed copy: six passes over (N, L, C)-sized tensors
// where one does.
//
// What bounds it on the H100: bytes, and nearly as much the SMs' issue. One
// launch at the time conformer's shape reads h once and writes out once:
// 5,123,200 x (256 + 128) bf16, 3.93 GB, 1.17 ms at 3.35 TB/s. Its float32
// work per output, 31 FMAs, and two exp2 and two reciprocals on the SFUs
// (one sigmoid in the SiLU, about one in the GLU), takes some 0.7 ms of the
// FMA pipes and as much of the SFUs at full rate, and about 50 instructions
// an output in all; the kernel is as much a matter of issuing those as of
// moving the bytes.
//
// Design:
// - Padded stream. Position l of sequence n is row n * P + l of a stream in
//   which every sequence is followed by 15 zero rows (P = L + 15), so the
//   taps of every output read zeros past its own sequence's edges and never
//   a neighbour's row, with no test a tap. A tile is TILE = 288 consecutive
//   stream positions, the outputs of its zero rows discarded; it needs g on
//   its rows and 15 rows each side. Divisions by P are a multiply-high by a
//   magic number worked out at launch.
// - A CTA takes 32 channels (one a lane) of a tile and walks the tiles with
//   a stride; the grid is persistent, one CTA an SM, so the BatchNorm fold
//   and the 31 taps are worked out once a CTA, in float32, into registers.
// - Warp-specialised: 12 producer warps copy rows in (16-byte cp.async of
//   the 32 values and of their 32 gates, 64 contiguous bytes each in bf16,
//   into a ring of raw tiles) and run the GLU once a row element, float32,
//   into a float32 tile of g in shared memory; 16 consumer warps run the
//   window. g is double-buffered, handed over by named barriers (FULL when
//   the producers have written it, EMPTY when the consumers have read it),
//   so the GLU of the next tile overlaps the FMAs of this one. Rows that no
//   kept output reads (zero rows, rows of other sequences, past the end) are
//   not copied, and no GLU runs on them: their g is written as 0.
// - Lane c of consumer warp w computes outputs 18 w .. 18 w + 17 of channel
//   c. It reads the 48 rows of g they need once each, and each row adds its
//   product into every output whose window holds it, so the window slides
//   through 18 float32 accumulators in registers: 48 shared reads for 558
//   FMAs. A warp reads one 128-byte row of g a step, one bank a lane.
// - SiLU on the accumulators, then each lane stores its channel: a warp
//   writes the 32 channels of a row, 64 contiguous bytes in bf16.
// All arithmetic is float32 (the exp2 and reciprocal of the sigmoids are the
// SFU's, within 2 and 1 ulps); the one rounding to the input's dtype is at
// the store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TAPS = 31;
constexpr int HALO = (TAPS - 1) / 2;       // 15
constexpr int LANES = 32;                  // channels a CTA takes
constexpr int RUN = 18;                    // outputs a consumer thread computes
constexpr int CWARPS = 16;                 // consumer warps: the runs of a tile
constexpr int PWARPS = 12;                 // producer warps: the copies and the GLU
constexpr int CTHREADS = LANES * CWARPS;   // 512
constexpr int PTHREADS = 32 * PWARPS;      // 384
constexpr int THREADS = CTHREADS + PTHREADS;
constexpr int TILE = RUN * CWARPS;         // 288 stream positions a tile
constexpr int ROWS = TILE + 2 * HALO;      // 318 rows of g a tile reads

template <typename T> struct Pack;  // a 16-byte vector as float values, and one value back

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
    __device__ __forceinline__ static float scalar(float v) { return v; }
    __device__ __forceinline__ static float from_float(float v) { return v; }
};

// 1 / (1 + e^-x) from the SFU's exp2 and reciprocal (2 and 1 float32 ulps;
// subnormals flushed): 0 where e^-x overflows, 1 where it underflows
__device__ __forceinline__ float sigmoid(float x) {
    float e, r;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(x * -1.4426950408889634f));
    asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.0f + e));
    return r;
}

template <typename T>
struct Smem {
    static constexpr int VECS = LANES / Pack<T>::N;  // 16-byte vectors of a row's 32 values
    static constexpr int RAW = sizeof(T) == 2 ? 2 : 1;  // tiles whose copies are in flight
    uint4 val[RAW][ROWS][VECS];  // the tiles' values and gates, as copied
    uint4 gate[RAW][ROWS][VECS];
    float g[2][ROWS][LANES];     // two tiles' GLU output
    unsigned char live[RAW][ROWS];
};

struct Shape {
    const void* h;
    const void* dw_weight;
    const void* dw_bias;
    const void* bn_weight;
    const void* bn_bias;
    const void* bn_mean;
    const void* bn_var;
    void* out;
    int n, len, c;
    int period;  // P = L + 15: a sequence and its trailing zero rows in the stream
    unsigned magic;  // q / P = umulhi(q, magic) >> shift for 0 <= q < 2**31
    int shift;
    int tiles;
    float eps;
    __device__ __forceinline__ int seq(int q) const {
        return __umulhi((unsigned)q, magic) >> shift;
    }
};

__device__ __forceinline__ void copy16(void* smem, const void* gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// until at most the last N groups are still in flight
template <int N>
__device__ __forceinline__ void copy_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// Named barriers between the two roles (0 is __syncthreads'): consumers wait
// on FULL(b) for g[b], producers on EMPTY(b) to refill it; PRODUCERS joins
// the producer warps alone.
constexpr int PRODUCERS = 1;
__device__ __forceinline__ int full(int b) { return 2 + b; }
__device__ __forceinline__ int empty(int b) { return 4 + b; }
__device__ __forceinline__ void bar_sync(int id, int n) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int n) {
    asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// A stream position as its sequence s and its row r in that sequence's
// period (r >= L: a zero row); the 15 positions before the stream are
// sequence -1's zero rows.
struct Cursor {
    int s, r;
    __device__ __forceinline__ Cursor(const Shape& a, int q) {
        s = q < 0 ? -1 : a.seq(q);
        r = q - s * a.period;
    }
};

// The tile's stream positions [p0, pend), and the sequence of both ends
struct Tile {
    int p0, pend;
    Cursor first;
    int s_last;
    __device__ __forceinline__ Tile(const Shape& a, int t)
        : p0(t * TILE), pend(min(p0 + TILE, a.n * a.period)), first(a, p0),
          s_last(a.seq(pend - 1)) {}
};

// A producer thread (ptid) issues its copies of tile t into buffer b: row
// q = p0 - 15 + row of the stream is copied when it is a data row that some
// kept output of the tile reads (the same sequence, within 15 rows); its
// flag says so.
template <typename T>
__device__ __forceinline__ void load_tile(const Shape& a, Smem<T>& sm, int b, int t, int group,
                                          int ptid) {
    constexpr int VECS = Smem<T>::VECS;
    constexpr int STEP = PTHREADS / (2 * VECS);  // rows between a thread's copies
    const int v = ptid % (2 * VECS);             // this thread's vector: values, then gates
    const int row0 = ptid / (2 * VECS);
    const int chan = group * LANES + (v % VECS) * Pack<T>::N;
    if (t < a.tiles) {
        const Tile tile(a, t);
        // the live rows: the tile's own data rows, and the halo rows of the
        // sequences of its first and last positions
        const int lo = tile.first.r < a.len ? max(tile.p0 - HALO, tile.first.s * a.period)
                                            : tile.p0;
        const int hi = min(tile.pend + HALO, tile.s_last * a.period + a.len);
        const T* src = static_cast<const T*>(a.h) + chan + (v < VECS ? 0 : a.c);
        uint4* dst = v < VECS ? &sm.val[b][0][v] : &sm.gate[b][0][v - VECS];
#pragma unroll
        for (int k = 0; k < (ROWS + STEP - 1) / STEP; ++k) {
            const int row = row0 + k * STEP;
            if (row >= ROWS) break;
            const int q = tile.p0 - HALO + row;
            const Cursor at(a, q);
            const bool live = q >= lo && q < hi && at.r < a.len;
            if (live && chan < a.c)
                copy16(dst + row * VECS, src + ((long long)at.s * a.len + at.r) * (2 * a.c));
            if (v == 0) sm.live[b][row] = live;
        }
    }
    copy_commit();  // an empty group past the last tile keeps the count of groups
}

template <typename T>
__device__ __forceinline__ void produce(const Shape& a, Smem<T>& sm, int t0, int count,
                                        int stride, int group) {
    constexpr int E = Pack<T>::N;
    constexpr int VECS = Smem<T>::VECS;
    constexpr int RAW = Smem<T>::RAW;
    const int ptid = threadIdx.x - CTHREADS;
#pragma unroll
    for (int r = 0; r < RAW; ++r) load_tile(a, sm, r, t0 + r * stride, group, ptid);
    for (int k = 0; k < count; ++k) {
        const int b = k & 1, r = k % RAW;
        copy_wait<RAW - 1>();
        bar_sync(PRODUCERS, PTHREADS);                // tile k's rows are in, all of them
        if (k >= 2) bar_sync(empty(b), THREADS);      // the consumers are done with g[b]
        // GLU of each live row into g[b], float32; 0 on every other row
#pragma unroll
        for (int n = 0; n < (ROWS * VECS + PTHREADS - 1) / PTHREADS; ++n) {
            const int i = ptid + n * PTHREADS;
            if (i >= ROWS * VECS) break;
            const int row = i / VECS, j = i % VECS;
            float o[E];
            if (sm.live[r][row] && group * LANES + j * E < a.c) {
                float x[E], y[E];
                Pack<T>::unpack(sm.val[r][row][j], x);
                Pack<T>::unpack(sm.gate[r][row][j], y);
#pragma unroll
                for (int e = 0; e < E; ++e) o[e] = x[e] * sigmoid(y[e]);
            } else {
#pragma unroll
                for (int e = 0; e < E; ++e) o[e] = 0.f;
            }
            float4* dst = reinterpret_cast<float4*>(&sm.g[b][row][j * E]);
#pragma unroll
            for (int e = 0; e < E; e += 4)
                dst[e / 4] = make_float4(o[e], o[e + 1], o[e + 2], o[e + 3]);
        }
        bar_sync(PRODUCERS, PTHREADS);                // every producer is done with buffer r
        load_tile(a, sm, r, t0 + (k + RAW) * stride, group, ptid);
        bar_arrive(full(b), THREADS);                 // g[b] is whole
    }
}

template <typename T>
__device__ __forceinline__ void consume(const Shape& a, Smem<T>& sm, int t0, int count,
                                        int stride, int group, const float* w, float bias) {
    const int lane = threadIdx.x % LANES;
    const int first = threadIdx.x / LANES * RUN;  // the warp's run of the tile
    const int chan = group * LANES + lane;
    T* out = static_cast<T*>(a.out) + chan;
    for (int k = 0; k < count; ++k) {
        const int b = k & 1;
        const Tile tile(a, t0 + k * stride);
        const int last = min(RUN, tile.pend - tile.p0 - first);  // kept positions of the run
        bar_sync(full(b), THREADS);
        // the sliding window: row j of the run's 48 adds into outputs j - 30 .. j
        float acc[RUN];
#pragma unroll
        for (int i = 0; i < RUN; ++i) acc[i] = bias;
        if (last > 0) {  // warp-uniform
#pragma unroll
            for (int j = 0; j < RUN + TAPS - 1; ++j) {
                const float v = sm.g[b][first + j][lane];
#pragma unroll
                for (int i = 0; i < RUN; ++i) {
                    if (j - i >= 0 && j - i < TAPS) acc[i] = fmaf(w[j - i], v, acc[i]);
                }
            }
        }
        if (k + 2 < count) bar_arrive(empty(b), THREADS);  // g[b] may be refilled
        if (last <= 0 || chan >= a.c) continue;
        // SiLU and the store of each kept output, one rounding each; a warp
        // writes the 32 channels of a row, 64 contiguous bytes in bf16
        Cursor at(a, tile.p0 + first);
        long long row = (long long)at.s * a.len + min(at.r, a.len);  // h's row of the position
        if (last == RUN && at.r + RUN <= a.len) {  // the run lies in one sequence: no zero rows
            T* dst = out + row * a.c;
#pragma unroll
            for (int i = 0; i < RUN; ++i)
                dst[(long long)i * a.c] = Pack<T>::from_float(acc[i] * sigmoid(acc[i]));
            continue;
        }
#pragma unroll
        for (int i = 0; i < RUN; ++i) {
            if (i < last && at.r < a.len) {
                out[row * a.c] = Pack<T>::from_float(acc[i] * sigmoid(acc[i]));
                ++row;
            }
            if (++at.r == a.period) {
                at.r = 0;
                ++at.s;
            }
        }
    }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
conv_module_rows(Shape a)
{
    extern __shared__ __align__(16) unsigned char smem_raw[];
    Smem<T>& sm = *reinterpret_cast<Smem<T>*>(smem_raw);
    const int groups = (a.c + LANES - 1) / LANES;
    const int group = blockIdx.x % groups;
    const int stride = gridDim.x / groups;
    const int t0 = blockIdx.x / groups;
    const int count = (a.tiles - t0 + stride - 1) / stride;  // this CTA's tiles

    if (threadIdx.x >= CTHREADS) {
        produce(a, sm, t0, count, stride, group);
        return;
    }
    // BatchNorm folded into the taps and the bias, in float32, once a CTA
    const int chan = group * LANES + threadIdx.x % LANES;
    float w[TAPS];
    float bias = 0.f, scale = 0.f;
    if (chan < a.c) {
        const float var = Pack<T>::scalar(static_cast<const T*>(a.bn_var)[chan]);
        const float mean = Pack<T>::scalar(static_cast<const T*>(a.bn_mean)[chan]);
        scale = Pack<T>::scalar(static_cast<const T*>(a.bn_weight)[chan])
                * (1.0f / sqrtf(var + a.eps));
        bias = (Pack<T>::scalar(static_cast<const T*>(a.dw_bias)[chan]) - mean) * scale
               + Pack<T>::scalar(static_cast<const T*>(a.bn_bias)[chan]);
    }
    const T* dw = static_cast<const T*>(a.dw_weight);
#pragma unroll
    for (int k = 0; k < TAPS; ++k)
        w[k] = chan < a.c ? Pack<T>::scalar(dw[chan * TAPS + k]) * scale : 0.f;
    consume(a, sm, t0, count, stride, group, w, bias);
}

template <typename T>
int run(Shape a, int sm_count, cudaStream_t stream)
{
    // the shared-memory opt-in and the resident CTAs an SM, once per device
    static int ready_dev = -1, per_sm = 0;
    const int smem = (int)sizeof(Smem<T>);
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess && dev != ready_dev) {
        err = cudaFuncSetAttribute(conv_module_rows<T>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, conv_module_rows<T>,
                                                                THREADS, smem);
        if (per_sm < 1) per_sm = 1;
        if (err == cudaSuccess) ready_dev = dev;
    }
    if (err != cudaSuccess) return (int)err;
    const int groups = (a.c + LANES - 1) / LANES;
    const long long work = (long long)a.tiles * groups;
    long long ctas = (long long)per_sm * sm_count / groups * groups;
    if (ctas < groups) ctas = groups;
    if (ctas > work) ctas = work;
    conv_module_rows<T><<<(unsigned)ctas, THREADS, smem, stream>>>(a);
    return (int)cudaGetLastError();
}

}  // namespace

// h: (n, len, 2c) and out: (n, len, c), contiguous and 16-byte aligned, f32
// (is_bf16 0) or bf16 (is_bf16 1); dw_weight: (c, 31); dw_bias, bn_weight,
// bn_bias, bn_mean, bn_var: (c,), all in h's dtype. c a multiple of 8, n and
// len at least 1, n * (len + 15) + 288 below 2**31. Returns cudaGetLastError()
// after the launch.
extern "C" int conv_module_launch(const void* h, const void* dw_weight, const void* dw_bias,
                                  const void* bn_weight, const void* bn_bias,
                                  const void* bn_mean, const void* bn_var, void* out,
                                  int is_bf16, int n, int len, int c, float eps, int sm_count,
                                  void* stream)
{
    const long long period = (long long)len + HALO;
    if (n < 1 || len < 1 || c < 8 || c % 8 != 0 || sm_count < 1
        || n * period + TILE >= (1LL << 31))
        return (int)cudaErrorInvalidValue;
    int log2p = 0;  // ceil(log2(P)), P >= 16
    while ((1LL << log2p) < period) ++log2p;
    const unsigned magic = (unsigned)(((1ULL << (31 + log2p)) + period - 1) / period);
    Shape a{h, dw_weight, dw_bias, bn_weight, bn_bias, bn_mean, bn_var, out, n, len, c,
            (int)period, magic, log2p - 1, (int)((n * period + TILE - 1) / TILE), eps};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16) return run<__nv_bfloat16>(a, sm_count, s);
    return run<float>(a, sm_count, s);
}
