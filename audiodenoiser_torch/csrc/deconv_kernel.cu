// 2x2 stride-2 transposed convolution (the U-Net decoder's upsampling).
//
// Replaces: audiodenoiser_tpu/ops/pallas/deconv_kernel.py::conv_transpose_2x2
// (_deconv_kernel), which runs four sub-pixel matmuls per input tile on the
// MXU and interleaves them in VMEM. With stride 2 and a 2x2 kernel every
// output pixel receives exactly one input tap:
//
//   out[b, 2i+di, 2j+dj, co] = sum_ci x[b, i, j, ci] * w[ci, (di, dj, co)] + bias[co]
//
// so the whole layer is one GEMM: M = B*H*W pixels, K = Cin, N = 4*Cout,
// with w the torch ConvTranspose2d weight (Cin, Cout, 2, 2) repacked by the
// wrapper to (Cin, 2, 2, Cout) in the compute dtype (no spatial flip: the
// port's weights are in torch's convention).
//
// What bounds it on the H100: at the U-Net's shapes (Cin 128..1024) the
// GEMM does 2*Cin/(bytes per pixel) operations per byte, under the card's
// ~295 bf16 operations per byte, so it is bound by its bytes: one read of
// x, one write of out (~30 us for the four layers of a batch-16 training
// step at 3.35 TB/s).
//
// Design (simple first): x and out are channels_last (NHWC) in memory, so
// x is a row-major (M, K) matrix and no transpose pass is needed on either
// side. The bf16 path stages 128x32 tiles of x and 32x64 tiles of w in
// shared memory (16-byte vector loads where the rows are aligned) and
// multiplies them on the tensor cores with WMMA (bf16 in, fp32
// accumulation); 8 warps each own a 32x32 piece of the 128x64 block tile.
// The epilogue stages the fp32 tile in shared memory, adds the fp32 bias,
// rounds to bf16 once (as B3 does) and writes every (di, dj) column straight
// to its interleaved NHWC output address, Cout-contiguous across threads.
// The fp32 path is a register-tiled FMA GEMM (64x64 block tile, 4x4 per
// thread) with the same epilogue. wgmma, TMA and a pipelined ring of tiles
// are for a later PR.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

using namespace nvcuda;

namespace {

constexpr int THREADS = 256;

// bf16 tensor-core path
constexpr int BM = 128, BN = 64, BK = 32;
constexpr int A_LD = BK + 8;  // bf16 elements (a multiple of 8 for WMMA)
constexpr int B_LD = BN + 8;
constexpr int C_LD = BN + 4;  // floats (a multiple of 4 for WMMA)
constexpr int A_BYTES = BM * A_LD * 2;
constexpr int B_BYTES = BK * B_LD * 2;
constexpr int C_BYTES = BM * C_LD * 4;
constexpr int SMEM_BF16 = (A_BYTES + B_BYTES) > C_BYTES ? (A_BYTES + B_BYTES) : C_BYTES;

// fp32 FMA path
constexpr int FM = 64, FN = 64, FK = 16;

// NHWC offset of output element (pixel m of the input grid, GEMM column n)
__device__ __forceinline__ long long out_offset(long long m, int n, int cout,
                                                int h, int w, int* co_out)
{
    const int d = n / cout;  // sub-pixel (di, dj) = (d >> 1, d & 1)
    const int co = n - d * cout;
    const long long j = m % w;
    const long long t = m / w;
    const long long i = t % h;
    const long long b = t / h;
    *co_out = co;
    return ((b * 2 * h + 2 * i + (d >> 1)) * 2 * w + 2 * j + (d & 1)) * cout + co;
}

template <bool VEC_A, bool VEC_B>
__global__ void __launch_bounds__(THREADS)
deconv_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ wmat,
                   const float* __restrict__ bias,
                   __nv_bfloat16* __restrict__ out,
                   long long M, int K, int N, int cout, int h, int w)
{
    __shared__ __align__(128) unsigned char smem[SMEM_BF16];
    __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem);            // [BM][A_LD]
    __nv_bfloat16* bs = reinterpret_cast<__nv_bfloat16*>(smem + A_BYTES);  // [BK][B_LD]
    float* cs = reinterpret_cast<float*>(smem);                            // [BM][C_LD]

    const int tid = threadIdx.x;
    const int warp = tid / 32;
    const int wm = warp / 2;  // rows wm*32 .. +32 of the block tile
    const int wn = warp % 2;  // columns wn*32 .. +32
    const long long m0 = (long long)blockIdx.x * BM;
    const int n0 = blockIdx.y * BN;
    const __nv_bfloat16 zero = __float2bfloat16(0.f);

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

    for (int k0 = 0; k0 < K; k0 += BK) {
        // x tile: BM rows x BK columns, in chunks of 8 elements
        for (int c = tid; c < BM * BK / 8; c += THREADS) {
            const int r = c / (BK / 8);
            const int kc = (c % (BK / 8)) * 8;
            const long long m = m0 + r;
            const int k = k0 + kc;
            __nv_bfloat16* dst = as + r * A_LD + kc;
            if (VEC_A) {
                uint4 v = make_uint4(0u, 0u, 0u, 0u);
                if (m < M && k < K) v = *reinterpret_cast<const uint4*>(x + m * K + k);
                *reinterpret_cast<uint4*>(dst) = v;
            } else {
#pragma unroll
                for (int e = 0; e < 8; ++e)
                    dst[e] = (m < M && k + e < K) ? x[m * K + k + e] : zero;
            }
        }
        // w tile: BK rows x BN columns
        for (int c = tid; c < BK * BN / 8; c += THREADS) {
            const int r = c / (BN / 8);
            const int nc = (c % (BN / 8)) * 8;
            const int k = k0 + r;
            const int n = n0 + nc;
            __nv_bfloat16* dst = bs + r * B_LD + nc;
            if (VEC_B) {
                uint4 v = make_uint4(0u, 0u, 0u, 0u);
                if (k < K && n < N)
                    v = *reinterpret_cast<const uint4*>(wmat + (long long)k * N + n);
                *reinterpret_cast<uint4*>(dst) = v;
            } else {
#pragma unroll
                for (int e = 0; e < 8; ++e)
                    dst[e] = (k < K && n + e < N) ? wmat[(long long)k * N + n + e] : zero;
            }
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
            for (int i = 0; i < 2; ++i)
                wmma::load_matrix_sync(fa[i], as + (wm * 32 + i * 16) * A_LD + kk, A_LD);
#pragma unroll
            for (int j = 0; j < 2; ++j)
                wmma::load_matrix_sync(fb[j], bs + kk * B_LD + wn * 32 + j * 16, B_LD);
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
        }
        __syncthreads();
    }

    // the fp32 tile reuses the operand buffers: the loop ended on a barrier
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
            wmma::store_matrix_sync(cs + (wm * 32 + i * 16) * C_LD + wn * 32 + j * 16,
                                    acc[i][j], C_LD, wmma::mem_row_major);
    __syncthreads();

    for (int idx = tid; idx < BM * BN; idx += THREADS) {
        const int r = idx / BN;
        const int c = idx - r * BN;
        const long long m = m0 + r;
        const int n = n0 + c;
        if (m >= M || n >= N) continue;
        int co;
        const long long o = out_offset(m, n, cout, h, w, &co);
        out[o] = __float2bfloat16(cs[r * C_LD + c] + bias[co]);  // one rounding
    }
}

__global__ void __launch_bounds__(THREADS)
deconv_f32_kernel(const float* __restrict__ x, const float* __restrict__ wmat,
                  const float* __restrict__ bias, float* __restrict__ out,
                  long long M, int K, int N, int cout, int h, int w)
{
    __shared__ float as[FK][FM + 4];  // transposed x tile: [k][row]
    __shared__ float bs[FK][FN + 4];

    const int tid = threadIdx.x;
    const int tm = tid / 16;  // rows tm + 16*i
    const int tn = tid % 16;  // columns tn + 16*j: neighbours store neighbours
    const long long m0 = (long long)blockIdx.x * FM;
    const int n0 = blockIdx.y * FN;

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < K; k0 += FK) {
        for (int q = tid; q < FM * FK; q += THREADS) {
            const int r = q / FK;
            const int k = q - r * FK;
            const long long m = m0 + r;
            as[k][r] = (m < M && k0 + k < K) ? x[m * K + k0 + k] : 0.f;
        }
        for (int q = tid; q < FK * FN; q += THREADS) {
            const int k = q / FN;
            const int n = q - k * FN;
            bs[k][n] = (k0 + k < K && n0 + n < N) ? wmat[(long long)(k0 + k) * N + n0 + n] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < FK; ++k) {
            float a[4], b[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = as[k][tm + 16 * i];
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = bs[k][tn + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const long long m = m0 + tm + 16 * i;
        if (m >= M) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int n = n0 + tn + 16 * j;
            if (n >= N) continue;
            int co;
            const long long o = out_offset(m, n, cout, h, w, &co);
            out[o] = acc[i][j] + bias[co];
        }
    }
}

}  // namespace

// x: (batch, h, w, cin) contiguous (a channels_last NCHW tensor), f32 or
// bf16; wmat: (cin, 4*cout) contiguous in x's dtype, column (di*2+dj)*cout
// + co; bias: (cout,) f32; out: (batch, 2h, 2w, cout) contiguous in x's
// dtype. Returns cudaGetLastError() after the launch.
extern "C" int deconv2x2_launch(const void* x, const void* wmat, const void* bias,
                                void* out, int is_bf16, long long batch, int h,
                                int w, int cin, int cout, void* stream)
{
    const long long M = batch * h * w;
    const int N = 4 * cout;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16) {
        const dim3 grid((unsigned)((M + BM - 1) / BM), (N + BN - 1) / BN);
        const bool va = cin % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
        const bool vb = N % 8 == 0 && (reinterpret_cast<uintptr_t>(wmat) & 15) == 0;
        const auto* xb = static_cast<const __nv_bfloat16*>(x);
        const auto* wb = static_cast<const __nv_bfloat16*>(wmat);
        const auto* bb = static_cast<const float*>(bias);
        auto* ob = static_cast<__nv_bfloat16*>(out);
        if (va && vb)
            deconv_bf16_kernel<true, true><<<grid, THREADS, 0, s>>>(xb, wb, bb, ob, M, cin, N, cout, h, w);
        else if (va)
            deconv_bf16_kernel<true, false><<<grid, THREADS, 0, s>>>(xb, wb, bb, ob, M, cin, N, cout, h, w);
        else if (vb)
            deconv_bf16_kernel<false, true><<<grid, THREADS, 0, s>>>(xb, wb, bb, ob, M, cin, N, cout, h, w);
        else
            deconv_bf16_kernel<false, false><<<grid, THREADS, 0, s>>>(xb, wb, bb, ob, M, cin, N, cout, h, w);
    } else {
        const dim3 grid((unsigned)((M + FM - 1) / FM), (N + FN - 1) / FN);
        deconv_f32_kernel<<<grid, THREADS, 0, s>>>(
            static_cast<const float*>(x), static_cast<const float*>(wmat),
            static_cast<const float*>(bias), static_cast<float*>(out), M, cin, N, cout, h, w);
    }
    return (int)cudaGetLastError();
}
