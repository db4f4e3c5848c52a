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
// with w the torch ConvTranspose2d weight (Cin, Cout, 2, 2) packed by the
// wrapper in the compute dtype (no spatial flip: the port's weights are in
// torch's convention) and cached there until the weight changes.
//
// What bounds it on the H100: at the U-Net's shapes (Cin 128..1024) the
// GEMM does 2*Cin/(bytes per pixel) operations per byte, under the card's
// ~295 bf16 operations per byte, so it is bound by its bytes: one read of
// x, one write of out (~30 us for the four layers of a batch-16 training
// step at 3.35 TB/s; the two deepest layers of a batch-256 bench batch come
// close to the tensor cores' bound too).
//
// x and out are channels_last (NHWC) in memory, so x is a row-major (M, K)
// matrix and no transpose pass is needed on either side. Three variants,
// chosen by the wrapper:
//
// wgmma (bf16, Cin and Cout multiples of 8: every U-Net layer). The weight
// is packed (N, K), K-major, so both operands take wgmma's K-major layout.
// A persistent block per SM walks 128 x 256 output tiles; a producer
// warpgroup issues TMA copies of x and w tiles (64 deep in K, 128-byte
// swizzle) into a ring of stages completing on mbarriers, two consumer
// warpgroups multiply them with wgmma (m64n256k16, fp32 accumulators in
// registers) and release each stage at once, so the next tile's loads run
// under this tile's epilogue. The epilogue adds the fp32 bias, rounds once
// to bf16 (as B3 does), stages each warp's rows in shared memory with
// stmatrix and stores 16-byte vectors, eight consecutive co of one (pixel,
// di, dj), to their interleaved NHWC address.
//
// wmma (other bf16 shapes): 128x32 tiles of x and 32x64 tiles of w staged
// in shared memory (16-byte loads where the rows are aligned), WMMA
// 16x16x16 products with fp32 accumulation, the same bias and rounding,
// stores Cout-contiguous across threads.
//
// fma (fp32): a register-tiled FMA GEMM (64x64 block tile, 4x4 per thread)
// with the same epilogue, in full fp32.

#include <cstdint>
#include <cuda.h>  // CUtensorMap and its enums only: nothing links against libcuda
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


// ---------------------------------------------------------------------------
// bf16 TMA + wgmma path (Cin % 8 == 0, Cout % 8 == 0)
// ---------------------------------------------------------------------------

constexpr int TM_BM = 128;     // block tile rows: two consumer warpgroups of 64
constexpr int TM_BN = 256;     // block tile columns: one m64n256 accumulator each
constexpr int TM_BK = 64;      // 128 bytes of bf16: one 128-byte swizzle row
constexpr int TM_STAGES = 3;
constexpr int TM_A_BYTES = TM_BM * TM_BK * 2;  // 16 KB
constexpr int TM_B_BYTES = TM_BN * TM_BK * 2;  // 32 KB
constexpr int TM_STAGE_BYTES = TM_A_BYTES + TM_B_BYTES;
constexpr int TM_THREADS = 3 * 128;            // two consumer warpgroups + a producer one
// epilogue staging: each consumer warp's 16 x 256 bf16 rows, padded by 16
// bytes so that the 8 rows an stmatrix writes fall on different banks
constexpr int TM_ROW_BYTES = TM_BN * 2 + 16;
constexpr int TM_WARP_STAGE = 16 * TM_ROW_BYTES;
// shared memory after the 1024-aligned ring: staging, the tile's fp32 bias
// by column, its per-chunk output offsets, each warp's 16 row bases, the
// mbarriers
constexpr int TM_OFF_STAGING = TM_STAGES * TM_STAGE_BYTES;
constexpr int TM_OFF_BIAS = TM_OFF_STAGING + 8 * TM_WARP_STAGE;
constexpr int TM_OFF_COLS = TM_OFF_BIAS + TM_BN * 4;
constexpr int TM_OFF_ROWS = TM_OFF_COLS + (TM_BN / 8) * 8;
constexpr int TM_OFF_BARS = TM_OFF_ROWS + 8 * 16 * 8;
constexpr int TM_SMEM = 1024 + TM_OFF_BARS + 2 * TM_STAGES * 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p)
{
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes)
{
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar)
{
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity)
{
    uint32_t done = 0;
    while (!done) {
        asm volatile("{\n.reg .pred p;\n"
                     "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                     "selp.u32 %0, 1, 0, p;\n}"
                     : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1)
{
    asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
                 " [%0], [%1, {%3, %4}], [%2];"
                 :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
                 : "memory");
}

// wgmma operand descriptor of a K-major tile whose 128-byte rows TMA wrote
// with the 128-byte swizzle: 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr)
{
    return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16)
         | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d += A(64x16, K-major, smem) * B(16x256, K-major, smem)^T; scale_d 0 overwrites d
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a,
                                                 uint64_t desc_b, int scale_d)
{
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// (lo, hi) -> one bf16x2 word, each rounded once
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi)
{
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

// four 8x8 bf16 matrices in the accumulator's fragment layout (lane l holds
// row l/4, columns 2*(l%4)) to shared memory; lane l gives the address of
// row l%8 of matrix l/8
__device__ __forceinline__ void stmatrix_x4(uint32_t addr, uint32_t r0, uint32_t r1, uint32_t r2,
                                            uint32_t r3)
{
    asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};"
                 :: "r"(addr), "r"(r0), "r"(r1), "r"(r2), "r"(r3) : "memory");
}

__device__ __forceinline__ void consumer_sync()  // the two consumer warpgroups only
{
    asm volatile("bar.sync 1, 256;" ::: "memory");
}

// Persistent: each block walks the (m, n) tiles, n fastest, so that blocks
// running together share the x tile in L2. Warpgroup 2 (one thread) keeps
// TMA loads of x and the packed weight in flight through a ring of TM_STAGES
// stages; warpgroups 0 and 1 each multiply 64 rows of the tile into a
// 64x256 fp32 accumulator with wgmma, release each stage as soon as its
// products are done, and then run the epilogue while the producer already
// loads the next tile. Epilogue: the fp32 bias of each column is added and
// the sum rounded once to bf16; each warp writes its 16 rows to shared
// memory with stmatrix and stores them back row by row, 16 bytes a lane
// (eight consecutive co of one (pixel, di, dj)), each row's interleaved NHWC
// address computed once per tile and each column chunk's offset once per
// tile, with no division in the store loop.
__global__ void __launch_bounds__(TM_THREADS, 1)
deconv_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ CUtensorMap map_w,
                    const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
                    int M, int N, int K, int cout, int h, int w)
{
    extern __shared__ unsigned char smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    const uint32_t tiles_base = (raw + 1023) & ~1023u;  // the swizzle wants 1024-byte alignment
    const uint32_t bars = tiles_base + TM_OFF_BARS;
    unsigned char* smem = smem_raw + (tiles_base - raw);
    float* bias_s = reinterpret_cast<float*>(smem + TM_OFF_BIAS);        // [TM_BN]
    long long* col_off = reinterpret_cast<long long*>(smem + TM_OFF_COLS);  // [TM_BN / 8]
    auto full = [&](int s) { return bars + 8 * s; };
    auto empty = [&](int s) { return bars + 8 * (TM_STAGES + s); };

    if (threadIdx.x == 0) {
        for (int s = 0; s < TM_STAGES; ++s) {
            mbar_init(full(s), 1);
            mbar_init(empty(s), 2);  // one arrival per consumer warpgroup
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    const int m_tiles = (M + TM_BM - 1) / TM_BM;
    const int n_tiles = (N + TM_BN - 1) / TM_BN;
    const int tiles = m_tiles * n_tiles;
    const int k_steps = (K + TM_BK - 1) / TM_BK;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;

    if (warp >= 8) {
        // producer warpgroup: one thread issues every copy; the others only
        // give their registers to the consumers
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
        if (threadIdx.x == 256) {
            int stage = 0, phase = 0;
            for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
                const int m0 = (tile / n_tiles) * TM_BM;
                const int n0 = (tile % n_tiles) * TM_BN;
                for (int kb = 0; kb < k_steps; ++kb) {
                    mbar_wait(empty(stage), phase ^ 1);
                    mbar_expect_tx(full(stage), TM_STAGE_BYTES);
                    const uint32_t a = tiles_base + stage * TM_STAGE_BYTES;
                    tma_load_2d(a, &map_x, full(stage), kb * TM_BK, m0);
                    tma_load_2d(a + TM_A_BYTES, &map_w, full(stage), kb * TM_BK, n0);
                    if (++stage == TM_STAGES) { stage = 0; phase ^= 1; }
                }
            }
        }
    } else {
        // consumer warpgroups 0 and 1
        asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
        const int wg = warp / 4;
        float acc[128];
        int stage = 0, phase = 0;
        for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
            const int m0 = (tile / n_tiles) * TM_BM;
            const int n0 = (tile % n_tiles) * TM_BN;
            for (int kb = 0; kb < k_steps; ++kb) {
                mbar_wait(full(stage), phase);
                const uint32_t a = tiles_base + stage * TM_STAGE_BYTES + wg * (TM_A_BYTES / 2);
                const uint32_t b = tiles_base + stage * TM_STAGE_BYTES + TM_A_BYTES;
                asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
                for (int kk = 0; kk < TM_BK / 16; ++kk)  // 32 bytes of K per product
                    wgmma_m64n256k16(acc, sw128_desc(a + 32 * kk), sw128_desc(b + 32 * kk),
                                     kb > 0 || kk > 0);
                asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
                asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
                for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(acc[i]) :: "memory");
                if (threadIdx.x % 128 == 0) mbar_arrive(empty(stage));
                if (++stage == TM_STAGES) { stage = 0; phase ^= 1; }
            }

            // the tile's columns: bias by column, output offset by 8-column chunk
            consumer_sync();  // the previous tile's epilogue is done with them
            {
                const int n = n0 + threadIdx.x;
                if (n < N) bias_s[threadIdx.x] = bias[n % cout];
                if (threadIdx.x < TM_BN / 8) {
                    const int nc = n0 + 8 * threadIdx.x;
                    const int d = nc / cout;  // sub-pixel (di, dj) = (d >> 1, d & 1)
                    col_off[threadIdx.x] = nc < N
                        ? ((long long)(d >> 1) * 2 * w + (d & 1)) * cout + (nc - d * cout) : -1;
                }
            }
            // this warp's 16 rows: interleaved NHWC base of each pixel
            const int warp_row = m0 + wg * 64 + (warp % 4) * 16;
            long long* row_base = reinterpret_cast<long long*>(smem + TM_OFF_ROWS) + warp * 16;
            if (lane < 16) {
                const int m = warp_row + lane;
                const int bb = m / (h * w);
                const int rem = m - bb * h * w;
                const int ii = rem / w;
                const int jj = rem - ii * w;
                row_base[lane] =
                    m < M ? (((long long)bb * 2 * h + 2 * ii) * 2 * w + 2 * jj) * cout : -1;
            }
            consumer_sync();

            // bias, one rounding, then the fragment to this warp's staging rows
            const uint32_t staging = tiles_base + TM_OFF_STAGING + warp * TM_WARP_STAGE;
            const uint32_t st_addr = staging + ((lane / 8) % 2 * 8 + lane % 8) * TM_ROW_BYTES
                                   + (lane / 16) * 16;
#pragma unroll
            for (int c = 0; c < TM_BN / 8; c += 2) {  // two 8-column chunks at a time
                const float* bc = bias_s + 8 * c + 2 * (lane & 3);
                const float2 b0 = *reinterpret_cast<const float2*>(bc);
                const float2 b1 = *reinterpret_cast<const float2*>(bc + 8);
                stmatrix_x4(st_addr + c * 16,
                            pack_bf16x2(acc[4 * c + 0] + b0.x, acc[4 * c + 1] + b0.y),
                            pack_bf16x2(acc[4 * c + 2] + b0.x, acc[4 * c + 3] + b0.y),
                            pack_bf16x2(acc[4 * c + 4] + b1.x, acc[4 * c + 5] + b1.y),
                            pack_bf16x2(acc[4 * c + 6] + b1.x, acc[4 * c + 7] + b1.y));
            }
            __syncwarp();
            // one row a step: lane c stores chunk c, eight consecutive co
            const long long coff = col_off[lane];
            const unsigned char* srow = smem + TM_OFF_STAGING + warp * TM_WARP_STAGE + lane * 16;
#pragma unroll 4
            for (int r = 0; r < 16; ++r) {
                const long long base = row_base[r];
                const uint4 v = *reinterpret_cast<const uint4*>(srow + r * TM_ROW_BYTES);
                if (base >= 0 && coff >= 0) *reinterpret_cast<uint4*>(out + base + coff) = v;
            }
            __syncwarp();  // the staging rows are read before the next tile writes them
        }
    }
}

// cuTensorMapEncodeTiled through the runtime's driver entry point, so that
// the build needs no -lcuda
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled()
{
    static EncodeTiled fn = nullptr;
    if (fn == nullptr) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q;
        if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q)
                == cudaSuccess && q == cudaDriverEntryPointSuccess)
            fn = reinterpret_cast<EncodeTiled>(p);
    }
    return fn;
}

// a (rows, k) row-major bf16 matrix in boxes of (box_rows, 64), 128-byte swizzle
bool kmajor_map(CUtensorMap* map, const void* ptr, long long rows, int k, int box_rows)
{
    EncodeTiled enc = encode_tiled();
    if (enc == nullptr) return false;
    const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)k * 2};
    const cuuint32_t box[2] = {(cuuint32_t)TM_BK, (cuuint32_t)box_rows};
    const cuuint32_t elem[2] = {1, 1};
    return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides,
               box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
               CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE)
           == CUDA_SUCCESS;
}

}  // namespace

// The wmma (is_bf16 1) and fma (is_bf16 0) variants. x: (batch, h, w, cin)
// contiguous (a channels_last NCHW tensor), f32 or bf16; wmat: (cin,
// 4*cout) contiguous in x's dtype, column (di*2+dj)*cout + co; bias:
// (cout,) f32; out: (batch, 2h, 2w, cout) contiguous in x's dtype. Returns
// cudaGetLastError() after the launch.
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

// The TMA + wgmma path. x: (batch, h, w, cin) contiguous bf16, 16-byte
// aligned; wpack: (4*cout, cin) contiguous bf16, row (di*2+dj)*cout + co
// (K-major); bias: (cout,) f32; out: (batch, 2h, 2w, cout) contiguous bf16.
// cin % 8 == 0 and cout % 8 == 0. Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue if a tensor map could not be built.
extern "C" int deconv2x2_wgmma_launch(const void* x, const void* wpack, const void* bias,
                                      void* out, long long batch, int h, int w, int cin,
                                      int cout, void* stream)
{
    const long long M = batch * h * w;
    const int N = 4 * cout;
    if (cin % 8 != 0 || cout % 8 != 0 || M > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    CUtensorMap map_x, map_w;
    if (!kmajor_map(&map_x, x, M, cin, TM_BM) || !kmajor_map(&map_w, wpack, N, cin, TM_BN))
        return (int)cudaErrorInvalidValue;
    // the SM count and the shared-memory opt-in, once per device
    static int ready_dev = -1, sms = 0;
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess && dev != ready_dev) {
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
        if (err == cudaSuccess)
            err = cudaFuncSetAttribute(deconv_wgmma_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, TM_SMEM);
        if (err == cudaSuccess) ready_dev = dev;
    }
    if (err != cudaSuccess) return (int)err;
    const long long tiles = ((M + TM_BM - 1) / TM_BM) * ((N + TM_BN - 1) / TM_BN);
    const int grid = (int)(tiles < sms ? tiles : sms);
    deconv_wgmma_kernel<<<grid, TM_THREADS, TM_SMEM, static_cast<cudaStream_t>(stream)>>>(
        map_x, map_w, static_cast<const float*>(bias), static_cast<__nv_bfloat16*>(out),
        (int)M, N, cin, cout, h, w);
    return (int)cudaGetLastError();
}
