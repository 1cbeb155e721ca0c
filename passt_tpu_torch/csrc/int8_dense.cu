// The int8 Dense family as one tiled GEMM with three epilogues, for Hopper
// (sm_90a).
//
// Replaces: passt_tpu/ops/pallas/int8_dense.py:_dense_kernel (epilogue
// DENSE) and :_dense_gelu_kernel (epilogue GELU), and
// scripts/int8_matmul_micro.py:_mm_kernel (epilogue RAW). The port's
// wrappers are in passt_tpu_torch/ops/int8.py.
//
// out[M, N] = epilogue(A[M, K] . B[N, K]^T): both operands K-major (row-major
// A; B is the [K, N] operand transposed). For int8, ldmatrix has no .trans
// form, so the wrapper writes the quantized weight as [N, K] in its one
// quantization pass (quantize_rows(w^T) is quantize_cols(w) transposed, bit
// for bit). The products run on mma.sync:
//   int8: m16n8k32 s8 x s8 -> s32, exact;
//   bf16: m16n8k16 bf16 x bf16 -> f32 (RAW only, the micro-benchmark's
//         second dtype).
// Both take 32 bytes of K per instruction with the same fragment layout, so
// one loop serves both.
//
// Epilogues (per element, fp32, no contraction: __fmul_rn / __fadd_rn):
//   DENSE  z = ((float(acc) * sx[row]) * sw[col]) + b[col], rounded once to
//          the output dtype (fp32 or bf16);
//   GELU   the same z, then t = tanhf(C (z + A z z z)), h = 0.5 z (1 + t),
//          d = 0.5 (1 + t) + 0.5 z (1 - t t) C (1 + 3A z z), each rounded once
//          (the reference's saved derivative, not the analytic gelu');
//   RAW    the accumulator cast to the output dtype: int32 as is; int32 ->
//          bf16 through fp32, as the reference's astype and torch's .to do
//          (rounded twice above 2^24, bit-equal to both); f32 -> bf16.
//
// What bounds it (PaSST-S MLP at M = 5688, H100): fc1 + GELU writes h and d
// (69.9 MB of its 76.7 MB) against 26.8 G int8 operations: bytes-bound,
// 0.0229 ms. fc2 (3072 -> 768) is operations-bound, 0.0136 ms; 8192^3 int8
// 0.556 ms. This first kernel is simple: mma.sync (not wgmma), a 128 x 128
// output tile per block, 8 warps of 64 x 32, 128 bytes of K per stage in a
// three-slot cp.async ring (110.6 KB of shared memory), ldmatrix fragments
// from rows padded by 16 bytes (conflict-free), the epilogue straight from
// registers.
//
// Any M, N and K: rows of A past M and of B past N, and K chunks past K, are
// zero-filled by cp.async (zeros add nothing to the sums, so the result stays
// exact); stores are predicated on M and N. K bytes must be a multiple of 16
// (the wrapper pads K with zeros).
#include "common.cuh"
#include "attention_common.cuh"

#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

namespace {

using passt::cp_async16;
using passt::ldmatrix_x4;
using passt_attn::cp_async_commit;
using passt_attn::cp_async_wait;

constexpr int THREADS = 256;
constexpr int BM = 128;                            // rows per block
constexpr int BN = 128;                            // output columns per block
constexpr int BKB = 128;                           // K bytes per stage
constexpr int LDB = BKB + 16;                      // shared row pitch (bytes)
constexpr int STAGES = 3;
constexpr int STAGE_BYTES = (BM + BN) * LDB;
constexpr int SMEM = STAGES * STAGE_BYTES;         // 110,592 bytes

enum { EPI_DENSE = 0, EPI_GELU = 1, EPI_RAW = 2 };

// The tensor-core product of one 32-byte K step for each input type.
template <typename TIn> struct Op;

template <> struct Op<int8_t> {
    using Acc = int;
    static __device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
        asm volatile(
            "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
};

template <> struct Op<__nv_bfloat16> {
    using Acc = float;
    static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
        passt_attn::Mma<__nv_bfloat16>::mma(d, a, b0, b1);
    }
};

__device__ __forceinline__ float acc_to_f(int v) { return __int2float_rn(v); }
__device__ __forceinline__ float acc_to_f(float v) { return v; }

__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void put(int* p, int v) { *p = v; }
__device__ __forceinline__ void put2(float* p, float a, float b) { passt::store2(p, a, b); }
__device__ __forceinline__ void put2(__nv_bfloat16* p, float a, float b) { passt::store2(p, a, b); }
__device__ __forceinline__ void put2(int* p, int a, int b) { *reinterpret_cast<int2*>(p) = make_int2(a, b); }

// Columns col and col + 1 (col even) of one output row, predicated on n; a
// two-element store where n is even (the pair is then aligned).
template <typename TOut, typename V>
__device__ __forceinline__ void put_pair(TOut* row, int col, int n, V v0, V v1) {
    if (col + 1 < n) {
        if ((n & 1) == 0) {
            put2(row + col, v0, v1);
        } else {
            put(row + col, v0);
            put(row + col + 1, v1);
        }
    } else if (col < n) {
        put(row + col, v0);
    }
}

__device__ __forceinline__ float dequant(int acc, float sx, float sw, float b) {
    return __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc), sx), sw), b);
}

// The reference's tanh-GELU value and saved derivative, in its evaluation
// order, with fp32 constants.
__device__ __forceinline__ void gelu(float z, float& h, float& d) {
    constexpr float C = static_cast<float>(0.7978845608028654);  // sqrt(2 / pi)
    constexpr float A = 0.044715f;
    constexpr float A3 = static_cast<float>(3.0 * 0.044715);
    const float t = tanhf(__fmul_rn(C, __fadd_rn(z, __fmul_rn(__fmul_rn(__fmul_rn(A, z), z), z))));
    const float one_t = __fadd_rn(1.f, t);
    h = __fmul_rn(__fmul_rn(0.5f, z), one_t);
    const float tail = __fmul_rn(__fmul_rn(__fmul_rn(__fmul_rn(0.5f, z), __fsub_rn(1.f, __fmul_rn(t, t))), C),
                                 __fadd_rn(1.f, __fmul_rn(__fmul_rn(A3, z), z)));
    d = __fadd_rn(__fmul_rn(0.5f, one_t), tail);
}

template <typename TIn, int EPI, typename TOut>
__global__ void __launch_bounds__(THREADS) gemm_kernel(
    const TIn* __restrict__ a, const TIn* __restrict__ bt, TOut* __restrict__ out, TOut* __restrict__ out2,
    const float* __restrict__ sx, const float* __restrict__ sw, const float* __restrict__ bias, int m, int n,
    int k) {
    using Acc = typename Op<TIn>::Acc;
    extern __shared__ __align__(16) unsigned char smem[];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
    const long long kb = static_cast<long long>(k) * sizeof(TIn);  // bytes per operand row
    const int ktiles = static_cast<int>((kb + BKB - 1) / BKB);
    const unsigned char* ab = reinterpret_cast<const unsigned char*>(a);
    const unsigned char* bb = reinterpret_cast<const unsigned char*>(bt);

    // stage kt: A rows row0.., B rows col0.., K bytes kt * BKB ..; zero past
    // M, N and K
    auto load = [&](int kt) {
        if (kt >= ktiles) return;
        unsigned char* sa = smem + (kt % STAGES) * STAGE_BYTES;
        unsigned char* sb = sa + BM * LDB;
        const long long k0 = static_cast<long long>(kt) * BKB;
        constexpr int CH = BKB / 16;  // 16-byte chunks per row
        for (int idx = tid; idx < BM * CH; idx += THREADS) {
            const int r = idx / CH, c = idx % CH;
            const long long kk = k0 + c * 16;
            const bool ok = row0 + r < m && kk < kb;
            cp_async16(sa + r * LDB + c * 16, ok ? ab + static_cast<long long>(row0 + r) * kb + kk : ab, ok ? 16 : 0);
        }
        for (int idx = tid; idx < BN * CH; idx += THREADS) {
            const int r = idx / CH, c = idx % CH;
            const long long kk = k0 + c * 16;
            const bool ok = col0 + r < n && kk < kb;
            cp_async16(sb + r * LDB + c * 16, ok ? bb + static_cast<long long>(col0 + r) * kb + kk : bb, ok ? 16 : 0);
        }
    };
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        load(s);
        cp_async_commit();
    }

    const int wr = warp >> 2, wc = warp & 3;  // the warp's 64 rows x 32 columns
    Acc acc[4][4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = Acc(0);

    // ldmatrix lane addresses: A rows (lane & 15), K half (lane >> 4); B (rows
    // are output columns) rows (lane & 7) + 8 (lane >> 4), K half bit 3
    const int a_off = (wr * 64 + (lane & 15)) * LDB + (lane >> 4) * 16;
    const int b_off = BM * LDB + (wc * 32 + (lane & 7) + ((lane >> 4) << 3)) * LDB + ((lane >> 3) & 1) * 16;
    for (int kt = 0; kt < ktiles; ++kt) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();  // stage kt has landed; every warp is done with stage kt - 1
        load(kt + STAGES - 1);  // into the slot stage kt - 1 used
        cp_async_commit();
        const unsigned char* base = smem + (kt % STAGES) * STAGE_BYTES;
#pragma unroll
        for (int ks = 0; ks < BKB / 32; ++ks) {
            uint32_t af[4][4], bq[2][4];
#pragma unroll
            for (int i = 0; i < 4; ++i) ldmatrix_x4(af[i], base + a_off + i * 16 * LDB + ks * 32);
#pragma unroll
            for (int jp = 0; jp < 2; ++jp) ldmatrix_x4(bq[jp], base + b_off + jp * 16 * LDB + ks * 32);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int jp = 0; jp < 2; ++jp) {
                    Op<TIn>::mma(acc[i][2 * jp], af[i], bq[jp][0], bq[jp][1]);
                    Op<TIn>::mma(acc[i][2 * jp + 1], af[i], bq[jp][2], bq[jp][3]);
                }
        }
    }
    cp_async_wait<0>();

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            const int row = row0 + wr * 64 + i * 16 + g + 8 * hh;
            if (row >= m) continue;
            const long long roff = static_cast<long long>(row) * n;
            float sxr = 0.f;
            if constexpr (EPI != EPI_RAW) sxr = sx[row];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int col = col0 + wc * 32 + j * 8 + 2 * t;
                const Acc v0 = acc[i][j][2 * hh], v1 = acc[i][j][2 * hh + 1];
                if constexpr (EPI == EPI_RAW) {
                    if constexpr (std::is_same<TOut, int>::value)
                        put_pair(out + roff, col, n, v0, v1);
                    else
                        put_pair(out + roff, col, n, acc_to_f(v0), acc_to_f(v1));
                } else {
                    if (col >= n) continue;
                    const float z0 = dequant(v0, sxr, sw[col], bias[col]);
                    const float z1 = col + 1 < n ? dequant(v1, sxr, sw[col + 1], bias[col + 1]) : 0.f;
                    if constexpr (EPI == EPI_DENSE) {
                        put_pair(out + roff, col, n, z0, z1);
                    } else {
                        float h0, d0, h1, d1;
                        gelu(z0, h0, d0);
                        gelu(z1, h1, d1);
                        put_pair(out + roff, col, n, h0, h1);
                        put_pair(out2 + roff, col, n, d0, d1);
                    }
                }
            }
        }
}

template <typename TIn, int EPI, typename TOut>
int launch(const void* a, const void* bt, void* out, void* out2, const void* sx, const void* sw, const void* bias,
           int m, int n, int k, cudaStream_t stream) {
    const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
    if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
    auto kernel = gemm_kernel<TIn, EPI, TOut>;
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<grid, THREADS, SMEM, stream>>>(
        static_cast<const TIn*>(a), static_cast<const TIn*>(bt), static_cast<TOut*>(out), static_cast<TOut*>(out2),
        static_cast<const float*>(sx), static_cast<const float*>(sw), static_cast<const float*>(bias), m, n, k);
    return passt_launch_status();
}

}  // namespace

// a [m, k] and bt [n, k] row-major in in_dtype (0 int8, 1 bfloat16), 16-byte
// aligned, k * element size a multiple of 16; out (and out2 for GELU) [m, n]
// in out_dtype (0 float32, 1 bfloat16, 2 int32); sx [m], sw [n], bias [n]
// float32 (DENSE and GELU only). epilogue 0 DENSE, 1 GELU, 2 RAW. Takes
// int8 DENSE / GELU -> float32 or bfloat16, int8 RAW -> int32 or bfloat16,
// bfloat16 RAW -> bfloat16. Returns cudaGetLastError() after the launch.
extern "C" int passt_int8_gemm(const void* a, const void* bt, void* out, void* out2, const void* sx, const void* sw,
                               const void* bias, int in_dtype, int epilogue, int out_dtype, int m, int n, int k,
                               void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int elem = in_dtype == 1 ? 2 : 1;
    if (m <= 0 || n <= 0 || k <= 0 || (static_cast<long long>(k) * elem) % 16)
        return static_cast<int>(cudaErrorInvalidValue);
    if (in_dtype == 0) {
        if (epilogue == EPI_DENSE && out_dtype == 0)
            return launch<int8_t, EPI_DENSE, float>(a, bt, out, out2, sx, sw, bias, m, n, k, st);
        if (epilogue == EPI_DENSE && out_dtype == 1)
            return launch<int8_t, EPI_DENSE, __nv_bfloat16>(a, bt, out, out2, sx, sw, bias, m, n, k, st);
        if (epilogue == EPI_GELU && out_dtype == 0)
            return launch<int8_t, EPI_GELU, float>(a, bt, out, out2, sx, sw, bias, m, n, k, st);
        if (epilogue == EPI_GELU && out_dtype == 1)
            return launch<int8_t, EPI_GELU, __nv_bfloat16>(a, bt, out, out2, sx, sw, bias, m, n, k, st);
        if (epilogue == EPI_RAW && out_dtype == 2)
            return launch<int8_t, EPI_RAW, int>(a, bt, out, out2, sx, sw, bias, m, n, k, st);
        if (epilogue == EPI_RAW && out_dtype == 1)
            return launch<int8_t, EPI_RAW, __nv_bfloat16>(a, bt, out, out2, sx, sw, bias, m, n, k, st);
    } else if (in_dtype == 1 && epilogue == EPI_RAW && out_dtype == 1) {
        return launch<__nv_bfloat16, EPI_RAW, __nv_bfloat16>(a, bt, out, out2, sx, sw, bias, m, n, k, st);
    }
    return static_cast<int>(cudaErrorInvalidValue);
}
