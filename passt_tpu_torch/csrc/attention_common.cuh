// Pieces shared by the attention forward (attention_fwd.cu,
// attention_fwd_fp32.cu) and backward (attention_bwd.cu,
// attention_bwd_fp32.cu) kernels: the layout of a strided [B, N, H, D]
// operand, element conversions, the mma.sync m16n8k16 tensor-core product,
// ldmatrix and cp.async for the bf16/fp16 paths, the row copies of the fp32
// "simt" paths and the fp32 tile helpers of the FMA paths.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace passt_attn {

constexpr int BQ = 64;  // queries per tile
constexpr int BK = 64;  // keys per tile

struct Strides {
    long long b, n, h;  // elements between batches, tokens and heads; d is contiguous
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
    return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f<__half>(float v) { return __float2half_rn(v); }

// v rounded to T and back: the rounding a product operand of type T takes.
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f(from_f<T>(v)); }

template <typename T> struct Mma;

template <> struct Mma<__nv_bfloat16> {
    static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
        __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
        return *reinterpret_cast<uint32_t*>(&v);
    }
    static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                               uint32_t b1) {
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
};

template <> struct Mma<__half> {
    static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
        __half2 v = __floats2half2_rn(lo, hi);
        return *reinterpret_cast<uint32_t*>(&v);
    }
    static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                               uint32_t b1) {
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
};

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1, const void* p) {
    const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r0), "=r"(r1)
                 : "r"(addr));
}

// Two elements (c, c + 1) of a row as one 32-bit word; 0 past the last row.
template <typename T>
__device__ __forceinline__ uint32_t load_pair(const T* base, long long row_stride, int row, int n,
                                              int c) {
    return row < n ? *reinterpret_cast<const uint32_t*>(base + (long long)row * row_stride + c) : 0u;
}

// A fragments (16 rows x D) of rows r0 .. r0 + 15 of a [N, D] operand.
template <typename T, int D>
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[D / 16][4], const T* base,
                                             long long row_stride, int r0, int n, int g, int t) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk * 16 + 2 * t;
        f[kk][0] = load_pair(base, row_stride, r0 + g, n, c);
        f[kk][1] = load_pair(base, row_stride, r0 + g + 8, n, c);
        f[kk][2] = load_pair(base, row_stride, r0 + g, n, c + 8);
        f[kk][3] = load_pair(base, row_stride, r0 + g + 8, n, c + 8);
    }
}

// Start copying a [64 rows][D] tile into shared memory (row pitch D + 8
// elements) with 16-byte cp.async by `threads` threads; rows past n are
// zero-filled.
template <typename T, int D, int threads>
__device__ __forceinline__ void load_tile_async(T* dst, const T* __restrict__ src,
                                                long long row_stride, int row0, int n) {
    constexpr int C = D / 8;  // 16-byte chunks per row
    for (int idx = threadIdx.x; idx < BK * C; idx += threads) {
        const int r = idx / C;
        const int c = idx - r * C;
        const bool valid = row0 + r < n;
        const T* from = valid ? src + (long long)(row0 + r) * row_stride + c * 8 : src;
        const uint32_t to = static_cast<uint32_t>(__cvta_generic_to_shared(dst + r * (D + 8) + c * 8));
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(to), "l"(from), "r"(valid ? 16 : 0));
    }
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most `pending` committed groups are still in flight.
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(pending));
}

// Base pointers 16-byte aligned and strides whole multiples of 8 elements:
// what the tensor-core paths need for their 16-byte and 32-bit accesses.
inline bool vectors_aligned(const void* p, Strides s) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % 8 == 0 && s.n % 8 == 0 && s.h % 8 == 0;
}

// ---- the fp32 "simt" paths (attention_fwd_fp32.cu, attention_bwd_fp32.cu) ----

// Rows of D floats (D = 32 or 64) in shared memory as they lie in device
// memory, at a pitch of D + 4 floats (36 or 68; 144 or 272 bytes): 4 mod 32
// banks from one row to the next, so the rows a warp reads at once as
// float4 fall in distinct banks or are broadcast. SIMT_LD is the pitch of
// 64-float rows (D = 64, and the 64-wide score tiles at either D).
template <int D>
constexpr int simt_ld = D + 4;
constexpr int SIMT_LD = simt_ld<64>;

// Start copying rows row0 .. row0 + 63 of a strided fp32 operand of head
// dim D into shared rows of pitch simt_ld<D> (16-byte cp.async by `threads`
// threads from thread `tid`); rows past n are zero-filled.
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src, long long row_stride, int row0, int n,
                                          int tid, int threads) {
    static_assert(D == 32 || D == 64, "rows of 8 or 16 chunks of 16 bytes");
    for (int idx = tid; idx < 64 * (D / 4); idx += threads) {
        const int r = idx >> (D == 64 ? 4 : 3), c = idx & (D / 4 - 1);
        const bool ok = row0 + r < n;
        const float* from = ok ? src + (long long)(row0 + r) * row_stride + 4 * c : src;
        const uint32_t to = static_cast<uint32_t>(__cvta_generic_to_shared(dst + r * simt_ld<D> + 4 * c));
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" :: "r"(to), "l"(from), "r"(ok ? 16 : 0));
    }
}

// ---- the fp32 FMA paths: 256 threads, fp32 tiles in shared memory ----

constexpr int FMA_THREADS = 256;

// Copy a [64 rows][d] tile to fp32 shared memory (row pitch ld); rows past
// n are zero.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* __restrict__ src,
                                          long long row_stride, int row0, int n, int d) {
    for (int idx = threadIdx.x; idx < BK * d; idx += FMA_THREADS) {
        const int r = idx / d;
        const int c = idx - r * d;
        const int row = row0 + r;
        dst[r * ld + c] = row < n ? to_f(src[(long long)row * row_stride + c]) : 0.f;
    }
}

// s[i][j] = q[tq + 16 i] . k[tk + 16 j] over the tile in shared memory.
__device__ __forceinline__ void tile_scores(float (&s)[4][4], const float* Qs, const float* Ks,
                                            int ld, int d, int tq, int tk) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
        float qa[4], ka[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qa[i] = Qs[(tq + 16 * i) * ld + c];
#pragma unroll
        for (int j = 0; j < 4; ++j) ka[j] = Ks[(tk + 16 * j) * ld + c];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }
}

}  // namespace passt_attn
