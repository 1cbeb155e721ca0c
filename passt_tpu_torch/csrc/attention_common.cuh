// Pieces shared by the attention forward (attention_fwd.cu,
// attention_fwd_fp32.cu) and backward (attention_bwd.cu,
// attention_bwd_fp32.cu) kernels: the layout of a strided [B, N, H, D]
// operand, element conversions, the mma.sync m16n8k16 tensor-core product,
// ldmatrix and cp.async for the bf16/fp16 paths, the padded rows, copies
// and stores of the "simt" paths and the fp32 tile helpers of the FMA paths.
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

// The padded head dims the "wgmma" kernels are built for (attention_fwd.cu,
// attention_bwd.cu): a call at head dim d (a multiple of 16 up to 128) runs
// on the instance of the smallest DP >= d. Columns d .. DP - 1 arrive as
// zeros (TMA's fill past d) and are never stored.
__host__ __device__ constexpr int wgmma_dp(int d) { return d <= 32 ? 32 : d <= 64 ? 64 : 128; }

// Base pointers 16-byte aligned and strides whole multiples of 8 elements:
// what the tensor-core paths need for their 16-byte and 32-bit accesses.
inline bool vectors_aligned(const void* p, Strides s) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0 && s.b % 8 == 0 && s.n % 8 == 0 && s.h % 8 == 0;
}

// ---- the "simt" paths (attention_fwd_fp32.cu, attention_bwd_fp32.cu) ----

// The padded head dims the "simt" kernels are built for: a call at head dim
// d (a multiple of 8 up to 128) runs on the instance of the smallest DP >= d.
// Columns d .. DP - 1 are zero in shared memory (simt_zero_pad) and never
// stored, so they add exact zeros to every product over D.
__host__ __device__ constexpr int simt_dp(int d) { return d <= 32 ? 32 : d <= 64 ? 64 : d <= 96 ? 96 : 128; }

// Rows of DP floats (DP = 32, 64, 96 or 128) in shared memory as they lie in
// device memory, converted to fp32, at a pitch of DP + 4 floats: 4 mod 32
// banks from one row to the next, so the rows a warp reads at once as
// float4 fall in distinct banks or are broadcast. SIMT_LD is the pitch of
// 64-float rows (DP = 64, and the 64-wide score tiles at any DP).
template <int DP>
constexpr int simt_ld = DP + 4;
constexpr int SIMT_LD = simt_ld<64>;

// Zero columns d .. DP - 1 of `rows` shared rows of pitch simt_ld<DP> (the
// loads write only columns < d): once per buffer, before its first load.
template <int DP>
__device__ __forceinline__ void simt_zero_pad(float* dst, int rows, int d, int tid, int threads) {
    const int pad = DP - d;
    for (int idx = tid; idx < rows * pad; idx += threads) {
        const int r = idx / pad;
        dst[r * simt_ld<DP> + d + idx - r * pad] = 0.f;
    }
}

// Start copying columns 0 .. d - 1 of rows row0 .. row0 + 63 of a strided
// operand of type T into shared fp32 rows of pitch simt_ld<DP>, by `threads`
// threads from thread `tid`; rows past n are zero-filled. `vec` (chosen once
// per launch: every operand 16-byte aligned, strides in multiples of 8
// elements) takes 16-byte copies: cp.async for fp32, 16-byte loads
// converted to fp32 for bf16 / fp16; otherwise 4-byte cp.async (fp32) or
// element loads (bf16 / fp16). The 2-byte types' copies are synchronous;
// the fp32 ones land at the caller's cp.async wait. FULL (fp32, d = DP,
// every operand aligned) is the first design's copy, with no check at run
// time.
template <typename T, int DP, bool FULL>
__device__ __forceinline__ void load_rows(float* dst, const T* src, long long row_stride, int row0, int n, int d,
                                          bool vec, int tid, int threads) {
    static_assert(DP % 32 == 0 && DP <= 128, "rows of whole float4 column groups");
    static_assert(!FULL || sizeof(T) == 4, "full rows are fp32's");
    if constexpr (sizeof(T) == 4) {
        if (FULL || vec) {
            constexpr unsigned C = DP / 4;  // 16-byte chunks a row
            for (int idx = tid; idx < 64 * (DP / 4); idx += threads) {
                const int r = static_cast<unsigned>(idx) / C, c = static_cast<unsigned>(idx) % C;
                if (!FULL && 4 * c >= d) continue;  // padding columns: zero since the start
                const bool ok = row0 + r < n;
                const T* from = ok ? src + (long long)(row0 + r) * row_stride + 4 * c : src;
                const uint32_t to = static_cast<uint32_t>(__cvta_generic_to_shared(dst + r * simt_ld<DP> + 4 * c));
                asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" :: "r"(to), "l"(from), "r"(ok ? 16 : 0));
            }
        } else {
            for (int idx = tid; idx < 64 * DP; idx += threads) {
                const int r = static_cast<unsigned>(idx) / DP, c = static_cast<unsigned>(idx) % DP;
                if (c >= d) continue;
                const bool ok = row0 + r < n;
                const T* from = ok ? src + (long long)(row0 + r) * row_stride + c : src;
                const uint32_t to = static_cast<uint32_t>(__cvta_generic_to_shared(dst + r * simt_ld<DP> + c));
                asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" :: "r"(to), "l"(from), "r"(ok ? 4 : 0));
            }
        }
    } else {
        if (vec) {
            constexpr unsigned C = DP / 8;  // 16-byte chunks a row
            for (int idx = tid; idx < 64 * (DP / 8); idx += threads) {
                const int r = static_cast<unsigned>(idx) / C, c = static_cast<unsigned>(idx) % C;
                if (8 * c >= d) continue;
                uint4 raw = make_uint4(0u, 0u, 0u, 0u);
                if (row0 + r < n) raw = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * row_stride + 8 * c);
                const T* e = reinterpret_cast<const T*>(&raw);
                float* to = dst + r * simt_ld<DP> + 8 * c;
                *reinterpret_cast<float4*>(to) = make_float4(to_f(e[0]), to_f(e[1]), to_f(e[2]), to_f(e[3]));
                *reinterpret_cast<float4*>(to + 4) = make_float4(to_f(e[4]), to_f(e[5]), to_f(e[6]), to_f(e[7]));
            }
        } else {
            for (int idx = tid; idx < 64 * DP; idx += threads) {
                const int r = static_cast<unsigned>(idx) / DP, c = static_cast<unsigned>(idx) % DP;
                if (c >= d) continue;
                dst[r * simt_ld<DP> + c] = row0 + r < n ? to_f(src[(long long)(row0 + r) * row_stride + c]) : 0.f;
            }
        }
    }
}

// Store columns c .. c + 3 of an output row (c < d: d is a multiple of 8,
// so all four are) in T: one 16-byte (fp32) or 8-byte (bf16 / fp16) store
// with `vec`, else element stores.
template <typename T>
__device__ __forceinline__ void store4(T* p, float4 x, bool vec) {
    if constexpr (sizeof(T) == 4) {
        if (vec) {
            *reinterpret_cast<float4*>(p) = x;
        } else {
            p[0] = x.x;
            p[1] = x.y;
            p[2] = x.z;
            p[3] = x.w;
        }
    } else {
        if (vec) {
            T e[4] = {from_f<T>(x.x), from_f<T>(x.y), from_f<T>(x.z), from_f<T>(x.w)};
            *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(e);
        } else {
            p[0] = from_f<T>(x.x);
            p[1] = from_f<T>(x.y);
            p[2] = from_f<T>(x.z);
            p[3] = from_f<T>(x.w);
        }
    }
}

// fn<T, DP, FULL>(args...) for the "simt" instance that takes dtype code
// `dtype` (0 fp32, 1 bf16, 2 fp16; ops/attention.py _DTYPE_CODE) at head
// dim d: the padded head dim DP = simt_dp(d), FULL for fp32 at d = DP with
// every operand aligned (`aligned`). cudaErrorInvalidValue for another code
// or a d no instance takes (a multiple of 8 up to 128).
#define PASST_SIMT_DISPATCH(fn, dtype, d, aligned, ...)                                           \
    [&]() -> cudaError_t {                                                                        \
        if ((dtype) < 0 || (dtype) > 2 || (d) <= 0 || (d) > 128 || (d) % 8)                       \
            return cudaErrorInvalidValue;                                                         \
        const int dp_ = passt_attn::simt_dp(d);                                                   \
        if ((dtype) == 0 && (aligned) && (d) == dp_) switch (dp_) {                               \
                case 32: return fn<float, 32, true>(__VA_ARGS__);                                 \
                case 64: return fn<float, 64, true>(__VA_ARGS__);                                 \
                case 96: return fn<float, 96, true>(__VA_ARGS__);                                 \
                default: return fn<float, 128, true>(__VA_ARGS__);                                \
            }                                                                                     \
        switch ((dtype) * 4 + dp_ / 32 - 1) {                                                     \
            case 0: return fn<float, 32, false>(__VA_ARGS__);                                     \
            case 1: return fn<float, 64, false>(__VA_ARGS__);                                     \
            case 2: return fn<float, 96, false>(__VA_ARGS__);                                     \
            case 3: return fn<float, 128, false>(__VA_ARGS__);                                    \
            case 4: return fn<__nv_bfloat16, 32, false>(__VA_ARGS__);                             \
            case 5: return fn<__nv_bfloat16, 64, false>(__VA_ARGS__);                             \
            case 6: return fn<__nv_bfloat16, 96, false>(__VA_ARGS__);                             \
            case 7: return fn<__nv_bfloat16, 128, false>(__VA_ARGS__);                            \
            case 8: return fn<__half, 32, false>(__VA_ARGS__);                                    \
            case 9: return fn<__half, 64, false>(__VA_ARGS__);                                    \
            case 10: return fn<__half, 96, false>(__VA_ARGS__);                                   \
            default: return fn<__half, 128, false>(__VA_ARGS__);                                  \
        }                                                                                         \
    }()

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
