// Attention forward for Hopper (sm_90a): o = softmax(q k^T * scale) v with
// fp32 scores, for one (batch, head, 64-query tile) per block.
//
// Replaces: passt_tpu/ops/pallas/attention.py:_fwd_kernel (entry
// fused_attention, [B, N, H, D]) and :_flat_fwd_kernel (entry
// fused_attention_qkv, the raw [B, N, 3C] qkv Dense output). One kernel
// serves both: q, k and v arrive as base pointers with (batch, token, head)
// strides, so both layouts are read in place with no transpose. The port's
// wrappers are in passt_tpu_torch/ops/attention.py.
//
// The math is the reference's _softmax_parts, row for row: fp32 scores
// s = (q . k) * scale; m = the row max (clamped at 0 under plus1);
// p = exp(s - m); l = sum p (+ exp(-m) under plus1); P is rounded to the
// input dtype for the PV product, which accumulates in fp32; o = (P v) / l,
// rounded to the input dtype.
//
// What bounds it: arithmetic. At eval length (N = 1190, D = 64) a head is
// 2 N^2 D FLOP for the scores and as many for PV, against 4 N D input
// bytes, and the scores are computed twice (below): 6 N^2 D FLOP a head.
//
// What the design does about it:
// - Two passes over K, so that P is exactly the reference's: the first pass
//   finds the row max m over all keys, the second computes p = exp(s - m)
//   with the final m, sums l from the unrounded p, rounds p to the input
//   dtype and accumulates PV. No online rescaling, so nothing differs from
//   the reference beyond summation order.
// - bf16/fp16 inputs with D a multiple of 16 and 16-byte aligned rows (the
//   model's path) run attention_fwd_mma_kernel: four warps, 16 queries
//   each, with the products on the tensor cores (mma.sync m16n8k16, fp32
//   accumulate; the product of two bf16 values is exact). Q stays in
//   registers as A fragments. K and V tiles of 64 keys go through padded
//   shared memory, double-buffered with cp.async so that tile i + 1 is
//   copied while tile i is computed; K is read as B fragments directly, V
//   through ldmatrix.trans. The score accumulators of a tile become the A
//   fragments of PV after the rounding of p, without a trip through shared
//   memory.
// - fp32 inputs (run at full fp32 on the TPU), other D and unaligned
//   strides run attention_fwd_kernel: fp32 FMA from shared memory, K/V
//   tiles as fp32 padded by one column, 4 queries x 4 keys of scores per
//   thread.
// - Ragged N is masked: keys past N get p = 0 and zero V rows, queries past
//   N are not stored. There is no cap on N.
#include "common.cuh"
#include "attention_common.cuh"

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

namespace {

using namespace passt_attn;

constexpr int THREADS = FMA_THREADS;

template <typename T, int DJ>
__global__ void __launch_bounds__(THREADS) attention_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, Strides qs, Strides ks, Strides vs, Strides os,
    int n, int d, float scale, int plus1) {
    extern __shared__ float smem[];
    const int ld = d + 1;
    float* Qs = smem;            // [BQ][ld]
    float* Ks = Qs + BQ * ld;    // [BK][ld]
    float* Vs = Ks + BK * ld;    // [BK][d]
    float* Ps = Vs + BK * d;     // [BQ][BK + 1] P rounded to T

    const int tid = threadIdx.x;
    const int tk = tid & 15, tq = tid >> 4;  // lanes 0-15 / 16-31 of a warp share a query row
    const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;

    const T* qb = q + b * qs.b + h * qs.h;
    const T* kb = k + b * ks.b + h * ks.h;
    const T* vb = v + b * vs.b + h * vs.h;
    T* ob = o + b * os.b + h * os.h;

    for (int idx = tid; idx < BQ * d; idx += THREADS) {
        const int r = idx / d;
        const int c = idx - r * d;
        const int row = q0 + r;
        Qs[r * ld + c] = row < n ? to_f(qb[(long long)row * qs.n + c]) : 0.f;
    }

    float s[4][4];

    // Pass 1: the row max over every key.
    float m[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) m[i] = -INFINITY;
    for (int k0 = 0; k0 < n; k0 += BK) {
        __syncthreads();
        load_tile(Ks, ld, kb, ks.n, k0, n, d);
        __syncthreads();
        tile_scores(s, Qs, Ks, ld, d, tq, tk);
#pragma unroll
        for (int j = 0; j < 4; ++j)
            if (k0 + tk + 16 * j < n)
#pragma unroll
                for (int i = 0; i < 4; ++i) m[i] = fmaxf(m[i], __fmul_rn(s[i][j], scale));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
            m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], off));
        if (plus1) m[i] = fmaxf(m[i], 0.f);
    }

    // Pass 2: p = exp(s - m), l = sum p, acc = round(p) v.
    float l[4] = {0.f, 0.f, 0.f, 0.f};
    float acc[4][DJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < n; k0 += BK) {
        __syncthreads();
        load_tile(Ks, ld, kb, ks.n, k0, n, d);
        load_tile(Vs, d, vb, vs.n, k0, n, d);
        __syncthreads();
        tile_scores(s, Qs, Ks, ld, d, tq, tk);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float p = (k0 + tk + 16 * j < n) ? expf(__fmul_rn(s[i][j], scale) - m[i]) : 0.f;
                l[i] += p;
                Ps[(tq + 16 * i) * (BK + 1) + tk + 16 * j] = to_f(from_f<T>(p));
            }
        __syncthreads();
        const int kmax = min(BK, n - k0);
        for (int kk = 0; kk < kmax; ++kk) {
            float pa[4], va[DJ];
#pragma unroll
            for (int i = 0; i < 4; ++i) pa[i] = Ps[(tq + 16 * i) * (BK + 1) + kk];
#pragma unroll
            for (int j = 0; j < DJ; ++j) {
                const int c = tk + 16 * j;
                va[j] = c < d ? Vs[kk * d + c] : 0.f;
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pa[i], va[j], acc[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
        if (plus1) l[i] += expf(-m[i]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = q0 + tq + 16 * i;
        if (row >= n) continue;
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
            const int c = tk + 16 * j;
            if (c < d) ob[(long long)row * os.n + c] = from_f<T>(acc[i][j] / l[i]);
        }
    }
}

size_t smem_bytes(int d) {
    return sizeof(float) * (size_t)(BQ * (d + 1) + BK * (d + 1) + BK * d + BQ * (BK + 1));
}

template <typename T, int DJ>
int launch(const void* q, const void* k, const void* v, void* o, int batch, int n, int heads,
           int d, Strides qs, Strides ks, Strides vs, Strides os, float scale, int plus1,
           cudaStream_t stream) {
    const size_t smem = smem_bytes(d);
    auto kernel = attention_fwd_kernel<T, DJ>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((n + BQ - 1) / BQ, heads, batch);
    kernel<<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), qs, ks, vs, os, n, d, scale, plus1);
    return passt_launch_status();
}

template <typename T>
int launch_d(int dj, const void* q, const void* k, const void* v, void* o, int batch, int n,
             int heads, int d, Strides qs, Strides ks, Strides vs, Strides os, float scale,
             int plus1, cudaStream_t stream) {
#define PASST_ATTN_CASE(DJ)                                                              \
    case DJ:                                                                              \
        return launch<T, DJ>(q, k, v, o, batch, n, heads, d, qs, ks, vs, os, scale, plus1, \
                             stream);
    switch (dj) {
        PASST_ATTN_CASE(1)
        PASST_ATTN_CASE(2)
        PASST_ATTN_CASE(3)
        PASST_ATTN_CASE(4)
        PASST_ATTN_CASE(5)
        PASST_ATTN_CASE(6)
        PASST_ATTN_CASE(7)
        PASST_ATTN_CASE(8)
    }
#undef PASST_ATTN_CASE
    return static_cast<int>(cudaErrorInvalidValue);
}


// ---- tensor-core path (bf16 / fp16, D % 16 == 0) ---------------------------

constexpr int MMA_THREADS = 128;  // 4 warps x 16 queries

// s[j] (keys j*8 .. j*8+7 of the tile) = q (16 rows of this warp) . k
template <typename T, int D>
__device__ __forceinline__ void tile_scores_mma(float (&s)[8][4], const uint32_t (&qf)[D / 16][4],
                                                const T* Ks, int g, int t) {
    const uint32_t* k32 = reinterpret_cast<const uint32_t*>(Ks);
    constexpr int LW = (D + 8) / 2;  // row pitch in words
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            const uint32_t b0 = k32[(j * 8 + g) * LW + kk * 8 + t];
            const uint32_t b1 = k32[(j * 8 + g) * LW + kk * 8 + 4 + t];
            Mma<T>::mma(s[j], qf[kk], b0, b1);
        }
    }
}

template <typename T, int D>
__global__ void __launch_bounds__(MMA_THREADS) attention_fwd_mma_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, Strides qs, Strides ks, Strides vs, Strides os,
    int n, float scale, int plus1) {
    constexpr int LD = D + 8;  // shared row pitch (elements): 16-byte rows, no bank conflicts
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* Kbuf = reinterpret_cast<T*>(smem_raw);  // [2][BK * LD]: tile i in buffer i & 1
    T* Vbuf = Kbuf + 2 * BK * LD;              // [2][BK * LD]

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
    const int b = blockIdx.z, h = blockIdx.y;
    const int r0 = blockIdx.x * BQ + warp * 16;  // this warp's first query

    const T* qb = q + b * qs.b + h * qs.h;
    const T* kb = k + b * ks.b + h * ks.h;
    const T* vb = v + b * vs.b + h * vs.h;
    T* ob = o + b * os.b + h * os.h;

    uint32_t qf[D / 16][4];  // A fragments of the warp's 16 x D queries
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
        const int c = kk * 16 + 2 * t;
        qf[kk][0] = load_pair(qb, qs.n, r0 + g, n, c);
        qf[kk][1] = load_pair(qb, qs.n, r0 + g + 8, n, c);
        qf[kk][2] = load_pair(qb, qs.n, r0 + g, n, c + 8);
        qf[kk][3] = load_pair(qb, qs.n, r0 + g + 8, n, c + 8);
    }

    float s[8][4];  // element e of s[j]: row g + 8 (e / 2), key j * 8 + 2 t + e % 2

    // Pass 1: the row max over every key (rows g and g + 8).
    // Tile i + 1 is copied while tile i is computed.
    const int tiles = (n + BK - 1) / BK;
    float m0 = -INFINITY, m1 = -INFINITY;
    load_tile_async<T, D, MMA_THREADS>(Kbuf, kb, ks.n, 0, n);
    cp_async_commit();
    for (int i = 0; i < tiles; ++i) {
        const int k0 = i * BK;
        if (i + 1 < tiles) load_tile_async<T, D, MMA_THREADS>(Kbuf + ((i + 1) & 1) * BK * LD, kb, ks.n, k0 + BK, n);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        tile_scores_mma<T, D>(s, qf, Kbuf + (i & 1) * BK * LD, g, t);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                if (k0 + j * 8 + 2 * t + (e & 1) < n) {
                    const float x = __fmul_rn(s[j][e], scale);
                    if (e < 2) m0 = fmaxf(m0, x); else m1 = fmaxf(m1, x);
                }
        __syncthreads();  // buffer i & 1 is refilled next iteration
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
        m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
        m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
    }
    if (plus1) {
        m0 = fmaxf(m0, 0.f);
        m1 = fmaxf(m1, 0.f);
    }

    // Pass 2: p = exp(s - m), l = sum p, acc = round(p) v.
    float l0 = 0.f, l1 = 0.f;
    float acc[D / 8][4];
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    load_tile_async<T, D, MMA_THREADS>(Kbuf, kb, ks.n, 0, n);
    load_tile_async<T, D, MMA_THREADS>(Vbuf, vb, vs.n, 0, n);
    cp_async_commit();
    for (int i = 0; i < tiles; ++i) {
        const int k0 = i * BK;
        if (i + 1 < tiles) {
            load_tile_async<T, D, MMA_THREADS>(Kbuf + ((i + 1) & 1) * BK * LD, kb, ks.n, k0 + BK, n);
            load_tile_async<T, D, MMA_THREADS>(Vbuf + ((i + 1) & 1) * BK * LD, vb, vs.n, k0 + BK, n);
        }
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        const T* Vs = Vbuf + (i & 1) * BK * LD;
        tile_scores_mma<T, D>(s, qf, Kbuf + (i & 1) * BK * LD, g, t);
        uint32_t pf[4][4];  // A fragments of P, 16 keys each
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            float p[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const bool valid = k0 + j * 8 + 2 * t + (e & 1) < n;
                p[e] = valid ? expf(__fmul_rn(s[j][e], scale) - (e < 2 ? m0 : m1)) : 0.f;
            }
            l0 += p[0] + p[1];
            l1 += p[2] + p[3];
            pf[j / 2][(j & 1) * 2 + 0] = Mma<T>::pack(p[0], p[1]);
            pf[j / 2][(j & 1) * 2 + 1] = Mma<T>::pack(p[2], p[3]);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int nt = 0; nt < D / 8; ++nt) {
                uint32_t b0, b1;
                ldmatrix_x2_trans(b0, b1, Vs + (kk * 16 + (lane & 15)) * LD + nt * 8);
                Mma<T>::mma(acc[nt], pf[kk], b0, b1);
            }
        __syncthreads();
    }
    cp_async_wait<0>();
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    if (plus1) {
        l0 += expf(-m0);
        l1 += expf(-m1);
    }

#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
        const int c = nt * 8 + 2 * t;
        if (r0 + g < n)
            *reinterpret_cast<uint32_t*>(ob + (long long)(r0 + g) * os.n + c) =
                Mma<T>::pack(acc[nt][0] / l0, acc[nt][1] / l0);
        if (r0 + g + 8 < n)
            *reinterpret_cast<uint32_t*>(ob + (long long)(r0 + g + 8) * os.n + c) =
                Mma<T>::pack(acc[nt][2] / l1, acc[nt][3] / l1);
    }
}

template <typename T, int D>
int launch_mma(const void* q, const void* k, const void* v, void* o, int batch, int n, int heads,
               Strides qs, Strides ks, Strides vs, Strides os, float scale, int plus1,
               cudaStream_t stream) {
    const size_t smem = 4 * BK * (D + 8) * sizeof(T);  // K and V, two buffers each
    auto kernel = attention_fwd_mma_kernel<T, D>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((n + BQ - 1) / BQ, heads, batch);
    kernel<<<grid, MMA_THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), qs, ks, vs, os, n, scale, plus1);
    return passt_launch_status();
}

template <typename T>
int launch_mma_d(int d, const void* q, const void* k, const void* v, void* o, int batch, int n,
                 int heads, Strides qs, Strides ks, Strides vs, Strides os, float scale,
                 int plus1, cudaStream_t stream) {
#define PASST_MMA_CASE(D)                                                                 \
    case D:                                                                               \
        return launch_mma<T, D>(q, k, v, o, batch, n, heads, qs, ks, vs, os, scale, plus1, \
                                stream);
    switch (d) {
        PASST_MMA_CASE(16)
        PASST_MMA_CASE(32)
        PASST_MMA_CASE(48)
        PASST_MMA_CASE(64)
        PASST_MMA_CASE(80)
        PASST_MMA_CASE(96)
        PASST_MMA_CASE(112)
        PASST_MMA_CASE(128)
    }
#undef PASST_MMA_CASE
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, k, v, o: element (b, t, h, c) at ptr[b * sb + t * sn + h * sh + c].
// dtype: 0 float32, 1 bfloat16, 2 float16. d <= 128 and a multiple of 8.
// Returns cudaGetLastError() after the launch.
extern "C" int passt_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int batch, int n, int heads, int d,
                                   long long qsb, long long qsn, long long qsh,
                                   long long ksb, long long ksn, long long ksh,
                                   long long vsb, long long vsn, long long vsh,
                                   long long osb, long long osn, long long osh,
                                   float scale, int plus1, void* stream) {
    if (d <= 0 || d > 128 || d % 8 != 0 || n <= 0 || batch <= 0 || heads <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const int dj = (d + 15) / 16;
    const Strides qs{qsb, qsn, qsh}, ks{ksb, ksn, ksh}, vs{vsb, vsn, vsh}, os{osb, osn, osh};
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const bool mma_ok = d % 16 == 0 && vectors_aligned(q, qs) && vectors_aligned(k, ks) &&
                        vectors_aligned(v, vs) && vectors_aligned(o, os);
    switch (dtype) {
        case 0:
            return launch_d<float>(dj, q, k, v, o, batch, n, heads, d, qs, ks, vs, os, scale, plus1, st);
        case 1:
            if (mma_ok)
                return launch_mma_d<__nv_bfloat16>(d, q, k, v, o, batch, n, heads, qs, ks, vs, os,
                                                   scale, plus1, st);
            return launch_d<__nv_bfloat16>(dj, q, k, v, o, batch, n, heads, d, qs, ks, vs, os, scale,
                                           plus1, st);
        case 2:
            if (mma_ok)
                return launch_mma_d<__half>(d, q, k, v, o, batch, n, heads, qs, ks, vs, os, scale,
                                            plus1, st);
            return launch_d<__half>(dj, q, k, v, o, batch, n, heads, d, qs, ks, vs, os, scale, plus1, st);
    }
    return static_cast<int>(cudaErrorInvalidValue);
}
