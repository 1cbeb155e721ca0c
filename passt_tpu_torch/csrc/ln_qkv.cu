// Fused norm1 -> qkv projection (F1) and its backward dqkv W -> LayerNorm
// backward (B2), for Hopper (sm_90a).
//
// Replaces: passt_tpu/ops/pallas/ln_qkv.py:_f1_kernel and :_b2_kernel. The
// port's wrappers are in passt_tpu_torch/ops/ln_qkv.py. W is the torch
// Linear weight [3C, C] (the JAX kernel's [C, 3C] transposed), in the
// compute dtype.
//
// F1, per row of x [M, C]: fp32 statistics with the fast variance
// max(E[x^2] - mu^2, 0), xn = ((x - mu) * rstd) * s + b rounded to the
// dtype, then qkv = round(xn W^T) + wb: the fp32 sum is rounded to the dtype
// and the bias added in the dtype (nn.Dense's two roundings).
// B2, per row: dxn = dqkv W in fp32; the statistics recomputed from x;
// x_hat = (x - mu) * rstd; xn = (x_hat * s + b) rounded to the dtype (for
// the dW product outside); dx = rstd * (g - mean(g) - x_hat mean(g x_hat))
// with g = dxn * s; per-block partials of dscale = sum(dxn * x_hat) and
// dbias = sum(dxn) over the block's rows, summed by the wrapper.
//
// What bounds them: operations. At the training step (M = 5688, C = 768)
// each is a [M, C] x [C, 3C] product, 20.1 GFLOP, against ~35 MB of bytes.
//
// What the design does about it:
// - fp32 runs the products on FMA in full fp32 (the JAX package asks for
//   Precision.HIGHEST there): no TF32.
// - F1 (bf16 / fp16, mma.sync m16n8k16, fp32 accumulate): a block owns 64
//   rows and a third of the 3C outputs (q, k or v), so the bench shape gives
//   89 x 3 blocks. The block computes its rows' statistics once and keeps
//   xn, already rounded, in shared memory ([64][C + 8], 99 KB at C = 768,
//   bf16); it then walks its 128-column output tiles, streaming 128 x 128
//   tiles of W (64 x 64 where C is not a multiple of 128) through a two-slot
//   cp.async ring. A warp computes 32 rows x 32 columns from ldmatrix
//   fragments; the epilogue rounds, adds the bias and stores each tile.
// - B2 (bf16 / fp16) runs on wgmma fed by TMA. The LayerNorm backward needs
//   whole rows of dxn (its two means run over C), and 192 rows x C fp32 do
//   not fit one CTA's registers, so a thread-block cluster splits C: for
//   C = 64 q, ceil(q / 3) CTAs of up to 3 column blocks of 64 (C = 768:
//   four CTAs of 192 rows x 192 columns, three consumer warpgroups of
//   64 x 192, 96 accumulators a thread; 30 clusters at M = 5688, which the
//   card holds at once). Each CTA streams its [192 x 64] dqkv tile and only
//   its W column slice (MN-major, 128-byte swizzle) through a 3-deep
//   mbarrier ring (a stage is freed as soon as its products complete), so W is read once per 192 rows (106 MB of L2 traffic at
//   M = 5688 against the 32-row mma.sync design's 630); one wgmma
//   m64n192k16 a k step. The CTAs load on their own: a TMA multicast of the
//   dqkv tile, whose stages the whole cluster must free before the next
//   load, was slower. A producer warpgroup gives its registers to the
//   consumers (setmaxnreg); its other three warps stage s, b and x's slice
//   (by TMA) and sum each row's x and x^2 over the slice under the
//   products. Then dxn goes to shared memory over the ring and each warp
//   walks 16 whole rows: coalesced xn and dx stores, the rows' g and g x_hat
//   sums by warp reductions, the columns' dscale and dbias sums in
//   registers. Each CTA's share of a row's sums sits in its shared memory
//   and every CTA adds the cluster's shares through distributed shared
//   memory in rank order; the columns' sums are added over the warps in a
//   fixed order: no atomics, so every run gives the same bits.
// - Ragged M: rows past M read as zero (B2: TMA's zero fill, which also
//   covers the last CTA's blocks past C) and are never stored; they add
//   nothing to the dscale/dbias partials.
#include "common.cuh"
#include "attention_common.cuh"
#include "hopper.cuh"

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

using passt_attn::cp_async_commit;
using passt_attn::cp_async_wait;
using passt_attn::from_f;
using passt_attn::Mma;
using passt_attn::to_f;

constexpr int THREADS = 256;  // 8 warps in every kernel here

using passt::cp_async16;
using passt::ldmatrix_x4;
using passt::load2;
using passt::store2;
using passt::warp_sum;

// The JAX ln_stats of one row, computed by one warp: mean and rstd in fp32
// (the variance clamped at 0). Every lane gets both.
template <typename T>
__device__ __forceinline__ void row_stats(const T* xr, int c, float eps, float& mu, float& rstd) {
    const int lane = threadIdx.x & 31;
    float s = 0.f, s2 = 0.f;
    for (int col = 2 * lane; col < c; col += 64) {
        const float2 v = load2(xr + col);
        s += v.x + v.y;
        s2 += v.x * v.x + v.y * v.y;
    }
    s = warp_sum(s);
    s2 = warp_sum(s2);
    const float fc = static_cast<float>(c);
    mu = __fdiv_rn(s, fc);
    const float var = fmaxf(__fsub_rn(__fdiv_rn(s2, fc), __fmul_rn(mu, mu)), 0.f);
    rstd = 1.0f / sqrtf(__fadd_rn(var, eps));
}

// ((x - mu) * rstd) * s + b, in that order, without contraction.
__device__ __forceinline__ float ln_affine(float x, float mu, float rstd, float s, float b) {
    return __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(x, mu), rstd), s), b);
}

// ---- F1 on the tensor cores (bf16 / fp16) ------------------------------------

constexpr int F1_BM = 64;      // rows per block
constexpr int F1_STAGES = 2;   // W tiles in flight
constexpr int F1_GROUPS = 3;   // column groups of the 3C outputs (grid.y)

// WN: output columns a warp computes per tile (the tile is 4 WN wide); BK:
// K per W tile.
template <typename T, int WN, int BK>
__global__ void __launch_bounds__(THREADS) ln_qkv_f1_mma_kernel(
    const T* __restrict__ x, const float* __restrict__ s, const float* __restrict__ b,
    const T* __restrict__ w, const T* __restrict__ wb, T* __restrict__ out, int m, int c,
    float eps) {
    constexpr int BN = 4 * WN;   // output columns per tile
    constexpr int NJ = WN / 8;   // n8 tiles a warp holds
    constexpr int WLD = BK + 8;  // W tile row pitch (elements)
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int xld = c + 8;  // xn row pitch (elements)
    T* Xn = reinterpret_cast<T*>(smem_raw);  // [F1_BM][xld]
    T* Wring = Xn + F1_BM * xld;             // [F1_STAGES][BN][WLD]

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int row0 = blockIdx.x * F1_BM;
    const int gw = 3 * c / F1_GROUPS;  // this block's output columns
    const int col0 = blockIdx.y * gw;
    const int c3 = 3 * c;
    const int ktiles = c / BK, stages = ktiles * (gw / BN);

    auto load_w = [&](int st) {
        if (st >= stages) return;
        const int nt = st / ktiles, kt = st - nt * ktiles;
        T* dst = Wring + (st % F1_STAGES) * BN * WLD;
        const T* src = w + static_cast<long long>(col0 + nt * BN) * c + kt * BK;
        for (int idx = tid; idx < BN * (BK / 8); idx += THREADS) {
            const int r = idx / (BK / 8), ch = idx % (BK / 8);
            cp_async16(dst + r * WLD + ch * 8, src + static_cast<long long>(r) * c + ch * 8);
        }
    };
    // the first W tiles fly while the statistics are computed
#pragma unroll
    for (int st = 0; st < F1_STAGES - 1; ++st) {
        load_w(st);
        cp_async_commit();
    }

    // xn of the block's rows, rounded to T, into shared memory (8 rows a warp)
    for (int r = warp; r < F1_BM; r += THREADS / 32) {
        const int row = row0 + r;
        T* dst = Xn + r * xld;
        if (row < m) {
            const T* xr = x + static_cast<long long>(row) * c;
            float mu, rstd;
            row_stats(xr, c, eps, mu, rstd);
            for (int col = 2 * lane; col < c; col += 64) {
                const float2 v = load2(xr + col);
                store2(dst + col, ln_affine(v.x, mu, rstd, s[col], b[col]),
                       ln_affine(v.y, mu, rstd, s[col + 1], b[col + 1]));
            }
        } else {
            for (int col = 2 * lane; col < c; col += 64) store2(dst + col, 0.f, 0.f);
        }
    }

    const int wr = warp & 1, wc = warp >> 1;  // 32 rows x WN columns a warp
    float acc[2][NJ][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

    // ldmatrix lane addresses: A rows (lane & 15), k half (lane >> 4); B (W
    // rows are output columns) rows (lane & 7) + 8 (lane >> 4), k half bit 3
    const T* a_base = Xn + (wr * 32 + (lane & 15)) * xld + (lane >> 4) * 8;
    const int b_off = (wc * WN + (lane & 7) + ((lane >> 4) << 3)) * WLD + ((lane >> 3) & 1) * 8;
    for (int st = 0; st < stages; ++st) {
        cp_async_wait<F1_STAGES - 2>();
        __syncthreads();  // tile st has landed; every warp is done with tile st - 1
        load_w(st + F1_STAGES - 1);  // into the slot tile st - 1 used
        cp_async_commit();
        const int nt = st / ktiles, kt = st - nt * ktiles;
        const T* ws = Wring + (st % F1_STAGES) * BN * WLD + b_off;
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
            const int k = kt * BK + kk * 16;
            uint32_t a[2][4];
#pragma unroll
            for (int i = 0; i < 2; ++i) ldmatrix_x4(a[i], a_base + i * 16 * xld + k);
#pragma unroll
            for (int jp = 0; jp < NJ / 2; ++jp) {
                uint32_t bq[4];  // b0, b1 of n8 tile 2 jp, then of 2 jp + 1
                ldmatrix_x4(bq, ws + jp * 16 * WLD + kk * 16);
#pragma unroll
                for (int i = 0; i < 2; ++i) {
                    Mma<T>::mma(acc[i][2 * jp], a[i], bq[0], bq[1]);
                    Mma<T>::mma(acc[i][2 * jp + 1], a[i], bq[2], bq[3]);
                }
            }
        }
        if (kt == ktiles - 1) {
            // round the fp32 sum to T, then add the bias in T
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
                const int col = col0 + nt * BN + wc * WN + j * 8 + 2 * t;
                const float b0 = to_f(wb[col]), b1 = to_f(wb[col + 1]);
#pragma unroll
                for (int i = 0; i < 2; ++i) {
#pragma unroll
                    for (int h = 0; h < 2; ++h) {
                        const int row = row0 + wr * 32 + i * 16 + g + 8 * h;
                        if (row < m)
                            store2(out + static_cast<long long>(row) * c3 + col,
                                   to_f(from_f<T>(acc[i][j][2 * h])) + b0,
                                   to_f(from_f<T>(acc[i][j][2 * h + 1])) + b1);
                        acc[i][j][2 * h] = acc[i][j][2 * h + 1] = 0.f;
                    }
                }
            }
        }
    }
    cp_async_wait<0>();
}

template <typename T, int WN, int BK>
int launch_f1_mma_n(const void* x, const float* s, const float* b, const void* w, const void* wb,
                    void* out, int m, int c, float eps, cudaStream_t stream) {
    const size_t smem =
        sizeof(T) * static_cast<size_t>(F1_BM * (c + 8) + F1_STAGES * 4 * WN * (BK + 8));
    auto kernel = ln_qkv_f1_mma_kernel<T, WN, BK>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((m + F1_BM - 1) / F1_BM, F1_GROUPS);
    kernel<<<grid, THREADS, smem, stream>>>(static_cast<const T*>(x), s, b, static_cast<const T*>(w),
                                            static_cast<const T*>(wb), static_cast<T*>(out), m, c, eps);
    return passt_launch_status();
}

// 128 x 128 W tiles where C is a multiple of 128 (a column group then holds
// whole tiles), else 64 x 64
template <typename T>
int launch_f1_mma(const void* x, const float* s, const float* b, const void* w, const void* wb,
                  void* out, int m, int c, float eps, cudaStream_t stream) {
    if (c % 128 == 0) return launch_f1_mma_n<T, 32, 128>(x, s, b, w, wb, out, m, c, eps, stream);
    return launch_f1_mma_n<T, 16, 64>(x, s, b, w, wb, out, m, c, eps, stream);
}

// ---- F1 in fp32 on FMA ----------------------------------------------------------

constexpr int F1F_BM = 32;   // rows per block
constexpr int F1F_BN = 128;  // output columns per block
constexpr int F1F_BK = 32;

__global__ void __launch_bounds__(THREADS) ln_qkv_f1_fma_kernel(
    const float* __restrict__ x, const float* __restrict__ s, const float* __restrict__ b,
    const float* __restrict__ w, const float* __restrict__ wb, float* __restrict__ out, int m,
    int c, float eps) {
    extern __shared__ float smem_f[];
    const int xld = c + 1;
    float* Xn = smem_f;                // [F1F_BM][xld]
    float* Ws = Xn + F1F_BM * xld;     // [F1F_BN][F1F_BK + 1]
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int row0 = blockIdx.x * F1F_BM, col0 = blockIdx.y * F1F_BN;
    const int c3 = 3 * c;

    for (int r = warp; r < F1F_BM; r += THREADS / 32) {
        const int row = row0 + r;
        if (row < m) {
            const float* xr = x + static_cast<long long>(row) * c;
            float mu, rstd;
            row_stats(xr, c, eps, mu, rstd);
            for (int col = lane; col < c; col += 32)
                Xn[r * xld + col] = ln_affine(xr[col], mu, rstd, s[col], b[col]);
        } else {
            for (int col = lane; col < c; col += 32) Xn[r * xld + col] = 0.f;
        }
    }

    const int tr = warp, tc = lane;  // rows tr + 8 i, columns tc + 32 j
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < c; k0 += F1F_BK) {
        __syncthreads();
        for (int idx = tid; idx < F1F_BN * F1F_BK; idx += THREADS) {
            const int n = idx / F1F_BK, kk = idx - n * F1F_BK;
            const int col = col0 + n;
            Ws[n * (F1F_BK + 1) + kk] = col < c3 ? w[static_cast<long long>(col) * c + k0 + kk] : 0.f;
        }
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < F1F_BK; ++kk) {
            float a[4], bw[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = Xn[(tr + 8 * i) * xld + k0 + kk];
#pragma unroll
            for (int j = 0; j < 4; ++j) bw[j] = Ws[(tc + 32 * j) * (F1F_BK + 1) + kk];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bw[j], acc[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = row0 + tr + 8 * i;
        if (row >= m) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int col = col0 + tc + 32 * j;
            if (col < c3) out[static_cast<long long>(row) * c3 + col] = acc[i][j] + wb[col];
        }
    }
}

int launch_f1_fma(const void* x, const float* s, const float* b, const void* w, const void* wb,
                  void* out, int m, int c, float eps, cudaStream_t stream) {
    const size_t smem = sizeof(float) * static_cast<size_t>(F1F_BM * (c + 1) + F1F_BN * (F1F_BK + 1));
    cudaError_t err = cudaFuncSetAttribute(ln_qkv_f1_fma_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((m + F1F_BM - 1) / F1F_BM, (3 * c + F1F_BN - 1) / F1F_BN);
    ln_qkv_f1_fma_kernel<<<grid, THREADS, smem, stream>>>(
        static_cast<const float*>(x), s, b, static_cast<const float*>(w),
        static_cast<const float*>(wb), static_cast<float*>(out), m, c, eps);
    return passt_launch_status();
}

// ---- B2 on wgmma, fed by TMA (bf16 / fp16) ------------------------------------------

namespace H = passt_hopper;

constexpr int B2_CW = 3;                    // consumer warpgroups of a CTA: 64 rows each
constexpr int B2_BM = 64 * B2_CW;           // rows of a cluster (the partials' row tile)
constexpr int B2_KS = 64;                   // K (= 3C) a stage: one 128-byte swizzle span
constexpr int B2_STAGES = 3;
constexpr int B2_CONSUMERS = 128 * B2_CW;
constexpr int B2_THREADS = B2_CONSUMERS + 128;  // the consumer warpgroups, then the producer warpgroup
constexpr int B2_PRODUCER_REGS = 40, B2_CONSUMER_REGS = 152;
constexpr int B2_A_BYTES = B2_BM * 128;     // a stage's dqkv tile: B2_BM rows x 64 of K
constexpr int B2_W_BLOCK = B2_KS * 128;     // a stage's block of W: 64 rows of K x 64 columns
constexpr int B2_MAX_NB = 3;                // 64-column blocks a CTA holds at most

// The CTAs of a cluster (the column slices of C) and the 64-column blocks
// each holds, for C = 64 q: ceil(q / 3) slices of at most 3 blocks; the last
// slice may hold fewer (its blocks past C load as zeros and store nothing).
// ops/ln_qkv.py b2_split mirrors it.
__host__ __device__ inline void b2_split(int c, int& ncta, int& nb) {
    const int q = c / 64;
    ncta = (q + B2_MAX_NB - 1) / B2_MAX_NB;
    nb = (q + ncta - 1) / ncta;
}

template <int NB> struct B2Tile {
    static constexpr int COLS = 64 * NB;
    static constexpr int STAGE = B2_A_BYTES + NB * B2_W_BLOCK;
    static constexpr int XS = NB * B2_BM * 128;  // x's [B2_BM x 64] blocks
    static constexpr int DP = COLS + 4;          // the row pitch of dxn in shared memory (floats)
    // x, s and b, the rows' sums and the barriers, then (1024-aligned) the
    // ring, which dxn [B2_BM][DP] and then the columns' sums
    // [warp][COLS][dscale, dbias] reuse once the products are done
    static constexpr int FRONT = (XS + 2 * COLS * 4 + 2 * B2_BM * 8 + (2 * B2_STAGES + 1) * 8 + 1023) / 1024 * 1024;
    static constexpr int RING = B2_STAGES * STAGE > B2_BM * DP * 4 ? B2_STAGES * STAGE : B2_BM * DP * 4;
    static constexpr int SMEM = 1024 + FRONT + RING;
    static_assert(B2_CONSUMERS / 32 * COLS * 2 <= B2_BM * DP, "the columns' sums fit where dxn was");
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
    return p + ((1024 - (H::smem_u32(p) & 1023)) & 1023);
}

__device__ __forceinline__ uint32_t cluster_rank() {
    uint32_t r;
    asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
    return r;
}
__device__ __forceinline__ uint32_t cluster_size() {
    uint32_t r;
    asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
    return r;
}
// Every thread of every CTA of the cluster: arrive (release), then wait
// (acquire) for the others' arrivals of the same phase.
__device__ __forceinline__ void cluster_arrive() { asm volatile("barrier.cluster.arrive.release;\n" ::: "memory"); }
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory"); }

// The address of this CTA's shared variable p in the shared memory of CTA
// `rank` of the cluster.
__device__ __forceinline__ uint32_t map_rank(const void* p, uint32_t rank) {
    uint32_t r;
    asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(H::smem_u32(p)), "r"(rank));
    return r;
}
__device__ __forceinline__ float2 ld_cluster(uint32_t addr) {
    float2 v;
    asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
    return v;
}
// wgmma descriptor of an MN-major operand NB blocks of 64 wide: each block
// is B2_KS rows of 128 bytes (128-byte swizzle), the blocks B2_W_BLOCK bytes
// apart (the leading byte offset), 8-row K groups 1024 bytes apart.
__device__ __forceinline__ uint64_t sw128_mn_blocks_desc(const void* p) {
    return (uint64_t)((H::smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(B2_W_BLOCK >> 4) << 16) |
           ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// A packed pair of T as two floats.
template <typename T> __device__ __forceinline__ float2 unpack2(uint32_t u);
template <> __device__ __forceinline__ float2 unpack2<__nv_bfloat16>(uint32_t u) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}
template <> __device__ __forceinline__ float2 unpack2<__half>(uint32_t u) {
    return __half22float2(*reinterpret_cast<const __half2*>(&u));
}

// The pair of x at column cl (even) of block nb, row r, from x's blocks in
// shared memory (B2_BM rows of 128 bytes each, 128-byte swizzle: the
// 16-byte chunk cl / 8 of row r sits at chunk (cl / 8) ^ (r % 8)).
__device__ __forceinline__ uint32_t x_pair(const unsigned char* xs, int nb, int r, int cl) {
    return *reinterpret_cast<const uint32_t*>(xs + nb * B2_BM * 128 + r * 128 + (((cl >> 3) ^ (r & 7)) << 4) +
                                              (cl & 7) * 2);
}

// x_hat, without contraction: (x - mu) * rstd.
__device__ __forceinline__ float xhat_of(float x, float mu, float rstd) { return __fmul_rn(__fsub_rn(x, mu), rstd); }

// One cluster of ncta CTAs per B2_BM rows; CTA `rank` holds columns
// [rank 64 NB, (rank + 1) 64 NB) of dxn. See the file's comment.
template <typename T, int NB>
__global__ void __launch_bounds__(B2_THREADS, 1) ln_qkv_b2_wgmma_kernel(
    const __grid_constant__ CUtensorMap dmap, const __grid_constant__ CUtensorMap wmap,
    const __grid_constant__ CUtensorMap xmap, const float* __restrict__ s, const float* __restrict__ b,
    T* __restrict__ dx, T* __restrict__ xn, float* __restrict__ dsc_part, float* __restrict__ dbi_part, int m, int c,
    int ktiles, float eps) {
    using Tl = B2Tile<NB>;
    constexpr int COLS = Tl::COLS, DP = Tl::DP;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* xs = align1024(smem_raw);            // x's [B2_BM x 64] blocks, 128-byte swizzle
    float* sb = reinterpret_cast<float*>(xs + Tl::XS);  // [2][COLS] s, b of this CTA's columns
    float2* statp = reinterpret_cast<float2*>(sb + 2 * COLS);  // [B2_BM] sum x, sum x^2 over this CTA's columns
    float2* gpart = statp + B2_BM;  // [B2_BM] sum g, sum g x_hat over them
    uint64_t* full = reinterpret_cast<uint64_t*>(gpart + B2_BM);
    uint64_t* empty = full + B2_STAGES;
    uint64_t* xfull = empty + B2_STAGES;
    unsigned char* ring = xs + Tl::FRONT;
    float* dxn = reinterpret_cast<float*>(ring);  // [B2_BM][DP] once the products are done

    const uint32_t rank = cluster_rank(), ncta = cluster_size();
    const int tile = blockIdx.x / ncta;
    const int row0 = tile * B2_BM, col0 = rank * COLS;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

    if (threadIdx.x == 0) {
        for (int st = 0; st < B2_STAGES; ++st) {
            H::mbar_init(full + st, 1);
            H::mbar_init(empty + st, B2_CONSUMERS / 32);
        }
        H::mbar_init(xfull, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (warp >= B2_CONSUMERS / 32) {  // the producer warpgroup
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(B2_PRODUCER_REGS));
        if (warp == B2_CONSUMERS / 32) {
            if (lane == 0) {  // one thread issues every copy: x's blocks, then the ring
                H::mbar_expect_tx(xfull, Tl::XS);
#pragma unroll
                for (int nb = 0; nb < NB; ++nb) H::tma_load_2d(xs + nb * B2_BM * 128, &xmap, xfull, col0 + 64 * nb, row0);
                for (int kt = 0; kt < ktiles; ++kt) {
                    const int st = kt % B2_STAGES;
                    if (kt >= B2_STAGES) H::mbar_wait_or_trap(empty + st, (kt / B2_STAGES - 1) & 1);
                    unsigned char* sp = ring + st * Tl::STAGE;
                    H::mbar_expect_tx(full + st, Tl::STAGE);
                    H::tma_load_2d(sp, &dmap, full + st, kt * B2_KS, row0);
#pragma unroll
                    for (int nb = 0; nb < NB; ++nb)
                        H::tma_load_2d(sp + B2_A_BYTES + nb * B2_W_BLOCK, &wmap, full + st, col0 + 64 * nb,
                                       kt * B2_KS);
                }
            }
        } else {
            // the other three warps: s and b of this CTA's columns, and its
            // share of every row's sums of x and x^2, under the products
            const int pw = warp - B2_CONSUMERS / 32 - 1;
            for (int i = pw * 32 + lane; i < COLS; i += 96) {
                const bool ok = col0 + i < c;
                sb[i] = ok ? s[col0 + i] : 0.f;
                sb[COLS + i] = ok ? b[col0 + i] : 0.f;
            }
            H::mbar_wait_or_trap(xfull, 0);
            for (int r = pw; r < B2_BM; r += 3) {
                float sx = 0.f, sx2 = 0.f;
#pragma unroll
                for (int nb = 0; nb < NB; ++nb) {
                    const float2 v = unpack2<T>(x_pair(xs, nb, r, 2 * lane));
                    sx += v.x + v.y;
                    sx2 += v.x * v.x + v.y * v.y;
                }
                sx = passt::warp_sum(sx);
                sx2 = passt::warp_sum(sx2);
                if (lane == 0) statp[r] = make_float2(sx, sx2);
            }
        }
        cluster_arrive();  // (1) the statistics' shares, s and b are in place
        cluster_wait();
        cluster_arrive();  // (2) the g sums
        cluster_wait();
        cluster_arrive();  // (3) no CTA leaves while another reads its shared memory
        cluster_wait();
        return;
    }

    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(B2_CONSUMER_REGS));
    cluster_arrive();  // (1): read after the products

    // dxn = dqkv W: the warpgroup's 64 rows x COLS columns
    const int wg = warp >> 2;
    float acc[NB * 32];
#pragma unroll
    for (int i = 0; i < NB * 32; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < ktiles; ++kt) {
        const int st = kt % B2_STAGES;
        H::mbar_wait_or_trap(full + st, (kt / B2_STAGES) & 1);
        const unsigned char* sp = ring + st * Tl::STAGE;
        const uint64_t ad = H::sw128_desc(sp + wg * 64 * 128);
        H::fence_regs(acc);
        H::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < B2_KS / 16; ++kk) {
            // one product of N = 64 NB across the NB blocks of W (NB
            // products of N = 64 took 7% longer)
            if constexpr (NB > 1)
                H::WgmmaF32<T, 64 * NB, 1>::mma(acc, ad + 2 * kk, sw128_mn_blocks_desc(sp + B2_A_BYTES) + 128 * kk, 1);
            else
                H::Wgmma<T>::ss64_bmn(acc, ad + 2 * kk, H::sw128_mn_desc(sp + B2_A_BYTES) + 128 * kk, 1);
        }
        H::wgmma_commit();
        // free the stage at once: with three stages, an earlier release
        // beats keeping a second group of products in flight
        H::wgmma_wait<0>();
        H::fence_regs(acc);
        if (lane == 0) H::mbar_arrive(empty + st);
    }

    // dxn into shared memory over the ring (both warpgroups are done with
    // it), so that a warp can walk whole rows: accumulator element 4 jb + e
    // of a thread is row 16 wq + g + 8 (e / 2), column 8 jb + 2 t4 + e % 2
    H::named_bar_sync(1, B2_CONSUMERS);
    {
        const int g = lane >> 2, t4 = lane & 3, r = wg * 64 + (warp & 3) * 16 + g;
#pragma unroll
        for (int jb = 0; jb < 8 * NB; ++jb)
#pragma unroll
            for (int h = 0; h < 2; ++h)
                *reinterpret_cast<float2*>(dxn + (r + 8 * h) * DP + 8 * jb + 2 * t4) =
                    make_float2(acc[4 * jb + 2 * h], acc[4 * jb + 2 * h + 1]);
    }
    H::named_bar_sync(1, B2_CONSUMERS);

    // the warp's 16 rows; a lane holds columns 2 lane + 64 nb and + 1.
    // Lane i < 16 finds row r0 + i's statistics from every CTA's share in
    // rank order.
    cluster_wait();  // (1)
    H::mbar_wait_or_trap(xfull, 0);
    const int r0 = 16 * warp;
    const float fc = static_cast<float>(c), inv_c = 1.0f / fc;
    float mu_l = 0.f, rstd_l = 0.f;
    if (lane < 16) {
        float tx = 0.f, tx2 = 0.f;
        for (uint32_t q = 0; q < ncta; ++q) {
            const float2 v = ld_cluster(map_rank(statp + r0 + lane, q));
            tx += v.x;
            tx2 += v.y;
        }
        mu_l = __fdiv_rn(tx, fc);
        const float var = fmaxf(__fsub_rn(__fdiv_rn(tx2, fc), __fmul_rn(mu_l, mu_l)), 0.f);
        rstd_l = 1.0f / sqrtf(__fadd_rn(var, eps));
    }
    float sc[2 * NB], bi[2 * NB], cs[2 * NB], cb[2 * NB];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
        const int cl = 2 * lane + 64 * nb;
        sc[2 * nb] = sb[cl];
        sc[2 * nb + 1] = sb[cl + 1];
        bi[2 * nb] = sb[COLS + cl];
        bi[2 * nb + 1] = sb[COLS + cl + 1];
        cs[2 * nb] = cs[2 * nb + 1] = cb[2 * nb] = cb[2 * nb + 1] = 0.f;
    }

    // xn; each row's sums of g = dxn s and g x_hat over this CTA's columns;
    // the columns' sums of dxn x_hat and dxn over the warp's rows. Past M
    // and past C x, s and dxn are 0, so they add nothing.
#pragma unroll 2
    for (int i = 0; i < 16; ++i) {
        const int r = r0 + i;
        const bool ok = row0 + r < m;
        const float mu = __shfl_sync(0xffffffffu, mu_l, i), rstd = __shfl_sync(0xffffffffu, rstd_l, i);
        float s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
            const int cl = 2 * lane + 64 * nb, col = col0 + cl;
            const float2 xv = unpack2<T>(x_pair(xs, nb, r, 2 * lane));
            const float xh0 = ok ? xhat_of(xv.x, mu, rstd) : 0.f, xh1 = ok ? xhat_of(xv.y, mu, rstd) : 0.f;
            if (ok && col < c)
                passt::store2(xn + static_cast<long long>(row0 + r) * c + col,
                              __fadd_rn(__fmul_rn(xh0, sc[2 * nb]), bi[2 * nb]),
                              __fadd_rn(__fmul_rn(xh1, sc[2 * nb + 1]), bi[2 * nb + 1]));
            const float2 d = *reinterpret_cast<const float2*>(dxn + r * DP + cl);
            const float g0 = d.x * sc[2 * nb], g1 = d.y * sc[2 * nb + 1];
            s1 += g0 + g1;
            s2 += g0 * xh0 + g1 * xh1;
            cs[2 * nb] += d.x * xh0;
            cs[2 * nb + 1] += d.y * xh1;
            cb[2 * nb] += d.x;
            cb[2 * nb + 1] += d.y;
        }
        s1 = passt::warp_sum(s1);
        s2 = passt::warp_sum(s2);
        if (lane == 0) gpart[r] = make_float2(s1, s2);
    }
    cluster_arrive();  // (2)
    cluster_wait();

    // dx = rstd (g - mean(g) - x_hat mean(g x_hat)), the means from every
    // CTA's sums in rank order (lane i < 16: row r0 + i)
    float m1_l = 0.f, m2_l = 0.f;
    if (lane < 16) {
        float a = 0.f, bb = 0.f;
        for (uint32_t q = 0; q < ncta; ++q) {
            const float2 v = ld_cluster(map_rank(gpart + r0 + lane, q));
            a += v.x;
            bb += v.y;
        }
        m1_l = a * inv_c;
        m2_l = bb * inv_c;
    }
#pragma unroll 2
    for (int i = 0; i < 16; ++i) {
        const int r = r0 + i;
        const float mu = __shfl_sync(0xffffffffu, mu_l, i), rstd = __shfl_sync(0xffffffffu, rstd_l, i);
        const float m1 = __shfl_sync(0xffffffffu, m1_l, i), m2 = __shfl_sync(0xffffffffu, m2_l, i);
        if (row0 + r >= m) continue;
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
            const int cl = 2 * lane + 64 * nb, col = col0 + cl;
            if (col >= c) continue;
            const float2 xv = unpack2<T>(x_pair(xs, nb, r, 2 * lane));
            const float xh0 = xhat_of(xv.x, mu, rstd), xh1 = xhat_of(xv.y, mu, rstd);
            const float2 d = *reinterpret_cast<const float2*>(dxn + r * DP + cl);
            const float g0 = d.x * sc[2 * nb], g1 = d.y * sc[2 * nb + 1];
            passt::store2(dx + static_cast<long long>(row0 + r) * c + col, rstd * (g0 - m1 - xh0 * m2),
                          rstd * (g1 - m1 - xh1 * m2));
        }
    }

    // the columns' sums over the warps, in a fixed order, where dxn was
    H::named_bar_sync(1, B2_CONSUMERS);
    float* colred = dxn;  // [warp][COLS][dscale, dbias]
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
        const int cl = 2 * lane + 64 * nb;
        *reinterpret_cast<float4*>(colred + 2 * (warp * COLS + cl)) =
            make_float4(cs[2 * nb], cb[2 * nb], cs[2 * nb + 1], cb[2 * nb + 1]);
    }
    H::named_bar_sync(1, B2_CONSUMERS);
    for (int cl = threadIdx.x; cl < COLS; cl += B2_CONSUMERS) {
        const int col = col0 + cl;
        if (col >= c) continue;
        float a = 0.f, bb = 0.f;
        for (int w = 0; w < B2_CONSUMERS / 32; ++w) {
            const float2 v = *reinterpret_cast<const float2*>(colred + 2 * (w * COLS + cl));
            a += v.x;
            bb += v.y;
        }
        dsc_part[static_cast<long long>(tile) * c + col] = a;
        dbi_part[static_cast<long long>(tile) * c + col] = bb;
    }
    cluster_arrive();  // (3)
    cluster_wait();
}

// A 2-D tensor map over a row-major [rows, cols] 2-byte operand (row pitch
// cols * 2 bytes): boxes of 64 columns x box_rows rows, 128-byte swizzle,
// zero fill past the edges.
inline bool b2_map(CUtensorMap* map, const void* ptr, bool bf16, long long rows, long long cols, int box_rows) {
    const H::EncodeTiled encode = H::encode_tiled();
    if (encode == nullptr) return false;
    const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
    const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
    const cuuint32_t box[2] = {64u, (cuuint32_t)box_rows};
    const cuuint32_t unit[2] = {1, 1};
    return encode(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16, 2,
                  const_cast<void*>(ptr), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                  CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int NB>
int launch_b2_wgmma_n(const void* x, const void* dqkv, const void* w, const float* s, const float* b, void* dx,
                      void* xn, float* dsc, float* dbi, int m, int c, int ncta, float eps, cudaStream_t stream) {
    auto kernel = ln_qkv_b2_wgmma_kernel<T, NB>;
    // a runtime call first: it makes the device's context current, which
    // the tensor-map encoder needs
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, B2Tile<NB>::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    const bool bf16 = std::is_same<T, __nv_bfloat16>::value;
    CUtensorMap dmap, wmap, xmap;
    if (!b2_map(&dmap, dqkv, bf16, m, 3LL * c, B2_BM) || !b2_map(&wmap, w, bf16, 3LL * c, c, B2_KS) ||
        !b2_map(&xmap, x, bf16, m, c, B2_BM))
        return static_cast<int>(cudaErrorInvalidValue);
    const int tiles = (m + B2_BM - 1) / B2_BM;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(tiles * ncta);
    cfg.blockDim = dim3(B2_THREADS);
    cfg.dynamicSmemBytes = B2Tile<NB>::SMEM;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = ncta;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, dmap, wmap, xmap, s, b, static_cast<T*>(dx),
                             static_cast<T*>(xn), dsc, dbi, m, c, (3 * c) / B2_KS, eps);
    if (err != cudaSuccess) return static_cast<int>(err);
    return passt_launch_status();
}

// How many clusters of the bf16/fp16 B2 kernel the card holds at once for
// width c (cudaOccupancyMaxActiveClusters), and the cluster's CTAs.
template <typename T, int NB>
int b2_clusters_n(int c, int* ncta, int* active) {
    auto kernel = ln_qkv_b2_wgmma_kernel<T, NB>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, B2Tile<NB>::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    int nb;
    b2_split(c, *ncta, nb);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(*ncta);
    cfg.blockDim = dim3(B2_THREADS);
    cfg.dynamicSmemBytes = B2Tile<NB>::SMEM;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = *ncta;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return static_cast<int>(cudaOccupancyMaxActiveClusters(active, kernel, &cfg));
}

template <typename T>
int launch_b2_wgmma(const void* x, const void* dqkv, const void* w, const float* s, const float* b, void* dx,
                    void* xn, float* dsc, float* dbi, int m, int c, float eps, cudaStream_t stream) {
    int ncta, nb;
    b2_split(c, ncta, nb);
    switch (nb) {
        case 1: return launch_b2_wgmma_n<T, 1>(x, dqkv, w, s, b, dx, xn, dsc, dbi, m, c, ncta, eps, stream);
        case 2: return launch_b2_wgmma_n<T, 2>(x, dqkv, w, s, b, dx, xn, dsc, dbi, m, c, ncta, eps, stream);
        case 3: return launch_b2_wgmma_n<T, 3>(x, dqkv, w, s, b, dx, xn, dsc, dbi, m, c, ncta, eps, stream);
    }
    return static_cast<int>(cudaErrorInvalidValue);
}

// ---- B2 in fp32 on FMA --------------------------------------------------------------

constexpr int B2F_BM = 8;   // rows per block (one a warp for the statistics)
constexpr int B2F_BK = 32;
constexpr int B2F_NJ = 4;   // columns a thread holds: c <= 4 * THREADS

__global__ void __launch_bounds__(THREADS) ln_qkv_b2_fma_kernel(
    const float* __restrict__ x, const float* __restrict__ dqkv, const float* __restrict__ w,
    const float* __restrict__ s, const float* __restrict__ b, float* __restrict__ dx,
    float* __restrict__ xn, float* __restrict__ dsc_part, float* __restrict__ dbi_part, int m,
    int c, float eps) {
    __shared__ float Ds[B2F_BM][B2F_BK];
    __shared__ float stat[B2F_BM][2];
    __shared__ float red[THREADS / 32][B2F_BM][2];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int row0 = blockIdx.x * B2F_BM;
    const int c3 = 3 * c;

    {
        const int row = row0 + warp;  // one row a warp
        float mu = 0.f, rstd = 0.f;
        if (row < m) {
            const float* xr = x + static_cast<long long>(row) * c;
            row_stats(xr, c, eps, mu, rstd);
            for (int col = lane; col < c; col += 32)
                xn[static_cast<long long>(row) * c + col] = ln_affine(xr[col], mu, rstd, s[col], b[col]);
        }
        if (lane == 0) {
            stat[warp][0] = mu;
            stat[warp][1] = rstd;
        }
    }

    float acc[B2F_BM][B2F_NJ];
#pragma unroll
    for (int r = 0; r < B2F_BM; ++r)
#pragma unroll
        for (int j = 0; j < B2F_NJ; ++j) acc[r][j] = 0.f;
    for (int k0 = 0; k0 < c3; k0 += B2F_BK) {
        __syncthreads();
        {
            const int r = tid / B2F_BK, kk = tid - r * B2F_BK;  // THREADS == B2F_BM * B2F_BK
            Ds[r][kk] = row0 + r < m ? dqkv[static_cast<long long>(row0 + r) * c3 + k0 + kk] : 0.f;
        }
        __syncthreads();
#pragma unroll 4
        for (int kk = 0; kk < B2F_BK; ++kk) {
            const float* wr = w + static_cast<long long>(k0 + kk) * c;
            float wv[B2F_NJ];
#pragma unroll
            for (int j = 0; j < B2F_NJ; ++j) {
                const int col = tid + THREADS * j;
                wv[j] = col < c ? wr[col] : 0.f;
            }
#pragma unroll
            for (int r = 0; r < B2F_BM; ++r) {
                const float a = Ds[r][kk];
#pragma unroll
                for (int j = 0; j < B2F_NJ; ++j) acc[r][j] = fmaf(a, wv[j], acc[r][j]);
            }
        }
    }

    // row sums of g and g x_hat (block-wide); column sums over the block's rows
    float cs[B2F_NJ], cb[B2F_NJ];
#pragma unroll
    for (int j = 0; j < B2F_NJ; ++j) cs[j] = cb[j] = 0.f;
#pragma unroll
    for (int r = 0; r < B2F_BM; ++r) {
        const int row = row0 + r;
        const bool valid = row < m;
        const float mu = stat[r][0], rstd = stat[r][1];
        float s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int j = 0; j < B2F_NJ; ++j) {
            const int col = tid + THREADS * j;
            if (col < c && valid) {
                const float xh = (x[static_cast<long long>(row) * c + col] - mu) * rstd;
                const float d = acc[r][j], gg = d * s[col];
                s1 += gg;
                s2 += gg * xh;
                cs[j] += d * xh;
                cb[j] += d;
            }
        }
        s1 = warp_sum(s1);
        s2 = warp_sum(s2);
        if (lane == 0) {
            red[warp][r][0] = s1;
            red[warp][r][1] = s2;
        }
    }
#pragma unroll
    for (int j = 0; j < B2F_NJ; ++j) {
        const int col = tid + THREADS * j;
        if (col < c) {
            dsc_part[static_cast<long long>(blockIdx.x) * c + col] = cs[j];
            dbi_part[static_cast<long long>(blockIdx.x) * c + col] = cb[j];
        }
    }
    __syncthreads();
    const float inv_d = 1.0f / static_cast<float>(c);
#pragma unroll
    for (int r = 0; r < B2F_BM; ++r) {
        const int row = row0 + r;
        if (row >= m) break;
        float a = 0.f, bb = 0.f;
#pragma unroll
        for (int q = 0; q < THREADS / 32; ++q) {
            a += red[q][r][0];
            bb += red[q][r][1];
        }
        const float m1 = a * inv_d, m2 = bb * inv_d;
        const float mu = stat[r][0], rstd = stat[r][1];
#pragma unroll
        for (int j = 0; j < B2F_NJ; ++j) {
            const int col = tid + THREADS * j;
            if (col < c) {
                const long long off = static_cast<long long>(row) * c + col;
                const float xh = (x[off] - mu) * rstd;
                const float gg = acc[r][j] * s[col];
                dx[off] = rstd * (gg - m1 - xh * m2);
            }
        }
    }
}

int launch_b2_fma(const void* x, const void* dqkv, const void* w, const float* s, const float* b,
                  void* dx, void* xn, float* dsc, float* dbi, int m, int c, float eps,
                  cudaStream_t stream) {
    const int blocks = (m + B2F_BM - 1) / B2F_BM;
    ln_qkv_b2_fma_kernel<<<blocks, THREADS, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(dqkv), static_cast<const float*>(w),
        s, b, static_cast<float*>(dx), static_cast<float*>(xn), dsc, dbi, m, c, eps);
    return passt_launch_status();
}

bool shape_ok(int m, int c) { return m > 0 && c >= 64 && c <= 1024 && c % 64 == 0; }

}  // namespace

// Rows per block of passt_ln_qkv_b2 for a dtype: its dscale/dbias partials
// have ceil(m / rows) rows.
extern "C" int passt_ln_qkv_b2_rows(int dtype) { return dtype == 0 ? B2F_BM : B2_BM; }

// The bf16 B2 kernel's cluster at width c: its CTAs (ncta) and how many
// such clusters the card holds at once (active). Returns a CUDA error code.
extern "C" int passt_ln_qkv_b2_clusters(int c, int* ncta, int* active) {
    if (!shape_ok(1, c)) return static_cast<int>(cudaErrorInvalidValue);
    int q, nb;
    b2_split(c, q, nb);
    switch (nb) {
        case 1: return b2_clusters_n<__nv_bfloat16, 1>(c, ncta, active);
        case 2: return b2_clusters_n<__nv_bfloat16, 2>(c, ncta, active);
        case 3: return b2_clusters_n<__nv_bfloat16, 3>(c, ncta, active);
    }
    return static_cast<int>(cudaErrorInvalidValue);
}

// x [m, c], w [3c, c], wb [3c], out [m, 3c] in dtype (0 float32, 1 bfloat16,
// 2 float16), row-major, 16-byte aligned; s, b [c] float32. c a multiple of
// 64, 64 <= c <= 1024. Returns cudaGetLastError() after the launch.
extern "C" int passt_ln_qkv_f1(const void* x, const void* s, const void* b, const void* w,
                               const void* wb, void* out, int dtype, int m, int c, float eps,
                               void* stream) {
    if (!shape_ok(m, c)) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* sf = static_cast<const float*>(s);
    const float* bf = static_cast<const float*>(b);
    switch (dtype) {
        case 0: return launch_f1_fma(x, sf, bf, w, wb, out, m, c, eps, st);
        case 1: return launch_f1_mma<__nv_bfloat16>(x, sf, bf, w, wb, out, m, c, eps, st);
        case 2: return launch_f1_mma<__half>(x, sf, bf, w, wb, out, m, c, eps, st);
    }
    return static_cast<int>(cudaErrorInvalidValue);
}

// x [m, c], dqkv [m, 3c], w [3c, c], dx and xn [m, c] in dtype, row-major,
// 16-byte aligned; s, b [c] float32; dscale_part, dbias_part
// [ceil(m / passt_ln_qkv_b2_rows(dtype)), c] float32. c as for
// passt_ln_qkv_f1. Returns cudaGetLastError() after the launch.
extern "C" int passt_ln_qkv_b2(const void* x, const void* dqkv, const void* w, const void* s,
                               const void* b, void* dx, void* xn, void* dscale_part,
                               void* dbias_part, int dtype, int m, int c, float eps, void* stream) {
    if (!shape_ok(m, c)) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* sf = static_cast<const float*>(s);
    const float* bf = static_cast<const float*>(b);
    float* dsc = static_cast<float*>(dscale_part);
    float* dbi = static_cast<float*>(dbias_part);
    switch (dtype) {
        case 0: return launch_b2_fma(x, dqkv, w, sf, bf, dx, xn, dsc, dbi, m, c, eps, st);
        case 1: return launch_b2_wgmma<__nv_bfloat16>(x, dqkv, w, sf, bf, dx, xn, dsc, dbi, m, c, eps, st);
        case 2: return launch_b2_wgmma<__half>(x, dqkv, w, sf, bf, dx, xn, dsc, dbi, m, c, eps, st);
    }
    return static_cast<int>(cudaErrorInvalidValue);
}
