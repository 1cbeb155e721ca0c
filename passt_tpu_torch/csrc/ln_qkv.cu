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
// - bf16/fp16 run the products on the tensor cores (mma.sync m16n8k16, fp32
//   accumulate). fp32 runs them on FMA in full fp32 (the JAX package asks
//   for Precision.HIGHEST there): no TF32.
// - F1: a block owns 64 rows and a third of the 3C outputs (q, k or v), so
//   the bench shape gives 89 x 3 blocks. The block computes its rows'
//   statistics once and keeps xn, already rounded, in shared memory
//   ([64][C + 8], 99 KB at C = 768, bf16); it then walks its 128-column
//   output tiles, streaming 128 x 128 tiles of W (64 x 64 where C is not a
//   multiple of 128) through a two-slot cp.async ring. A warp computes 32
//   rows x 32 columns from ldmatrix fragments; the epilogue rounds, adds
//   the bias and stores each tile.
// - B2: the LayerNorm backward needs whole rows of dxn (m1 and m2 are means
//   over C), so a block owns 32 rows and all C columns: its fp32
//   accumulator is 32 x C, spread over 8 warps (16 rows x C/4 columns each,
//   96 registers a thread at C = 768). The K = 3C reduction streams [32 x 32]
//   tiles of dqkv and [32 x C] tiles of W through a three-slot cp.async
//   ring; W's tiles are read as B fragments with ldmatrix.trans. Every
//   block streams all of W (3.5 MB at C = 768, bf16) from L2. The epilogue sums
//   each row over the 4 column warps through shared memory in a fixed order
//   and each column over the 2 row warps the same way: no atomics, so every
//   run gives the same bits.
// - Ragged M: rows past M read as zero and are never stored; they add
//   nothing to the dscale/dbias partials.
#include "common.cuh"
#include "attention_common.cuh"

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

namespace {

using passt_attn::cp_async_commit;
using passt_attn::cp_async_wait;
using passt_attn::from_f;
using passt_attn::ldmatrix_x2_trans;
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

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
    const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

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

// ---- B2 on the tensor cores (bf16 / fp16) ----------------------------------------

constexpr int B2_BM = 32;  // rows per block (the partials' row tile)
constexpr int B2_BK = 32;  // K (= 3C) per stage
constexpr int B2_STAGES = 3;  // stages in flight
constexpr int B2_DLD = B2_BK + 8;  // dqkv tile row pitch (elements)

// NT_MAX: the most n8 tiles a warp holds (C / 32 of them, C <= 32 NT_MAX).
template <typename T, int NT_MAX>
__global__ void __launch_bounds__(THREADS) ln_qkv_b2_mma_kernel(
    const T* __restrict__ x, const T* __restrict__ dqkv, const T* __restrict__ w,
    const float* __restrict__ s, const float* __restrict__ b, T* __restrict__ dx,
    T* __restrict__ xn, float* __restrict__ dsc_part, float* __restrict__ dbi_part, int m, int c,
    float eps) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int wld = c + 8;  // W tile row pitch (elements)
    const int stage_elems = B2_BM * B2_DLD + B2_BK * wld;  // a stage: the dqkv tile, then W's
    T* ring = reinterpret_cast<T*>(smem_raw);  // [B2_STAGES][stage_elems]
    __shared__ float stat[B2_BM][2];           // mu, rstd of the block's rows

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int row0 = blockIdx.x * B2_BM;
    const int c3 = 3 * c;
    const int nt = c / 32;  // n8 tiles a warp holds
    const int wr = warp & 1, wc = warp >> 1;  // 16 rows x C/4 columns a warp
    const int cw0 = wc * (c / 4);
    const int stages = c3 / B2_BK;

    auto load_stage = [&](int st) {
        if (st >= stages) return;
        const int k0 = st * B2_BK;
        T* dd = ring + (st % B2_STAGES) * stage_elems;
        for (int idx = tid; idx < B2_BM * (B2_BK / 8); idx += THREADS) {
            const int r = idx / (B2_BK / 8), ch = idx % (B2_BK / 8);
            const bool valid = row0 + r < m;
            cp_async16(dd + r * B2_DLD + ch * 8,
                       valid ? dqkv + static_cast<long long>(row0 + r) * c3 + k0 + ch * 8 : dqkv,
                       valid ? 16 : 0);
        }
        T* dw = dd + B2_BM * B2_DLD;
        const int chunks = c / 8;
        for (int idx = tid; idx < B2_BK * chunks; idx += THREADS) {
            const int r = idx / chunks, ch = idx - r * chunks;
            cp_async16(dw + r * wld + ch * 8, w + static_cast<long long>(k0 + r) * c + ch * 8);
        }
    };
#pragma unroll
    for (int st = 0; st < B2_STAGES - 1; ++st) {
        load_stage(st);
        cp_async_commit();
    }

    // the statistics of the block's rows, and xn (4 rows a warp)
    for (int r = warp; r < B2_BM; r += THREADS / 32) {
        const int row = row0 + r;
        float mu = 0.f, rstd = 0.f;
        if (row < m) {
            const T* xr = x + static_cast<long long>(row) * c;
            row_stats(xr, c, eps, mu, rstd);
            T* xo = xn + static_cast<long long>(row) * c;
            for (int col = 2 * lane; col < c; col += 64) {
                const float2 v = load2(xr + col);
                store2(xo + col, ln_affine(v.x, mu, rstd, s[col], b[col]),
                       ln_affine(v.y, mu, rstd, s[col + 1], b[col + 1]));
            }
        }
        if (lane == 0) {
            stat[r][0] = mu;
            stat[r][1] = rstd;
        }
    }

    float acc[NT_MAX][4];
#pragma unroll
    for (int j = 0; j < NT_MAX; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

    // ldmatrix lane addresses: A rows (lane & 15), k half (lane >> 4); W
    // (k-major) rows (lane & 7) + 8 ((lane >> 3) & 1), column half (lane >> 4)
    const int a_off = (wr * 16 + (lane & 15)) * B2_DLD + (lane >> 4) * 8;
    const int b_off = B2_BM * B2_DLD + ((lane & 7) + ((lane >> 3) & 1) * 8) * wld + cw0 + (lane >> 4) * 8;
    for (int st = 0; st < stages; ++st) {
        cp_async_wait<B2_STAGES - 2>();
        __syncthreads();  // stage st has landed; every warp is done with stage st - 1
        load_stage(st + B2_STAGES - 1);  // into the slot stage st - 1 used
        cp_async_commit();
        const T* base = ring + (st % B2_STAGES) * stage_elems;
#pragma unroll
        for (int kk = 0; kk < B2_BK / 16; ++kk) {
            uint32_t a[4];
            ldmatrix_x4(a, base + a_off + kk * 16);
#pragma unroll
            for (int jp = 0; jp < NT_MAX / 2; ++jp) {
                if (2 * jp < nt) {
                    uint32_t bq[4];  // b0, b1 of n8 tile 2 jp, then of 2 jp + 1
                    ldmatrix_x4_trans(bq, base + b_off + kk * 16 * wld + jp * 16);
                    Mma<T>::mma(acc[2 * jp], a, bq[0], bq[1]);
                    Mma<T>::mma(acc[2 * jp + 1], a, bq[2], bq[3]);
                }
            }
        }
    }
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with the ring

    // epilogue; the staging buffers are free now
    float* rowred = reinterpret_cast<float*>(smem_raw);  // [4 column warps][B2_BM][2]
    float* colred = rowred + 4 * B2_BM * 2;              // [2 row warps][2][c]
    const float inv_d = 1.0f / static_cast<float>(c);
    int rl[2];
    float mu[2], rstd[2], s1[2] = {0.f, 0.f}, s2[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        rl[h] = wr * 16 + g + 8 * h;
        mu[h] = stat[rl[h]][0];
        rstd[h] = stat[rl[h]][1];
    }
    const bool valid[2] = {row0 + rl[0] < m, row0 + rl[1] < m};

    // row sums of g and g x_hat; column sums of dxn x_hat and dxn
#pragma unroll
    for (int j = 0; j < NT_MAX; ++j) {
        if (j < nt) {
            const int col = cw0 + j * 8 + 2 * t;
            const float sc0 = s[col], sc1 = s[col + 1];
            float cs[2] = {0.f, 0.f}, cb[2] = {0.f, 0.f};
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                float2 xv = make_float2(0.f, 0.f);
                if (valid[h]) xv = load2(x + static_cast<long long>(row0 + rl[h]) * c + col);
                const float xh0 = valid[h] ? (xv.x - mu[h]) * rstd[h] : 0.f;
                const float xh1 = valid[h] ? (xv.y - mu[h]) * rstd[h] : 0.f;
                const float d0 = acc[j][2 * h], d1 = acc[j][2 * h + 1];
                const float g0 = d0 * sc0, g1 = d1 * sc1;
                s1[h] += g0 + g1;
                s2[h] += g0 * xh0 + g1 * xh1;
                cs[0] += d0 * xh0;
                cs[1] += d1 * xh1;
                cb[0] += d0;
                cb[1] += d1;
            }
#pragma unroll
            for (int off = 4; off < 32; off <<= 1) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    cs[e] += __shfl_xor_sync(0xffffffffu, cs[e], off);
                    cb[e] += __shfl_xor_sync(0xffffffffu, cb[e], off);
                }
            }
            if (g == 0) {
                colred[(wr * 2 + 0) * c + col] = cs[0];
                colred[(wr * 2 + 0) * c + col + 1] = cs[1];
                colred[(wr * 2 + 1) * c + col] = cb[0];
                colred[(wr * 2 + 1) * c + col + 1] = cb[1];
            }
        }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
            s1[h] += __shfl_xor_sync(0xffffffffu, s1[h], off);
            s2[h] += __shfl_xor_sync(0xffffffffu, s2[h], off);
        }
        if (t == 0) {
            rowred[(wc * B2_BM + rl[h]) * 2 + 0] = s1[h];
            rowred[(wc * B2_BM + rl[h]) * 2 + 1] = s2[h];
        }
    }
    __syncthreads();

    for (int col = tid; col < c; col += THREADS) {
        dsc_part[static_cast<long long>(blockIdx.x) * c + col] = colred[0 * c + col] + colred[2 * c + col];
        dbi_part[static_cast<long long>(blockIdx.x) * c + col] = colred[1 * c + col] + colred[3 * c + col];
    }

    float m1[2], m2[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
        float a = 0.f, bb = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            a += rowred[(q * B2_BM + rl[h]) * 2 + 0];
            bb += rowred[(q * B2_BM + rl[h]) * 2 + 1];
        }
        m1[h] = a * inv_d;
        m2[h] = bb * inv_d;
    }
#pragma unroll
    for (int j = 0; j < NT_MAX; ++j) {
        if (j < nt) {
            const int col = cw0 + j * 8 + 2 * t;
            const float sc0 = s[col], sc1 = s[col + 1];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                if (!valid[h]) continue;
                const long long off = static_cast<long long>(row0 + rl[h]) * c + col;
                const float2 xv = load2(x + off);
                const float xh0 = (xv.x - mu[h]) * rstd[h], xh1 = (xv.y - mu[h]) * rstd[h];
                const float g0 = acc[j][2 * h] * sc0, g1 = acc[j][2 * h + 1] * sc1;
                store2(dx + off, rstd[h] * (g0 - m1[h] - xh0 * m2[h]),
                       rstd[h] * (g1 - m1[h] - xh1 * m2[h]));
            }
        }
    }
}

template <typename T, int NT_MAX>
int launch_b2_mma_n(const void* x, const void* dqkv, const void* w, const float* s, const float* b,
                    void* dx, void* xn, float* dsc, float* dbi, int m, int c, float eps,
                    cudaStream_t stream) {
    const size_t staging = sizeof(T) * static_cast<size_t>(B2_STAGES * (B2_BM * B2_DLD + B2_BK * (c + 8)));
    const size_t reduce = sizeof(float) * static_cast<size_t>(4 * B2_BM * 2 + 4 * c);
    const size_t smem = staging > reduce ? staging : reduce;
    auto kernel = ln_qkv_b2_mma_kernel<T, NT_MAX>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int blocks = (m + B2_BM - 1) / B2_BM;
    kernel<<<blocks, THREADS, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(dqkv), static_cast<const T*>(w), s, b,
        static_cast<T*>(dx), static_cast<T*>(xn), dsc, dbi, m, c, eps);
    return passt_launch_status();
}

template <typename T>
int launch_b2_mma(const void* x, const void* dqkv, const void* w, const float* s, const float* b,
                  void* dx, void* xn, float* dsc, float* dbi, int m, int c, float eps,
                  cudaStream_t stream) {
    const int nt = c / 32;
    if (nt <= 8) return launch_b2_mma_n<T, 8>(x, dqkv, w, s, b, dx, xn, dsc, dbi, m, c, eps, stream);
    if (nt <= 16) return launch_b2_mma_n<T, 16>(x, dqkv, w, s, b, dx, xn, dsc, dbi, m, c, eps, stream);
    if (nt <= 24) return launch_b2_mma_n<T, 24>(x, dqkv, w, s, b, dx, xn, dsc, dbi, m, c, eps, stream);
    return launch_b2_mma_n<T, 32>(x, dqkv, w, s, b, dx, xn, dsc, dbi, m, c, eps, stream);
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
        case 1: return launch_b2_mma<__nv_bfloat16>(x, dqkv, w, sf, bf, dx, xn, dsc, dbi, m, c, eps, st);
        case 2: return launch_b2_mma<__half>(x, dqkv, w, sf, bf, dx, xn, dsc, dbi, m, c, eps, st);
    }
    return static_cast<int>(cudaErrorInvalidValue);
}
