// LayerNorm backward for Hopper (sm_90a): one pass over (x, dy) per row.
//
// Replaces: passt_tpu/ops/pallas/layernorm.py:_bwd_kernel. The port's
// wrapper is passt_tpu_torch/ops/layernorm.py (layer_norm_bwd).
//
// Per row, with the forward's saved mu and rstd (nothing is recomputed):
//   x_hat = (x - mu) * rstd,  g = dy * scale
//   m1 = sum(g) / C,  m2 = sum(g * x_hat) / C
//   dx = rstd * (g - m1 - x_hat * m2)            rounded to x's dtype
// and over the rows, dscale = sum(dy * x_hat), dbias = sum(dy).
//
// What bounds it: bytes. It reads x (2 or 4 B) and dy (fp32) once and writes
// dx once, about 10 FLOP per element: at the training step's shape
// (M = 5688 rows of C = 768, bf16 x) 34.9 MB against 0.04 GFLOP.
//
// What the design does about it:
// - One warp per row, the row in registers: each lane holds pairs of
//   neighbouring columns (2 * lane + 64 p), so a warp reads 128 B (bf16) or
//   256 B (fp32 dy) per load and x and dy are read exactly once. The two row
//   sums are warp shuffles.
// - A block owns 32 rows (8 warps, 4 rows each). Each lane keeps its
//   columns' dscale/dbias sums over its warp's rows in registers; the block
//   adds its 8 warps' sums through shared memory in a fixed order and writes
//   one [C] partial per block. No atomics: every run gives the same bits.
//   The wrapper sums the [G, C] partials (G = ceil(M / 32)), as the JAX
//   package sums its per-tile partials outside its kernel.
// - Ragged M: a warp stops at the last row; its sums hold only real rows.
#include "common.cuh"

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = 32;  // rows per block: the dscale/dbias partials' row tile

using passt::load2;
using passt::store2;
using passt::warp_sum;

// NP: column pairs per lane (64 columns per pair index); columns past c are
// masked.
template <typename T, int NP>
__global__ void __launch_bounds__(THREADS) layernorm_bwd_kernel(
    const T* __restrict__ x, const float* __restrict__ dy, const float* __restrict__ mu,
    const float* __restrict__ rstd, const float* __restrict__ scale, T* __restrict__ dx,
    float* __restrict__ dscale_part, float* __restrict__ dbias_part, int m, int c) {
    extern __shared__ float red[];  // [2][WARPS][c]: the warps' dscale, then dbias sums
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const float inv_d = 1.0f / static_cast<float>(c);

    float sc[NP][2], dsc[NP][2], dbi[NP][2];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
        const int col = p * 64 + 2 * lane;
        const float2 s = col < c ? load2(scale + col) : make_float2(0.f, 0.f);
        sc[p][0] = s.x;
        sc[p][1] = s.y;
        dsc[p][0] = dsc[p][1] = dbi[p][0] = dbi[p][1] = 0.f;
    }

    for (int i = 0; i < ROWS / WARPS; ++i) {
        const int row = blockIdx.x * ROWS + i * WARPS + warp;
        if (row >= m) break;
        const float mu_r = mu[row], rs = rstd[row];
        const T* xr = x + static_cast<long long>(row) * c;
        const float* dyr = dy + static_cast<long long>(row) * c;
        float xh[NP][2], g[NP][2];
        float s1 = 0.f, s2 = 0.f;
#pragma unroll
        for (int p = 0; p < NP; ++p) {
            const int col = p * 64 + 2 * lane;
            if (col < c) {
                const float2 xv = load2(xr + col);
                const float2 dv = load2(dyr + col);
                xh[p][0] = (xv.x - mu_r) * rs;
                xh[p][1] = (xv.y - mu_r) * rs;
                g[p][0] = dv.x * sc[p][0];
                g[p][1] = dv.y * sc[p][1];
                s1 += g[p][0] + g[p][1];
                s2 += g[p][0] * xh[p][0] + g[p][1] * xh[p][1];
                dsc[p][0] += dv.x * xh[p][0];
                dsc[p][1] += dv.y * xh[p][1];
                dbi[p][0] += dv.x;
                dbi[p][1] += dv.y;
            } else {
                xh[p][0] = xh[p][1] = g[p][0] = g[p][1] = 0.f;
            }
        }
        const float m1 = warp_sum(s1) * inv_d;
        const float m2 = warp_sum(s2) * inv_d;
        T* dxr = dx + static_cast<long long>(row) * c;
#pragma unroll
        for (int p = 0; p < NP; ++p) {
            const int col = p * 64 + 2 * lane;
            if (col < c)
                store2(dxr + col, rs * (g[p][0] - m1 - xh[p][0] * m2),
                       rs * (g[p][1] - m1 - xh[p][1] * m2));
        }
    }

#pragma unroll
    for (int p = 0; p < NP; ++p) {
        const int col = p * 64 + 2 * lane;
        if (col < c) {
            store2(red + warp * c + col, dsc[p][0], dsc[p][1]);
            store2(red + (WARPS + warp) * c + col, dbi[p][0], dbi[p][1]);
        }
    }
    __syncthreads();
    for (int col = threadIdx.x; col < c; col += THREADS) {
        float a = 0.f, b = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
            a += red[w * c + col];
            b += red[(WARPS + w) * c + col];
        }
        dscale_part[static_cast<long long>(blockIdx.x) * c + col] = a;
        dbias_part[static_cast<long long>(blockIdx.x) * c + col] = b;
    }
}

template <typename T, int NP>
int launch(const void* x, const float* dy, const float* mu, const float* rstd, const float* scale,
           void* dx, float* dsc, float* dbi, int m, int c, cudaStream_t stream) {
    const size_t smem = 2 * WARPS * static_cast<size_t>(c) * sizeof(float);
    auto kernel = layernorm_bwd_kernel<T, NP>;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int blocks = (m + ROWS - 1) / ROWS;
    kernel<<<blocks, THREADS, smem, stream>>>(static_cast<const T*>(x), dy, mu, rstd, scale,
                                              static_cast<T*>(dx), dsc, dbi, m, c);
    return passt_launch_status();
}

template <typename T>
int launch_c(const void* x, const float* dy, const float* mu, const float* rstd, const float* scale,
             void* dx, float* dsc, float* dbi, int m, int c, cudaStream_t stream) {
    const int pairs = (c + 63) / 64;
#define PASST_LN_CASE(NP) \
    if (pairs <= NP) return launch<T, NP>(x, dy, mu, rstd, scale, dx, dsc, dbi, m, c, stream);
    PASST_LN_CASE(1)
    PASST_LN_CASE(2)
    PASST_LN_CASE(4)
    PASST_LN_CASE(6)
    PASST_LN_CASE(8)
    PASST_LN_CASE(12)
    PASST_LN_CASE(16)
#undef PASST_LN_CASE
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Rows per block of passt_layernorm_bwd: its partials have ceil(m / rows) rows.
extern "C" int passt_layernorm_bwd_rows() { return ROWS; }

// x, dx: [m, c] row-major in dtype (0 float32, 1 bfloat16, 2 float16); dy:
// [m, c] float32; mu, rstd: [m] float32; scale: [c] float32; dscale_part and
// dbias_part: [ceil(m / passt_layernorm_bwd_rows()), c] float32. c a multiple
// of 8, at most 1024.
// Returns cudaGetLastError() after the launch.
extern "C" int passt_layernorm_bwd(const void* x, const void* dy, const void* mu, const void* rstd,
                                   const void* scale, void* dx, void* dscale_part,
                                   void* dbias_part, int dtype, int m, int c, void* stream) {
    if (m <= 0 || c <= 0 || c % 8 != 0 || c > 1024) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* dyf = static_cast<const float*>(dy);
    const float* muf = static_cast<const float*>(mu);
    const float* rsf = static_cast<const float*>(rstd);
    const float* scf = static_cast<const float*>(scale);
    float* dsc = static_cast<float*>(dscale_part);
    float* dbi = static_cast<float*>(dbias_part);
    switch (dtype) {
        case 0: return launch_c<float>(x, dyf, muf, rsf, scf, dx, dsc, dbi, m, c, st);
        case 1: return launch_c<__nv_bfloat16>(x, dyf, muf, rsf, scf, dx, dsc, dbi, m, c, st);
        case 2: return launch_c<__half>(x, dyf, muf, rsf, scf, dx, dsc, dbi, m, c, st);
    }
    return static_cast<int>(cudaErrorInvalidValue);
}
