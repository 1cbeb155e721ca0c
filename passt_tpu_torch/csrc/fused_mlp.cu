// The fused MLP, fc1 -> tanh-GELU -> fc2 with the hidden activation kept on
// chip, and its dx / dh backward, for Hopper (sm_90a).
//
// Replaces: scripts/proto_mlp_fused.py:_fwd_kernel (passt_fused_mlp_fwd) and
// :_bwd_kernel (passt_fused_mlp_bwd). The port's wrappers are in
// passt_tpu_torch/ops/fused_mlp.py. x [M, C], W1 [C, H], W2 [H, C], b1 [H] and
// b2 [C], all in one dtype T (bfloat16 or float32), row-major.
//
// Forward, per row: h = sum_k x W1 in fp32, plus fp32(b1); g and d = gelu'(h)
// from one tanh (common.cuh gelu, the reference's order); g rounded to T;
// y = sum g W2 in fp32, plus fp32(b2), rounded once to T. With residuals it
// also writes g and d in T; without them it writes only y: h and g never
// reach device memory.
// Backward, per row: dg = dy W2^T in fp32 (on chip only); dh = dg * fp32(d),
// rounded once to T and written; dx = sum dh W1^T in fp32 over that rounded
// dh, rounded once. dW1, dW2 and the bias gradients stay outside (torch
// products), as the reference leaves them to XLA.
//
// What bounds it: operations. At the training token count M = 5688 (C = 768,
// H = 3072) each entry is 4 M C H = 53.68 GFLOP: 0.0543 ms at 989 TFLOP/s
// (bf16). The forward moves 26.9 MB without residuals and 96.8 MB with them
// (0.0080 / 0.0289 ms at 3.35 TB/s); the backward 96.8 MB.
//
// What the design does about it, and what limits this first design:
// - A block owns 16 RW rows (RW = 2, 3 or 4 warps of 16 rows, each beside
//   three more warps for the other column quarters); the reference's
//   [bm, H] hidden block (393 KB at 64 bf16 rows) does not fit in shared
//   memory, so the hidden dimension is walked in slices of HS = 64: compute
//   the slice of h (forward; dg in the backward) for the block's rows, apply
//   the GELU (the d product) in registers, round the slice into a small
//   shared tile, and accumulate its contribution to y (dx) at once. y's fp32
//   accumulator, 16 RW x C, lives in registers: 96 a thread at C = 768.
// - Products on the tensor cores (mma.sync m16n8k16 bf16, fp32 accumulate)
//   from ldmatrix fragments: the forward's weights are [K, N] (ldmatrix
//   .trans), the backward's are read as [N, K] rows (plain ldmatrix). The
//   x (dy) tile stays in shared memory for the whole block.
// - Weights stream through a three-slot cp.async ring in 8 stages a slice:
//   4 of the first product (K = C in quarters) and 4 of the second (16
//   hidden rows each). Rows of x past M are zero-filled; stores are
//   predicated.
// - What limits it (tools/fused_mlp_variants on the card): not the products
//   (removing them saves 10%) but the weight stream and the waves. Every
//   block reads all of W1 and W2 (9.44 MB in bf16) from L2 in 384 stages;
//   one block fits on an SM (134-214 KB of shared memory), so its 8-16 warps
//   hide little of it, and a block takes about as long whatever its rows.
//   So the row block is chosen per call for the fewest waves (row_warps):
//   48 rows at M = 5688 (119 blocks, one wave on 132 SMs; 1.8x faster than
//   32 rows in two), 64 at M = 14280. ptxas: 159-168 registers at RW = 2
//   and 3, no spills; 128 at RW = 4 (its 512-thread cap), 32 bytes of spill
//   stores. A cluster that splits H and shares g through distributed shared
//   memory, and wgmma with TMA, are the later design.
// - fp32 runs on FMA in full fp32 (the reference asks for HIGHEST there; no
//   TF32): x (dy) in shared memory, one thread per (row, hidden unit) for
//   the first product and 4 rows x C/32 columns of y (dx) for the second.
//
// Limits: C a multiple of 64 up to 768, H a multiple of 64 (the wrapper
// raises outside them); any M >= 1.
#include "common.cuh"
#include "attention_common.cuh"

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using passt::cp_async16;
using passt::gelu;
using passt::ldmatrix_x4;
using passt::load2;
using passt::store2;
using passt_attn::cp_async_commit;
using passt_attn::cp_async_wait;
using passt_attn::Mma;

constexpr int HS = 64;        // hidden units per slice
constexpr int HLD = HS + 8;   // the g / dh tile's row pitch (elements)
constexpr int STAGES = 3;     // weight stages in flight
constexpr int SUBS = 8;       // stages a slice: 4 of the first product, 4 of the second
constexpr int NT_MAX = 24;    // n8 tiles of y a warp holds: C / 32 <= 24

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
    const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

// Copy the block's [16 RW, c] rows of a into shared memory (row pitch c + 8),
// zero past m.
template <int RW, typename T>
__device__ __forceinline__ void load_rows(T* dst, const T* __restrict__ a, int row0, int m, int c) {
    constexpr int THREADS = 128 * RW, BM = 16 * RW;
    const int chunks = c / 8;
    for (int idx = threadIdx.x; idx < BM * chunks; idx += THREADS) {
        const int r = idx / chunks, ch = idx - r * chunks;
        const bool ok = row0 + r < m;
        cp_async16(dst + r * (c + 8) + ch * 8, ok ? a + static_cast<long long>(row0 + r) * c + ch * 8 : a,
                   ok ? 16 : 0);
    }
}

// Elements of one ring slot: the larger of the two stage shapes.
__host__ __device__ __forceinline__ int fwd_slot(int c) {
    const int w1 = (c / 4) * HLD, w2 = 16 * (c + 8);
    return w1 > w2 ? w1 : w2;
}
__host__ __device__ __forceinline__ int bwd_slot(int c) {
    const int w2 = HS * (c / 4 + 8), w1 = c * 24;
    return w2 > w1 ? w2 : w1;
}

// ---- forward on the tensor cores -------------------------------------------------

// RW warps of 16 rows, each beside 3 more of the other C/4 column quarters
template <typename T, int RW>
__global__ void __launch_bounds__(128 * RW) fwd_mma_kernel(
    const T* __restrict__ x, const T* __restrict__ w1, const T* __restrict__ b1, const T* __restrict__ w2,
    const T* __restrict__ b2, T* __restrict__ y, T* __restrict__ gout, T* __restrict__ dout, int m, int c, int h,
    int residuals) {
    constexpr int THREADS = 128 * RW, BM = 16 * RW;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int xld = c + 8, bk1 = c / 4, slot = fwd_slot(c);
    T* Xs = reinterpret_cast<T*>(smem_raw);  // [BM][xld]
    T* Gs = Xs + BM * xld;                   // [BM][HLD] the slice of g, rounded
    T* ring = Gs + BM * HLD;                 // [STAGES][slot]
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int row0 = blockIdx.x * BM;
    const int wr = warp % RW, wc = warp / RW;
    const int nt = c / 32, cw0 = wc * (c / 4);
    const int stages = (h / HS) * SUBS;

    // stage st of slice st / 8: sub 0-3 W1[sub bk1 .., j0 .. j0 + HS] as
    // [bk1][HLD]; sub 4-7 W2[j0 + 16 (sub - 4) .., :] as [16][c + 8]
    auto load_stage = [&](int st) {
        if (st >= stages) return;
        const int j0 = (st / SUBS) * HS, sub = st % SUBS;
        T* dst = ring + (st % STAGES) * slot;
        if (sub < 4) {
            const T* src = w1 + static_cast<long long>(sub * bk1) * h + j0;
            for (int idx = tid; idx < bk1 * (HS / 8); idx += THREADS) {
                const int r = idx / (HS / 8), ch = idx % (HS / 8);
                cp_async16(dst + r * HLD + ch * 8, src + static_cast<long long>(r) * h + ch * 8);
            }
        } else {
            const T* src = w2 + static_cast<long long>(j0 + 16 * (sub - 4)) * c;
            const int chunks = c / 8;
            for (int idx = tid; idx < 16 * chunks; idx += THREADS) {
                const int r = idx / chunks, ch = idx - r * chunks;
                cp_async16(dst + r * (c + 8) + ch * 8, src + static_cast<long long>(r) * c + ch * 8);
            }
        }
    };
    load_rows<RW>(Xs, x, row0, m, c);  // in the first group, with stage 0
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        load_stage(s);
        cp_async_commit();
    }

    float acc[NT_MAX][4];
#pragma unroll
    for (int j = 0; j < NT_MAX; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    float hacc[2][4];

    // ldmatrix lane addresses: A rows (lane & 15), k half (lane >> 4); [K, N]
    // B tiles (.trans) k rows (lane & 7) + 8 ((lane >> 3) & 1), n half (lane >> 4)
    const int a_row = wr * 16 + (lane & 15), a_k = (lane >> 4) * 8;
    const int bt_k = (lane & 7) + ((lane >> 3) & 1) * 8, bt_n = (lane >> 4) * 8;
    for (int st = 0; st < stages; ++st) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();  // stage st has landed; every warp is done with stage st - 1
        load_stage(st + STAGES - 1);  // into the slot stage st - 1 used
        cp_async_commit();
        const T* base = ring + (st % STAGES) * slot;
        const int j0 = (st / SUBS) * HS, sub = st % SUBS;
        if (sub < 4) {
            if (sub == 0) {
#pragma unroll
                for (int jn = 0; jn < 2; ++jn) hacc[jn][0] = hacc[jn][1] = hacc[jn][2] = hacc[jn][3] = 0.f;
            }
            // h[:, j0 + 16 wc ..] += x[:, sub bk1 ..] W1 stage
            for (int kk = 0; kk < bk1 / 16; ++kk) {
                uint32_t a[4], bq[4];
                ldmatrix_x4(a, Xs + a_row * xld + sub * bk1 + kk * 16 + a_k);
                ldmatrix_x4_trans(bq, base + (kk * 16 + bt_k) * HLD + wc * 16 + bt_n);
                Mma<T>::mma(hacc[0], a, bq[0], bq[1]);
                Mma<T>::mma(hacc[1], a, bq[2], bq[3]);
            }
            if (sub == 3) {
                // the slice's GELU: g rounded into Gs (read from stage 4 on,
                // after its barrier), and the residuals
#pragma unroll
                for (int jn = 0; jn < 2; ++jn) {
                    const int col = wc * 16 + jn * 8 + 2 * t, hcol = j0 + col;
                    const float2 bb = load2(b1 + hcol);
#pragma unroll
                    for (int hh = 0; hh < 2; ++hh) {
                        const int r = wr * 16 + g + 8 * hh, row = row0 + r;
                        float g0, d0, g1, d1;
                        gelu(__fadd_rn(hacc[jn][2 * hh], bb.x), g0, d0);
                        gelu(__fadd_rn(hacc[jn][2 * hh + 1], bb.y), g1, d1);
                        store2(Gs + r * HLD + col, g0, g1);
                        if (residuals && row < m) {
                            const long long off = static_cast<long long>(row) * h + hcol;
                            store2(gout + off, g0, g1);
                            store2(dout + off, d0, d1);
                        }
                    }
                }
            }
        } else {
            // y += g[:, 16 q ..] W2 stage (16 hidden rows)
            const int q = sub - 4;
            uint32_t a[4];
            ldmatrix_x4(a, Gs + a_row * HLD + q * 16 + a_k);
#pragma unroll
            for (int jp = 0; jp < NT_MAX / 2; ++jp) {
                if (2 * jp < nt) {
                    uint32_t bq[4];
                    ldmatrix_x4_trans(bq, base + bt_k * (c + 8) + cw0 + jp * 16 + bt_n);
                    Mma<T>::mma(acc[2 * jp], a, bq[0], bq[1]);
                    Mma<T>::mma(acc[2 * jp + 1], a, bq[2], bq[3]);
                }
            }
        }
    }
    cp_async_wait<0>();

#pragma unroll
    for (int j = 0; j < NT_MAX; ++j) {
        if (j < nt) {
            const int col = cw0 + j * 8 + 2 * t;
            const float2 bb = load2(b2 + col);
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
                const int row = row0 + wr * 16 + g + 8 * hh;
                if (row < m)
                    store2(y + static_cast<long long>(row) * c + col, __fadd_rn(acc[j][2 * hh], bb.x),
                           __fadd_rn(acc[j][2 * hh + 1], bb.y));
            }
        }
    }
}

// ---- backward on the tensor cores ------------------------------------------------

// RW warps of 16 rows, each beside 3 more of the other C/4 column quarters
template <typename T, int RW>
__global__ void __launch_bounds__(128 * RW) bwd_mma_kernel(
    const T* __restrict__ dy, const T* __restrict__ d, const T* __restrict__ w1, const T* __restrict__ w2,
    T* __restrict__ dx, T* __restrict__ dh, int m, int c, int h) {
    constexpr int THREADS = 128 * RW, BM = 16 * RW;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int yld = c + 8, bk1 = c / 4, w2ld = bk1 + 8, slot = bwd_slot(c);
    T* Ys = reinterpret_cast<T*>(smem_raw);  // [BM][yld]
    T* Hs = Ys + BM * yld;                   // [BM][HLD] the slice of dh, rounded
    T* ring = Hs + BM * HLD;                 // [STAGES][slot]
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int row0 = blockIdx.x * BM;
    const int wr = warp % RW, wc = warp / RW;
    const int nt = c / 32, cw0 = wc * (c / 4);
    const int stages = (h / HS) * SUBS;

    // sub 0-3: W2[j0 .. j0 + HS, sub bk1 ..] as [HS][bk1 + 8] (rows are the
    // hidden units, the product's N); sub 4-7: W1[:, j0 + 16 (sub - 4) ..] as
    // [c][24] (rows are dx's columns)
    auto load_stage = [&](int st) {
        if (st >= stages) return;
        const int j0 = (st / SUBS) * HS, sub = st % SUBS;
        T* dst = ring + (st % STAGES) * slot;
        if (sub < 4) {
            const T* src = w2 + static_cast<long long>(j0) * c + sub * bk1;
            const int chunks = bk1 / 8;
            for (int idx = tid; idx < HS * chunks; idx += THREADS) {
                const int r = idx / chunks, ch = idx - r * chunks;
                cp_async16(dst + r * w2ld + ch * 8, src + static_cast<long long>(r) * c + ch * 8);
            }
        } else {
            const T* src = w1 + j0 + 16 * (sub - 4);
            for (int idx = tid; idx < c * 2; idx += THREADS) {
                const int r = idx >> 1, ch = idx & 1;
                cp_async16(dst + r * 24 + ch * 8, src + static_cast<long long>(r) * h + ch * 8);
            }
        }
    };
    load_rows<RW>(Ys, dy, row0, m, c);
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) {
        load_stage(s);
        cp_async_commit();
    }

    float acc[NT_MAX][4];
#pragma unroll
    for (int j = 0; j < NT_MAX; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    float gacc[2][4];

    // A as in the forward; [N, K] B tiles: n rows (lane & 7) + 8 (lane >> 4),
    // k half ((lane >> 3) & 1)
    const int a_row = wr * 16 + (lane & 15), a_k = (lane >> 4) * 8;
    const int b_n = (lane & 7) + ((lane >> 4) << 3), b_k = ((lane >> 3) & 1) * 8;
    for (int st = 0; st < stages; ++st) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();
        load_stage(st + STAGES - 1);
        cp_async_commit();
        const T* base = ring + (st % STAGES) * slot;
        const int j0 = (st / SUBS) * HS, sub = st % SUBS;
        if (sub < 4) {
            if (sub == 0) {
#pragma unroll
                for (int jn = 0; jn < 2; ++jn) gacc[jn][0] = gacc[jn][1] = gacc[jn][2] = gacc[jn][3] = 0.f;
            }
            // dg[:, j0 + 16 wc ..] += dy[:, sub bk1 ..] W2^T stage
            for (int kk = 0; kk < bk1 / 16; ++kk) {
                uint32_t a[4], bq[4];
                ldmatrix_x4(a, Ys + a_row * yld + sub * bk1 + kk * 16 + a_k);
                ldmatrix_x4(bq, base + (wc * 16 + b_n) * w2ld + kk * 16 + b_k);
                Mma<T>::mma(gacc[0], a, bq[0], bq[1]);
                Mma<T>::mma(gacc[1], a, bq[2], bq[3]);
            }
            if (sub == 3) {
                // dh = dg * d, rounded once: into Hs and out
#pragma unroll
                for (int jn = 0; jn < 2; ++jn) {
                    const int col = wc * 16 + jn * 8 + 2 * t, hcol = j0 + col;
#pragma unroll
                    for (int hh = 0; hh < 2; ++hh) {
                        const int r = wr * 16 + g + 8 * hh, row = row0 + r;
                        const long long off = static_cast<long long>(row) * h + hcol;
                        const float2 dv = row < m ? load2(d + off) : make_float2(0.f, 0.f);
                        const float v0 = __fmul_rn(gacc[jn][2 * hh], dv.x);
                        const float v1 = __fmul_rn(gacc[jn][2 * hh + 1], dv.y);
                        store2(Hs + r * HLD + col, v0, v1);
                        if (row < m) store2(dh + off, v0, v1);
                    }
                }
            }
        } else {
            // dx += dh[:, 16 q ..] W1^T stage
            const int q = sub - 4;
            uint32_t a[4];
            ldmatrix_x4(a, Hs + a_row * HLD + q * 16 + a_k);
#pragma unroll
            for (int jp = 0; jp < NT_MAX / 2; ++jp) {
                if (2 * jp < nt) {
                    uint32_t bq[4];
                    ldmatrix_x4(bq, base + (cw0 + jp * 16 + b_n) * 24 + b_k);
                    Mma<T>::mma(acc[2 * jp], a, bq[0], bq[1]);
                    Mma<T>::mma(acc[2 * jp + 1], a, bq[2], bq[3]);
                }
            }
        }
    }
    cp_async_wait<0>();

#pragma unroll
    for (int j = 0; j < NT_MAX; ++j) {
        if (j < nt) {
            const int col = cw0 + j * 8 + 2 * t;
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
                const int row = row0 + wr * 16 + g + 8 * hh;
                if (row < m) store2(dx + static_cast<long long>(row) * c + col, acc[j][2 * hh], acc[j][2 * hh + 1]);
            }
        }
    }
}

// ---- fp32 on FMA -------------------------------------------------------------------

constexpr int FS = 32;         // hidden units per slice: one per lane
constexpr int FTHREADS = 256;  // 8 warps
constexpr int FBM = 32;        // rows per block: 4 a warp

// Copy the block's rows of a into fp32 shared memory (row pitch c), zero past m.
__device__ __forceinline__ void load_rows_f(float* dst, const float* __restrict__ a, int row0, int m, int c) {
    for (int idx = threadIdx.x; idx < FBM * c; idx += FTHREADS) {
        const int r = idx / c, col = idx - r * c;
        dst[idx] = row0 + r < m ? a[static_cast<long long>(row0 + r) * c + col] : 0.f;
    }
}

// Thread (warp w, lane l) holds rows w + 8 i (i < 4) of the slice's hidden
// unit j0 + l, and of y (dx) the columns l + 32 j (j < c / 32).
__global__ void __launch_bounds__(FTHREADS) fwd_fma_kernel(
    const float* __restrict__ x, const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2, float* __restrict__ y, float* __restrict__ gout,
    float* __restrict__ dout, int m, int c, int h, int residuals) {
    extern __shared__ float smem_f[];
    float* Xs = smem_f;        // [FBM][c]
    float* Gs = Xs + FBM * c;   // [FBM][FS + 1]
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int row0 = blockIdx.x * FBM, nt = c / 32;
    load_rows_f(Xs, x, row0, m, c);
    float acc[4][NT_MAX];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NT_MAX; ++j) acc[i][j] = 0.f;
    for (int j0 = 0; j0 < h; j0 += FS) {
        __syncthreads();  // Xs has landed; every thread is done with the last slice's Gs
        float hv[4] = {0.f, 0.f, 0.f, 0.f};
        for (int k = 0; k < c; ++k) {
            const float wv = w1[static_cast<long long>(k) * h + j0 + lane];
#pragma unroll
            for (int i = 0; i < 4; ++i) hv[i] = fmaf(Xs[(warp + 8 * i) * c + k], wv, hv[i]);
        }
        const float bb = b1[j0 + lane];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int r = warp + 8 * i, row = row0 + r;
            float gv, dv;
            gelu(__fadd_rn(hv[i], bb), gv, dv);
            Gs[r * (FS + 1) + lane] = gv;
            if (residuals && row < m) {
                gout[static_cast<long long>(row) * h + j0 + lane] = gv;
                dout[static_cast<long long>(row) * h + j0 + lane] = dv;
            }
        }
        __syncthreads();
        for (int k = 0; k < FS; ++k) {
            float a[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = Gs[(warp + 8 * i) * (FS + 1) + k];
            const float* wr = w2 + static_cast<long long>(j0 + k) * c + lane;
#pragma unroll
            for (int j = 0; j < NT_MAX; ++j) {
                if (j < nt) {
                    const float wv = wr[32 * j];
#pragma unroll
                    for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(a[i], wv, acc[i][j]);
                }
            }
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = row0 + warp + 8 * i;
        if (row >= m) continue;
#pragma unroll
        for (int j = 0; j < NT_MAX; ++j)
            if (j < nt) y[static_cast<long long>(row) * c + lane + 32 * j] = __fadd_rn(acc[i][j], b2[lane + 32 * j]);
    }
}

__global__ void __launch_bounds__(FTHREADS) bwd_fma_kernel(
    const float* __restrict__ dy, const float* __restrict__ d, const float* __restrict__ w1,
    const float* __restrict__ w2, float* __restrict__ dx, float* __restrict__ dh, int m, int c, int h) {
    extern __shared__ float smem_f[];
    float* Ys = smem_f;                                   // [FBM][c]
    float* Hs = Ys + FBM * c;                              // [FBM][FS + 1]
    float* Ws = Hs + FBM * (FS + 1);                       // W2 slice [FS][c + 1], then W1 slice [c][FS + 1]
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int row0 = blockIdx.x * FBM, nt = c / 32;
    load_rows_f(Ys, dy, row0, m, c);
    float acc[4][NT_MAX];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NT_MAX; ++j) acc[i][j] = 0.f;
    for (int j0 = 0; j0 < h; j0 += FS) {
        __syncthreads();  // every thread is done with the last slice's W1 tile and Hs
        for (int idx = tid; idx < FS * c; idx += FTHREADS) {
            const int r = idx / c, col = idx - r * c;
            Ws[r * (c + 1) + col] = w2[static_cast<long long>(j0 + r) * c + col];
        }
        __syncthreads();
        float gv[4] = {0.f, 0.f, 0.f, 0.f};
        for (int k = 0; k < c; ++k) {
            const float wv = Ws[lane * (c + 1) + k];
#pragma unroll
            for (int i = 0; i < 4; ++i) gv[i] = fmaf(Ys[(warp + 8 * i) * c + k], wv, gv[i]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int r = warp + 8 * i, row = row0 + r;
            const long long off = static_cast<long long>(row) * h + j0 + lane;
            const float v = __fmul_rn(gv[i], row < m ? d[off] : 0.f);
            Hs[r * (FS + 1) + lane] = v;
            if (row < m) dh[off] = v;
        }
        __syncthreads();  // Hs is written; every thread is done with the W2 tile
        for (int idx = tid; idx < c * FS; idx += FTHREADS) {
            const int r = idx / FS, k = idx - r * FS;
            Ws[r * (FS + 1) + k] = w1[static_cast<long long>(r) * h + j0 + k];
        }
        __syncthreads();
        for (int k = 0; k < FS; ++k) {
            float a[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) a[i] = Hs[(warp + 8 * i) * (FS + 1) + k];
#pragma unroll
            for (int j = 0; j < NT_MAX; ++j) {
                if (j < nt) {
                    const float wv = Ws[(lane + 32 * j) * (FS + 1) + k];
#pragma unroll
                    for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(a[i], wv, acc[i][j]);
                }
            }
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = row0 + warp + 8 * i;
        if (row >= m) continue;
#pragma unroll
        for (int j = 0; j < NT_MAX; ++j)
            if (j < nt) dx[static_cast<long long>(row) * c + lane + 32 * j] = acc[i][j];
    }
}

template <typename K, typename... Args>
int launch(K kernel, int threads, int rows, size_t smem, int m, cudaStream_t stream, Args... args) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<(m + rows - 1) / rows, threads, smem, stream>>>(args...);
    return passt_launch_status();
}

// The row block (16 RW rows, RW = 2, 3 or 4) whose number of waves over
// the card's SMs, times a block's time, is least. A block's time hardly
// depends on its rows (every block streams all the weights): measured about
// 7 : 8 : 9 for 32, 48 and 64 rows at C = 768, H = 3072
// (tools/fused_mlp_variants). So M = 5688 takes 48 rows (119 blocks, one
// wave on 132 SMs) and M = 14280 takes 64 (224 blocks, two waves).
int row_warps(int m) {
    int dev = 0, sms = 132;
    if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
        sms = 132;
    int best = 2;
    long long best_cost = -1;
    for (int rw = 2; rw <= 4; ++rw) {
        const long long blocks = (m + 16LL * rw - 1) / (16LL * rw);
        const long long cost = (blocks + sms - 1) / sms * (5 + rw);
        if (best_cost < 0 || cost < best_cost) {
            best_cost = cost;
            best = rw;
        }
    }
    return best;
}

template <typename T, int RW>
int launch_fwd(const void* x, const void* w1, const void* b1, const void* w2, const void* b2, void* y, void* g,
               void* d, int residuals, int m, int c, int h, cudaStream_t st) {
    const size_t smem = sizeof(T) * static_cast<size_t>(16 * RW * (c + 8 + HLD) + STAGES * fwd_slot(c));
    return launch(fwd_mma_kernel<T, RW>, 128 * RW, 16 * RW, smem, m, st, static_cast<const T*>(x),
                  static_cast<const T*>(w1), static_cast<const T*>(b1), static_cast<const T*>(w2),
                  static_cast<const T*>(b2), static_cast<T*>(y), static_cast<T*>(g), static_cast<T*>(d), m, c, h,
                  residuals);
}

template <typename T, int RW>
int launch_bwd(const void* dy, const void* d, const void* w1, const void* w2, void* dx, void* dh, int m, int c, int h,
               cudaStream_t st) {
    const size_t smem = sizeof(T) * static_cast<size_t>(16 * RW * (c + 8 + HLD) + STAGES * bwd_slot(c));
    return launch(bwd_mma_kernel<T, RW>, 128 * RW, 16 * RW, smem, m, st, static_cast<const T*>(dy),
                  static_cast<const T*>(d), static_cast<const T*>(w1), static_cast<const T*>(w2), static_cast<T*>(dx),
                  static_cast<T*>(dh), m, c, h);
}

bool shapes_ok(int m, int c, int h) {
    return m > 0 && c > 0 && c % 64 == 0 && c <= 32 * NT_MAX && h > 0 && h % HS == 0;
}

}  // namespace

// x [m, c], w1 [c, h], b1 [h], w2 [h, c], b2 [c] -> y [m, c] (and, under
// residuals, g and d [m, h]), all in dtype (0 float32, 1 bfloat16),
// contiguous and 16-byte aligned; c a multiple of 64 up to 768, h a multiple
// of 64. Returns cudaGetLastError() after the launch.
// The rows a bfloat16 block takes at M = m on the current card.
extern "C" int passt_fused_mlp_row_block(int m) { return 16 * row_warps(m); }

extern "C" int passt_fused_mlp_fwd(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                                   void* y, void* g, void* d, int residuals, int dtype, int m, int c, int h,
                                   void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (!shapes_ok(m, c, h)) return static_cast<int>(cudaErrorInvalidValue);
    if (dtype == 1) {
        using T = __nv_bfloat16;
        switch (row_warps(m)) {
            case 2: return launch_fwd<T, 2>(x, w1, b1, w2, b2, y, g, d, residuals, m, c, h, st);
            case 3: return launch_fwd<T, 3>(x, w1, b1, w2, b2, y, g, d, residuals, m, c, h, st);
            default: return launch_fwd<T, 4>(x, w1, b1, w2, b2, y, g, d, residuals, m, c, h, st);
        }
    }
    if (dtype == 0) {
        const size_t smem = sizeof(float) * static_cast<size_t>(FBM * c + FBM * (FS + 1));
        return launch(fwd_fma_kernel, FTHREADS, FBM, smem, m, st, static_cast<const float*>(x), static_cast<const float*>(w1),
                      static_cast<const float*>(b1), static_cast<const float*>(w2), static_cast<const float*>(b2),
                      static_cast<float*>(y), static_cast<float*>(g), static_cast<float*>(d), m, c, h, residuals);
    }
    return static_cast<int>(cudaErrorInvalidValue);
}

// dy [m, c], d [m, h], w1 [c, h], w2 [h, c] -> dx [m, c], dh [m, h], all in
// dtype, with the forward's limits.
extern "C" int passt_fused_mlp_bwd(const void* dy, const void* d, const void* w1, const void* w2, void* dx, void* dh,
                                   int dtype, int m, int c, int h, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (!shapes_ok(m, c, h)) return static_cast<int>(cudaErrorInvalidValue);
    if (dtype == 1) {
        using T = __nv_bfloat16;
        switch (row_warps(m)) {
            case 2: return launch_bwd<T, 2>(dy, d, w1, w2, dx, dh, m, c, h, st);
            case 3: return launch_bwd<T, 3>(dy, d, w1, w2, dx, dh, m, c, h, st);
            default: return launch_bwd<T, 4>(dy, d, w1, w2, dx, dh, m, c, h, st);
        }
    }
    if (dtype == 0) {
        const int tile = FS * (c + 1) > c * (FS + 1) ? FS * (c + 1) : c * (FS + 1);
        const size_t smem = sizeof(float) * static_cast<size_t>(FBM * c + FBM * (FS + 1) + tile);
        return launch(bwd_fma_kernel, FTHREADS, FBM, smem, m, st, static_cast<const float*>(dy), static_cast<const float*>(d),
                      static_cast<const float*>(w1), static_cast<const float*>(w2), static_cast<float*>(dx),
                      static_cast<float*>(dh), m, c, h);
    }
    return static_cast<int>(cudaErrorInvalidValue);
}
