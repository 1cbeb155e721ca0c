// Attention backward for Hopper (sm_90a): dq, dk, dv of
// o = softmax(q k^T * scale) v, with the probabilities recomputed from q and k.
//
// Replaces: passt_tpu/ops/pallas/attention.py:_bwd_kernel (:188, the VJP of
// fused_attention on [B, H, N, D]) and :_flat_bwd_kernel (:388, the VJP of
// fused_attention_qkv, writing dqkv [B, N, 3C] in the Dense layout). One
// kernel pair serves both: every operand arrives as a base pointer with
// (batch, token, head) strides, so q/k/v views into qkv are read, and
// dq/dk/dv views into dqkv are written, in place. The port's wrappers are in
// passt_tpu_torch/ops/attention.py.
//
// The math is the reference kernel's, row for row:
//   s = fp32 (q . k) * scale; m = row max (clamped at 0 under plus1);
//   p = exp(s - m); l = sum p (+ exp(-m) under plus1); il = 1 / l;
//   dP = dO . v (fp32 accumulate);  di = sum(p * dP) * il  (the unrounded p:
//   not FlashAttention's rowsum(dO * O), O was rounded to the input dtype);
//   dS = (p * il) * (dP - di) * scale, rounded to the input dtype;
//   dQ = dS . k, dK = dS^T . q (fp32 accumulate, stored in the input dtype);
//   dV = (p * il)^T . dO.
// The plus1 column is constant, so it changes only m and l.
// dV's left operand: the reference forms dO * il in fp32 and contracts it
// with the fp32 p (exact in interpret mode; the TPU's MXU at DEFAULT
// precision rounds both to bf16). Here P_norm = p * il is rounded once to the
// input dtype, as the forward rounds p for PV, and dO enters as stored, so
// the bf16/fp16 products run on the tensor cores. For fp32 inputs the
// rounding is the identity and everything is fp32.
//
// What bounds it: arithmetic. The function is five N x N x D products per
// head (scores, dP, dV, dQ, dK: 10 N^2 D FLOP) against 4 N D input and 3 N D
// output elements; at the training shape (bf16, B = 12, H = 12, N = 474,
// D = 64) that is 20.7 GFLOP against ~61 MB, 0.021 ms at 989 TFLOP/s.
//
// Design: two kernels, no atomics, so every run gives the same bits.
// - Kernel A, one block per (batch, head, 64-query tile), three passes over
//   the K/V tiles: (1) the row max m; (2) l and sum(p * dP); (3) dS and
//   dQ += dS . k. It writes m, il and di ([3][B*H][N rounded up to 64] fp32
//   scratch the wrapper allocates) for kernel B.
// - Kernel B, one block per (batch, head, 64-key tile), one pass over the
//   query tiles: recompute p^T = exp(k . q * scale - m) from the saved m,
//   dP^T = v . dO, then dV += P_norm^T . dO and dK += dS^T . q in registers.
// Scores are recomputed 4 times (3 in A, 1 in B) and dP 3 times: 20 N^2 D
// FLOP against the function's 10, the price of no [N, N] scratch and no
// atomics.
// - bf16/fp16 with D a multiple of 16 and 16-byte aligned rows (the model's
//   path): four warps of 16 rows each, mma.sync m16n8k16 with fp32
//   accumulate. The warp's own 16 rows (q and dO in A; k and v in B) stay in
//   registers as A fragments; the streamed tiles go through padded shared
//   memory, double-buffered with cp.async. Score accumulators become the A
//   fragments of the next product after rounding, without a trip through
//   shared memory. 16 columns of scores are live at a time.
// - fp32 inputs (full fp32 on the TPU: no TF32 here), other D and unaligned
//   strides: fp32 FMA from shared memory, 256 threads, 4 x 4 scores each.
// - Ragged N: keys past N get p = 0 in A, queries past N get p = dS = 0 in
//   B, rows past N are not stored. There is no cap on N.
#include "common.cuh"
#include "attention_common.cuh"

#include <math.h>
#include <stdint.h>

namespace {

using namespace passt_attn;

// The saved row statistics: m, il and di planes of [B*H][npad] floats.
struct Stats {
    float* base;
    long long plane;  // B * H * npad
    int npad;         // N rounded up to the tile size
};

// ---- fp32 FMA path ----------------------------------------------------------

template <typename T, int DJ>
__global__ void __launch_bounds__(FMA_THREADS) attention_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, T* __restrict__ dq, Strides qs, Strides ks, Strides vs,
    Strides dos, Strides dqs, Stats st, int n, int d, float scale, int plus1) {
    extern __shared__ float smem[];
    const int ld = d + 1;
    float* Qs = smem;            // [BQ][ld]
    float* dOs = Qs + BQ * ld;   // [BQ][ld]
    float* Ks = dOs + BQ * ld;   // [BK][ld]
    float* Vs = Ks + BK * ld;    // [BK][ld]
    float* DS = Vs + BK * ld;    // [BQ][BK + 1] dS rounded to T

    const int tid = threadIdx.x;
    const int tk = tid & 15, tq = tid >> 4;  // lanes 0-15 / 16-31 of a warp share a query row
    const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * BQ;
    const long long bh = (long long)b * gridDim.y + h;

    const T* qb = q + b * qs.b + h * qs.h;
    const T* kb = k + b * ks.b + h * ks.h;
    const T* vb = v + b * vs.b + h * vs.h;
    const T* dob = dout + b * dos.b + h * dos.h;
    T* dqb = dq + b * dqs.b + h * dqs.h;

    load_tile(Qs, ld, qb, qs.n, q0, n, d);
    load_tile(dOs, ld, dob, dos.n, q0, n, d);

    float s[4][4], dp[4][4];

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

    // Pass 2: l = sum p and sum(p * dP).
    float l[4] = {0.f, 0.f, 0.f, 0.f}, pdp[4] = {0.f, 0.f, 0.f, 0.f};
    for (int k0 = 0; k0 < n; k0 += BK) {
        __syncthreads();
        load_tile(Ks, ld, kb, ks.n, k0, n, d);
        load_tile(Vs, ld, vb, vs.n, k0, n, d);
        __syncthreads();
        tile_scores(s, Qs, Ks, ld, d, tq, tk);
        tile_scores(dp, dOs, Vs, ld, d, tq, tk);
#pragma unroll
        for (int j = 0; j < 4; ++j)
            if (k0 + tk + 16 * j < n)
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const float p = expf(__fmul_rn(s[i][j], scale) - m[i]);
                    l[i] += p;
                    pdp[i] = fmaf(p, dp[i][j], pdp[i]);
                }
    }
    float il[4], di[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) {
            l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
            pdp[i] += __shfl_xor_sync(0xffffffffu, pdp[i], off);
        }
        if (plus1) l[i] += expf(-m[i]);
        il[i] = 1.f / l[i];
        di[i] = pdp[i] * il[i];
    }

    // Pass 3: dS, rounded to T, and dQ += dS . k.
    float acc[4][DJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < n; k0 += BK) {
        __syncthreads();
        load_tile(Ks, ld, kb, ks.n, k0, n, d);
        load_tile(Vs, ld, vb, vs.n, k0, n, d);
        __syncthreads();
        tile_scores(s, Qs, Ks, ld, d, tq, tk);
        tile_scores(dp, dOs, Vs, ld, d, tq, tk);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                float ds = 0.f;
                if (k0 + tk + 16 * j < n) {
                    const float p = expf(__fmul_rn(s[i][j], scale) - m[i]);
                    ds = round_to<T>(p * il[i] * (dp[i][j] - di[i]) * scale);
                }
                DS[(tq + 16 * i) * (BK + 1) + tk + 16 * j] = ds;
            }
        __syncthreads();
        const int kmax = min(BK, n - k0);
        for (int kk = 0; kk < kmax; ++kk) {
            float da[4], ka[DJ];
#pragma unroll
            for (int i = 0; i < 4; ++i) da[i] = DS[(tq + 16 * i) * (BK + 1) + kk];
#pragma unroll
            for (int j = 0; j < DJ; ++j) {
                const int c = tk + 16 * j;
                ka[j] = c < d ? Ks[kk * ld + c] : 0.f;
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(da[i], ka[j], acc[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = q0 + tq + 16 * i;
        if (tk == 0) {  // rows up to npad: kernel B reads whole tiles
            st.base[bh * st.npad + row] = m[i];
            st.base[st.plane + bh * st.npad + row] = il[i];
            st.base[2 * st.plane + bh * st.npad + row] = di[i];
        }
        if (row >= n) continue;
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
            const int c = tk + 16 * j;
            if (c < d) dqb[(long long)row * dqs.n + c] = from_f<T>(acc[i][j]);
        }
    }
}

template <typename T, int DJ>
__global__ void __launch_bounds__(FMA_THREADS) attention_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, T* __restrict__ dk, T* __restrict__ dv, Strides qs, Strides ks,
    Strides vs, Strides dos, Strides dks, Strides dvs, Stats st, int n, int d, float scale) {
    extern __shared__ float smem[];
    const int ld = d + 1;
    float* Ks = smem;                // [BK][ld]
    float* Vs = Ks + BK * ld;        // [BK][ld]
    float* Qs = Vs + BK * ld;        // [BQ][ld]
    float* dOs = Qs + BQ * ld;       // [BQ][ld]
    float* PN = dOs + BQ * ld;       // [BK][BQ + 1] P_norm^T rounded to T
    float* DS = PN + BK * (BQ + 1);  // [BK][BQ + 1] dS^T rounded to T
    float* Sm = DS + BK * (BQ + 1);  // [3][BQ] m, il, di of the query tile

    const int tid = threadIdx.x;
    const int tq = tid & 15, tkey = tid >> 4;  // keys tkey + 16 i, queries tq + 16 j
    const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * BK;
    const long long bh = (long long)b * gridDim.y + h;

    const T* qb = q + b * qs.b + h * qs.h;
    const T* kb = k + b * ks.b + h * ks.h;
    const T* vb = v + b * vs.b + h * vs.h;
    const T* dob = dout + b * dos.b + h * dos.h;
    T* dkb = dk + b * dks.b + h * dks.h;
    T* dvb = dv + b * dvs.b + h * dvs.h;

    load_tile(Ks, ld, kb, ks.n, k0, n, d);
    load_tile(Vs, ld, vb, vs.n, k0, n, d);

    float sT[4][4], dpT[4][4];
    float dka[4][DJ], dva[4][DJ];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) dka[i][j] = dva[i][j] = 0.f;

    for (int q0 = 0; q0 < n; q0 += BQ) {
        __syncthreads();
        load_tile(Qs, ld, qb, qs.n, q0, n, d);
        load_tile(dOs, ld, dob, dos.n, q0, n, d);
        for (int idx = tid; idx < 3 * BQ; idx += FMA_THREADS) {
            const int plane = idx / BQ;
            Sm[idx] = st.base[plane * st.plane + bh * st.npad + q0 + idx - plane * BQ];
        }
        __syncthreads();
        tile_scores(sT, Ks, Qs, ld, d, tkey, tq);
        tile_scores(dpT, Vs, dOs, ld, d, tkey, tq);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int qi = tq + 16 * j;
            const bool valid = q0 + qi < n;
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                float pn = 0.f, ds = 0.f;
                if (valid) {
                    pn = expf(__fmul_rn(sT[i][j], scale) - Sm[qi]) * Sm[BQ + qi];
                    ds = pn * (dpT[i][j] - Sm[2 * BQ + qi]) * scale;
                }
                PN[(tkey + 16 * i) * (BQ + 1) + qi] = round_to<T>(pn);
                DS[(tkey + 16 * i) * (BQ + 1) + qi] = round_to<T>(ds);
            }
        }
        __syncthreads();
        const int qmax = min(BQ, n - q0);
        for (int qq = 0; qq < qmax; ++qq) {
            float pa[4], da[4], oa[DJ], qa[DJ];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                pa[i] = PN[(tkey + 16 * i) * (BQ + 1) + qq];
                da[i] = DS[(tkey + 16 * i) * (BQ + 1) + qq];
            }
#pragma unroll
            for (int j = 0; j < DJ; ++j) {
                const int c = tq + 16 * j;
                oa[j] = c < d ? dOs[qq * ld + c] : 0.f;
                qa[j] = c < d ? Qs[qq * ld + c] : 0.f;
            }
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < DJ; ++j) {
                    dva[i][j] = fmaf(pa[i], oa[j], dva[i][j]);
                    dka[i][j] = fmaf(da[i], qa[j], dka[i][j]);
                }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = k0 + tkey + 16 * i;
        if (row >= n) continue;
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
            const int c = tq + 16 * j;
            if (c < d) {
                dkb[(long long)row * dks.n + c] = from_f<T>(dka[i][j]);
                dvb[(long long)row * dvs.n + c] = from_f<T>(dva[i][j]);
            }
        }
    }
}

size_t fma_dq_smem(int d) {
    return sizeof(float) * (size_t)(4 * BQ * (d + 1) + BQ * (BK + 1));
}

size_t fma_dkv_smem(int d) {
    return sizeof(float) * (size_t)(4 * BQ * (d + 1) + 2 * BK * (BQ + 1) + 3 * BQ);
}

struct Args {
    const void *q, *k, *v, *dout;
    void *dq, *dk, *dv;
    Strides qs, ks, vs, dos, dqs, dks, dvs;
    Stats st;
    int batch, n, heads, d;
    float scale;
    int plus1;
    cudaStream_t stream;
};

template <typename K>
int set_smem(K kernel, size_t bytes) {
    return static_cast<int>(
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes));
}

template <typename T, int DJ>
int launch_fma(const Args& a) {
    const dim3 grid_q((a.n + BQ - 1) / BQ, a.heads, a.batch);
    const dim3 grid_k((a.n + BK - 1) / BK, a.heads, a.batch);
    auto ka = attention_bwd_dq_kernel<T, DJ>;
    auto kb = attention_bwd_dkv_kernel<T, DJ>;
    int err = set_smem(ka, fma_dq_smem(a.d));
    if (err) return err;
    err = set_smem(kb, fma_dkv_smem(a.d));
    if (err) return err;
    ka<<<grid_q, FMA_THREADS, fma_dq_smem(a.d), a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const T*>(a.dout), static_cast<T*>(a.dq), a.qs, a.ks, a.vs, a.dos, a.dqs, a.st,
        a.n, a.d, a.scale, a.plus1);
    err = passt_launch_status();
    if (err) return err;
    kb<<<grid_k, FMA_THREADS, fma_dkv_smem(a.d), a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const T*>(a.dout), static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.qs, a.ks,
        a.vs, a.dos, a.dks, a.dvs, a.st, a.n, a.d, a.scale);
    return passt_launch_status();
}

template <typename T>
int launch_fma_d(const Args& a) {
#define PASST_BWD_CASE(DJ) \
    case DJ:               \
        return launch_fma<T, DJ>(a);
    switch ((a.d + 15) / 16) {
        PASST_BWD_CASE(1)
        PASST_BWD_CASE(2)
        PASST_BWD_CASE(3)
        PASST_BWD_CASE(4)
        PASST_BWD_CASE(5)
        PASST_BWD_CASE(6)
        PASST_BWD_CASE(7)
        PASST_BWD_CASE(8)
    }
#undef PASST_BWD_CASE
    return static_cast<int>(cudaErrorInvalidValue);
}

// ---- tensor-core path (bf16 / fp16, D % 16 == 0) ----------------------------

constexpr int MMA_THREADS = 128;  // 4 warps x 16 rows

// s[jj] = a (this warp's 16 rows, A fragments) . rows kk*16 + jj*8 .. + 7 of
// the [64][D] tile B (pitch D + 8); element e of s[jj] is row g + 8 (e / 2),
// tile row kk*16 + jj*8 + 2 t + e % 2.
template <typename T, int D>
__device__ __forceinline__ void scores16(float (&s)[2][4], const uint32_t (&af)[D / 16][4],
                                         const T* Bs, int kk, int g, int t) {
    const uint32_t* b32 = reinterpret_cast<const uint32_t*>(Bs);
    constexpr int LW = (D + 8) / 2;  // row pitch in words
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
        const int row = kk * 16 + jj * 8 + g;
        s[jj][0] = s[jj][1] = s[jj][2] = s[jj][3] = 0.f;
#pragma unroll
        for (int c = 0; c < D / 16; ++c)
            Mma<T>::mma(s[jj], af[c], b32[row * LW + c * 8 + t], b32[row * LW + c * 8 + 4 + t]);
    }
}

// The 16 x 16 block x (C layout of two 8-column products) as A fragments,
// rounded to T.
template <typename T>
__device__ __forceinline__ void to_a_frag(uint32_t (&f)[4], const float (&x)[2][4]) {
    f[0] = Mma<T>::pack(x[0][0], x[0][1]);
    f[1] = Mma<T>::pack(x[0][2], x[0][3]);
    f[2] = Mma<T>::pack(x[1][0], x[1][1]);
    f[3] = Mma<T>::pack(x[1][2], x[1][3]);
}

// acc (16 rows x D, C layout) += a (16 x 16 A fragments) . rows kk*16 ..
// kk*16 + 15 of the [64][D] tile B (pitch D + 8).
template <typename T, int D>
__device__ __forceinline__ void accumulate16(float (&acc)[D / 8][4], const uint32_t (&af)[4],
                                             const T* Bs, int kk, int lane) {
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
        uint32_t b0, b1;
        ldmatrix_x2_trans(b0, b1, Bs + (kk * 16 + (lane & 15)) * (D + 8) + nt * 8);
        Mma<T>::mma(acc[nt], af, b0, b1);
    }
}

// Store rows r and r + 8 of a 16 x D C-layout accumulator.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* base, long long row_stride, int r, int n,
                                           const float (&acc)[D / 8][4], int t) {
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
        const int c = nt * 8 + 2 * t;
        if (r < n)
            *reinterpret_cast<uint32_t*>(base + (long long)r * row_stride + c) =
                Mma<T>::pack(acc[nt][0], acc[nt][1]);
        if (r + 8 < n)
            *reinterpret_cast<uint32_t*>(base + (long long)(r + 8) * row_stride + c) =
                Mma<T>::pack(acc[nt][2], acc[nt][3]);
    }
}

template <typename T, int D>
__global__ void __launch_bounds__(MMA_THREADS) attention_bwd_dq_mma_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, T* __restrict__ dq, Strides qs, Strides ks, Strides vs,
    Strides dos, Strides dqs, Stats st, int n, float scale, int plus1) {
    constexpr int LD = D + 8;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* Kbuf = reinterpret_cast<T*>(smem_raw);  // [2][BK * LD]: tile i in buffer i & 1
    T* Vbuf = Kbuf + 2 * BK * LD;              // [2][BK * LD]

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;  // mma fragment coordinates
    const int b = blockIdx.z, h = blockIdx.y;
    const long long bh = (long long)b * gridDim.y + h;
    const int r0 = blockIdx.x * BQ + warp * 16;  // this warp's first query

    const T* qb = q + b * qs.b + h * qs.h;
    const T* kb = k + b * ks.b + h * ks.h;
    const T* vb = v + b * vs.b + h * vs.h;
    const T* dob = dout + b * dos.b + h * dos.h;
    T* dqb = dq + b * dqs.b + h * dqs.h;

    uint32_t qf[D / 16][4], of[D / 16][4];  // A fragments of the warp's q and dO rows
    load_a_frags<T, D>(qf, qb, qs.n, r0, n, g, t);
    load_a_frags<T, D>(of, dob, dos.n, r0, n, g, t);

    const int tiles = (n + BK - 1) / BK;
    float s[2][4], dp[2][4];

    // Pass 1: the row max over every key (rows g and g + 8).
    float m0 = -INFINITY, m1 = -INFINITY;
    load_tile_async<T, D, MMA_THREADS>(Kbuf, kb, ks.n, 0, n);
    cp_async_commit();
    for (int i = 0; i < tiles; ++i) {
        const int k0 = i * BK;
        if (i + 1 < tiles)
            load_tile_async<T, D, MMA_THREADS>(Kbuf + ((i + 1) & 1) * BK * LD, kb, ks.n, k0 + BK, n);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        const T* Ks = Kbuf + (i & 1) * BK * LD;
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
            scores16<T, D>(s, qf, Ks, kk, g, t);
#pragma unroll
            for (int jj = 0; jj < 2; ++jj)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    if (k0 + kk * 16 + jj * 8 + 2 * t + (e & 1) < n) {
                        const float x = __fmul_rn(s[jj][e], scale);
                        if (e < 2) m0 = fmaxf(m0, x); else m1 = fmaxf(m1, x);
                    }
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

    // Pass 2: l = sum p and sum(p * dP).
    float l0 = 0.f, l1 = 0.f, pdp0 = 0.f, pdp1 = 0.f;
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
        const T* Ks = Kbuf + (i & 1) * BK * LD;
        const T* Vs = Vbuf + (i & 1) * BK * LD;
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
            scores16<T, D>(s, qf, Ks, kk, g, t);
            scores16<T, D>(dp, of, Vs, kk, g, t);
#pragma unroll
            for (int jj = 0; jj < 2; ++jj)
#pragma unroll
                for (int e = 0; e < 4; ++e)
                    if (k0 + kk * 16 + jj * 8 + 2 * t + (e & 1) < n) {
                        const float p = expf(__fmul_rn(s[jj][e], scale) - (e < 2 ? m0 : m1));
                        if (e < 2) {
                            l0 += p;
                            pdp0 = fmaf(p, dp[jj][e], pdp0);
                        } else {
                            l1 += p;
                            pdp1 = fmaf(p, dp[jj][e], pdp1);
                        }
                    }
        }
        __syncthreads();
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
        pdp0 += __shfl_xor_sync(0xffffffffu, pdp0, off);
        pdp1 += __shfl_xor_sync(0xffffffffu, pdp1, off);
    }
    if (plus1) {
        l0 += expf(-m0);
        l1 += expf(-m1);
    }
    const float il0 = 1.f / l0, il1 = 1.f / l1;
    const float di0 = pdp0 * il0, di1 = pdp1 * il1;

    // Pass 3: dS, rounded to T, and dQ += dS . k.
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
        const T* Ks = Kbuf + (i & 1) * BK * LD;
        const T* Vs = Vbuf + (i & 1) * BK * LD;
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
            scores16<T, D>(s, qf, Ks, kk, g, t);
            scores16<T, D>(dp, of, Vs, kk, g, t);
            float ds[2][4];
#pragma unroll
            for (int jj = 0; jj < 2; ++jj)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const bool hi = e >= 2;
                    ds[jj][e] = 0.f;
                    if (k0 + kk * 16 + jj * 8 + 2 * t + (e & 1) < n) {
                        const float p = expf(__fmul_rn(s[jj][e], scale) - (hi ? m1 : m0));
                        ds[jj][e] = p * (hi ? il1 : il0) * (dp[jj][e] - (hi ? di1 : di0)) * scale;
                    }
                }
            uint32_t af[4];
            to_a_frag<T>(af, ds);
            accumulate16<T, D>(acc, af, Ks, kk, lane);
        }
        __syncthreads();
    }
    cp_async_wait<0>();

    store_rows<T, D>(dqb, dqs.n, r0 + g, n, acc, t);
    if (t == 0) {  // rows up to npad: kernel B reads whole tiles
        float* row = st.base + bh * st.npad + r0 + g;
        row[0] = m0;
        row[8] = m1;
        row[st.plane] = il0;
        row[st.plane + 8] = il1;
        row[2 * st.plane] = di0;
        row[2 * st.plane + 8] = di1;
    }
}

template <typename T, int D>
__global__ void __launch_bounds__(MMA_THREADS) attention_bwd_dkv_mma_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, T* __restrict__ dk, T* __restrict__ dv, Strides qs, Strides ks,
    Strides vs, Strides dos, Strides dks, Strides dvs, Stats st, int n, float scale) {
    constexpr int LD = D + 8;
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* Qbuf = reinterpret_cast<T*>(smem_raw);                  // [2][BQ * LD]
    T* Obuf = Qbuf + 2 * BQ * LD;                              // [2][BQ * LD] dO
    float* Sbuf = reinterpret_cast<float*>(Obuf + 2 * BQ * LD);  // [2][3][BQ] m, il, di

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int b = blockIdx.z, h = blockIdx.y;
    const long long bh = (long long)b * gridDim.y + h;
    const int r0 = blockIdx.x * BK + warp * 16;  // this warp's first key

    const T* qb = q + b * qs.b + h * qs.h;
    const T* kb = k + b * ks.b + h * ks.h;
    const T* vb = v + b * vs.b + h * vs.h;
    const T* dob = dout + b * dos.b + h * dos.h;
    T* dkb = dk + b * dks.b + h * dks.h;
    T* dvb = dv + b * dvs.b + h * dvs.h;
    const float* stb = st.base + bh * st.npad;

    uint32_t kf[D / 16][4], vf[D / 16][4];  // A fragments of the warp's k and v rows
    load_a_frags<T, D>(kf, kb, ks.n, r0, n, g, t);
    load_a_frags<T, D>(vf, vb, vs.n, r0, n, g, t);

    float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) dka[nt][e] = dva[nt][e] = 0.f;

    // q, dO and the three statistics of query tile i into buffer i & 1.
    auto stage = [&](int i) {
        const int buf = i & 1;
        load_tile_async<T, D, MMA_THREADS>(Qbuf + buf * BQ * LD, qb, qs.n, i * BQ, n);
        load_tile_async<T, D, MMA_THREADS>(Obuf + buf * BQ * LD, dob, dos.n, i * BQ, n);
        for (int idx = threadIdx.x; idx < 3 * BQ / 4; idx += MMA_THREADS) {
            const int plane = idx / (BQ / 4), c = idx - plane * (BQ / 4);
            const float* from = stb + plane * st.plane + i * BQ + c * 4;
            const uint32_t to = static_cast<uint32_t>(
                __cvta_generic_to_shared(Sbuf + buf * 3 * BQ + plane * BQ + c * 4));
            asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(to), "l"(from));
        }
    };

    const int tiles = (n + BQ - 1) / BQ;
    float s[2][4], dp[2][4];
    stage(0);
    cp_async_commit();
    for (int i = 0; i < tiles; ++i) {
        const int q0 = i * BQ;
        if (i + 1 < tiles) stage(i + 1);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        const T* Qs = Qbuf + (i & 1) * BQ * LD;
        const T* Os = Obuf + (i & 1) * BQ * LD;
        const float* Sm = Sbuf + (i & 1) * 3 * BQ;
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) {
            scores16<T, D>(s, kf, Qs, kk, g, t);   // s^T: keys x queries
            scores16<T, D>(dp, vf, Os, kk, g, t);  // dP^T
            float pn[2][4], ds[2][4];
#pragma unroll
            for (int jj = 0; jj < 2; ++jj)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int qi = kk * 16 + jj * 8 + 2 * t + (e & 1);
                    pn[jj][e] = ds[jj][e] = 0.f;
                    if (q0 + qi < n) {
                        pn[jj][e] = expf(__fmul_rn(s[jj][e], scale) - Sm[qi]) * Sm[BQ + qi];
                        ds[jj][e] = pn[jj][e] * (dp[jj][e] - Sm[2 * BQ + qi]) * scale;
                    }
                }
            uint32_t pf[4], dsf[4];
            to_a_frag<T>(pf, pn);
            to_a_frag<T>(dsf, ds);
            accumulate16<T, D>(dva, pf, Os, kk, lane);
            accumulate16<T, D>(dka, dsf, Qs, kk, lane);
        }
        __syncthreads();
    }
    cp_async_wait<0>();

    store_rows<T, D>(dkb, dks.n, r0 + g, n, dka, t);
    store_rows<T, D>(dvb, dvs.n, r0 + g, n, dva, t);
}

template <typename T, int D>
int launch_mma(const Args& a) {
    const size_t smem_a = 4 * BK * (D + 8) * sizeof(T);  // K and V, two buffers each
    const size_t smem_b = 4 * BQ * (D + 8) * sizeof(T) + 2 * 3 * BQ * sizeof(float);
    auto ka = attention_bwd_dq_mma_kernel<T, D>;
    auto kb = attention_bwd_dkv_mma_kernel<T, D>;
    int err = set_smem(ka, smem_a);
    if (err) return err;
    err = set_smem(kb, smem_b);
    if (err) return err;
    const dim3 grid_q((a.n + BQ - 1) / BQ, a.heads, a.batch);
    const dim3 grid_k((a.n + BK - 1) / BK, a.heads, a.batch);
    ka<<<grid_q, MMA_THREADS, smem_a, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const T*>(a.dout), static_cast<T*>(a.dq), a.qs, a.ks, a.vs, a.dos, a.dqs, a.st,
        a.n, a.scale, a.plus1);
    err = passt_launch_status();
    if (err) return err;
    kb<<<grid_k, MMA_THREADS, smem_b, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
        static_cast<const T*>(a.dout), static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.qs, a.ks,
        a.vs, a.dos, a.dks, a.dvs, a.st, a.n, a.scale);
    return passt_launch_status();
}

template <typename T>
int launch_mma_d(const Args& a) {
#define PASST_BWD_MMA_CASE(D) \
    case D:                   \
        return launch_mma<T, D>(a);
    switch (a.d) {
        PASST_BWD_MMA_CASE(16)
        PASST_BWD_MMA_CASE(32)
        PASST_BWD_MMA_CASE(48)
        PASST_BWD_MMA_CASE(64)
        PASST_BWD_MMA_CASE(80)
        PASST_BWD_MMA_CASE(96)
        PASST_BWD_MMA_CASE(112)
        PASST_BWD_MMA_CASE(128)
    }
#undef PASST_BWD_MMA_CASE
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, k, v, dout, dq, dk, dv: element (b, t, h, c) at ptr[b * sb + t * sn + h * sh + c].
// stats: 3 * batch * heads * npad floats of scratch, npad = n rounded up to 64.
// dtype: 0 float32, 1 bfloat16, 2 float16. d <= 128 and a multiple of 8.
// Launches kernel A then kernel B on `stream`; returns cudaGetLastError()
// after the launches.
extern "C" int passt_attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                                   void* dq, void* dk, void* dv, void* stats, int dtype,
                                   int batch, int n, int heads, int d,
                                   long long qsb, long long qsn, long long qsh,
                                   long long ksb, long long ksn, long long ksh,
                                   long long vsb, long long vsn, long long vsh,
                                   long long dosb, long long dosn, long long dosh,
                                   long long dqsb, long long dqsn, long long dqsh,
                                   long long dksb, long long dksn, long long dksh,
                                   long long dvsb, long long dvsn, long long dvsh,
                                   float scale, int plus1, void* stream) {
    if (d <= 0 || d > 128 || d % 8 != 0 || n <= 0 || batch <= 0 || heads <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const int npad = (n + BQ - 1) / BQ * BQ;
    Args a{q, k, v, dout, dq, dk, dv,
           {qsb, qsn, qsh}, {ksb, ksn, ksh}, {vsb, vsn, vsh}, {dosb, dosn, dosh},
           {dqsb, dqsn, dqsh}, {dksb, dksn, dksh}, {dvsb, dvsn, dvsh},
           {static_cast<float*>(stats), (long long)batch * heads * npad, npad},
           batch, n, heads, d, scale, plus1, static_cast<cudaStream_t>(stream)};
    const bool mma_ok = d % 16 == 0 && vectors_aligned(q, a.qs) && vectors_aligned(k, a.ks) &&
                        vectors_aligned(v, a.vs) && vectors_aligned(dout, a.dos) &&
                        vectors_aligned(dq, a.dqs) && vectors_aligned(dk, a.dks) &&
                        vectors_aligned(dv, a.dvs) &&
                        reinterpret_cast<uintptr_t>(stats) % 16 == 0;
    switch (dtype) {
        case 0:
            return launch_fma_d<float>(a);
        case 1:
            return mma_ok ? launch_mma_d<__nv_bfloat16>(a) : launch_fma_d<__nv_bfloat16>(a);
        case 2:
            return mma_ok ? launch_mma_d<__half>(a) : launch_fma_d<__half>(a);
    }
    return static_cast<int>(cudaErrorInvalidValue);
}
