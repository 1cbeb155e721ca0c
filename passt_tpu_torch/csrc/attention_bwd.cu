// Attention backward for Hopper (sm_90a): dq, dk, dv of
// o = softmax(q k^T * scale) v, with the probabilities recomputed from q and k.
//
// Replaces: passt_tpu/ops/pallas/attention.py:_bwd_kernel (:188, the VJP of
// fused_attention on [B, H, N, D]) and :_flat_bwd_kernel (:388, the VJP of
// fused_attention_qkv, writing dqkv [B, N, 3C] in the Dense layout), and
// scripts/proto_attn_qkv.py:78 _bwd_kernel_flat (the latter with plus1 off).
// Each path serves both entries: every operand arrives as a base pointer with
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
// Four paths here (a fifth, "simt", every other call, has its own source and
// C entry, attention_bwd_fp32.cu). ops/attention.py backward_path() picks one
// per call in Python and the C entry launches exactly that one, or returns
// cudaErrorInvalidValue for a call the path cannot take:
// - "wgmma" (bf16/fp16 at every D that is a multiple of 16 but D = 32 at
//   N <= 128, 16-byte aligned strides; the training step's path): kernel S
//   then kernel KV below, 14 N^2 D FLOP, templates on the head dim padded to
//   DP = 32, 64 or 128 (below).
//   Kernel S, one block per (batch, head, 64-query tile), one pass over
//   128-key K/V tiles: S and dP on wgmma, the running max m (from 0 under
//   plus1) with l = sum p and sum(p * dP) rescaled by exp(m_old - m_new)
//   when it rises; writes m, il and di (4 N^2 D). di keeps the reference's
//   unrounded p, not FlashAttention's rowsum(dO * O) (O was rounded).
//   Kernel KV, one block per (batch, head, 64 keys), one pass over 64-query
//   tiles (10 N^2 D): S^T = K Q^T and dP^T = V dO^T from shared memory,
//   P_norm^T and dS^T rounded to the input dtype in registers as the A
//   operands of dV += P_norm^T dO and dK += dS^T Q, and dS^T stored once
//   to shared memory and read transposed for dQ_part = dS K
//   (FlashAttention-3's backward layout). K and V stay resident; Q, dO
//   and the tile's statistics arrive through a TMA-fed mbarrier ring
//   (4-D tensor maps, so rows past N of one batch are never another
//   batch's rows). dQ across key blocks is summed in fp32 in a fixed order
//   per query tile through a [B*H][npad][64] scratch: a counter per tile,
//   read with acquire and released after the adds, admits the blocks one
//   by one; a dQ warp adds each staged share with one TMA bulk add, off
//   the consumers' path, and the last block rounds and writes dQ in place,
//   so every run gives the same bits (no unordered atomics). Blocks start
//   on different query tiles (a rotation) so that each one's turn comes
//   right after its predecessor's turn of the step before.
//   What sets its time (tools/attention_bwd_variants, PERF.md): not the
//   products (without the dQ or the dS products it is 0-5% faster) but the
//   latency of each step's chain within a warpgroup (two warpgroups an SM,
//   168 registers, 44 bytes of spills) and the dQ sum (~0.05 ms at the
//   training shape); per-block partials summed by a third kernel, the plain
//   block order, and two consumer warpgroups of 64 keys each are slower
//   (the last measured as a text variant of the one-warpgroup D = 64
//   kernel, not carried over to the templated kernel KV).
// - "resident" (bf16/fp16, D = 32, N <= 128, 16-byte aligned strides; the
//   convergence demo's training step, PaSST 4 x 192 with 6 heads):
//   attention_bwd_resident_kernel below, one launch, one block per (batch,
//   head) holding the whole head (q, k, v, dO: 32 KB by TMA) with two
//   consumer warpgroups of 64 queries. S and dP are computed once over all
//   keys on wgmma, the row statistics are exact (no running max), dQ = dS K
//   finishes in the block with dS as register A operand, and dV, dK read
//   P_norm and dS staged once in shared memory: 10 N^2 D FLOP, no scratch,
//   no atomics (every run the same bits). Like every path here it ports
//   passt_tpu/ops/pallas/attention.py:188 and :388; at D = 32 it takes the
//   place of the "mma" pair, which at the demo's B = 25, N = 79 took
//   0.0236-0.0239 ms against cuDNN's 0.0175-0.0176 (PERF.md row 4o): two
//   launches, kernel A walking
//   the keys three times and writing a [3][B*H][npad] fp32 scratch the
//   wrapper allocated every call, kernel B reading it back, the scores
//   computed 4 times and dP 3 times (20 N^2 D), six serial key-tile steps.
//   What bounds it: neither the work nor the bytes (B = 25, H = 6, N = 79:
//   0.30 GFLOP -> 0.0003 ms, 5.3 MB -> 0.0016 ms at the card's peaks) but
//   the latency of one block's chain (the load, four product groups and the
//   softmax between them), so everything runs in one wave: 98 KB of shared
//   memory and at most 128 registers a thread keep two blocks an SM (the
//   demo's 150 heads on 132 SMs). To stay there only S and one 64-key half
//   of dP are live at once (the first half of dP waits in shared memory, in
//   the rows dS takes later, until di is known), and P_norm goes from
//   registers straight to shared memory: ptxas gives it 128 registers and
//   24 bytes of spill stores. Of its time at the demo's shape about a
//   quarter is the launch and the loads, an eighth dQ, dV and dK, the rest
//   the chain between (tools/attention_bwd_variants, PERF.md row 4o).
// - "mma" (bf16/fp16 at a D that is a multiple of 16; no call dispatches to
//   it: ops/attention.py's private path override times it beside "wgmma"
//   and "resident"): kernels A and B below, mma.sync m16n8k16.
// The "wgmma" kernels at a padded head dim (the calls "mma" took): the TMA
// maps take the true D as the row's extent and boxes of one swizzle atom
// (32 columns at DP = 32, 64 otherwise, two at DP = 128), so columns
// D .. DP - 1 of every tile arrive as zeros and add exact zeros to S and
// dP; dQ, dK and dV are stored over D columns only. At DP = 128 kernel S
// takes 64-key tiles (two blocks an SM) and kernel KV two consumer
// warpgroups (one block an SM, see kernel KV); the dQ sum holds 64 x DP
// floats a query tile. What set the DP = 128 time (tools/
// attention_bwd_variants, PERF.md row 4m): the last block's pass over a
// tile's 32 KB sum, whose loop waited out each load's latency in turn
// (without the pass the backward took 0.64x at B = 12, N = 474 and half
// at the convergence demo's shapes); in the DP != 64 instances it issues
// a round of loads before their stores. The DP = 64 instances compile
// the D = 64 kernels as they were (their outputs bit-equal,
// tools/attention_same_bits).
// - "fma" (fp32, which the TPU runs at full fp32; bf16/fp16 at a D that is
//   8 mod 16 or with unaligned strides): the same pair in fp32 FMA.
// Kernels A and B ("mma", "fma"), no atomics:
// - Kernel A, one block per (batch, head, 64-query tile), three passes over
//   the K/V tiles: (1) the row max m; (2) l and sum(p * dP); (3) dS and
//   dQ += dS . k. It writes m, il and di ([3][B*H][N rounded up to 64] fp32
//   scratch the wrapper allocates) for kernel B.
// - Kernel B, one block per (batch, head, 64-key tile), one pass over the
//   query tiles: recompute p^T = exp(k . q * scale - m) from the saved m,
//   dP^T = v . dO, then dV += P_norm^T . dO and dK += dS^T . q in registers.
// Scores are recomputed 4 times (3 in A, 1 in B) and dP 3 times: 20 N^2 D
// FLOP against the function's 10.
// - "mma": four warps of 16 rows each, mma.sync m16n8k16 with fp32
//   accumulate. The warp's own 16 rows (q and dO in A; k and v in B) stay in
//   registers as A fragments; the streamed tiles go through padded shared
//   memory, double-buffered with cp.async. Score accumulators become the A
//   fragments of the next product after rounding, without a trip through
//   shared memory. 16 columns of scores are live at a time.
// - "fma": fp32 FMA from shared memory, 256 threads, 4 x 4 scores each.
// - Ragged N: keys past N get p = 0, queries past N get p = dS = 0, rows
//   past N are not stored. There is no cap on N.
#include "common.cuh"
#include "attention_common.cuh"
#include "hopper.cuh"

#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace passt_attn;
using namespace passt_hopper;

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

// ---- "wgmma" path (bf16 / fp16, D a multiple of 16; padded to DP = 32, 64, 128) ----

// A DP-wide operand tile lies in shared memory as DP / atom column blocks,
// each as one TMA box writes it, of rows of 2 atom bytes: 64 columns with
// the 128-byte swizzle at DP = 64 and 128, 32 with the 64-byte swizzle at 32.
template <int DP>
__host__ __device__ constexpr int bw_atom() { return DP == 32 ? 32 : 64; }
// Kernel S: one block per (64-query tile, head, batch); 128-key K/V tiles
// (64 at DP = 128, so that two blocks fit an SM).
template <int DP>
__host__ __device__ constexpr int st_bk() { return DP == 128 ? 64 : 128; }
constexpr int ST_STAGES = 2;
constexpr int ST_THREADS = 128 + 32;  // one consumer warpgroup and one producer warp
template <int DP>
__host__ __device__ constexpr int st_smem() { return 2 * 64 * 2 * DP + 2 * ST_STAGES * st_bk<DP>() * 2 * DP + 8 * (1 + 2 * ST_STAGES); }
// Kernel KV: one block per (64 keys, head, batch); 64-query tiles. One
// consumer warpgroup, two blocks an SM, at DP = 32 and 64; at DP = 128 two
// consumer warpgroups (each takes half of the queries of S^T and dP^T and
// one column block of dK, dV and dQ_part), one block an SM.
constexpr int KV_STAGES = 3;
template <int DP>
__host__ __device__ constexpr int kv_groups() { return DP == 128 ? 2 : 1; }
// the consumer warpgroups, the TMA producer and the dQ warp
template <int DP>
__host__ __device__ constexpr int kv_threads() { return 128 * kv_groups<DP>() + 64; }
template <int DP>
__host__ __device__ constexpr int kv_smem() {
    return 2 * 64 * 2 * DP                // K, V
           + 2 * KV_STAGES * 64 * 2 * DP  // the Q and dO ring
           + 2 * 64 * 128                 // P_norm^T and dS^T
           + 64 * DP * 4                  // the staged fp32 dQ share
           + KV_STAGES * 3 * 64 * 4       // the m, il, di ring
           + 8 * (3 + 2 * KV_STAGES);
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
    return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// The wgmma descriptor of a column block as TMA wrote it (bw_atom).
template <int DP>
__device__ __forceinline__ uint64_t bw_desc(const void* p) {
    if constexpr (bw_atom<DP>() == 64) return sw128_desc(p);
    else return sw64_desc(p);
}

// The descriptor offset of k step kk (16 columns) of a K-major tile of ROWS
// rows: 32 bytes along a row of a column block, whole blocks apart.
template <int DP, int ROWS>
__device__ __forceinline__ uint64_t bw_kstep(int kk) {
    constexpr int KA = bw_atom<DP>() / 16;  // k steps a column block
    return (uint64_t)((kk / KA) * (ROWS * 2 * bw_atom<DP>() >> 4) + 2 * (kk % KA));
}

// D (64 x N) [+]= A . B^T, both K-major from shared memory, N = 64 or 128.
template <typename T, int N>
__device__ __forceinline__ void ss_kmajor(float (&d)[N / 2], uint64_t a, uint64_t b, int accumulate) {
    if constexpr (N == 128) Wgmma<T>::ss(d, a, b, accumulate);
    else WgmmaSs<T, N, 0, 0>::mma(d, a, b, accumulate);
}

// Load the column blocks of rows `row` .. of one head into a tile at `dst`
// (`rows` rows a block) on the barrier.
template <typename T, int DP>
__device__ __forceinline__ void tma_tile(T* dst, const CUtensorMap* map, uint64_t* bar, int rows, int row, int h,
                                         int b) {
#pragma unroll
    for (int a = 0; a < DP / bw_atom<DP>(); ++a)
        tma_load_4d(dst + a * rows * bw_atom<DP>(), map, bar, a * bw_atom<DP>(), row, h, b);
}

// Kernel S: the row statistics of one 64-query tile in one pass over the
// keys. S = Q K^T and dP = dO V^T per BK-key tile (wgmma m64nBKk16, Q and
// dO resident, K and V through a TMA ring); the running max m (from 0 under
// plus1), l = sum p and r = sum p dP, both rescaled by exp(m_old - m_new)
// when the max rises. Writes m, il = 1 / l (plus exp(-m) under plus1) and
// di = r il for all 64 rows (up to npad) as [B*H][tiles][3][64] floats, so
// that kernel KV takes a tile's three with one copy, and zeroes the tile's
// dQ counter. Columns d .. DP - 1 are zeros in every tile (TMA's fill), so
// they add exact zeros to S and dP.
// Accumulator layout as in attention_fwd.cu: element 4 j + e of a thread in
// warp w is row 16 w + g + 8 (e / 2), column 8 j + 2 t + e % 2.
template <typename T, int DP>
__global__ void __launch_bounds__(ST_THREADS, 2) attention_bwd_stats_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap omap,
    const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap, Stats st,
    int* __restrict__ counters, int n, float scale, int plus1) {
    constexpr int BK = st_bk<DP>();
    extern __shared__ unsigned char smem_raw[];
    unsigned char* base = align1024(smem_raw);
    T* Qs = reinterpret_cast<T*>(base);   // [64][DP]
    T* Os = Qs + 64 * DP;                 // [64][DP] dO
    T* Ks = Os + 64 * DP;                 // [ST_STAGES][BK][DP]
    T* Vs = Ks + ST_STAGES * BK * DP;     // [ST_STAGES][BK][DP]
    uint64_t* qbar = reinterpret_cast<uint64_t*>(Vs + ST_STAGES * BK * DP);
    uint64_t* full = qbar + 1;            // [ST_STAGES]
    uint64_t* empty = full + ST_STAGES;   // [ST_STAGES]

    const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * 64;
    const long long bh = (long long)b * gridDim.y + h;
    const int tiles = (n + BK - 1) / BK;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

    if (threadIdx.x == 0) {
        mbar_init(qbar, 1);
        for (int s = 0; s < ST_STAGES; ++s) {
            mbar_init(full + s, 1);
            mbar_init(empty + s, 4);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
        counters[bh * gridDim.x + blockIdx.x] = 0;  // kernel KV's dQ order of this tile starts here
    }
    __syncthreads();

    if (warp == 4) {  // the producer warp: one thread issues every copy
        if (lane == 0) {
            mbar_expect_tx(qbar, 2 * 64 * 2 * DP);
            tma_tile<T, DP>(Qs, &qmap, qbar, 64, q0, h, b);
            tma_tile<T, DP>(Os, &omap, qbar, 64, q0, h, b);
            for (int i = 0; i < tiles; ++i) {
                const int s = i % ST_STAGES;
                if (i >= ST_STAGES) mbar_wait(empty + s, (i / ST_STAGES - 1) & 1);
                mbar_expect_tx(full + s, 2 * BK * 2 * DP);
                tma_tile<T, DP>(Ks + s * BK * DP, &kmap, full + s, BK, i * BK, h, b);
                tma_tile<T, DP>(Vs + s * BK * DP, &vmap, full + s, BK, i * BK, h, b);
            }
        }
        return;
    }

    const int g = lane >> 2, t = lane & 3;
    const float sl2 = scale * LOG2E;
    float m0 = plus1 ? 0.f : -INFINITY, m1 = m0;  // running max of rows g and g + 8, scaled
    float l0 = 0.f, l1 = 0.f;                    // this thread's share of sum p
    float r0 = 0.f, r1 = 0.f;                    // and of sum p dP
    float s[BK / 2], dp[BK / 2];

    mbar_wait(qbar, 0);
    const uint64_t qd = bw_desc<DP>(Qs), od = bw_desc<DP>(Os);
    for (int i = 0; i < tiles; ++i) {
        const int stage = i % ST_STAGES;
        mbar_wait(full + stage, (i / ST_STAGES) & 1);
        const uint64_t kd = bw_desc<DP>(Ks + stage * BK * DP), vd = bw_desc<DP>(Vs + stage * BK * DP);
        // S and dP as two groups: the max and the exponentials of S run while
        // dP is still in flight
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
            ss_kmajor<T, BK>(s, qd + bw_kstep<DP, 64>(kk), kd + bw_kstep<DP, BK>(kk), kk);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
            ss_kmajor<T, BK>(dp, od + bw_kstep<DP, 64>(kk), vd + bw_kstep<DP, BK>(kk), kk);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(s);

        const int k0 = i * BK;
        if (k0 + BK > n) {  // the ragged last tile: keys past N get p = 0
#pragma unroll
            for (int j = 0; j < BK / 8; ++j)
#pragma unroll
                for (int e = 0; e < 2; ++e)
                    if (k0 + 8 * j + 2 * t + e >= n) s[4 * j + e] = s[4 * j + 2 + e] = -INFINITY;
        }
        float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
            x0 = fmaxf(x0, fmaxf(s[4 * j], s[4 * j + 1]));
            x1 = fmaxf(x1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
            x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, off));
            x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, off));
        }
        // key k0 is valid, so x0 and x1 are finite; m_old = -inf gives a = 0
        const float n0 = fmaxf(m0, x0 * scale), n1 = fmaxf(m1, x1 * scale);
        const float a0 = ex2_approx((m0 - n0) * LOG2E), a1 = ex2_approx((m1 - n1) * LOG2E);
        m0 = n0;
        m1 = n1;
        const float ml0 = n0 * LOG2E, ml1 = n1 * LOG2E;
        float pl0 = 0.f, pl1 = 0.f, pr0 = 0.f, pr1 = 0.f;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {  // p in place of s
            s[4 * j] = ex2_approx(fmaf(s[4 * j], sl2, -ml0));
            s[4 * j + 1] = ex2_approx(fmaf(s[4 * j + 1], sl2, -ml0));
            s[4 * j + 2] = ex2_approx(fmaf(s[4 * j + 2], sl2, -ml1));
            s[4 * j + 3] = ex2_approx(fmaf(s[4 * j + 3], sl2, -ml1));
            pl0 += s[4 * j] + s[4 * j + 1];
            pl1 += s[4 * j + 2] + s[4 * j + 3];
        }
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + stage);
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
            pr0 = fmaf(s[4 * j + 1], dp[4 * j + 1], fmaf(s[4 * j], dp[4 * j], pr0));
            pr1 = fmaf(s[4 * j + 3], dp[4 * j + 3], fmaf(s[4 * j + 2], dp[4 * j + 2], pr1));
        }
        l0 = l0 * a0 + pl0;
        l1 = l1 * a1 + pl1;
        r0 = r0 * a0 + pr0;
        r1 = r1 * a1 + pr1;
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
        r0 += __shfl_xor_sync(0xffffffffu, r0, off);
        r1 += __shfl_xor_sync(0xffffffffu, r1, off);
    }
    if (plus1) {
        l0 += ex2_approx(-m0 * LOG2E);
        l1 += ex2_approx(-m1 * LOG2E);
    }
    const float il0 = 1.f / l0, il1 = 1.f / l1;
    if (t == 0) {  // rows up to npad: kernel KV reads whole tiles
        float* row = st.base + (bh * gridDim.x + blockIdx.x) * 3 * 64 + warp * 16 + g;
        row[0] = m0;
        row[8] = m1;
        row[64] = il0;
        row[64 + 8] = il1;
        row[128] = r0 * il0;
        row[128 + 8] = r1 * il1;
    }
}

// Wait until a tile's dQ counter reaches `pos` (acquire). A predecessor that
// never comes (a broken dispatch order) ends the kernel with an error after
// WAIT_LIMIT_NS instead of hanging.
__device__ __forceinline__ void wait_turn(const int* count, int pos) {
    if (ld_acquire_gpu(count) >= pos) return;
    const uint64_t t0 = global_ns();
    while (ld_acquire_gpu(count) < pos)
        if (global_ns() - t0 > WAIT_LIMIT_NS) __trap();
}

// The query tile key block `blk` takes at step s. With `rotate`, block blk
// starts at tile -blk and walks down, so that at every step each block's
// turn in that tile's dQ order comes right after its predecessor's turn of
// the step before; without, every block walks the tiles in order.
__device__ __forceinline__ int kv_query_tile(int blk, int s, int tiles, int rotate) {
    return rotate ? (s - blk + tiles) % tiles : s;
}

// Block blk's position in query tile i's dQ order (there are as many key
// blocks as query tiles). With `rotate`, the blocks in the rotation that
// starts at the block taking tile i at step 0, (tiles - i) % tiles: the
// position is the step at which blk takes tile i. Without, the block index.
__device__ __forceinline__ int kv_position(int blk, int i, int tiles, int rotate) {
    return rotate ? (blk + i) % tiles : blk;
}

// A 64 x DP fp32 dQ share as kernel KV stages it (in shared memory, and in
// the dQ scratch in device memory): consumer warpgroup wg's 64 x CW columns
// (CW = DP / groups, one column block) at floats 64 CW wg on; within them
// thread slot ts = 32 w + lane of the warpgroup holds its CW / 2
// accumulator values as CW / 8 float4 chunks at floats
// CW / 2 ts + 4 (k ^ (ts & (CW / 8 - 1))), the swizzle keeping the warp's
// stores free of bank conflicts at CW = 64. Chunk k of slot ts is rows r and
// r + 8, columns CW wg + c and + c + 1 (r = 16 w + g, c = 8 k + 2 t,
// g = lane / 4, t = lane % 4).
template <int CW>
__device__ __forceinline__ int dq_chunk(int wg, int ts, int k) {
    return 64 * CW * wg + CW / 2 * ts + 4 * (k ^ (ts & (CW / 8 - 1)));
}
// Chunk `idx` of a share in the dQ warp's walk (idx < 16 DP): its float
// offset `at`, its rows r, r + 8 and its first column c.
template <int CW>
__device__ __forceinline__ void dq_chunk_place(int idx, int& at, int& r, int& c) {
    constexpr int KC = CW / 8;  // chunks a slot
    const int wg = idx / (128 * KC), ts = idx / KC % 128, k = idx % KC;
    at = dq_chunk<CW>(wg, ts, k);
    r = 16 * (ts >> 5) + ((ts & 31) >> 2);
    c = CW * wg + 8 * k + 2 * (ts & 3);
}

// Round the chunk sums x of one tile to T and store them at their rows of dq
// (rows past n and, with PAD, columns past d are not stored); lane `lane` of
// a warp takes every 32nd chunk.
template <typename T, bool PAD>
__device__ __forceinline__ void dq_store_chunk(T* dqb, long long row_stride, int q0, int n, int d, int r, int c,
                                               float4 x) {
    if (PAD && c >= d) return;  // the next head's columns (or k's) in the qkv layout
    if (q0 + r < n)
        *reinterpret_cast<uint32_t*>(dqb + (long long)(q0 + r) * row_stride + c) = Mma<T>::pack(x.x, x.y);
    if (q0 + r + 8 < n)
        *reinterpret_cast<uint32_t*>(dqb + (long long)(q0 + r + 8) * row_stride + c) = Mma<T>::pack(x.z, x.w);
}

// Kernel KV: dK and dV of 64 keys, and their share of dQ, in one
// pass over the query tiles. K and V stay in shared memory; Q, dO and the
// tile's m, il, di arrive through a TMA ring. Per query tile, on wgmma:
//   S^T = K Q^T, dP^T = V dO^T (A and B K-major from shared memory);
//   P_norm^T = exp(s^T scale - m) il and dS^T = P_norm^T (dP^T - di) scale,
//   each rounded to T into shared memory (swizzled as a TMA tile); then
//   dV += P_norm^T dO and dK += dS^T Q (A K-major, B MN-major) and
//   dQ_part = dS K (A and B MN-major: dS^T read transposed). Only the three
//   accumulators are in flight during the products (3 CW / 2 registers a
//   thread), not P and dS as register operands too. At DP = 128 two
//   consumer warpgroups share the block: warpgroup wg takes queries
//   32 wg .. 32 wg + 31 of S^T and dP^T (each over all DP columns) and
//   column block wg of dK, dV and dQ_part (each over all 64 queries or
//   keys), so that each holds 96 accumulators, as at DP = 64. The
//   consumers stage dQ_part in shared memory and go on; the dQ warp adds it
//   to the tile's fp32 sum
//   in a fixed order, off the consumers' path: the block at position p
//   waits for the tile's counter to reach p (acquire); the first stores its
//   share with a bulk copy, the others add it with a bulk fp32 add (nothing
//   else touches the sum meanwhile, so the order is fixed) and release
//   p + 1; the last reads the sum, adds its share, rounds and stores dQ.
//   Keys past N get p = dS = 0; queries past N likewise. Columns d .. DP - 1
//   are zeros in every tile (TMA's fill), so S^T and dP^T are exact, and
//   dK, dV and dQ are stored over d columns only (PAD: d < DP; at d = DP no
//   column check is compiled).
// Warps: the consumers, then the TMA producer, then the dQ warp. Every
// mbarrier wait here traps after WAIT_LIMIT_NS rather than hang the card.
template <typename T, int DP, bool PAD>
__global__ void __launch_bounds__(kv_threads<DP>(), DP == 128 ? 1 : 2) attention_bwd_kv_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap omap,
    const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap,
    T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv, Strides dqs, Strides dks, Strides dvs,
    Stats st, float* __restrict__ dqacc, int* __restrict__ counters, int n, int d, float scale, int rotate) {
    constexpr int WGS = kv_groups<DP>(), ATOM = bw_atom<DP>();
    constexpr int QW = 64 / WGS;  // queries of S^T and dP^T a warpgroup
    constexpr int CW = DP / WGS;  // columns of dK, dV and dQ_part a warpgroup: one column block
    constexpr int TILE = 64 * DP; // elements of a 64-row tile
    static_assert(CW == ATOM, "a warpgroup's columns are one column block");
    extern __shared__ unsigned char smem_raw[];
    unsigned char* base = align1024(smem_raw);
    T* Ks = reinterpret_cast<T*>(base);  // [64][DP]
    T* Vs = Ks + TILE;                   // [64][DP]
    T* Qs = Vs + TILE;                   // [KV_STAGES][64][DP]
    T* Os = Qs + KV_STAGES * TILE;       // [KV_STAGES][64][DP] dO
    T* DSs = Os + KV_STAGES * TILE;      // [64 keys][64 queries] dS^T
    T* PNs = DSs + 64 * 64;              // [64 keys][64 queries] P_norm^T
    float* DQs = reinterpret_cast<float*>(PNs + 64 * 64);  // [64 * DP] the dQ share (dq_chunk)
    float* Sm = DQs + TILE;              // [KV_STAGES][3][64] m, il, di
    uint64_t* kvbar = reinterpret_cast<uint64_t*>(Sm + KV_STAGES * 3 * 64);
    uint64_t* full = kvbar + 1;           // [KV_STAGES]
    uint64_t* empty = full + KV_STAGES;   // [KV_STAGES]
    uint64_t* dqfull = empty + KV_STAGES; // a dQ share staged
    uint64_t* dqfree = dqfull + 1;        // the dQ warp has read it

    const int b = blockIdx.z, h = blockIdx.y, blk = blockIdx.x;
    const long long bh = (long long)b * gridDim.y + h;
    const int tiles = (n + 63) / 64;  // the query tiles, and the key blocks
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

    if (threadIdx.x == 0) {
        mbar_init(kvbar, 1);
        for (int s = 0; s < KV_STAGES; ++s) {
            mbar_init(full + s, 1);
            mbar_init(empty + s, 4 * WGS);
        }
        mbar_init(dqfull, 4 * WGS);
        mbar_init(dqfree, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (warp == 4 * WGS) {  // the producer warp
        if (lane == 0) {
            mbar_expect_tx(kvbar, 2 * 64 * 2 * DP);
            tma_tile<T, DP>(Ks, &kmap, kvbar, 64, blk * 64, h, b);
            tma_tile<T, DP>(Vs, &vmap, kvbar, 64, blk * 64, h, b);
            for (int s = 0; s < tiles; ++s) {
                const int i = kv_query_tile(blk, s, tiles, rotate), stage = s % KV_STAGES;
                if (s >= KV_STAGES) mbar_wait_or_trap(empty + stage, (s / KV_STAGES - 1) & 1);
                mbar_expect_tx(full + stage, 2 * 64 * 2 * DP + 3 * 64 * 4);
                tma_tile<T, DP>(Qs + stage * TILE, &qmap, full + stage, 64, i * 64, h, b);
                tma_tile<T, DP>(Os + stage * TILE, &omap, full + stage, 64, i * 64, h, b);
                bulk_load(Sm + stage * 3 * 64, st.base + (bh * tiles + i) * 3 * 64, 3 * 64 * 4, full + stage);
            }
        }
        return;
    }

    if (warp == 4 * WGS + 1) {  // the dQ warp: each staged share into the tile's sum, in order
        T* dqb = dq + b * dqs.b + h * dqs.h;
        for (int s = 0; s < tiles; ++s) {
            const int i = kv_query_tile(blk, s, tiles, rotate);
            float* acc = dqacc + (bh * st.npad + i * 64) * DP;
            mbar_wait_or_trap(dqfull, s & 1);
            const int pos = kv_position(blk, i, tiles, rotate);
            int* count = counters + bh * tiles + i;
            if (pos > 0 && lane == 0) {
                wait_turn(count, pos);
                fence_proxy_async_global();  // its bulk writes before our reads and adds
            }
            __syncwarp();
            if (pos == tiles - 1) {  // the last: the sum and this share, rounded and stored
                if constexpr (DP == 64) {
#pragma unroll 8
                    for (int it = 0; it < DP / 2; ++it) {
                        int at, r, c;
                        dq_chunk_place<CW>(it * 32 + lane, at, r, c);
                        float4 x = *reinterpret_cast<const float4*>(DQs + at);
                        if (pos > 0) {
                            const float4 y = __ldcg(reinterpret_cast<const float4*>(acc + at));
                            x = make_float4(y.x + x.x, y.y + x.y, y.z + x.z, y.w + x.w);
                        }
                        dq_store_chunk<T, PAD>(dqb, dqs.n, i * 64, n, d, r, c, x);
                    }
                } else {
                    // RB chunks a round, every load of a round issued before its
                    // stores: one loop iteration a load's latency, as above, left
                    // this pass most of the DP = 128 backward's dQ time
                    // (tools/attention_bwd_variants no_final_pass); 16 at
                    // DP = 128, whose one block an SM leaves registers to spare
                    constexpr int RB = DP == 128 ? 16 : 8;
                    for (int it0 = 0; it0 < DP / 2; it0 += RB) {
                        float4 x[RB], y[RB];
#pragma unroll
                        for (int u = 0; u < RB; ++u) {
                            int at, r, c;
                            dq_chunk_place<CW>((it0 + u) * 32 + lane, at, r, c);
                            x[u] = *reinterpret_cast<const float4*>(DQs + at);
                            y[u] = pos > 0 ? __ldcg(reinterpret_cast<const float4*>(acc + at)) : make_float4(0.f, 0.f, 0.f, 0.f);
                        }
#pragma unroll
                        for (int u = 0; u < RB; ++u) {
                            int at, r, c;
                            dq_chunk_place<CW>((it0 + u) * 32 + lane, at, r, c);
                            if (pos > 0)
                                x[u] = make_float4(y[u].x + x[u].x, y[u].y + x[u].y, y[u].z + x[u].z, y[u].w + x[u].w);
                            dq_store_chunk<T, PAD>(dqb, dqs.n, i * 64, n, d, r, c, x[u]);
                        }
                    }
                }
                __syncwarp();
                if (lane == 0) mbar_arrive(dqfree);
                continue;
            }
            if (lane == 0) {
                if (pos == 0)
                    bulk_store(acc, DQs, TILE * 4);
                else
                    bulk_reduce_add(acc, DQs, TILE * 4);
                bulk_commit();
                bulk_wait_read();
                mbar_arrive(dqfree);
                bulk_wait();
                fence_proxy_async_global();  // the writes before the release
                st_release_gpu(count, pos + 1);
            }
        }
        return;
    }

    const int wg = warp >> 2, w = warp & 3;  // this consumer warp's warpgroup, and its warp there
    const int g = lane >> 2, t = lane & 3;
    const int key0 = blk * 64 + 16 * w + g;  // this thread's key rows: key0, key0 + 8
    const bool kv0 = key0 < n, kv1 = key0 + 8 < n;
    const float sl2 = scale * LOG2E;
    const uint64_t kd = bw_desc<DP>(Ks), vd = bw_desc<DP>(Vs);
    // dV's and dK's A operands, K-major: P_norm^T and dS^T
    const uint64_t pnd = sw128_desc(PNs), dsd_k = sw128_desc(DSs);
    // dQ's operands: dS^T and K's column block wg as [64 keys][CW] MN-major
    const uint64_t dsd = sw128_mn_desc(DSs), kd_mn = bw_desc<DP>(Ks + wg * 64 * ATOM);
    unsigned char* ds_rows = reinterpret_cast<unsigned char*>(DSs);
    unsigned char* pn_rows = reinterpret_cast<unsigned char*>(PNs);
    float dka[CW / 2], dva[CW / 2];
#pragma unroll
    for (int x = 0; x < CW / 2; ++x) dka[x] = dva[x] = 0.f;

    mbar_wait_or_trap(kvbar, 0);
    for (int s = 0; s < tiles; ++s) {
        const int i = kv_query_tile(blk, s, tiles, rotate), stage = s % KV_STAGES, q0 = i * 64;
        mbar_wait_or_trap(full + stage, (s / KV_STAGES) & 1);
        const T* Qt = Qs + stage * TILE;
        const T* Ot = Os + stage * TILE;
        // K-major, this warpgroup's QW query rows: S^T, dP^T
        const uint64_t qd = bw_desc<DP>(Qt + wg * QW * ATOM), od = bw_desc<DP>(Ot + wg * QW * ATOM);
        // MN-major, column block wg: dK, dV
        const uint64_t qd_mn = bw_desc<DP>(Qt + wg * 64 * ATOM), od_mn = bw_desc<DP>(Ot + wg * 64 * ATOM);
        float sT[QW / 2], dpT[QW / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
            WgmmaSs<T, QW, 0, 0>::mma(sT, kd + bw_kstep<DP, 64>(kk), qd + bw_kstep<DP, 64>(kk), kk);
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
            WgmmaSs<T, QW, 0, 0>::mma(dpT, vd + bw_kstep<DP, 64>(kk), od + bw_kstep<DP, 64>(kk), kk);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(sT);
        fence_regs(dpT);

        // P_norm^T and dS^T in place of s^T and dP^T: rows are keys, columns queries
        const float* m = Sm + stage * 3 * 64 + wg * QW;
#pragma unroll
        for (int j = 0; j < QW / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int c = 8 * j + 2 * t + e;
                const bool qv = q0 + wg * QW + c < n;
                const float ml = m[c] * LOG2E, il = m[64 + c], di = m[128 + c];
#pragma unroll
                for (int hh = 0; hh < 2; ++hh) {
                    const int x = 4 * j + 2 * hh + e;
                    const bool valid = qv && (hh ? kv1 : kv0);
                    const float pn = valid ? ex2_approx(fmaf(sT[x], sl2, -ml)) * il : 0.f;
                    dpT[x] = valid ? pn * (dpT[x] - di) * scale : 0.f;
                    sT[x] = pn;
                }
            }
        // P_norm^T and dS^T into shared memory, rounded to T and swizzled as a
        // TMA tile of 128-byte rows, once every product of the last step is done
        named_bar_sync(1, 128 * WGS);
#pragma unroll
        for (int j = 0; j < QW / 8; ++j)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
                const int r = 16 * w + g + 8 * hh, at = r * 128 + (((wg * QW / 8 + j) ^ (r & 7)) << 4) + 4 * t;
                *reinterpret_cast<uint32_t*>(pn_rows + at) = Mma<T>::pack(sT[4 * j + 2 * hh], sT[4 * j + 2 * hh + 1]);
                *reinterpret_cast<uint32_t*>(ds_rows + at) = Mma<T>::pack(dpT[4 * j + 2 * hh], dpT[4 * j + 2 * hh + 1]);
            }
        fence_proxy_async();
        named_bar_sync(1, 128 * WGS);

        // dV += P_norm^T dO and dK += dS^T Q: 16 queries a k step, 32 bytes
        // apart in A's rows and 16 rows apart in B's; then dQ_part = dS K,
        // 16 keys a k step
        float dqa[CW / 2];
        fence_regs(dva);
        fence_regs(dka);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) WgmmaSs<T, CW, 0, 1>::mma(dva, pnd + 2 * kk, od_mn + kk * (2 * ATOM), 1);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) WgmmaSs<T, CW, 0, 1>::mma(dka, dsd_k + 2 * kk, qd_mn + kk * (2 * ATOM), 1);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) WgmmaSs<T, CW, 1, 1>::mma(dqa, dsd + kk * 128, kd_mn + kk * (2 * ATOM), kk);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dva);
        fence_regs(dka);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + stage);
        fence_regs(dqa);

        // stage dQ_part for the dQ warp, once it has read the last share
        const int ts = 32 * w + lane;
        if (s > 0) mbar_wait_or_trap(dqfree, (s - 1) & 1);
#pragma unroll
        for (int k = 0; k < CW / 8; ++k)
            *reinterpret_cast<float4*>(DQs + dq_chunk<CW>(wg, ts, k)) =
                make_float4(dqa[4 * k], dqa[4 * k + 1], dqa[4 * k + 2], dqa[4 * k + 3]);
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(dqfull);
    }

    T* dkb = dk + b * dks.b + h * dks.h;
    T* dvb = dv + b * dvs.b + h * dvs.h;
#pragma unroll
    for (int j = 0; j < CW / 8; ++j) {
        const int c = CW * wg + 8 * j + 2 * t;
        if (PAD && c >= d) break;  // the next head's columns (or k's, v's) in the qkv layout
        if (kv0) {
            *reinterpret_cast<uint32_t*>(dkb + (long long)key0 * dks.n + c) = Mma<T>::pack(dka[4 * j], dka[4 * j + 1]);
            *reinterpret_cast<uint32_t*>(dvb + (long long)key0 * dvs.n + c) = Mma<T>::pack(dva[4 * j], dva[4 * j + 1]);
        }
        if (kv1) {
            *reinterpret_cast<uint32_t*>(dkb + (long long)(key0 + 8) * dks.n + c) =
                Mma<T>::pack(dka[4 * j + 2], dka[4 * j + 3]);
            *reinterpret_cast<uint32_t*>(dvb + (long long)(key0 + 8) * dvs.n + c) =
                Mma<T>::pack(dva[4 * j + 2], dva[4 * j + 3]);
        }
    }
}

// Floats of scratch the "wgmma" path takes beyond the statistics: the dQ
// sum (64 x DP floats a query tile) and the per-tile counters.
long long wgmma_scratch(int batch, int n, int heads, int d) {
    const long long tiles = (n + 63) / 64, bh = (long long)batch * heads;
    return bh * tiles * 64 * wgmma_dp(d) + bh * tiles;
}

template <typename T, int DP, bool PAD>
int launch_wgmma(const Args& a, float* dqacc, int* counters, int sms) {
    const int tiles = (a.n + 63) / 64;
    const int st_bytes = st_smem<DP>() + 1024, kv_bytes = kv_smem<DP>() + 1024;  // 1 KB to align the swizzled tiles
    auto ks = attention_bwd_stats_kernel<T, DP>;
    auto kv = attention_bwd_kv_kernel<T, DP, PAD>;
    // runtime calls first: on a thread that has made none yet (autograd's
    // backward thread) they make the device's context current, which the
    // driver's tensor-map encoder below needs
    int err = set_smem(ks, st_bytes);
    if (err) return err;
    err = set_smem(kv, kv_bytes);
    if (err) return err;
    const bool bf16 = std::is_same<T, __nv_bfloat16>::value;
    CUtensorMap q64, o64, k64, v64, kst, vst;
    if (!make_map(&q64, a.q, bf16, a.batch, a.n, a.heads, a.qs, 64, a.d, DP) ||
        !make_map(&o64, a.dout, bf16, a.batch, a.n, a.heads, a.dos, 64, a.d, DP) ||
        !make_map(&k64, a.k, bf16, a.batch, a.n, a.heads, a.ks, 64, a.d, DP) ||
        !make_map(&v64, a.v, bf16, a.batch, a.n, a.heads, a.vs, 64, a.d, DP) ||
        !make_map(&kst, a.k, bf16, a.batch, a.n, a.heads, a.ks, st_bk<DP>(), a.d, DP) ||
        !make_map(&vst, a.v, bf16, a.batch, a.n, a.heads, a.vs, st_bk<DP>(), a.d, DP))
        return static_cast<int>(cudaErrorInvalidValue);
    ks<<<dim3(tiles, a.heads, a.batch), ST_THREADS, st_bytes, a.stream>>>(q64, o64, kst, vst, a.st, counters,
                                                                           a.n, a.scale, a.plus1);
    err = passt_launch_status();
    if (err) return err;
    // With the rotated order a block may wait on a block of its (batch,
    // head) with a higher index, so all of them must be on the card at once.
    // The hardware dispatches blocks in index order, so at most the last head
    // dispatched is resident in part, and the heads before it finish: the
    // rule holds while one head's blocks fit the card, one an SM (kernel KV
    // fits two an SM at DP = 32 and 64, one at DP = 128). Otherwise blocks
    // wait only on lower indices, which the hardware dispatches first.
    const int rotate = tiles <= sms;
    kv<<<dim3(tiles, a.heads, a.batch), kv_threads<DP>(), kv_bytes, a.stream>>>(
        q64, o64, k64, v64, static_cast<T*>(a.dq), static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.dqs, a.dks,
        a.dvs, a.st, dqacc, counters, a.n, a.d, a.scale, rotate);
    return passt_launch_status();
}

// The "wgmma" instance that takes head dim d (a multiple of 16 up to 128):
// DP = wgmma_dp(d), with the column check (PAD) where d < DP.
template <typename T>
int launch_wgmma_d(const Args& a, float* dqacc, int* counters, int sms) {
    if (a.d % 16) return static_cast<int>(cudaErrorInvalidValue);
    switch (wgmma_dp(a.d)) {
        case 32: return a.d == 32 ? launch_wgmma<T, 32, false>(a, dqacc, counters, sms)
                                  : launch_wgmma<T, 32, true>(a, dqacc, counters, sms);
        case 64: return a.d == 64 ? launch_wgmma<T, 64, false>(a, dqacc, counters, sms)
                                  : launch_wgmma<T, 64, true>(a, dqacc, counters, sms);
        default: return a.d == 128 ? launch_wgmma<T, 128, false>(a, dqacc, counters, sms)
                                   : launch_wgmma<T, 128, true>(a, dqacc, counters, sms);
    }
}

// ---- "resident" path (bf16 / fp16, D = 32, N <= 128) -------------------------

constexpr int RS_D = 32;                  // the head dim
constexpr int RS_N = 128;                 // the most tokens: every key and query of a head at once
constexpr int RS_TILE = RS_N * RS_D * 2;  // bytes of a [128][32] operand tile (64-byte rows)
constexpr int RS_STAGED = 2 * RS_N * 128; // bytes of P_norm or dS: [2 key halves][128 queries][64 keys]
constexpr int RS_THREADS = 256;           // two consumer warpgroups of 64 queries each
constexpr int RS_SMEM = 4 * RS_TILE + 2 * RS_STAGED + 8;

// The byte of P_norm or dS (staged as [2 key halves][128 queries][64 keys],
// rows of 128 bytes with the 128-byte swizzle, as TMA would write them) that
// holds the pair of keys 8 j + 2 t, 8 j + 2 t + 1 (j < 16) of query r.
__device__ __forceinline__ int rs_staged_at(int r, int j, int t) {
    return (j >> 3) * (RS_N * 128) + r * 128 + (((j & 7) ^ (r & 7)) << 4) + 4 * t;
}

// Where thread slot ts (0-127) of warpgroup wg keeps chunk k (0-7) of its
// 32 dP values of keys 0-63 until di is known: in that warpgroup's own rows
// of the dS area (16 KB, two 8 KB row ranges), chunks swizzled so that a
// quarter-warp's float4 stores and loads are free of bank conflicts.
__device__ __forceinline__ int rs_stash_at(int wg, int ts, int k) {
    return (ts >> 6) * (RS_N * 128) + (64 * wg + (ts & 63)) * 128 + ((k ^ (ts & 7)) << 4);
}

// dq, dk, dv of one (batch, head) in one block: the whole head is resident.
// One mbarrier brings q, k, v and dO in by TMA (4-D maps, 64-byte swizzle:
// rows past N arrive as zeros and are never another batch's). Warpgroup wg
// (warps 4 wg .. 4 wg + 3) takes queries 64 wg .. 64 wg + 63:
//   S = Q K^T over all 128 keys (wgmma m64n128k16, both operands K-major),
//   and dP = dO V^T in two 64-key halves (m64n64k16), so that S and one half
//   of dP are live at a time; the first half waits in shared memory until
//   di is known. The row statistics are exact and taken once: m = the row
//   max (clamped at 0 under plus1), l = sum p (+ exp(-m) under plus1),
//   il = 1 / l, di = sum(p dP) il from the unrounded p. P_norm = p il and
//   dS = P_norm (dP - di) scale are rounded to T in registers; dS's packed
//   pairs are the A fragments of dQ = dS K (m64n32k16, K MN-major), which
//   finishes in the block. P_norm and dS are staged once in shared memory;
//   then the warpgroup takes keys 64 wg .. 64 wg + 63 for dV = P_norm^T dO
//   and dK = dS^T Q (m64n32k16, A and B both read MN-major). Keys past N
//   get p = 0 and queries past N p = dS = 0; rows past N are not stored.
// Accumulator layout as in attention_fwd.cu: element 4 j + e of a thread in
// warp w of its warpgroup is row 16 w + g + 8 (e / 2), column
// 8 j + 2 t + e % 2.
template <typename T>
__global__ void __launch_bounds__(RS_THREADS, 2) attention_bwd_resident_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap omap,
    T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv, Strides dqs, Strides dks, Strides dvs,
    int heads, int n, float scale, int plus1) {
    extern __shared__ unsigned char smem_raw[];
    unsigned char* base = align1024(smem_raw);
    T* Qs = reinterpret_cast<T*>(base);               // [128][32]
    T* Ks = Qs + RS_N * RS_D;                         // [128][32]
    T* Vs = Ks + RS_N * RS_D;                         // [128][32]
    T* Os = Vs + RS_N * RS_D;                         // [128][32] dO
    unsigned char* pn_at = base + 4 * RS_TILE;        // P_norm, staged
    unsigned char* ds_at = pn_at + RS_STAGED;         // dS, staged (and the dP stash before it)
    uint64_t* bar = reinterpret_cast<uint64_t*>(ds_at + RS_STAGED);

    const int b = blockIdx.x / heads, h = blockIdx.x - b * heads;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wg = warp >> 2, w = warp & 3, g = lane >> 2, t = lane & 3;

    if (threadIdx.x == 0) {
        mbar_init(bar, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        mbar_expect_tx(bar, 4 * RS_TILE);
        tma_load_4d(Qs, &qmap, bar, 0, 0, h, b);
        tma_load_4d(Ks, &kmap, bar, 0, 0, h, b);
        tma_load_4d(Vs, &vmap, bar, 0, 0, h, b);
        tma_load_4d(Os, &omap, bar, 0, 0, h, b);
    }

    const int r = 64 * wg + 16 * w + g;  // this thread's query rows r, r + 8 (and key rows, for dK and dV)
    const bool qv0 = r < n, qv1 = r + 8 < n;
    const float sl2 = scale * LOG2E;
    const uint64_t qd = sw64_desc(Qs + 64 * wg * RS_D), od = sw64_desc(Os + 64 * wg * RS_D);
    const uint64_t kd = sw64_desc(Ks), vd = sw64_desc(Vs);
    float s[64], dp[32];
    mbar_wait(bar, 0);

    // S and dP's first 64 keys as two groups: the softmax statistics of S
    // run while dP is still in flight
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < RS_D / 16; ++kk) Wgmma<T>::ss(s, qd + 2 * kk, kd + 2 * kk, kk);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < RS_D / 16; ++kk) Wgmma<T>::ss64(dp, od + 2 * kk, vd + 2 * kk, kk);
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(s);

    if (n < RS_N) {  // keys past N get p = 0
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
                if (8 * j + 2 * t + e >= n) s[4 * j + e] = s[4 * j + 2 + e] = -INFINITY;
    }
    // the row max of the raw scores (key 0 is valid, so it is finite),
    // clamped at 0 under plus1 (scale > 0: the scaled max's clamp); p =
    // 2^((s - m) scale log2 e), so the max key's p is exactly 1, as the
    // reference's exp(0) is (at N = 1 dS is then exactly 0)
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
        m0 = fmaxf(m0, fmaxf(s[4 * j], s[4 * j + 1]));
        m1 = fmaxf(m1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
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
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {  // p in place of s, unrounded
        s[4 * j] = ex2_approx((s[4 * j] - m0) * sl2);
        s[4 * j + 1] = ex2_approx((s[4 * j + 1] - m0) * sl2);
        s[4 * j + 2] = ex2_approx((s[4 * j + 2] - m1) * sl2);
        s[4 * j + 3] = ex2_approx((s[4 * j + 3] - m1) * sl2);
        l0 += s[4 * j] + s[4 * j + 1];
        l1 += s[4 * j + 2] + s[4 * j + 3];
    }

    // sum p dP over keys 0-63; that half of dP waits in shared memory
    wgmma_wait<0>();
    fence_regs(dp);
    float d0 = 0.f, d1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        d0 = fmaf(s[4 * j + 1], dp[4 * j + 1], fmaf(s[4 * j], dp[4 * j], d0));
        d1 = fmaf(s[4 * j + 3], dp[4 * j + 3], fmaf(s[4 * j + 2], dp[4 * j + 2], d1));
    }
    const int ts = 32 * w + lane;
#pragma unroll
    for (int k = 0; k < 8; ++k)
        *reinterpret_cast<float4*>(ds_at + rs_stash_at(wg, ts, k)) =
            make_float4(dp[4 * k], dp[4 * k + 1], dp[4 * k + 2], dp[4 * k + 3]);

    // dP's keys 64-127 into the same registers (V's rows 64-127: 4096 bytes on)
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < RS_D / 16; ++kk) Wgmma<T>::ss64(dp, od + 2 * kk, vd + (4096 >> 4) + 2 * kk, kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        d0 = fmaf(s[32 + 4 * j + 1], dp[4 * j + 1], fmaf(s[32 + 4 * j], dp[4 * j], d0));
        d1 = fmaf(s[32 + 4 * j + 3], dp[4 * j + 3], fmaf(s[32 + 4 * j + 2], dp[4 * j + 2], d1));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
        d0 += __shfl_xor_sync(0xffffffffu, d0, off);
        d1 += __shfl_xor_sync(0xffffffffu, d1, off);
    }
    if (plus1) {
        l0 += ex2_approx(-m0 * sl2);
        l1 += ex2_approx(-m1 * sl2);
    }
    // queries past N: P_norm = dS = 0
    const float il0 = qv0 ? 1.f / l0 : 0.f, il1 = qv1 ? 1.f / l1 : 0.f;
    const float di0 = d0 * il0, di1 = d1 * il1;

    // P_norm = p il straight into its staged rows; dS = P_norm (dP - di)
    // scale as dQ's A fragments: keys 64-127 from the registers, then keys
    // 0-63 from the stash
    uint32_t dsf[8][4];
#pragma unroll
    for (int j = 8; j < 16; ++j) {
        const float* x = dp + 4 * (j - 8);
        const float p0 = s[4 * j] * il0, p1 = s[4 * j + 1] * il0, p2 = s[4 * j + 2] * il1, p3 = s[4 * j + 3] * il1;
        *reinterpret_cast<uint32_t*>(pn_at + rs_staged_at(r, j, t)) = Mma<T>::pack(p0, p1);
        *reinterpret_cast<uint32_t*>(pn_at + rs_staged_at(r + 8, j, t)) = Mma<T>::pack(p2, p3);
        dsf[j / 2][(j & 1) * 2] = Mma<T>::pack(p0 * (x[0] - di0) * scale, p1 * (x[1] - di0) * scale);
        dsf[j / 2][(j & 1) * 2 + 1] = Mma<T>::pack(p2 * (x[2] - di1) * scale, p3 * (x[3] - di1) * scale);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const float4 x = *reinterpret_cast<const float4*>(ds_at + rs_stash_at(wg, ts, j));
        const float p0 = s[4 * j] * il0, p1 = s[4 * j + 1] * il0, p2 = s[4 * j + 2] * il1, p3 = s[4 * j + 3] * il1;
        *reinterpret_cast<uint32_t*>(pn_at + rs_staged_at(r, j, t)) = Mma<T>::pack(p0, p1);
        *reinterpret_cast<uint32_t*>(pn_at + rs_staged_at(r + 8, j, t)) = Mma<T>::pack(p2, p3);
        dsf[j / 2][(j & 1) * 2] = Mma<T>::pack(p0 * (x.x - di0) * scale, p1 * (x.y - di0) * scale);
        dsf[j / 2][(j & 1) * 2 + 1] = Mma<T>::pack(p2 * (x.z - di1) * scale, p3 * (x.w - di1) * scale);
    }
    // dS into its staged rows, once the warpgroup has read its stash there
    named_bar_sync(1 + wg, 128);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
        *reinterpret_cast<uint32_t*>(ds_at + rs_staged_at(r, j, t)) = dsf[j / 2][(j & 1) * 2];
        *reinterpret_cast<uint32_t*>(ds_at + rs_staged_at(r + 8, j, t)) = dsf[j / 2][(j & 1) * 2 + 1];
    }
    fence_proxy_async();
    __syncthreads();  // both warpgroups' P_norm and dS staged

    // dQ = dS K (16 keys a k step, K's rows 1024 bytes apart); dV = P_norm^T
    // dO and dK = dS^T Q over the keys of this warpgroup's half (16 queries a
    // k step, 2048 bytes apart in the staged rows, 1024 in dO's and Q's)
    float dqa[16], dva[16], dka[16];
    const uint64_t pnd = sw128_desc(pn_at + wg * (RS_N * 128)), dsd = sw128_desc(ds_at + wg * (RS_N * 128));
    const uint64_t od_all = sw64_desc(Os), qd_all = sw64_desc(Qs);
    fence_regs(dsf);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < RS_N / 16; ++kk) Wgmma32<T>::rs(dqa, dsf[kk], kd + kk * 64, kk);
#pragma unroll
    for (int kk = 0; kk < RS_N / 16; ++kk) Wgmma32<T>::ss_mn(dva, pnd + kk * 128, od_all + kk * 64, kk);
#pragma unroll
    for (int kk = 0; kk < RS_N / 16; ++kk) Wgmma32<T>::ss_mn(dka, dsd + kk * 128, qd_all + kk * 64, kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dqa);
    fence_regs(dva);
    fence_regs(dka);
    fence_regs(dsf);

    T* dqb = dq + b * dqs.b + h * dqs.h;
    T* dkb = dk + b * dks.b + h * dks.h;
    T* dvb = dv + b * dvs.b + h * dvs.h;
#pragma unroll
    for (int j = 0; j < RS_D / 8; ++j) {
        const int c = 8 * j + 2 * t;
        if (qv0) {
            *reinterpret_cast<uint32_t*>(dqb + (long long)r * dqs.n + c) = Mma<T>::pack(dqa[4 * j], dqa[4 * j + 1]);
            *reinterpret_cast<uint32_t*>(dkb + (long long)r * dks.n + c) = Mma<T>::pack(dka[4 * j], dka[4 * j + 1]);
            *reinterpret_cast<uint32_t*>(dvb + (long long)r * dvs.n + c) = Mma<T>::pack(dva[4 * j], dva[4 * j + 1]);
        }
        if (qv1) {
            *reinterpret_cast<uint32_t*>(dqb + (long long)(r + 8) * dqs.n + c) =
                Mma<T>::pack(dqa[4 * j + 2], dqa[4 * j + 3]);
            *reinterpret_cast<uint32_t*>(dkb + (long long)(r + 8) * dks.n + c) =
                Mma<T>::pack(dka[4 * j + 2], dka[4 * j + 3]);
            *reinterpret_cast<uint32_t*>(dvb + (long long)(r + 8) * dvs.n + c) =
                Mma<T>::pack(dva[4 * j + 2], dva[4 * j + 3]);
        }
    }
}

template <typename T>
int launch_resident(const Args& a) {
    if (a.d != RS_D || a.n > RS_N) return static_cast<int>(cudaErrorInvalidValue);
    const int smem = RS_SMEM + 1024;  // 1 KB to align the swizzled tiles
    auto kernel = attention_bwd_resident_kernel<T>;
    // a runtime call first: it makes the device's context current on a thread
    // that has made none yet (autograd's), which the tensor-map encoder needs
    int err = set_smem(kernel, smem);
    if (err) return err;
    const bool bf16 = std::is_same<T, __nv_bfloat16>::value;
    CUtensorMap qm, km, vm, om;
    if (!make_map(&qm, a.q, bf16, a.batch, a.n, a.heads, a.qs, RS_N, RS_D) ||
        !make_map(&km, a.k, bf16, a.batch, a.n, a.heads, a.ks, RS_N, RS_D) ||
        !make_map(&vm, a.v, bf16, a.batch, a.n, a.heads, a.vs, RS_N, RS_D) ||
        !make_map(&om, a.dout, bf16, a.batch, a.n, a.heads, a.dos, RS_N, RS_D))
        return static_cast<int>(cudaErrorInvalidValue);
    const long long blocks = (long long)a.batch * a.heads;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    kernel<<<(unsigned)blocks, RS_THREADS, smem, a.stream>>>(
        qm, km, vm, om, static_cast<T*>(a.dq), static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.dqs, a.dks, a.dvs,
        a.heads, a.n, a.scale, a.plus1);
    return passt_launch_status();
}

enum Path { PATH_FMA = 0, PATH_MMA = 1, PATH_WGMMA = 2, PATH_RESIDENT = 4 };

}  // namespace

// Floats of scratch (float32, 16-byte aligned) that passt_attention_bwd
// takes on `path`: the row statistics [3][B*H][npad] (npad = n rounded up
// to 64), and on "wgmma" the dQ sum and the per-tile counters after them;
// none on "resident".
extern "C" long long passt_attention_bwd_scratch(int path, int batch, int n, int heads, int d) {
    if (path == PATH_RESIDENT) return 0;
    const long long npad = (n + BQ - 1) / BQ * BQ;
    const long long stats = 3LL * batch * heads * npad;
    return path == PATH_WGMMA ? stats + wgmma_scratch(batch, n, heads, d) : stats;
}

// q, k, v, dout, dq, dk, dv: element (b, t, h, c) at ptr[b * sb + t * sn + h * sh + c].
// scratch: passt_attention_bwd_scratch(path, ...) floats (none, and null
// allowed, on "resident").
// dtype: 0 float32, 1 bfloat16, 2 float16. d <= 128 and a multiple of 8.
// sms: the card's multiprocessor count ("wgmma" only).
// path: 0 "fma" (any input: kernel A then kernel B, FMA), 1 "mma"
// (bf16/fp16, d a multiple of 16: the same pair on mma.sync), 2 "wgmma"
// (bf16/fp16, d = 64: kernel S then kernel KV), 4 "resident" (bf16/fp16,
// d = 32, n <= 128: one block per head); the three tensor-core paths need
// 16-byte aligned base pointers and strides that are multiples of 8
// elements. A path that cannot take the call returns cudaErrorInvalidValue
// and launches nothing. Otherwise returns cudaGetLastError() after the
// launches, on `stream`.
extern "C" int passt_attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                                   void* dq, void* dk, void* dv, void* scratch, int dtype, int path,
                                   int batch, int n, int heads, int d,
                                   long long qsb, long long qsn, long long qsh,
                                   long long ksb, long long ksn, long long ksh,
                                   long long vsb, long long vsn, long long vsh,
                                   long long dosb, long long dosn, long long dosh,
                                   long long dqsb, long long dqsn, long long dqsh,
                                   long long dksb, long long dksn, long long dksh,
                                   long long dvsb, long long dvsn, long long dvsh,
                                   float scale, int plus1, int sms, void* stream) {
    if (d <= 0 || d > 128 || d % 8 != 0 || n <= 0 || batch <= 0 || heads <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const int npad = (n + BQ - 1) / BQ * BQ;
    float* stats = static_cast<float*>(scratch);
    const long long plane = (long long)batch * heads * npad;
    Args a{q, k, v, dout, dq, dk, dv,
           {qsb, qsn, qsh}, {ksb, ksn, ksh}, {vsb, vsn, vsh}, {dosb, dosn, dosh},
           {dqsb, dqsn, dqsh}, {dksb, dksn, dksh}, {dvsb, dvsn, dvsh},
           {stats, plane, npad},
           batch, n, heads, d, scale, plus1, static_cast<cudaStream_t>(stream)};
    if (path == PATH_FMA) {
        switch (dtype) {
            case 0: return launch_fma_d<float>(a);
            case 1: return launch_fma_d<__nv_bfloat16>(a);
            case 2: return launch_fma_d<__half>(a);
        }
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const bool aligned = vectors_aligned(q, a.qs) && vectors_aligned(k, a.ks) && vectors_aligned(v, a.vs) &&
                         vectors_aligned(dout, a.dos) && vectors_aligned(dq, a.dqs) &&
                         vectors_aligned(dk, a.dks) && vectors_aligned(dv, a.dvs) &&
                         reinterpret_cast<uintptr_t>(scratch) % 16 == 0;
    if (!aligned || (dtype != 1 && dtype != 2)) return static_cast<int>(cudaErrorInvalidValue);
    if (path == PATH_MMA) return dtype == 1 ? launch_mma_d<__nv_bfloat16>(a) : launch_mma_d<__half>(a);
    if (path == PATH_RESIDENT) return dtype == 1 ? launch_resident<__nv_bfloat16>(a) : launch_resident<__half>(a);
    if (path != PATH_WGMMA) return static_cast<int>(cudaErrorInvalidValue);
    float* dqacc = stats + 3 * plane;
    int* counters = reinterpret_cast<int*>(dqacc + wgmma_scratch(batch, n, heads, d) - (long long)batch * heads * (npad / BQ));
    return dtype == 1 ? launch_wgmma_d<__nv_bfloat16>(a, dqacc, counters, sms)
                      : launch_wgmma_d<__half>(a, dqacc, counters, sms);
}
