// Attention forward for Hopper (sm_90a): o = softmax(q k^T * scale) v with
// fp32 scores.
//
// Replaces: passt_tpu/ops/pallas/attention.py:171 _fwd_kernel (entry
// fused_attention, [B, N, H, D]), :373 _flat_fwd_kernel (entry
// fused_attention_qkv, the raw [B, N, 3C] qkv Dense output) and
// scripts/proto_attn_qkv.py:63 _fwd_kernel_flat (the same, plus1 off). One
// library serves all three: q, k and v arrive as base pointers with (batch,
// token, head) strides, so both layouts are read in place with no transpose.
// The port's wrappers are in passt_tpu_torch/ops/attention.py.
//
// The math is the reference's _softmax_parts: fp32 scores s = (q . k) *
// scale; m = the row max (clamped at 0 under plus1); p = exp(s - m); l = sum
// p (+ exp(-m) under plus1); P is rounded to the input dtype for the PV
// product, which accumulates in fp32; o = (P v) / l, rounded to the input
// dtype. The bf16/fp16 paths take the exponential as one FMA and ex2.approx,
// 2^(s_raw * (scale log2 e) - m log2 e), fp32 throughout; it differs from
// expf(s - m) by a few fp32 ulps, far below the rounding of P.
//
// Five paths. ops/attention.py forward_path() picks one per call in Python
// and the C entry launches exactly that one, or returns
// cudaErrorInvalidValue for a shape the path cannot take (the fifth,
// "simt", has its own source and C entry, attention_fwd_fp32.cu):
// - "wgmma" (bf16/fp16 at every D that is a multiple of 16 but D = 64 at
//   N <= 64, 16-byte aligned strides; the model's serving and training
//   shapes, the convergence demo's PaSST 4 x 192 at 6 and 2 heads):
//   attention_fwd_wgmma_kernel below, a template on the head dim padded to
//   DP = 32, 64 or 128, one pass over K with an online softmax, products on
//   wgmma, K/V tiles by TMA.
// - "short" (the same inputs at N <= 64; the timestamp windows, N = 14):
//   attention_fwd_short_kernel, mma.sync m16n8k16, one key tile, so the max
//   is exact after one product and the scores stay in registers; at N <= 16
//   each warp takes its own (batch, head), four heads a block, so no warp
//   multiplies rows past N.
// - "mma" (bf16/fp16 at a D that is a multiple of 16 but 64, aligned
//   strides; no call dispatches to it: ops/attention.py's private path
//   override times it beside "wgmma"): attention_fwd_mma_kernel, two passes
//   (the row max, then p and PV), mma.sync m16n8k16 with cp.async K/V tiles.
// - "simt" (fp32 at D = 64 with aligned strides; every fp32 call of the
//   model): attention_fwd_fp32.cu, one pass over K with a running max in
//   fp32 FMA, 4 x 8 register micro-tiles fed by float4 shared loads, K and V
//   by staggered cp.async, three blocks an SM. Against this file's "fma"
//   kernel, which the model's fp32 calls ran before: one pass instead of two
//   (4 N^2 D of FMA work for 6), 3 float4 loads a 32 FMA instead of 8
//   scalar loads a 16, one FMA and ex2.approx a score instead of expf, and
//   copies in flight during the arithmetic. fp32 bound (67 TFLOP/s FMA):
//   B = 20, H = 12, N = 1190: 87.0 GFLOP -> 1.2986 ms (bytes 292 MB ->
//   0.0872 ms); B = 2, N = 474: 1.38 GFLOP -> 0.0206 ms.
// - "fma" (fp32 at D != 64 or with unaligned strides, which the TPU runs at
//   full fp32; bf16/fp16 at a D that is 8 mod 16 or with unaligned
//   strides): attention_fwd_kernel, fp32 FMA from shared memory, two
//   passes. ops/attention.py's private path override reaches it at fp32
//   D = 64, where chip_smoke [18] times it beside "simt".
//
// Bounds on one H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s; the function is
// 4 N^2 D FLOP a head, q, k, v read once and o written once):
// - serving, bf16 B = 20, H = 12, N = 1190, D = 64: 87.0 GFLOP -> 0.0880 ms
//   (operations); 146 MB -> 0.0437 ms. The exponentials run on another
//   unit: B H N^2 = 3.40e8 of them at 16 MUFU.EX2 a clock on each of 132 SMs
//   at ~1.8 GHz take ~0.09 ms, as long as the products.
// - training, the qkv entry, bf16 B = 12, N = 474: 8.28 GFLOP -> 0.0084 ms;
//   4 B N C 2 = 34.9 MB -> 0.0104 ms (bytes).
// - timestamps, bf16 B = 256, N = 14: 22.0 MB -> 0.0066 ms (bytes).
//
// What the wgmma design does about the limits of the two-pass mma.sync
// kernel that the model's D = 64 shapes ran before:
// 1. Two passes over K (6 N^2 D of tensor work for 4 N^2 D, K read twice):
//    one pass. The running row max m starts at -inf (at 0 under plus1, which
//    makes the final m exactly max(0, row max)); when a tile raises it, the
//    fp32 accumulator and l are rescaled by exp(m_old - m_new). p = exp(s -
//    m_running) is summed unrounded into l and rounded to the input dtype as
//    PV's A operand; o = acc / l at the end, rounded once. The only change
//    against the exact-max order is that p is rounded against the running
//    max; tests/test_torch_attention_online.py holds an fp32 emulation of
//    this order to chip_smoke's TOL_ATTN on the CPU.
// 2. Scalar shared loads of K's B fragments: gone. wgmma reads Q and K from
//    shared memory through descriptors (128-byte swizzle: a D = 64 row of
//    bf16 is 128 bytes), and V with the transposed-B flag.
// 3. mma.sync: S = Q K^T is wgmma.m64n128k16 (four k steps), O += P V is
//    wgmma.m64n64k16 with P in registers (eight k steps).
// 4. expf behind __fmul_rn, not overlapped with the products: one FMA and
//    ex2.approx per score, and the softmax overlapped with the products.
//    Turn i issues S(i) and PV(i-1) together, and the softmax of S(i) runs
//    while PV(i-1) is in flight (P stays in the S registers until PV(i-1)
//    has read the previous P). Across blocks, the warp schedulers interleave
//    the two blocks an SM holds.
// 5. 64 queries per block over 64-key mma.sync tiles: 128-key tiles, and
//    two blocks of one consumer warpgroup (64 rows) each per SM. Two or
//    three consumer warpgroups a block sharing each K/V tile, with or
//    without FlashAttention-3's ping-pong through named barriers, fit only
//    one block an SM (registers) and measured slower; they are kept as text
//    edits in tools/attention_variants.json (PERF.md).
// 6. Short sequences: the "short" path above.
// Head dims past 64 and between the instances (the calls "mma" took): the
// kernel is a template on DP, the head dim padded to 32, 64 or 128. The
// TMA maps take the true D as the row's extent and boxes of one swizzle
// atom (32 columns at DP = 32, 64 otherwise, two boxes at DP = 128), so
// columns D .. DP - 1 arrive as zeros (the box's bytes, zeros included,
// complete the barrier) and add exact zeros to S; O's columns past D are
// never stored (in the qkv layout they are the next head's, or k's), the
// check compiled only where D < DP. At DP = 128 O is 64 registers a thread,
// so the key tiles are 64 keys (S 32 registers, P 16) and Q's A fragments
// (32 registers) come straight from device memory into registers, S being
// m64n64k16 with A from registers: the K/V ring of three stages is then
// 97 KB, and two blocks fit an SM. PV is m64n128k16 with V MN-major over
// its two column blocks (sw128_mn_blocks_desc). The DP = 32 and 64
// instances compile the D = 32 and 64 kernels as they were (their outputs
// bit-equal, tools/attention_same_bits).
// D = 32 (the "wgmma" instance at D = 32, a port of attention.py:171 and
// :373 like every path here, takes the place of the "mma" kernel there,
// which the convergence demo ran at B = 25, N = 79 and B = 50, N = 110):
// the "mma" kernel made two passes over the keys (QK^T twice, K read twice),
// each 64-key tile a serial cp.async wait and two __syncthreads, four
// serial steps at those N, on mma.sync. The work is tiny (B = 25, H = 6,
// N = 79: 0.12 GFLOP -> 0.0001 ms; 3.0 MB -> 0.0009 ms), so the latency of
// that chain set its time. Here N <= 128 is one key tile: Q K^T once, K and
// V read once, one barrier wait for them. A row of D = 32 is 64 bytes, so
// the TMA maps and the wgmma descriptors take the 64-byte swizzle (8-row
// groups 512 bytes apart; sw64_desc); S = Q K^T is two k steps of
// m64n128k16 and O += P V eight of m64n32k16 (16 accumulators a thread).
// With 53 KB of shared memory the launch bounds ask for three blocks an SM,
// so the demo's 300 and 600 blocks take one and two waves.
// Loads: one producer warp issues TMA copies (tensor maps over the strided
// (D, N, H, B) view, built on the host per call with cuTensorMapEncodeTiled
// from the CUDA driver's entry point, passed as __grid_constant__) of Q once and of
// K/V tiles into a WG_STAGES-deep ring (3: tiles i-1 and i are in use during
// turn i) with mbarrier expect-tx / try-wait; the consumers release a stage
// with one arrival per warp once PV has read it. Rows past N are
// zero-filled by TMA and their keys masked to p = 0 before the max; queries
// past N are not stored (predicated stores from the accumulator registers).
// No cap on N.
//
// ptxas (-Xptxas -v, sm_90a, CUDA 12.8; the most over each path's
// instances, as chip_smoke [2] reports them): wgmma at DP = 128 166
// registers and 48 bytes of spill stores, its wgmma serialized (C7512); at
// D = 64 154 registers, no spills (two 160-thread blocks an SM fit up to
// 204); at D = 32 126 registers and 144 bytes of spill stores, its wgmma serialized
// (C7512) under the three-block bound, which still measured faster than
// two blocks an SM without spills (tools/attention_variants
// d32_two_blocks_an_sm, PERF.md row 4o); short 64 registers,
// 8 bytes of spill stores; mma 164, no spills; fma 122, no spills. ptxas
// reports no serialized wgmma ("Performance Loss") for the wgmma path; it
// did for a variant capped at 126 registers, and a single loop with the
// first and last turns as conditionals measured 38% slower than the peeled
// loop below (PERF.md).
#include "common.cuh"
#include "attention_common.cuh"
#include "hopper.cuh"  // mbarriers, TMA, wgmma; tensor maps from the CUDA driver's encoder at run time

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace passt_attn;
using namespace passt_hopper;

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


// ---- "mma" path (bf16 / fp16, D != 64, D % 16 == 0) -------------------------

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
    switch (d) {  // D = 64 takes the "short" and "wgmma" paths
        PASST_MMA_CASE(16)
        PASST_MMA_CASE(32)
        PASST_MMA_CASE(48)
        PASST_MMA_CASE(80)
        PASST_MMA_CASE(96)
        PASST_MMA_CASE(112)
        PASST_MMA_CASE(128)
    }
#undef PASST_MMA_CASE
    return static_cast<int>(cudaErrorInvalidValue);
}


// ---- "short" path (bf16 / fp16, D = 64, N <= 64) -----------------------------

// NK: the keys padded to one tile, 16 or 64. A head takes NK / 16 warps of 16
// queries each, so a block of four warps holds 64 / NK heads.
template <typename T, int NK>
__global__ void __launch_bounds__(MMA_THREADS) attention_fwd_short_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, Strides qs, Strides ks, Strides vs, Strides os,
    int batch, int heads, int n, float scale, int plus1) {
    constexpr int D = 64, LD = D + 8, LW = LD / 2;
    constexpr int W = NK / 16;  // warps per head
    constexpr int HPB = 4 / W;  // heads per block
    extern __shared__ __align__(16) unsigned char smem_raw[];

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int g = lane >> 2, t = lane & 3;
    const int slot = warp / W, part = warp % W;
    const int bh = blockIdx.x * HPB + slot;
    const bool live = bh < batch * heads;
    const int b = live ? bh / heads : 0;
    const int h = live ? bh - b * heads : 0;
    T* Ks = reinterpret_cast<T*>(smem_raw) + slot * 2 * NK * LD;  // [NK][LD]
    T* Vs = Ks + NK * LD;                                          // [NK][LD]

    const T* qb = q + b * qs.b + h * qs.h;
    const T* kb = k + b * ks.b + h * ks.h;
    const T* vb = v + b * vs.b + h * vs.h;
    T* ob = o + b * os.b + h * os.h;

    if (live) {
        for (int idx = part * 32 + lane; idx < NK * (D / 8); idx += 32 * W) {
            const int r = idx / (D / 8);
            const int c = idx - r * (D / 8);
            const bool ok = r < n;
            passt::cp_async16(Ks + r * LD + c * 8, ok ? kb + (long long)r * ks.n + c * 8 : kb, ok ? 16 : 0);
            passt::cp_async16(Vs + r * LD + c * 8, ok ? vb + (long long)r * vs.n + c * 8 : vb, ok ? 16 : 0);
        }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const int r0 = part * 16;  // this warp's first query
    if (!live || r0 >= n) return;

    uint32_t qf[D / 16][4];
    load_a_frags<T, D>(qf, qb, qs.n, r0, n, g, t);

    // The scores of every key, in registers: element e of s[j] is row
    // g + 8 (e / 2), key j * 8 + 2 t + e % 2.
    const uint32_t* k32 = reinterpret_cast<const uint32_t*>(Ks);
    float s[NK / 8][4];
#pragma unroll
    for (int j = 0; j < NK / 8; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
            Mma<T>::mma(s[j], qf[kk], k32[(j * 8 + g) * LW + kk * 8 + t],
                        k32[(j * 8 + g) * LW + kk * 8 + 4 + t]);
    }

    // The exact row max over the valid keys (raw scores; scale > 0).
    float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < NK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
            if (j * 8 + 2 * t + (e & 1) < n) {
                if (e < 2) m0 = fmaxf(m0, s[j][e]); else m1 = fmaxf(m1, s[j][e]);
            }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
        m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, off));
        m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, off));
    }
    m0 *= scale;
    m1 *= scale;
    if (plus1) {
        m0 = fmaxf(m0, 0.f);
        m1 = fmaxf(m1, 0.f);
    }
    const float sl2 = scale * LOG2E, ml0 = m0 * LOG2E, ml1 = m1 * LOG2E;

    float l0 = 0.f, l1 = 0.f;
    uint32_t pf[NK / 16][4];  // A fragments of P, 16 keys each
#pragma unroll
    for (int j = 0; j < NK / 8; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
            p[e] = j * 8 + 2 * t + (e & 1) < n ? ex2_approx(fmaf(s[j][e], sl2, -(e < 2 ? ml0 : ml1))) : 0.f;
        l0 += p[0] + p[1];
        l1 += p[2] + p[3];
        pf[j / 2][(j & 1) * 2 + 0] = Mma<T>::pack(p[0], p[1]);
        pf[j / 2][(j & 1) * 2 + 1] = Mma<T>::pack(p[2], p[3]);
    }
    float acc[D / 8][4];
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK / 16; ++kk)
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt) {
            uint32_t b0, b1;
            ldmatrix_x2_trans(b0, b1, Vs + (kk * 16 + (lane & 15)) * LD + nt * 8);
            Mma<T>::mma(acc[nt], pf[kk], b0, b1);
        }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    if (plus1) {
        l0 += ex2_approx(-ml0);
        l1 += ex2_approx(-ml1);
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

template <typename T, int NK>
int launch_short(const void* q, const void* k, const void* v, void* o, int batch, int n, int heads,
                 Strides qs, Strides ks, Strides vs, Strides os, float scale, int plus1,
                 cudaStream_t stream) {
    constexpr int HPB = 64 / NK;
    const size_t smem = HPB * 2 * NK * (64 + 8) * sizeof(T);
    const long long blocks = ((long long)batch * heads + HPB - 1) / HPB;
    attention_fwd_short_kernel<T, NK><<<(unsigned)blocks, MMA_THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<T*>(o), qs, ks, vs, os, batch, heads, n, scale, plus1);
    return passt_launch_status();
}


// ---- "wgmma" path (bf16 / fp16, D a multiple of 16; padded to DP = 32, 64, 128) ----

constexpr int WG_STAGES = 3;     // K/V ring depth
constexpr int WG_BQ = 64;        // query rows a block: one consumer warpgroup
constexpr int WG_THREADS = 128 + 32;  // the consumer warpgroup and one producer warp
// Keys a tile: 128 at DP = 32 and 64; 64 at DP = 128, where O (64 x 128) is
// 64 registers a thread and Q's A fragments 32 more.
template <int DP>
__host__ __device__ constexpr int wg_bk() { return DP == 128 ? 64 : 128; }
// Columns of one swizzle atom: a tile of DP columns lies in shared memory as
// DP / atom column blocks, each as one TMA box writes it, of rows of 2 atom
// bytes (one swizzle span: 128 bytes at 64 columns, 64 at 32).
template <int DP>
__host__ __device__ constexpr int wg_atom() { return DP == 32 ? 32 : 64; }
// Shared memory of the DP-wide instance: Q (at DP <= 64; at DP = 128 Q is
// in registers), the K/V ring and the barriers.
template <int DP>
__host__ __device__ constexpr int wg_smem() {
    return (DP == 128 ? 0 : WG_BQ * 2 * DP) + 2 * WG_STAGES * wg_bk<DP>() * 2 * DP + 8 * (1 + 2 * WG_STAGES);
}

// The wgmma descriptor of a column block of DP-padded rows as TMA wrote it:
// 128-byte swizzle at 64 columns, 64-byte swizzle at 32 (8-row groups
// 1024 / 512 bytes apart). A k step of 16 along the row is 32 bytes (+ 2),
// of 16 rows 16 x 2 atom bytes.
template <int DP>
__device__ __forceinline__ uint64_t wg_desc(const void* p) {
    if constexpr (wg_atom<DP>() == 64) return sw128_desc(p);
    else return sw64_desc(p);
}

// The descriptor offset of k step kk (16 columns) of a K-major tile of ROWS
// rows: 32 bytes along a row of a column block, whole blocks of ROWS rows
// apart.
template <int DP, int ROWS>
__device__ __forceinline__ uint64_t wg_kstep(int kk) {
    constexpr int KA = wg_atom<DP>() / 16;  // k steps a column block
    return (uint64_t)((kk / KA) * (ROWS * 2 * wg_atom<DP>() >> 4) + 2 * (kk % KA));
}

// O (64 x DP) += P (64 x 16, registers) . V (16 x DP, MN-major) for one k step.
template <typename T, int DP> struct WgmmaPv;
template <typename T> struct WgmmaPv<T, 64> {
    static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
        Wgmma<T>::rs(d, a, b);
    }
};
template <typename T> struct WgmmaPv<T, 32> {
    static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
        Wgmma32<T>::rs(d, a, b, 1);
    }
};
template <typename T> struct WgmmaPv<T, 128> {  // V's two column blocks, one N block each
    static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
        WgmmaRsMn<T, 128>::mma(d, a, b);
    }
};

// S (64 x 128) = Q . K^T: D / 16 k steps of 16, 32 bytes apart inside the
// swizzled rows; issued and committed as one group (DP = 32, 64).
template <typename T, int D>
__device__ __forceinline__ void s_product(float (&s)[64], uint64_t qd, uint64_t kd) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) Wgmma<T>::ss(s, qd + 2 * kk, kd + 2 * kk, kk);
    wgmma_commit();
}

// S (64 x 64) = Q . K^T at DP = 128: Q's A fragments from registers, K
// K-major in two column blocks; eight k steps, one group.
template <typename T>
__device__ __forceinline__ void s_product_rq(float (&s)[32], const uint32_t (&qf)[8][4], uint64_t kd) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) WgmmaRsF32<T, 64>::mma(s, qf[kk], kd + wg_kstep<128, 64>(kk), kk);
    wgmma_commit();
}

// S = Q . K^T at the DP-wide instance: Q from shared memory (DP = 32, 64)
// or from registers (DP = 128).
template <typename T, int DP>
__device__ __forceinline__ void s_issue(float (&s)[wg_bk<DP>() / 2], const uint32_t (&qf)[DP == 128 ? 8 : 1][4],
                                        uint64_t qd, uint64_t kd) {
    if constexpr (DP == 128) s_product_rq<T>(s, qf, kd);
    else s_product<T, DP>(s, qd, kd);
}

// O (64 x DP) += P (64 x BK, registers) . V (BK x DP at descriptor vd):
// BK / 16 k steps of 16 keys, 16 rows of 2 atom bytes apart.
template <typename T, int DP>
__device__ __forceinline__ void pv_product(float (&acc)[DP / 2], const uint32_t (&pf)[wg_bk<DP>() / 16][4],
                                           uint64_t vd) {
#pragma unroll
    for (int kk = 0; kk < wg_bk<DP>() / 16; ++kk) WgmmaPv<T, DP>::rs(acc, pf[kk], vd + kk * (2 * wg_atom<DP>()));
}

// Rescale O by the last softmax's a0 (row g) and a1 (row g + 8), then issue
// and commit O += P V.
template <typename T, int DP>
__device__ __forceinline__ void pv_issue(float (&acc)[DP / 2], uint32_t (&pf)[wg_bk<DP>() / 16][4], float a0,
                                         float a1, uint64_t vd) {
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
        acc[4 * j] *= a0;
        acc[4 * j + 1] *= a0;
        acc[4 * j + 2] *= a1;
        acc[4 * j + 3] *= a1;
    }
    fence_regs(acc);
    fence_regs(pf);
    wgmma_fence();
    pv_product<T, DP>(acc, pf, vd);
    wgmma_commit();
}

// Wait until tile i's K and V have landed in its stage.
__device__ __forceinline__ void wait_tile(uint64_t* full, int i) {
    mbar_wait(full + i % WG_STAGES, (i / WG_STAGES) & 1);
}

// One probability: 2^(s scale log2 e - m log2 e), fp32.
__device__ __forceinline__ float wg_p(float s, float sl2, float ml) {
    return ex2_approx(fmaf(s, sl2, -ml));
}

// The online softmax of one tile's scores (BK keys), in place: keys past n
// masked, the running max (m0, m1: rows g and g + 8, scaled) raised, a0 and
// a1 the factors that carry the old max to the new one, s replaced by p and
// the row sums (this thread's share) l0, l1 rescaled and extended.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], int k0, int n, int t, float scale, float sl2,
                                             float& m0, float& m1, float& l0, float& l1, float& a0, float& a1) {
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
    a0 = ex2_approx((m0 - n0) * LOG2E);
    a1 = ex2_approx((m1 - n1) * LOG2E);
    m0 = n0;
    m1 = n1;
    const float ml0 = n0 * LOG2E, ml1 = n1 * LOG2E;
    float r0 = 0.f, r1 = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
        s[4 * j] = wg_p(s[4 * j], sl2, ml0);
        s[4 * j + 1] = wg_p(s[4 * j + 1], sl2, ml0);
        s[4 * j + 2] = wg_p(s[4 * j + 2], sl2, ml1);
        s[4 * j + 3] = wg_p(s[4 * j + 3], sl2, ml1);
        r0 += s[4 * j] + s[4 * j + 1];
        r1 += s[4 * j + 2] + s[4 * j + 3];
    }
    l0 = l0 * a0 + r0;
    l1 = l1 * a1 + r1;
}

// P rounded to the input dtype as the A fragments of PV's k steps.
template <typename T, int BK>
__device__ __forceinline__ void pack_p(uint32_t (&pf)[BK / 16][4], const float (&s)[BK / 2]) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
        pf[j / 2][(j & 1) * 2 + 0] = Mma<T>::pack(s[4 * j], s[4 * j + 1]);
        pf[j / 2][(j & 1) * 2 + 1] = Mma<T>::pack(s[4 * j + 2], s[4 * j + 3]);
    }
}

// One block per (64-query tile, head, batch): warps 0-3 (the consumer
// warpgroup) take 16 query rows each, warp 4 loads. DP is the head dim
// padded to 32, 64 or 128 (wgmma_dp): columns d .. DP - 1 of every tile are
// zeros (TMA's fill past d, zero A fragments of Q), so they add exact zeros
// to S, and O's columns past d are never stored (PAD: d < DP; at d = DP
// no column check is compiled). Two blocks an SM at DP = 64 and 128, three
// at DP = 32 (fewer registers and 53 KB of shared memory).
// Accumulator layout (wgmma m64nN, fp32): element 4 j + e of a thread in warp
// w is row 16 w + g + 8 (e / 2), column 8 j + 2 t + e % 2 (g = lane / 4,
// t = lane % 4).
template <typename T, int DP, bool PAD>
__global__ void __launch_bounds__(WG_THREADS, DP == 32 ? 3 : 2) attention_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, const T* __restrict__ q, Strides qs, T* __restrict__ o, Strides os,
    int n, int d, float scale, int plus1) {
    constexpr int BK = wg_bk<DP>(), ATOM = wg_atom<DP>();
    constexpr bool QREGS = DP == 128;  // Q as A fragments in registers, not in shared memory
    extern __shared__ unsigned char smem_raw[];
    // the swizzled tiles want 1024-byte alignment; the launch asks for 1 KB more
    unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
    T* Qs = reinterpret_cast<T*>(base);                          // [WG_BQ][DP] (DP <= 64)
    T* Ks = Qs + (QREGS ? 0 : WG_BQ * DP);                       // [WG_STAGES][DP / ATOM][BK][ATOM]
    T* Vs = Ks + WG_STAGES * BK * DP;                            // [WG_STAGES][DP / ATOM][BK][ATOM]
    uint64_t* qbar = reinterpret_cast<uint64_t*>(Vs + WG_STAGES * BK * DP);
    uint64_t* full = qbar + 1;               // [WG_STAGES]: K and V of the stage arrived
    uint64_t* empty = full + WG_STAGES;      // [WG_STAGES]: every consumer warp is done with it

    const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * WG_BQ;
    const int tiles = (n + BK - 1) / BK;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

    if (threadIdx.x == 0) {
        mbar_init(qbar, 1);
        for (int s = 0; s < WG_STAGES; ++s) {
            mbar_init(full + s, 1);
            mbar_init(empty + s, WG_BQ / 16);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (warp == WG_BQ / 16) {  // the producer warp: one thread issues every copy
        if (lane == 0) {
            if constexpr (!QREGS) {
                mbar_expect_tx(qbar, WG_BQ * 2 * DP);
                tma_load_4d(Qs, &qmap, qbar, 0, q0, h, b);
            }
            for (int i = 0; i < tiles; ++i) {
                const int st = i % WG_STAGES;
                if (i >= WG_STAGES) mbar_wait(empty + st, (i / WG_STAGES - 1) & 1);
                mbar_expect_tx(full + st, 2 * BK * 2 * DP);
#pragma unroll
                for (int a = 0; a < DP / ATOM; ++a)
                    tma_load_4d(Ks + st * BK * DP + a * BK * ATOM, &kmap, full + st, a * ATOM, i * BK, h, b);
#pragma unroll
                for (int a = 0; a < DP / ATOM; ++a)
                    tma_load_4d(Vs + st * BK * DP + a * BK * ATOM, &vmap, full + st, a * ATOM, i * BK, h, b);
            }
        }
        return;
    }

    const int g = lane >> 2, t = lane & 3;
    const float sl2 = scale * LOG2E;
    float acc[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
    float m0 = plus1 ? 0.f : -INFINITY, m1 = m0;  // running max of rows g and g + 8, scaled
    float l0 = 0.f, l1 = 0.f;                    // this thread's share of the row sums
    float a0 = 1.f, a1 = 1.f;                    // the last softmax's rescale of acc
    float s[BK / 2];                             // scores, then p in place
    uint32_t pf[BK / 16][4];                     // P as the A fragments of PV's k steps
    uint32_t qf[QREGS ? 8 : 1][4];               // Q's A fragments (DP = 128)

    if constexpr (QREGS) {  // the warp's 16 query rows; rows past n and columns past d are zeros
        const T* qb = q + b * qs.b + h * qs.h;
        const int r0 = q0 + warp * 16;
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
            const bool live = !PAD || kk * 16 < d;  // d is a multiple of 16
            const int c = kk * 16 + 2 * t;
            qf[kk][0] = live ? load_pair(qb, qs.n, r0 + g, n, c) : 0u;
            qf[kk][1] = live ? load_pair(qb, qs.n, r0 + g + 8, n, c) : 0u;
            qf[kk][2] = live ? load_pair(qb, qs.n, r0 + g, n, c + 8) : 0u;
            qf[kk][3] = live ? load_pair(qb, qs.n, r0 + g + 8, n, c + 8) : 0u;
        }
    } else {
        mbar_wait(qbar, 0);
    }
    const uint64_t qd = wg_desc<DP>(Qs);
    auto kdesc = [&](int i) { return wg_desc<DP>(Ks + (i % WG_STAGES) * BK * DP); };
    // V MN-major; at DP = 128 its two column blocks are N blocks BK rows apart
    auto vdesc = [&](int i) {
        if constexpr (DP == 128) return sw128_mn_blocks_desc(Vs + (i % WG_STAGES) * BK * DP);
        else return wg_desc<DP>(Vs + (i % WG_STAGES) * BK * DP);
    };
    static_assert(!QREGS || BK * 128 == MN_BLOCK_BYTES, "V's column blocks one MN block apart");

    // Turn 0: S(0) alone.
    wait_tile(full, 0);
    s_issue<T, DP>(s, qf, qd, kdesc(0));
    wgmma_wait<0>();
    fence_regs(s);
    softmax_tile<BK>(s, 0, n, t, scale, sl2, m0, m1, l0, l1, a0, a1);
    pack_p<T, BK>(pf, s);
    // Turn i: S(i) = Q K_i^T and O += P(i-1) V_(i-1) issued together; the
    // softmax of S(i) then runs while PV(i-1) keeps the tensor cores busy.
    // Tile i-1's stage is released once PV(i-1) is done, so the ring holds
    // tiles i-1, i and the ones in flight.
    for (int i = 1; i < tiles; ++i) {
        wait_tile(full, i);
        s_issue<T, DP>(s, qf, qd, kdesc(i));
        pv_issue<T, DP>(acc, pf, a0, a1, vdesc(i - 1));
        wgmma_wait<1>();  // S(i) has landed; PV(i-1) may still run
        fence_regs(s);
        softmax_tile<BK>(s, i * BK, n, t, scale, sl2, m0, m1, l0, l1, a0, a1);
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(pf);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + (i - 1) % WG_STAGES);
        pack_p<T, BK>(pf, s);  // P(i), once PV(i-1) has read P(i-1)
    }
    // Turn `tiles`: the last PV alone.
    pv_issue<T, DP>(acc, pf, a0, a1, vdesc(tiles - 1));
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pf);

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    if (plus1) {
        l0 += ex2_approx(-m0 * LOG2E);
        l1 += ex2_approx(-m1 * LOG2E);
    }
    const int r = q0 + warp * 16 + g;
    T* ob = o + b * os.b + h * os.h;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
        const int c = 8 * j + 2 * t;
        if (PAD && c >= d) break;  // columns past d belong to the next head (or to k, v) in the qkv layout
        if (r < n)
            *reinterpret_cast<uint32_t*>(ob + (long long)r * os.n + c) =
                Mma<T>::pack(acc[4 * j] / l0, acc[4 * j + 1] / l0);
        if (r + 8 < n)
            *reinterpret_cast<uint32_t*>(ob + (long long)(r + 8) * os.n + c) =
                Mma<T>::pack(acc[4 * j + 2] / l1, acc[4 * j + 3] / l1);
    }
}

template <typename T, int DP, bool PAD>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int batch, int n, int heads, int d,
                 Strides qs, Strides ks, Strides vs, Strides os, float scale, int plus1, cudaStream_t stream) {
    const bool bf16 = std::is_same<T, __nv_bfloat16>::value;
    CUtensorMap qm, km, vm;
    if (!make_map(&qm, q, bf16, batch, n, heads, qs, WG_BQ, d, DP) ||
        !make_map(&km, k, bf16, batch, n, heads, ks, wg_bk<DP>(), d, DP) ||
        !make_map(&vm, v, bf16, batch, n, heads, vs, wg_bk<DP>(), d, DP))
        return static_cast<int>(cudaErrorInvalidValue);
    const int smem = wg_smem<DP>() + 1024;
    auto kernel = attention_fwd_wgmma_kernel<T, DP, PAD>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((n + WG_BQ - 1) / WG_BQ, heads, batch);
    kernel<<<grid, WG_THREADS, smem, stream>>>(qm, km, vm, static_cast<const T*>(q), qs, static_cast<T*>(o), os, n, d,
                                               scale, plus1);
    return passt_launch_status();
}

// The "wgmma" instance that takes head dim d (a multiple of 16 up to 128):
// DP = wgmma_dp(d), with the column check (PAD) where d < DP.
template <typename T>
int launch_wgmma_d(const void* q, const void* k, const void* v, void* o, int batch, int n, int heads, int d,
                   Strides qs, Strides ks, Strides vs, Strides os, float scale, int plus1, cudaStream_t st) {
    if (d % 16) return static_cast<int>(cudaErrorInvalidValue);
#define PASST_WG_CASE(DP, PAD) \
    return launch_wgmma<T, DP, PAD>(q, k, v, o, batch, n, heads, d, qs, ks, vs, os, scale, plus1, st)
    switch (wgmma_dp(d)) {
        case 32: if (d == 32) PASST_WG_CASE(32, false); PASST_WG_CASE(32, true);
        case 64: if (d == 64) PASST_WG_CASE(64, false); PASST_WG_CASE(64, true);
        default: if (d == 128) PASST_WG_CASE(128, false); PASST_WG_CASE(128, true);
    }
#undef PASST_WG_CASE
    return static_cast<int>(cudaErrorInvalidValue);
}

enum Path { PATH_FMA = 0, PATH_MMA = 1, PATH_SHORT = 2, PATH_WGMMA = 3 };

template <typename T>
int launch_path(int path, const void* q, const void* k, const void* v, void* o, int batch, int n,
                int heads, int d, Strides qs, Strides ks, Strides vs, Strides os, float scale,
                int plus1, cudaStream_t st) {
    switch (path) {
        case PATH_MMA:
            return launch_mma_d<T>(d, q, k, v, o, batch, n, heads, qs, ks, vs, os, scale, plus1, st);
        case PATH_SHORT:
            if (d != 64 || n > 64) break;
            if (n <= 16) return launch_short<T, 16>(q, k, v, o, batch, n, heads, qs, ks, vs, os, scale, plus1, st);
            return launch_short<T, 64>(q, k, v, o, batch, n, heads, qs, ks, vs, os, scale, plus1, st);
        case PATH_WGMMA:
            return launch_wgmma_d<T>(q, k, v, o, batch, n, heads, d, qs, ks, vs, os, scale, plus1, st);
    }
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q, k, v, o: element (b, t, h, c) at ptr[b * sb + t * sn + h * sh + c].
// dtype: 0 float32, 1 bfloat16, 2 float16. d <= 128 and a multiple of 8.
// path: 0 "fma" (any input), 1 "mma" (bf16/fp16, d != 64 and a multiple of
// 16), 2 "short" (bf16/fp16, d = 64, n <= 64), 3 "wgmma" (bf16/fp16,
// d = 64 or 32); the three
// tensor-core paths need 16-byte aligned base pointers and strides that are
// multiples of 8 elements. A path that cannot take the call returns
// cudaErrorInvalidValue and launches nothing. Otherwise returns
// cudaGetLastError() after the launch.
extern "C" int passt_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int path, int batch, int n, int heads, int d,
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
    if (path == PATH_FMA) {
        switch (dtype) {
            case 0: return launch_d<float>(dj, q, k, v, o, batch, n, heads, d, qs, ks, vs, os, scale, plus1, st);
            case 1: return launch_d<__nv_bfloat16>(dj, q, k, v, o, batch, n, heads, d, qs, ks, vs, os, scale, plus1, st);
            case 2: return launch_d<__half>(dj, q, k, v, o, batch, n, heads, d, qs, ks, vs, os, scale, plus1, st);
        }
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const bool aligned = vectors_aligned(q, qs) && vectors_aligned(k, ks) && vectors_aligned(v, vs) &&
                         vectors_aligned(o, os);
    if (!aligned) return static_cast<int>(cudaErrorInvalidValue);
    switch (dtype) {
        case 1: return launch_path<__nv_bfloat16>(path, q, k, v, o, batch, n, heads, d, qs, ks, vs, os, scale, plus1, st);
        case 2: return launch_path<__half>(path, q, k, v, o, batch, n, heads, d, qs, ks, vs, os, scale, plus1, st);
    }
    return static_cast<int>(cudaErrorInvalidValue);
}
