// Attention backward for Hopper (sm_90a) in fp32 FMA: the "simt" path of
// ops/attention.py backward_path, which takes every fp32 call (any head dim
// d, a multiple of 8 up to 128, any strides) and the bf16 / fp16 calls no
// tensor-core path takes (d = 8 mod 16, or unaligned views): the fp32
// training step's call at D = 64; the convergence demo's reduced PaSST at
// model.dtype=float32, 6 heads of D = 32 (B = 25, N = 79), and the same demo
// with 2 heads of D = 96.
//
// Replaces passt_tpu/ops/pallas/attention.py:_bwd_kernel (:188) and
// :_flat_bwd_kernel (:388) for those calls, as attention_bwd.cu's "fma"
// pair did (which no call dispatches to now; the private path override
// still reaches it). Both entries: every operand is a base pointer with
// (batch, token, head) strides, so q/k/v views into qkv are read and
// dq/dk/dv views into dqkv written in place. Both kernels are templates on
// the input type T (float, bf16, fp16) and the padded head dim DP (32, 64,
// 96, 128; simt_dp in attention_common.cuh): the call's d is a run-time
// argument of the loads and stores only, columns d .. DP - 1 are zeroed
// once in shared memory and never stored (exact zeros in every product over
// D), operands are converted to fp32 in shared memory (load_rows: 16-byte
// copies for 16-byte aligned operands, else 4-byte cp.async or element
// loads, chosen once per launch; an fp32 call at d = DP with aligned
// operands takes a FULL instance, whose copies and stores check nothing at
// run time, as attention_fwd_fp32.cu's). The fp32 instances at D = 64 and
// 32 are those of the first design, bit for bit (tools/attention_same_bits).
//
// The math is the reference kernel's, row for row (attention_bwd.cu's
// header): s = (q . k) * scale; m = row max (from 0 under plus1);
// p = exp(s - m); l = sum p (+ exp(-m) under plus1); il = 1 / l;
// dP = dO . v; di = sum(p dP) il; P_norm = p il; dS = P_norm (dP - di) scale;
// dQ = dS . k, dK = dS^T . q, dV = P_norm^T . dO. P_norm and dS are rounded
// to T as the products' left operands (dS from the unrounded P_norm), as
// the "fma" pair rounds them; the gradients are rounded to T once. At fp32
// those roundings are the identity, and every product is full fp32 on the
// FMA units (no TF32, no split products: the contract).
//
// What bounds it: fp32 FMA. The function is 10 N^2 D FLOP a head (3.45
// GFLOP at B = 2, H = 12, N = 474: 0.0515 ms at 67 TFLOP/s, the same at 6
// heads of D = 128 or 16 of D = 48; 0.30 GFLOP at the demo's B = 25, H = 6,
// N = 79, D = 32: 0.0045 ms, the same at 2 heads of D = 96); this path does
// 14 N^2 DP, the "wgmma" path's order:
// - Kernel S, one block per (64-query tile, head, batch), 128 threads, two
//   blocks an SM at D = 64 and three at D = 32: one pass over 64-key K/V
//   tiles (a 2-deep cp.async ring; one-deep at DP = 96, so that two blocks
//   fit an SM) with a running max, rescaling l = sum p and sum p dP by
//   exp(m_old - m_new) when it rises; writes m, il and di (4 N^2 D).
// - Kernel KV, one block per (64 keys, head, batch), KV_CONSUMERS FMA
//   threads and a dQ warp, one block an SM (two at D = 32): K and V
//   resident, one pass over the 64-query tiles (Q, dO and the tile's
//   statistics through a 2-deep cp.async ring, the next tile's load in
//   flight during this tile's arithmetic; one-deep at DP = 128): S^T = K Q^T
//   and dP^T = V dO^T, then P_norm and dS into shared memory, then dV +=
//   P_norm^T dO, dK += dS^T Q and dQ_part = dS K (10 N^2 D). dQ is summed
//   across key blocks in a fixed order, attention_bwd.cu's scheme: a counter
//   per query tile read with acquire and released after the adds, an fp32
//   scratch, the dQ warp adding each staged share with one TMA bulk add;
//   the last block stores.
//   Where it saves a round of blocks over the card's slots (the SMs times
//   the blocks of kernel KV an SM holds, the occupancy query: the fp32
//   step's B = 2, H = 12, N = 474 at D = 64 has 192 blocks on 132 slots,
//   two rounds, and 384 halves take three of half the work; the demo's
//   B = 25, H = 6, N = 79 at D = 32 has 300 blocks on 264 slots, two
//   rounds, and 600 halves take three of half the work), two blocks share
//   a key block, each walking half of the query tiles side by side: their
//   dQ turns interleave (kv_place) and half 0 hands its dK, dV over to half
//   1 (a flag, release / acquire), which adds them first. The same bits on
//   every run; every wait that depends on another block traps after 10 s.
// Against the "fma" pair's shared-memory bound (scalar loads, 4 x 4 scores
// a thread, 8 loads a 16 FMA, three passes over K/V in kernel A):
// - register micro-tiles: 4 x 8 scores a thread (4 x 4 on 256 threads);
//   KV_RR rows x KV_OC = DP / 8 columns of dK, dV and dQ;
// - operands in shared memory as they are in device memory (rows of DP
//   floats, pitch DP + 4). The two score products run along the rows (the
//   contraction index, D): per step of 4 a thread reads 4 + 8 float4 for
//   128 FMA; the three accumulating products are outer products over the
//   query (dV, dK) or key (dQ) index, a row of each operand a step: one
//   float4 (float2 at KV_RR = 2) + KV_OC / 4 float4 for KV_RR KV_OC FMA.
//   P_norm and dS are written [query][key] for dV and dK, dS also
//   [key][query] for dQ;
// - the rows a warp reads at once fall in distinct banks or are broadcast,
//   so each float4 load is one or two shared-memory wavefronts;
// - kernel KV's shared memory (K, V, the Q / dO ring, P_norm, dS both ways,
//   the staged dQ share): 174.6 KB at D = 64, one block an SM, 128 threads
//   holding dK, dV (32 each) and S^T, dP^T (32 each) or dQ (32) at 254
//   registers; at D = 32, 115.2 KB (P_norm and dS [query][key] at a pitch
//   of 64, whose float4 reads are broadcasts), under the 115.7 KB (113 KiB)
//   at which two blocks fit an SM, dK and dV 16 registers each, the launch
//   bounds capping the registers at 200. At DP = 96 and 128 the first
//   layout's 128 threads would hold dK and dV at 4 x 12 or 4 x 16 each
//   besides 64 scores (past 255 registers), and at DP = 128 its shared
//   memory (280.5 KiB) passes the 227 KiB a block may have. So there 256
//   FMA threads share the block: 4 x 4 scores of S^T and of dP^T, 2 rows x
//   DP / 8 columns of dK, dV and dQ a thread; at DP = 96 the layout is the
//   first one (224.5 KiB), at DP = 128 the Q / dO ring is one-deep (214.5
//   KiB), its next tile loaded once dV and dK have read this one, during
//   dQ_part.
// - Ragged N: keys past N get p = 0, queries past N get p = dS = 0, rows
//   past N are zero-filled on load and never stored.
// What sets its time (tools/attention_bwd_fp32_variants, PERF.md): at the
// fp32 step's shape (B = 2, H = 12, N = 474) kernel KV takes ~0.165 ms
// (0.195 before the halves) and kernel S ~0.068, 192 blocks two an SM. An
// SM runs a block at ~40-55% of its FMA rate; the score products cost
// ~1.7x the outer products per FMA. Neither more threads (two groups of
// 128 splitting each step's products, or 4 x 4 micro-tiles on 256 threads:
// +4%, +11%), nor broadcast loads, nor other unrolling moved it by more
// than 3% at D = 64; splitting kernel S's key walk in halves the same way
// made it 3% slower (two blocks an SM already run side by side at full
// speed).
#include "common.cuh"
#include "attention_common.cuh"
#include "hopper.cuh"

#include <math.h>
#include <stdint.h>

namespace {

using namespace passt_attn;
using namespace passt_hopper;

constexpr int PLD = SIMT_LD;      // pitch of the 64-wide score tiles (dS^T): 272 bytes
template <int DP>
constexpr int LD = simt_ld<DP>;   // Q, K, V, dO row pitch in floats: load_rows' layout
template <int DP>
constexpr int TILE = 64 * LD<DP>; // floats of a padded 64-row tile of Q, K, V or dO
// P_norm's and dS's [query][key] pitch: 68 at D = 64 (the first layout);
// 64 at the other DP, so that two blocks of kernel KV fit an SM at D = 32
// and one at DP = 96 and 128 (their float4 reads are broadcasts, and a
// warp's scalar writes are two-way at either pitch)
template <int DP>
constexpr int SLD = DP == 64 ? PLD : 64;
// Register micro-tiles. Kernel S: S_QR queries x S_KC keys a thread.
// Kernel KV: KV_KR keys x KV_QC queries of S^T and dP^T, and KV_RR rows x
// KV_OC<DP> columns of dK, dV and dQ, a thread; 128 FMA threads up to
// DP = 64, 256 above.
constexpr int S_QR = 4, S_KC = 8;
constexpr int KV_KR = 4;
template <int DP>
constexpr int KV_CONSUMERS = DP <= 64 ? 128 : 256;
template <int DP>
constexpr int KV_QC = 64 * 64 / (KV_KR * KV_CONSUMERS<DP>);
template <int DP>
constexpr int KV_RR = 4 * 128 / KV_CONSUMERS<DP>;
template <int DP>
constexpr int KV_OC = DP / 8;
constexpr int DG = 8;  // threads a row group of dK, dV and dQ: columns 4 (tid % DG) + 32 h
constexpr int S_THREADS = (64 / S_QR) * (64 / S_KC);
template <int DP>
constexpr bool kv_tiles_cover() {  // the score micro-tiles cover 64 x 64, the row groups 64 rows x DP columns
    return (64 / KV_KR) * (64 / KV_QC<DP>) == KV_CONSUMERS<DP> && KV_CONSUMERS<DP> / DG * KV_RR<DP> == 64 &&
           4 * DG == 32 && KV_OC<DP> / 4 * 32 == DP;
}
static_assert(kv_tiles_cover<32>() && kv_tiles_cover<64>() && kv_tiles_cover<96>() && kv_tiles_cover<128>(),
              "every instance's micro-tiles");
static_assert(KV_QC<64> == 8 && KV_RR<64> == 4 && KV_QC<32> == 8 && KV_RR<32> == 4,
              "the first design's micro-tiles up to D = 64");
template <int DP>
constexpr int KV_THREADS = KV_CONSUMERS<DP> + 32;  // the FMA threads, then the dQ warp
// the K/V ring of kernel S and the Q / dO ring of kernel KV: 2-deep, or
// 1-deep where that fits more blocks an SM (kernel S at DP = 96: two) or
// one block at all (kernel KV at DP = 128)
template <int DP>
constexpr int S_STAGES = DP == 96 ? 1 : 2;
template <int DP>
constexpr int KV_STAGES = DP == 128 ? 1 : 2;
// blocks an SM the launch bounds ask the registers to allow
template <int DP>
constexpr int S_MIN_BLOCKS = DP == 32 ? 3 : DP <= 96 ? 2 : 1;
template <int DP>
constexpr int KV_MIN_BLOCKS = DP == 32 ? 2 : 1;
template <int DP>
constexpr int S_SMEM = (2 + 2 * S_STAGES<DP>) * TILE<DP> * 4;  // Q, dO; the K/V ring
template <int DP>  // K, V, the Q / dO ring, P_norm, dS, dS^T, dQ, statistics
constexpr int KV_SMEM =
    ((2 + 2 * KV_STAGES<DP>) * TILE<DP> + 2 * 64 * SLD<DP> + 64 * PLD + 64 * DP + KV_STAGES<DP> * 3 * 64) * 4 + 16;
static_assert(KV_SMEM<64> == (9 * TILE<64> + 64 * 64 + 2 * 3 * 64) * 4 + 16, "the first design's layout");
static_assert(KV_SMEM<96> <= 227 * 1024 && KV_SMEM<128> <= 227 * 1024, "one block of kernel KV fits an SM");

// The saved row statistics: [B*H][tiles][3][64] floats (m, il, di of a
// tile together, so a block of kernel KV takes them with one copy).
struct Stats {
    float* base;
    int npad;  // N rounded up to 64
};

// acc[i][j] = A[ra + (64 / RI) i] . B[rb + (64 / CJ) j] over DP (shared rows
// of pitch LD<DP>).
template <int RI, int CJ, int DP>
__device__ __forceinline__ void dot(float (&acc)[RI][CJ], const float* A, int ra, const float* B, int rb) {
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
#pragma unroll 2
    for (int c = 0; c < DP; c += 4) {
        float4 a[RI], b[CJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) a[i] = *reinterpret_cast<const float4*>(A + (ra + 64 / RI * i) * LD<DP> + c);
#pragma unroll
        for (int j = 0; j < CJ; ++j) b[j] = *reinterpret_cast<const float4*>(B + (rb + 64 / CJ * j) * LD<DP> + c);
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
            for (int j = 0; j < CJ; ++j) {
                float x = fmaf(a[i].x, b[j].x, acc[i][j]);
                x = fmaf(a[i].y, b[j].y, x);
                x = fmaf(a[i].z, b[j].z, x);
                acc[i][j] = fmaf(a[i].w, b[j].w, x);
            }
    }
}

// acc[r][4 h + c] += sum over the 64 rows x of L[x][l0 + r]
// R[x][r0 + 32 h + c] (r < RR = 4 or 2, h < OC / 4, c < 4; L of pitch LL,
// R of pitch LR): an outer product, a row of each operand a step.
template <int RR, int OC, int LL, int LR>
__device__ __forceinline__ void outer(float (&acc)[RR][OC], const float* L, int l0, const float* R, int r0) {
    static_assert(RR == 4 || RR == 2, "a float4 or a float2 of L a step");
#pragma unroll 8
    for (int x = 0; x < 64; ++x) {
        float av[RR];
        if constexpr (RR == 4) {
            const float4 a = *reinterpret_cast<const float4*>(L + x * LL + l0);
            av[0] = a.x;
            av[1] = a.y;
            av[2] = a.z;
            av[3] = a.w;
        } else {
            const float2 a = *reinterpret_cast<const float2*>(L + x * LL + l0);
            av[0] = a.x;
            av[1] = a.y;
        }
        float bv[OC];
#pragma unroll
        for (int h = 0; h < OC / 4; ++h) {
            const float4 b = *reinterpret_cast<const float4*>(R + x * LR + r0 + 32 * h);
            bv[4 * h] = b.x;
            bv[4 * h + 1] = b.y;
            bv[4 * h + 2] = b.z;
            bv[4 * h + 3] = b.w;
        }
#pragma unroll
        for (int r = 0; r < RR; ++r)
#pragma unroll
            for (int c = 0; c < OC; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
}

// Wait until a tile's dQ counter reaches `pos` (acquire); trap after
// WAIT_LIMIT_NS rather than hang on a predecessor that never comes.
__device__ __forceinline__ void wait_turn(const int* count, int pos) {
    if (ld_acquire_gpu(count) >= pos) return;
    const uint64_t t0 = global_ns();
    while (ld_acquire_gpu(count) < pos)
        if (global_ns() - t0 > WAIT_LIMIT_NS) __trap();
}

// Kernel S: m, il, di of one 64-query tile. Thread (tq, tk) =
// (tid / (64 / S_KC), tid % (64 / S_KC)) holds queries tq + (64 / S_QR) i and
// keys tk + (64 / S_KC) j of each key tile; the threads of a query row are
// neighbouring lanes.
template <typename T, int DP, bool FULL>
__global__ void __launch_bounds__(S_THREADS, S_MIN_BLOCKS<DP>) bwd32_stats_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ dout,
    Strides qs, Strides ks, Strides vs, Strides dos, Stats st, int* __restrict__ counters, int* __restrict__ flags,
    int n, int d, float scale, int plus1, int vec) {
    constexpr int STAGES = S_STAGES<DP>;
    if constexpr (FULL) {  // d = DP and every operand aligned: the checks below fold away
        d = DP;
        vec = 1;
    }
    extern __shared__ __align__(16) float smem[];
    float* Qs = smem;
    float* Os = Qs + TILE<DP>;
    float* Kb = Os + TILE<DP>;           // [STAGES][TILE]
    float* Vb = Kb + STAGES * TILE<DP>;  // [STAGES][TILE]

    constexpr int KS = 64 / S_KC, QS = 64 / S_QR;  // key and query steps
    const int tid = threadIdx.x, tk = tid % KS, tq = tid / KS;
    const int tiles = (n + 63) / 64;
    const int b = blockIdx.z, h = blockIdx.y, tile = blockIdx.x, q0 = tile * 64;
    const long long bh = (long long)b * gridDim.y + h;
    const T* qb = q + b * qs.b + h * qs.h;
    const T* kb = k + b * ks.b + h * ks.h;
    const T* vb = v + b * vs.b + h * vs.h;
    const T* ob = dout + b * dos.b + h * dos.h;

    if (tid == 0) {  // kernel KV's dQ order of this tile, and its key block's dK/dV hand-over, start here
        counters[bh * tiles + tile] = 0;
        flags[bh * tiles + tile] = 0;
    }
    if (d < DP) simt_zero_pad<DP>(smem, (2 + 2 * STAGES) * 64, d, tid, S_THREADS);  // every buffer, side by side
    load_rows<T, DP, FULL>(Qs, qb, qs.n, q0, n, d, vec, tid, S_THREADS);
    load_rows<T, DP, FULL>(Os, ob, dos.n, q0, n, d, vec, tid, S_THREADS);
    load_rows<T, DP, FULL>(Kb, kb, ks.n, 0, n, d, vec, tid, S_THREADS);
    load_rows<T, DP, FULL>(Vb, vb, vs.n, 0, n, d, vec, tid, S_THREADS);
    cp_async_commit();

    const float sl2 = scale * LOG2E;
    float m[S_QR], l[S_QR], r[S_QR];
#pragma unroll
    for (int i = 0; i < S_QR; ++i) {
        m[i] = plus1 ? 0.f : -INFINITY;
        l[i] = r[i] = 0.f;
    }
    for (int t = 0; t < tiles; ++t) {
        if constexpr (STAGES == 2) {
            if (t + 1 < tiles) {  // into the buffer tile t - 1 used: every thread is past it
                load_rows<T, DP, FULL>(Kb + ((t + 1) & 1) * TILE<DP>, kb, ks.n, (t + 1) * 64, n, d, vec, tid, S_THREADS);
                load_rows<T, DP, FULL>(Vb + ((t + 1) & 1) * TILE<DP>, vb, vs.n, (t + 1) * 64, n, d, vec, tid, S_THREADS);
            }
            cp_async_commit();
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();
        const int slot = STAGES == 2 ? t & 1 : 0;
        float s[S_QR][S_KC], dp[S_QR][S_KC];
        dot<S_QR, S_KC, DP>(s, Qs, tq, Kb + slot * TILE<DP>, tk);
        dot<S_QR, S_KC, DP>(dp, Os, tq, Vb + slot * TILE<DP>, tk);
        const int k0 = t * 64;
#pragma unroll
        for (int i = 0; i < S_QR; ++i) {
            float x = -INFINITY;
#pragma unroll
            for (int j = 0; j < S_KC; ++j) {
                if (k0 + tk + KS * j >= n) s[i][j] = -INFINITY;  // keys past N: p = 0
                x = fmaxf(x, s[i][j]);
            }
#pragma unroll
            for (int off = 1; off < KS; off <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
            // key k0 < N, so x is finite; m_old = -inf gives alpha = 0
            const float mn = fmaxf(m[i], x * scale);
            const float alpha = ex2_approx((m[i] - mn) * LOG2E), ml = mn * LOG2E;
            float pl = 0.f, pr = 0.f;
#pragma unroll
            for (int j = 0; j < S_KC; ++j) {
                const float p = ex2_approx(fmaf(s[i][j], sl2, -ml));
                pl += p;
                pr = fmaf(p, dp[i][j], pr);
            }
            l[i] = l[i] * alpha + pl;
            r[i] = r[i] * alpha + pr;
            m[i] = mn;
        }
        __syncthreads();  // the buffer is refilled next
        if constexpr (STAGES == 1) {
            if (t + 1 < tiles) {
                load_rows<T, DP, FULL>(Kb, kb, ks.n, (t + 1) * 64, n, d, vec, tid, S_THREADS);
                load_rows<T, DP, FULL>(Vb, vb, vs.n, (t + 1) * 64, n, d, vec, tid, S_THREADS);
            }
            cp_async_commit();
        }
    }
    float* row = st.base + (bh * tiles + tile) * 3 * 64;
#pragma unroll
    for (int i = 0; i < S_QR; ++i) {
#pragma unroll
        for (int off = 1; off < KS; off <<= 1) {
            l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
            r[i] += __shfl_xor_sync(0xffffffffu, r[i], off);
        }
        if (plus1) l[i] += ex2_approx(-m[i] * LOG2E);
        const float il = 1.f / l[i];
        if (tk == 0) {  // all 64 rows (up to npad): kernel KV reads whole tiles
            row[tq + QS * i] = m[i];
            row[64 + tq + QS * i] = il;
            row[128 + tq + QS * i] = r[i] * il;
        }
    }
}

// attention_bwd.cu's kv_query_tile and kv_position: with `rotate`, block
// blk takes tile (s - blk) mod tiles at step s and is at place (blk + i) mod
// tiles of tile i's dQ order (the step at which it takes the tile);
// without, tiles in order and places by block index.
__device__ __forceinline__ int kv_query_tile(int blk, int s, int tiles, int rotate) {
    return rotate ? (s - blk + tiles) % tiles : s;
}
__device__ __forceinline__ int kv_position(int blk, int i, int tiles, int rotate) {
    return rotate ? (blk + i) % tiles : blk;
}

// With the query walk split in two halves (`halves` = 2: half 0 takes the
// rotation's steps 0 .. H0 - 1, H0 = ceil(tiles / 2), half 1 the rest, two
// blocks a key block running side by side), the place of step s in its
// tile's dQ order: 2 l + h for local step l of half h, so that at every
// local step each contribution waits only on one made at the same or the
// step before. With one half, kv_position.
__device__ __forceinline__ int kv_place(int blk, int s, int tiles, int rotate, int halves) {
    if (halves == 1) return kv_position(blk, kv_query_tile(blk, s, tiles, rotate), tiles, rotate);
    const int h0 = (tiles + 1) / 2, hf = s >= h0;
    return 2 * (s - hf * h0) + hf;
}


// Kernel KV: dK and dV of 64 keys and their share of dQ, in one pass over
// the query tiles. The first KV_CONSUMERS threads do the arithmetic; the
// last warp adds each staged dQ share to its tile's sum in the fixed order.
template <typename T, int DP, bool FULL>
__global__ void __launch_bounds__(KV_THREADS<DP>, KV_MIN_BLOCKS<DP>) bwd32_kv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, const T* __restrict__ dout,
    T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv, Strides qs, Strides ks, Strides vs, Strides dos,
    Strides dqs, Strides dks, Strides dvs, Stats st, float* __restrict__ dqacc, int* __restrict__ counters,
    float* __restrict__ kvacc, int* __restrict__ flags, int n, int d, float scale, int rotate, int halves, int vec) {
    constexpr int OC = KV_OC<DP>, RR = KV_RR<DP>, QC = KV_QC<DP>, CONSUMERS = KV_CONSUMERS<DP>;
    constexpr int STAGES = KV_STAGES<DP>;
    if constexpr (FULL) {  // d = DP and every operand aligned: the checks below fold away
        d = DP;
        vec = 1;
    }
    extern __shared__ __align__(16) float smem[];
    float* Ks = smem;                      // [64 keys][LD]
    float* Vs = Ks + TILE<DP>;             // [64 keys][LD]
    float* Qb = Vs + TILE<DP>;             // [STAGES][64 queries][LD]
    float* Ob = Qb + STAGES * TILE<DP>;    // [STAGES][64 queries][LD] dO
    float* PN = Ob + STAGES * TILE<DP>;    // [64 queries][SLD] P_norm, keys along the row
    float* DS = PN + 64 * SLD<DP>;         // [64 queries][SLD] dS
    float* DST = DS + 64 * SLD<DP>;        // [64 keys][PLD] dS^T
    float* DQs = DST + 64 * PLD;           // [64][DP] the staged dQ share, row-major
    float* Sm = DQs + 64 * DP;             // [STAGES][3][64] m, il, di
    uint64_t* dqfull = reinterpret_cast<uint64_t*>(Sm + STAGES * 3 * 64);  // a share staged
    uint64_t* dqfree = dqfull + 1;                                         // the dQ warp has read it

    const int tiles = (n + 63) / 64;  // the query tiles, and the key blocks
    const int b = blockIdx.z, h = blockIdx.y, half = blockIdx.x / tiles, blk = blockIdx.x % tiles;
    const long long bh = (long long)b * gridDim.y + h;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    // this block's steps of the rotation: s0 .. s0 + steps - 1
    const int h0 = halves == 2 ? (tiles + 1) / 2 : tiles;
    const int s0 = half * h0, steps = half ? tiles - h0 : h0;

    if (tid == 0) {
        mbar_init(dqfull, CONSUMERS / 32);
        mbar_init(dqfree, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (warp == CONSUMERS / 32) {  // the dQ warp
        T* dqb = dq + b * dqs.b + h * dqs.h;
        for (int t = 0; t < steps; ++t) {
            const int s = s0 + t, i = kv_query_tile(blk, s, tiles, rotate);
            float* acc = dqacc + (bh * st.npad + i * 64) * DP;
            mbar_wait_or_trap(dqfull, t & 1);
            const int pos = kv_place(blk, s, tiles, rotate, halves);
            int* count = counters + bh * tiles + i;
            if (pos > 0 && lane == 0) {
                wait_turn(count, pos);
                fence_proxy_async_global();  // its bulk writes before our reads and adds
            }
            __syncwarp();
            if (pos == tiles - 1) {  // the last: the sum and this share, stored
#pragma unroll 8
                for (int it = 0; it < 2 * DP / 4; ++it) {  // 64 rows of DP / 4 float4, 32 lanes
                    const int idx = it * 32 + lane;
                    const int rr = static_cast<unsigned>(idx) / (DP / 4), c = 4 * (static_cast<unsigned>(idx) % (DP / 4));
                    float4 x = *reinterpret_cast<const float4*>(DQs + rr * DP + c);
                    if (pos > 0) {
                        const float4 y = __ldcg(reinterpret_cast<const float4*>(acc + rr * DP + c));
                        x = make_float4(y.x + x.x, y.y + x.y, y.z + x.z, y.w + x.w);
                    }
                    if (i * 64 + rr < n && c < d) store4<T>(dqb + (long long)(i * 64 + rr) * dqs.n + c, x, vec);
                }
                __syncwarp();
                if (lane == 0) mbar_arrive(dqfree);
                continue;
            }
            if (lane == 0) {
                if (pos == 0)
                    bulk_store(acc, DQs, 64 * DP * 4);
                else
                    bulk_reduce_add(acc, DQs, 64 * DP * 4);
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

    const T* qb = q + b * qs.b + h * qs.h;
    const T* kb = k + b * ks.b + h * ks.h;
    const T* vb = v + b * vs.b + h * vs.h;
    const T* ob = dout + b * dos.b + h * dos.h;
    const float* stb = st.base + bh * tiles * 3 * 64;
    // Q, dO and the statistics of query tile i into ring slot `slot`
    auto stage = [&](int i, int slot) {
        load_rows<T, DP, FULL>(Qb + slot * TILE<DP>, qb, qs.n, i * 64, n, d, vec, tid, CONSUMERS);
        load_rows<T, DP, FULL>(Ob + slot * TILE<DP>, ob, dos.n, i * 64, n, d, vec, tid, CONSUMERS);
        if (tid < 48) passt::cp_async16(Sm + slot * 192 + 4 * tid, stb + i * 192 + 4 * tid);
    };
    const int key0 = blk * 64;
    if (d < DP) simt_zero_pad<DP>(Ks, (2 + 2 * STAGES) * 64, d, tid, CONSUMERS);  // K, V and the ring, side by side
    load_rows<T, DP, FULL>(Ks, kb, ks.n, key0, n, d, vec, tid, CONSUMERS);
    load_rows<T, DP, FULL>(Vs, vb, vs.n, key0, n, d, vec, tid, CONSUMERS);
    if (steps > 0) stage(kv_query_tile(blk, s0, tiles, rotate), 0);
    cp_async_commit();

    // S^T, dP^T: keys tk + KSTEP i, queries tq + QSTEP j; dK, dV: keys RR ra + r,
    // dQ: queries RR ra + r, columns cb + 32 h + c
    constexpr int KSTEP = 64 / KV_KR, QSTEP = 64 / QC;
    const int tk = tid % KSTEP, tq = tid / KSTEP;
    const int ra = tid / DG, cb = 4 * (tid % DG);
    const float sl2 = scale * LOG2E;
    float dka[RR][OC], dva[RR][OC];
#pragma unroll
    for (int r = 0; r < RR; ++r)
#pragma unroll
        for (int c = 0; c < OC; ++c) dka[r][c] = dva[r][c] = 0.f;

    for (int t = 0; t < steps; ++t) {
        const int s = s0 + t, i = kv_query_tile(blk, s, tiles, rotate), slot = STAGES == 2 ? t & 1 : 0, q0 = i * 64;
        cp_async_wait<0>();
        named_bar_sync(1, CONSUMERS);  // step t's tile has landed; every thread is done with step t - 1
        if constexpr (STAGES == 2) {
            if (t + 1 < steps) stage(kv_query_tile(blk, s + 1, tiles, rotate), slot ^ 1);
            cp_async_commit();
        }
        const float* Qs = Qb + slot * TILE<DP>;
        const float* Os = Ob + slot * TILE<DP>;
        const float* mt = Sm + slot * 192;

        float sT[KV_KR][QC], dpT[KV_KR][QC];
        dot<KV_KR, QC, DP>(sT, Ks, tk, Qs, tq);
        dot<KV_KR, QC, DP>(dpT, Vs, tk, Os, tq);
#pragma unroll
        for (int j = 0; j < QC; ++j) {
            const int qq = tq + QSTEP * j;
            const bool qv = q0 + qq < n;
            const float ml = mt[qq] * LOG2E, il = mt[64 + qq], di = mt[128 + qq];
#pragma unroll
            for (int r = 0; r < KV_KR; ++r) {
                const int kk = tk + KSTEP * r;
                const bool valid = qv && key0 + kk < n;
                const float pn = valid ? ex2_approx(fmaf(sT[r][j], sl2, -ml)) * il : 0.f;
                const float ds = round_to<T>(valid ? pn * (dpT[r][j] - di) * scale : 0.f);
                PN[qq * SLD<DP> + kk] = round_to<T>(pn);  // the products' operands in T (the identity at fp32)
                DS[qq * SLD<DP> + kk] = ds;
                DST[kk * PLD + qq] = ds;
            }
        }
        named_bar_sync(1, CONSUMERS);  // P_norm and dS are in shared memory

        outer<RR, OC, SLD<DP>, LD<DP>>(dva, PN, RR * ra, Os, cb);  // dV += P_norm^T dO
        outer<RR, OC, SLD<DP>, LD<DP>>(dka, DS, RR * ra, Qs, cb);  // dK += dS^T Q
        if constexpr (STAGES == 1) {  // the ring's one slot is free: the next tile lands during dQ_part
            named_bar_sync(1, CONSUMERS);
            if (t + 1 < steps) stage(kv_query_tile(blk, s + 1, tiles, rotate), 0);
            cp_async_commit();
        }
        float dqa[RR][OC];
#pragma unroll
        for (int r = 0; r < RR; ++r)
#pragma unroll
            for (int c = 0; c < OC; ++c) dqa[r][c] = 0.f;
        outer<RR, OC, PLD, LD<DP>>(dqa, DST, RR * ra, Ks, cb);  // dQ_part = dS K

        // stage dQ_part for the dQ warp, once it has read the last share
        if (t > 0) mbar_wait_or_trap(dqfree, (t - 1) & 1);
#pragma unroll
        for (int r = 0; r < RR; ++r)
#pragma unroll
            for (int hh = 0; hh < OC / 4; ++hh)
                *reinterpret_cast<float4*>(DQs + (RR * ra + r) * DP + cb + 32 * hh) =
                    make_float4(dqa[r][4 * hh], dqa[r][4 * hh + 1], dqa[r][4 * hh + 2], dqa[r][4 * hh + 3]);
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(dqfull);
    }
    cp_async_wait<0>();

    if (halves == 2) {  // half 0 hands its dK, dV over; half 1 adds them first, in that order
        float* part = kvacc + (bh * tiles + blk) * 2 * 64 * DP;  // [dK, dV][64 keys][DP]
        int* flag = flags + bh * tiles + blk;
        if (half == 0) {
#pragma unroll
            for (int r = 0; r < RR; ++r)
#pragma unroll
                for (int hh = 0; hh < OC / 4; ++hh) {
                    const int at = (RR * ra + r) * DP + cb + 32 * hh;
                    *reinterpret_cast<float4*>(part + at) =
                        make_float4(dka[r][4 * hh], dka[r][4 * hh + 1], dka[r][4 * hh + 2], dka[r][4 * hh + 3]);
                    *reinterpret_cast<float4*>(part + 64 * DP + at) =
                        make_float4(dva[r][4 * hh], dva[r][4 * hh + 1], dva[r][4 * hh + 2], dva[r][4 * hh + 3]);
                }
            named_bar_sync(1, CONSUMERS);
            if (tid == 0) {
                __threadfence();
                st_release_gpu(flag, 1);
            }
            return;
        }
        if (tid == 0) wait_turn(flag, 1);  // half 0's dK, dV are in place
        named_bar_sync(1, CONSUMERS);
#pragma unroll
        for (int r = 0; r < RR; ++r)
#pragma unroll
            for (int hh = 0; hh < OC / 4; ++hh) {
                const int at = (RR * ra + r) * DP + cb + 32 * hh;
                const float4 pk = __ldcg(reinterpret_cast<const float4*>(part + at));
                const float4 pv = __ldcg(reinterpret_cast<const float4*>(part + 64 * DP + at));
                const float ok[4] = {pk.x, pk.y, pk.z, pk.w}, ov[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    dka[r][4 * hh + c] = ok[c] + dka[r][4 * hh + c];
                    dva[r][4 * hh + c] = ov[c] + dva[r][4 * hh + c];
                }
            }
    }

    T* dkb = dk + b * dks.b + h * dks.h;
    T* dvb = dv + b * dvs.b + h * dvs.h;
#pragma unroll
    for (int r = 0; r < RR; ++r) {
        const int key = key0 + RR * ra + r;
        if (key >= n) continue;
#pragma unroll
        for (int hh = 0; hh < OC / 4; ++hh) {
            const int c = cb + 32 * hh;
            if (c >= d) continue;
            store4<T>(dkb + (long long)key * dks.n + c,
                      make_float4(dka[r][4 * hh], dka[r][4 * hh + 1], dka[r][4 * hh + 2], dka[r][4 * hh + 3]), vec);
            store4<T>(dvb + (long long)key * dvs.n + c,
                      make_float4(dva[r][4 * hh], dva[r][4 * hh + 1], dva[r][4 * hh + 2], dva[r][4 * hh + 3]), vec);
        }
    }
}

// Both kernels' dynamic shared memory, and the carve-out as large as it
// goes, so that their MIN_BLOCKS fit an SM.
template <typename T, int DP, bool FULL>
cudaError_t configure() {
    const auto ks = bwd32_stats_kernel<T, DP, FULL>;
    const auto kv = bwd32_kv_kernel<T, DP, FULL>;
    cudaError_t err = cudaFuncSetAttribute(ks, cudaFuncAttributeMaxDynamicSharedMemorySize, S_SMEM<DP>);
    if (err == cudaSuccess) err = cudaFuncSetAttribute(kv, cudaFuncAttributeMaxDynamicSharedMemorySize, KV_SMEM<DP>);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(ks, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(kv, cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
    return err;
}

// Blocks of kernel S and of kernel KV an SM holds at once (the occupancy
// query).
template <typename T, int DP, bool FULL>
cudaError_t occupancy(int* stats_blocks, int* kv_blocks) {
    cudaError_t err = configure<T, DP, FULL>();
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(stats_blocks, bwd32_stats_kernel<T, DP, FULL>, S_THREADS,
                                                            S_SMEM<DP>);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(kv_blocks, bwd32_kv_kernel<T, DP, FULL>, KV_THREADS<DP>,
                                                            KV_SMEM<DP>);
    return err;
}

// Two blocks a key block, each walking half of the query tiles, where that
// takes fewer rounds of blocks over the card's slots (`slots`: the SMs
// times the blocks of kernel KV an SM holds): at D = 64 (one block an SM)
// the fp32 step's B = 2, H = 12, N = 474 has 192 blocks, two rounds on 132
// slots, and 384 halves three rounds of half the work; at D = 32 (two an
// SM) the demo's B = 25, H = 6, N = 79 has 300 blocks, two rounds on 264
// slots, and 600 halves three. Both halves of every key block of a head
// must fit on the card at once (their dQ turns interleave).
int kv_halves(int batch, int n, int heads, int slots) {
    const long long tiles = (n + 63) / 64, blocks = (long long)batch * heads * tiles;
    if (tiles < 2 || 2 * tiles > slots) return 1;
    const long long rounds = (blocks + slots - 1) / slots, half_rounds = (2 * blocks + slots - 1) / slots;
    return half_rounds < 2 * rounds ? 2 : 1;
}

// The card's slots for kernel KV of the (T, DP) instance: the SMs times its
// blocks an SM (the answer is 0 where the occupancy query fails).
template <typename T, int DP, bool FULL>
cudaError_t kv_slots(int sms, int* slots) {
    int stats_blocks = 0, kv_blocks = 0;
    *slots = occupancy<T, DP, FULL>(&stats_blocks, &kv_blocks) == cudaSuccess ? sms * kv_blocks : 0;
    return cudaSuccess;
}

// Floats of scratch the call takes (see passt_attention_bwd_fp32_scratch).
long long scratch_floats(int batch, int n, int heads, int dp, int halves) {
    const long long tiles = (n + 63) / 64, bh = (long long)batch * heads;
    const long long split = halves == 2 ? 2 * 64 * dp : 0;
    return bh * tiles * (3 * 64 + 64 * dp + split) + 2 * ((bh * tiles + 3) / 4 * 4);
}

struct Args {
    const void *q, *k, *v, *dout;
    void *dq, *dk, *dv;
    float* scratch;
    int batch, n, heads, d;
    Strides qs, ks, vs, dos, dqs, dks, dvs;
    float scale;
    int plus1, slots, vec;
    cudaStream_t stream;
};

template <typename T, int DP, bool FULL>
cudaError_t launch(const Args& a) {
    const int tiles = (a.n + 63) / 64;
    const long long bh = (long long)a.batch * a.heads;
    float* stats = a.scratch;
    float* dqacc = stats + bh * tiles * 3 * 64;
    int* counters = reinterpret_cast<int*>(dqacc + bh * tiles * 64 * DP);
    const long long ints = (bh * tiles + 3) / 4 * 4;  // counters and flags, each 16-byte aligned
    int* flags = counters + ints;
    float* kvacc = reinterpret_cast<float*>(flags + ints);
    const int halves = kv_halves(a.batch, a.n, a.heads, a.slots);
    const Stats sts{stats, tiles * 64};
    const auto c = [](const void* p) { return static_cast<const T*>(p); };
    const auto w = [](void* p) { return static_cast<T*>(p); };
    cudaError_t err = configure<T, DP, FULL>();
    if (err != cudaSuccess) return err;
    bwd32_stats_kernel<T, DP, FULL><<<dim3(tiles, a.heads, a.batch), S_THREADS, S_SMEM<DP>, a.stream>>>(
        c(a.q), c(a.k), c(a.v), c(a.dout), a.qs, a.ks, a.vs, a.dos, sts, counters, flags, a.n, a.d, a.scale, a.plus1,
        a.vec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    // With the rotated order a block may wait on a block of its (batch,
    // head) with a higher index, so a head's blocks must all fit on the
    // card at once (kv_halves asks that of both halves); otherwise blocks
    // wait only on lower indices, which the hardware dispatches first.
    const int rotate = tiles <= a.slots;
    bwd32_kv_kernel<T, DP, FULL><<<dim3(tiles * halves, a.heads, a.batch), KV_THREADS<DP>, KV_SMEM<DP>, a.stream>>>(
        c(a.q), c(a.k), c(a.v), c(a.dout), w(a.dq), w(a.dk), w(a.dv), a.qs, a.ks, a.vs, a.dos, a.dqs, a.dks, a.dvs,
        sts, dqacc, counters, kvacc, flags, a.n, a.d, a.scale, rotate, halves, a.vec);
    return cudaSuccess;
}

}  // namespace

// Blocks of kernel S and of kernel KV of the instance that takes dtype code
// `dtype` at head dim d (`aligned`: every operand 16-byte aligned) an SM
// holds at once (the occupancy query). Returns a CUDA error code.
extern "C" int passt_attention_bwd_fp32_occupancy(int dtype, int d, int aligned, int* stats_blocks, int* kv_blocks) {
    return static_cast<int>(PASST_SIMT_DISPATCH(occupancy, dtype, d, aligned, stats_blocks, kv_blocks));
}

// Floats of scratch (16-byte aligned) the call takes at dtype code `dtype`
// and head dim d (`aligned`: every operand 16-byte aligned, with strides in
// multiples of 8 elements), on a card of `sms` multiprocessors: the row statistics
// [B*H][tiles][3][64], the dQ sums [B*H][tiles][64][DP], the per-tile
// counters and dK/dV hand-over flags, and where the query walk is split in
// two halves the hand-over's dK and dV [B*H][tiles][2][64][DP] (DP the
// instance's padded head dim). -1 for a dtype or d no instance takes, or
// where the occupancy query fails.
extern "C" long long passt_attention_bwd_fp32_scratch(int dtype, int batch, int n, int heads, int d, int aligned,
                                                      int sms) {
    int slots = 0;
    if (PASST_SIMT_DISPATCH(kv_slots, dtype, d, aligned, sms, &slots) != cudaSuccess || slots <= 0) return -1;
    return scratch_floats(batch, n, heads, simt_dp(d), kv_halves(batch, n, heads, slots));
}

// q, k, v, dout, dq, dk, dv: dtype code `dtype` (0 fp32, 1 bf16, 2 fp16),
// element (b, t, h, c) at ptr[b * sb + t * sn + h * sh + c]; d a multiple of
// 8 up to 128 (else cudaErrorInvalidValue and nothing launched); scratch
// 16-byte aligned, `scratch_size` floats, at least
// passt_attention_bwd_fp32_scratch's size (else cudaErrorInvalidValue). Every operand
// 16-byte aligned with strides in multiples of 8 elements takes the 16-byte
// copies and stores. sms: the card's multiprocessor count. Returns
// cudaGetLastError() after the launches.
extern "C" int passt_attention_bwd_fp32(const void* q, const void* k, const void* v, const void* dout, void* dq,
                                        void* dk, void* dv, void* scratch, long long scratch_size, int dtype,
                                        int batch, int n, int heads,
                                        int d, long long qsb, long long qsn, long long qsh,
                                        long long ksb, long long ksn, long long ksh,
                                        long long vsb, long long vsn, long long vsh,
                                        long long dosb, long long dosn, long long dosh,
                                        long long dqsb, long long dqsn, long long dqsh,
                                        long long dksb, long long dksn, long long dksh,
                                        long long dvsb, long long dvsn, long long dvsh,
                                        float scale, int plus1, int sms, void* stream) {
    const Strides qs{qsb, qsn, qsh}, ks{ksb, ksn, ksh}, vs{vsb, vsn, vsh}, dos{dosb, dosn, dosh};
    const Strides dqs{dqsb, dqsn, dqsh}, dks{dksb, dksn, dksh}, dvs{dvsb, dvsn, dvsh};
    const int vec = vectors_aligned(q, qs) && vectors_aligned(k, ks) && vectors_aligned(v, vs) &&
                    vectors_aligned(dout, dos) && vectors_aligned(dq, dqs) && vectors_aligned(dk, dks) &&
                    vectors_aligned(dv, dvs);
    if (n <= 0 || batch <= 0 || heads <= 0 || batch > 65535 || heads > 65535 ||
        reinterpret_cast<uintptr_t>(scratch) % 16 != 0)
        return static_cast<int>(cudaErrorInvalidValue);
    int slots = 0;
    cudaError_t err = PASST_SIMT_DISPATCH(kv_slots, dtype, d, vec, sms, &slots);
    if (err != cudaSuccess || slots <= 0 ||
        scratch_size < scratch_floats(batch, n, heads, simt_dp(d), kv_halves(batch, n, heads, slots)))
        return static_cast<int>(cudaErrorInvalidValue);
    const Args a{q, k, v, dout, dq, dk, dv, static_cast<float*>(scratch), batch, n, heads, d,
                 qs, ks, vs, dos, dqs, dks, dvs, scale, plus1, slots, vec, static_cast<cudaStream_t>(stream)};
    err = PASST_SIMT_DISPATCH(launch, dtype, d, vec, a);
    if (err != cudaSuccess) return static_cast<int>(err);
    return passt_launch_status();
}
