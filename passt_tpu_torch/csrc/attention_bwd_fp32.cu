// Attention backward for Hopper (sm_90a), fp32 at D = 64 and D = 32: the
// "simt" path of ops/attention.py backward_path (the fp32 training step's
// call at D = 64; the convergence demo's reduced PaSST at
// model.dtype=float32, 6 heads of D = 32, B = 25, N = 79).
//
// Replaces, for fp32 inputs at D = 64 or 32 with 16-byte aligned strides:
// passt_tpu/ops/pallas/attention.py:_bwd_kernel (:188) and
// :_flat_bwd_kernel (:388), as attention_bwd.cu's "fma" pair did (which
// stays for fp32 at another D and for unaligned views). Both entries: every
// operand is a base pointer with (batch, token, head) strides, so q/k/v
// views into qkv are read and dq/dk/dv views into dqkv written in place.
// Both kernels are templates on D; the D = 64 instances are those of the
// first design, bit for bit.
//
// The math is the reference kernel's, row for row (attention_bwd.cu's
// header): s = (q . k) * scale; m = row max (from 0 under plus1);
// p = exp(s - m); l = sum p (+ exp(-m) under plus1); il = 1 / l;
// dP = dO . v; di = sum(p dP) il; P_norm = p il; dS = P_norm (dP - di) scale;
// dQ = dS . k, dK = dS^T . q, dV = P_norm^T . dO. At fp32 rounding P_norm
// and dS to the input dtype is the identity, and every product is full
// fp32 on the FMA units (no TF32, no split products: the contract).
//
// What bounds it: fp32 FMA. The function is 10 N^2 D FLOP a head (3.45
// GFLOP at B = 2, H = 12, N = 474: 0.0515 ms at 67 TFLOP/s; 0.30 GFLOP at
// the demo's B = 25, H = 6, N = 79, D = 32: 0.0045 ms); this path does
// 14 N^2 D, the "wgmma" path's order:
// - Kernel S, one block per (64-query tile, head, batch), 128 threads, two
//   blocks an SM at D = 64 and three at D = 32: one pass over 64-key K/V
//   tiles (a 2-deep cp.async ring) with a running max, rescaling l = sum p
//   and sum p dP by exp(m_old - m_new) when it rises; writes m, il and di
//   (4 N^2 D).
// - Kernel KV, one block per (64 keys, head, batch), 128 FMA threads and a
//   dQ warp, one block an SM at D = 64 and two at D = 32: K and V resident,
//   one pass over the 64-query tiles (Q, dO and the tile's statistics
//   through a 2-deep cp.async ring, the next tile's load in flight during
//   this tile's arithmetic): S^T = K Q^T and dP^T = V dO^T, then P_norm and
//   dS into shared memory, then dV += P_norm^T dO, dK += dS^T Q and
//   dQ_part = dS K (10 N^2 D). dQ is summed across key blocks in a fixed
//   order, attention_bwd.cu's scheme: a counter per query tile read with
//   acquire and released after the adds, an fp32 scratch, the dQ warp
//   adding each staged share with one TMA bulk add; the last block stores.
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
// - register micro-tiles: 4 x 8 scores a thread; 4 rows x KV_OC<D> = D / 8
//   columns of dK, dV and dQ (8 at D = 64, 4 at D = 32);
// - operands in shared memory as they are in device memory (rows of D
//   floats, pitch D + 4: 68 or 36). The two score products run along the
//   rows (the contraction index, D): per step of 4 a thread reads 4 + 8
//   float4 for 128 FMA; the three accumulating products are outer products
//   over the query (dV, dK) or key (dQ) index, a row of each operand a
//   step: 1 + KV_OC / 4 float4 for 4 KV_OC FMA. P_norm and dS are written
//   [query][key] for dV and dK, dS also [key][query] for dQ;
// - the rows a warp reads at once fall in distinct banks or are broadcast,
//   so each float4 load is one or two shared-memory wavefronts;
// - kernel KV's shared memory (K, V, the Q / dO ring, P_norm, dS both ways,
//   the staged dQ share): 174.6 KB at D = 64, one block an SM, 128 threads
//   holding dK, dV (32 each) and S^T, dP^T (32 each) or dQ (32) at 254
//   registers; at D = 32, 115.2 KB (P_norm and dS [query][key] at a pitch
//   of 64, whose float4 reads are broadcasts), under the 115.7 KB (113 KiB)
//   at which two blocks fit an SM, dK and dV 16 registers each, the launch
//   bounds capping the registers at 200.
// - Ragged N: keys past N get p = 0, queries past N get p = dS = 0, rows
//   past N are zero-filled on load and never stored.
// What sets its time (tools/attention_bwd_fp32_variants, PERF.md): at the
// fp32 step's shape (B = 2, H = 12, N = 474) kernel KV takes ~0.165 ms
// (0.195 before the halves) and kernel S ~0.068, 192 blocks two an SM. An
// SM runs a block at ~40-55% of its FMA rate; the score products cost
// ~1.7x the outer products per FMA. Neither more threads (two groups of
// 128 splitting each step's products, or 4 x 4 micro-tiles on 256 threads:
// +4%, +11%), nor broadcast loads, nor other unrolling moved it by more
// than 3%; splitting kernel S's key walk in halves the same way made it 3%
// slower (two blocks an SM already run side by side at full speed).
#include "common.cuh"
#include "attention_common.cuh"
#include "hopper.cuh"

#include <math.h>
#include <stdint.h>

namespace {

using namespace passt_attn;
using namespace passt_hopper;

constexpr int PLD = SIMT_LD;     // pitch of the 64-wide score tiles (dS^T): 272 bytes
template <int D>
constexpr int LD = simt_ld<D>;   // Q, K, V, dO row pitch in floats: load_rows' layout
template <int D>
constexpr int TILE = 64 * LD<D>; // floats of a padded 64-row tile of Q, K, V or dO
// P_norm's and dS's [query][key] pitch: 68 at D = 64 (the first layout);
// 64 at D = 32, so that two blocks of kernel KV fit an SM (their float4
// reads are broadcasts, and a warp's scalar writes are two-way at either
// pitch)
template <int D>
constexpr int SLD = D == 64 ? PLD : 64;
// Register micro-tiles. Kernel S: S_QR queries x S_KC keys a thread.
// Kernel KV: KV_KR keys x KV_QC queries of S^T and dP^T, and 4 rows x
// KV_OC<D> columns of dK, dV and dQ, a thread.
constexpr int S_QR = 4, S_KC = 8;
constexpr int KV_KR = 4, KV_QC = 8;
template <int D>
constexpr int KV_OC = D / 8;
constexpr int S_THREADS = (64 / S_QR) * (64 / S_KC);
constexpr int KV_CONSUMERS = (64 / KV_KR) * (64 / KV_QC);
static_assert(KV_CONSUMERS == 16 * (64 / KV_OC<64>) && KV_CONSUMERS == 16 * (32 / KV_OC<32>),
              "one thread count for both micro-tiles");
constexpr int KV_THREADS = KV_CONSUMERS + 32;  // the FMA threads, then the dQ warp
// blocks an SM the launch bounds ask the registers to allow
template <int D>
constexpr int S_MIN_BLOCKS = D == 64 ? 2 : 3;
template <int D>
constexpr int KV_MIN_BLOCKS = D == 64 ? 1 : 2;
template <int D>
constexpr int S_SMEM = 6 * TILE<D> * 4;       // Q, dO; the 2-deep K/V ring
template <int D>                              // K, V, the Q / dO ring, P_norm, dS, dS^T, dQ, statistics
constexpr int KV_SMEM = (6 * TILE<D> + 2 * 64 * SLD<D> + 64 * PLD + 64 * D + 2 * 3 * 64) * 4 + 16;
static_assert(KV_SMEM<64> == (9 * TILE<64> + 64 * 64 + 2 * 3 * 64) * 4 + 16, "the first design's layout");

// The saved row statistics: [B*H][tiles][3][64] floats (m, il, di of a
// tile together, so a block of kernel KV takes them with one copy).
struct Stats {
    float* base;
    int npad;  // N rounded up to 64
};

// acc[i][j] = A[ra + (64 / RI) i] . B[rb + (64 / CJ) j] over D (shared rows
// of pitch LD<D>).
template <int RI, int CJ, int D>
__device__ __forceinline__ void dot(float (&acc)[RI][CJ], const float* A, int ra, const float* B, int rb) {
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
#pragma unroll 2
    for (int c = 0; c < D; c += 4) {
        float4 a[RI], b[CJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) a[i] = *reinterpret_cast<const float4*>(A + (ra + 64 / RI * i) * LD<D> + c);
#pragma unroll
        for (int j = 0; j < CJ; ++j) b[j] = *reinterpret_cast<const float4*>(B + (rb + 64 / CJ * j) * LD<D> + c);
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
// R[x][r0 + 32 h + c] (r < 4, h < OC / 4, c < 4; L of pitch LL, R of pitch
// LR): an outer product, a row of each operand a step.
template <int OC, int LL, int LR>
__device__ __forceinline__ void outer(float (&acc)[4][OC], const float* L, int l0, const float* R, int r0) {
#pragma unroll 8
    for (int x = 0; x < 64; ++x) {
        const float4 a = *reinterpret_cast<const float4*>(L + x * LL + l0);
        const float av[4] = {a.x, a.y, a.z, a.w};
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
        for (int r = 0; r < 4; ++r)
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
template <int D>
__global__ void __launch_bounds__(S_THREADS, S_MIN_BLOCKS<D>) bwd32_stats_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, Strides qs, Strides ks, Strides vs, Strides dos, Stats st,
    int* __restrict__ counters, int* __restrict__ flags, int n, float scale, int plus1) {
    extern __shared__ __align__(16) float smem[];
    float* Qs = smem;
    float* Os = Qs + TILE<D>;
    float* Kb = Os + TILE<D>;      // [2][TILE]
    float* Vb = Kb + 2 * TILE<D>;  // [2][TILE]

    constexpr int KS = 64 / S_KC, QS = 64 / S_QR;  // key and query steps
    const int tid = threadIdx.x, tk = tid % KS, tq = tid / KS;
    const int tiles = (n + 63) / 64;
    const int b = blockIdx.z, h = blockIdx.y, tile = blockIdx.x, q0 = tile * 64;
    const long long bh = (long long)b * gridDim.y + h;
    const float* qb = q + b * qs.b + h * qs.h;
    const float* kb = k + b * ks.b + h * ks.h;
    const float* vb = v + b * vs.b + h * vs.h;
    const float* ob = dout + b * dos.b + h * dos.h;

    if (tid == 0) {  // kernel KV's dQ order of this tile, and its key block's dK/dV hand-over, start here
        counters[bh * tiles + tile] = 0;
        flags[bh * tiles + tile] = 0;
    }
    load_rows<D>(Qs, qb, qs.n, q0, n, tid, S_THREADS);
    load_rows<D>(Os, ob, dos.n, q0, n, tid, S_THREADS);
    load_rows<D>(Kb, kb, ks.n, 0, n, tid, S_THREADS);
    load_rows<D>(Vb, vb, vs.n, 0, n, tid, S_THREADS);
    cp_async_commit();

    const float sl2 = scale * LOG2E;
    float m[S_QR], l[S_QR], r[S_QR];
#pragma unroll
    for (int i = 0; i < S_QR; ++i) {
        m[i] = plus1 ? 0.f : -INFINITY;
        l[i] = r[i] = 0.f;
    }
    for (int t = 0; t < tiles; ++t) {
        if (t + 1 < tiles) {  // into the buffer tile t - 1 used: every thread is past it
            load_rows<D>(Kb + ((t + 1) & 1) * TILE<D>, kb, ks.n, (t + 1) * 64, n, tid, S_THREADS);
            load_rows<D>(Vb + ((t + 1) & 1) * TILE<D>, vb, vs.n, (t + 1) * 64, n, tid, S_THREADS);
        }
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        float s[S_QR][S_KC], dp[S_QR][S_KC];
        dot<S_QR, S_KC, D>(s, Qs, tq, Kb + (t & 1) * TILE<D>, tk);
        dot<S_QR, S_KC, D>(dp, Os, tq, Vb + (t & 1) * TILE<D>, tk);
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
        __syncthreads();  // buffer t & 1 is refilled next iteration
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
// the query tiles. Warps 0-3 do the arithmetic; warp 4 adds each staged dQ
// share to its tile's sum in the fixed order.
template <int D>
__global__ void __launch_bounds__(KV_THREADS, KV_MIN_BLOCKS<D>) bwd32_kv_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    const float* __restrict__ dout, float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
    Strides qs, Strides ks, Strides vs, Strides dos, Strides dqs, Strides dks, Strides dvs, Stats st,
    float* __restrict__ dqacc, int* __restrict__ counters, float* __restrict__ kvacc, int* __restrict__ flags,
    int n, float scale, int rotate, int halves) {
    constexpr int OC = KV_OC<D>;
    extern __shared__ __align__(16) float smem[];
    float* Ks = smem;                // [64 keys][LD]
    float* Vs = Ks + TILE<D>;        // [64 keys][LD]
    float* Qb = Vs + TILE<D>;        // [2][64 queries][LD]
    float* Ob = Qb + 2 * TILE<D>;    // [2][64 queries][LD] dO
    float* PN = Ob + 2 * TILE<D>;    // [64 queries][SLD] P_norm, keys along the row
    float* DS = PN + 64 * SLD<D>;    // [64 queries][SLD] dS
    float* DST = DS + 64 * SLD<D>;   // [64 keys][PLD] dS^T
    float* DQs = DST + 64 * PLD;     // [64][D] the staged dQ share, row-major
    float* Sm = DQs + 64 * D;        // [2][3][64] m, il, di
    uint64_t* dqfull = reinterpret_cast<uint64_t*>(Sm + 2 * 3 * 64);  // a share staged
    uint64_t* dqfree = dqfull + 1;                                     // the dQ warp has read it

    const int tiles = (n + 63) / 64;  // the query tiles, and the key blocks
    const int b = blockIdx.z, h = blockIdx.y, half = blockIdx.x / tiles, blk = blockIdx.x % tiles;
    const long long bh = (long long)b * gridDim.y + h;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    // this block's steps of the rotation: s0 .. s0 + steps - 1
    const int h0 = halves == 2 ? (tiles + 1) / 2 : tiles;
    const int s0 = half * h0, steps = half ? tiles - h0 : h0;

    if (tid == 0) {
        mbar_init(dqfull, KV_CONSUMERS / 32);
        mbar_init(dqfree, 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (warp == KV_CONSUMERS / 32) {  // the dQ warp
        float* dqb = dq + b * dqs.b + h * dqs.h;
        for (int t = 0; t < steps; ++t) {
            const int s = s0 + t, i = kv_query_tile(blk, s, tiles, rotate);
            float* acc = dqacc + (bh * st.npad + i * 64) * D;
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
                for (int it = 0; it < 2 * D / 4; ++it) {  // 64 rows of D / 4 float4, 32 lanes
                    const int idx = it * 32 + lane, rr = idx >> (D == 64 ? 4 : 3), c = 4 * (idx & (D / 4 - 1));
                    float4 x = *reinterpret_cast<const float4*>(DQs + rr * D + c);
                    if (pos > 0) {
                        const float4 y = __ldcg(reinterpret_cast<const float4*>(acc + rr * D + c));
                        x = make_float4(y.x + x.x, y.y + x.y, y.z + x.z, y.w + x.w);
                    }
                    if (i * 64 + rr < n)
                        *reinterpret_cast<float4*>(dqb + (long long)(i * 64 + rr) * dqs.n + c) = x;
                }
                __syncwarp();
                if (lane == 0) mbar_arrive(dqfree);
                continue;
            }
            if (lane == 0) {
                if (pos == 0)
                    bulk_store(acc, DQs, 64 * D * 4);
                else
                    bulk_reduce_add(acc, DQs, 64 * D * 4);
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

    const float* qb = q + b * qs.b + h * qs.h;
    const float* kb = k + b * ks.b + h * ks.h;
    const float* vb = v + b * vs.b + h * vs.h;
    const float* ob = dout + b * dos.b + h * dos.h;
    const float* stb = st.base + bh * tiles * 3 * 64;
    // Q, dO and the statistics of query tile i into ring slot `slot`
    auto stage = [&](int i, int slot) {
        load_rows<D>(Qb + slot * TILE<D>, qb, qs.n, i * 64, n, tid, KV_CONSUMERS);
        load_rows<D>(Ob + slot * TILE<D>, ob, dos.n, i * 64, n, tid, KV_CONSUMERS);
        if (tid < 48) passt::cp_async16(Sm + slot * 192 + 4 * tid, stb + i * 192 + 4 * tid);
    };
    const int key0 = blk * 64;
    load_rows<D>(Ks, kb, ks.n, key0, n, tid, KV_CONSUMERS);
    load_rows<D>(Vs, vb, vs.n, key0, n, tid, KV_CONSUMERS);
    if (steps > 0) stage(kv_query_tile(blk, s0, tiles, rotate), 0);
    cp_async_commit();

    // S^T, dP^T: keys tk + KSTEP i, queries tq + QSTEP j; dK, dV: keys 4 ra + r,
    // dQ: queries 4 ra + r, columns cb + 32 h + c
    constexpr int KSTEP = 64 / KV_KR, QSTEP = 64 / KV_QC, DG = 8;
    const int tk = tid % KSTEP, tq = tid / KSTEP;
    const int ra = tid / DG, cb = 4 * (tid % DG);
    const float sl2 = scale * LOG2E;
    float dka[4][OC], dva[4][OC];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < OC; ++c) dka[r][c] = dva[r][c] = 0.f;

    for (int t = 0; t < steps; ++t) {
        const int s = s0 + t, i = kv_query_tile(blk, s, tiles, rotate), slot = t & 1, q0 = i * 64;
        cp_async_wait<0>();
        named_bar_sync(1, KV_CONSUMERS);  // step t's tile has landed; every thread is done with step t - 1
        if (t + 1 < steps) stage(kv_query_tile(blk, s + 1, tiles, rotate), slot ^ 1);
        cp_async_commit();
        const float* Qs = Qb + slot * TILE<D>;
        const float* Os = Ob + slot * TILE<D>;
        const float* mt = Sm + slot * 192;

        float sT[KV_KR][KV_QC], dpT[KV_KR][KV_QC];
        dot<KV_KR, KV_QC, D>(sT, Ks, tk, Qs, tq);
        dot<KV_KR, KV_QC, D>(dpT, Vs, tk, Os, tq);
#pragma unroll
        for (int j = 0; j < KV_QC; ++j) {
            const int qq = tq + QSTEP * j;
            const bool qv = q0 + qq < n;
            const float ml = mt[qq] * LOG2E, il = mt[64 + qq], di = mt[128 + qq];
#pragma unroll
            for (int r = 0; r < KV_KR; ++r) {
                const int kk = tk + KSTEP * r;
                const bool valid = qv && key0 + kk < n;
                const float pn = valid ? ex2_approx(fmaf(sT[r][j], sl2, -ml)) * il : 0.f;
                const float ds = valid ? pn * (dpT[r][j] - di) * scale : 0.f;
                PN[qq * SLD<D> + kk] = pn;
                DS[qq * SLD<D> + kk] = ds;
                DST[kk * PLD + qq] = ds;
            }
        }
        named_bar_sync(1, KV_CONSUMERS);  // P_norm and dS are in shared memory

        outer<OC, SLD<D>, LD<D>>(dva, PN, 4 * ra, Os, cb);  // dV += P_norm^T dO
        outer<OC, SLD<D>, LD<D>>(dka, DS, 4 * ra, Qs, cb);  // dK += dS^T Q
        float dqa[4][OC];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < OC; ++c) dqa[r][c] = 0.f;
        outer<OC, PLD, LD<D>>(dqa, DST, 4 * ra, Ks, cb);  // dQ_part = dS K

        // stage dQ_part for the dQ warp, once it has read the last share
        if (t > 0) mbar_wait_or_trap(dqfree, (t - 1) & 1);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int hh = 0; hh < OC / 4; ++hh)
                *reinterpret_cast<float4*>(DQs + (4 * ra + r) * D + cb + 32 * hh) =
                    make_float4(dqa[r][4 * hh], dqa[r][4 * hh + 1], dqa[r][4 * hh + 2], dqa[r][4 * hh + 3]);
        fence_proxy_async();
        __syncwarp();
        if (lane == 0) mbar_arrive(dqfull);
    }
    cp_async_wait<0>();

    if (halves == 2) {  // half 0 hands its dK, dV over; half 1 adds them first, in that order
        float* part = kvacc + (bh * tiles + blk) * 2 * 64 * D;  // [dK, dV][64 keys][D]
        int* flag = flags + bh * tiles + blk;
        if (half == 0) {
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
                for (int hh = 0; hh < OC / 4; ++hh) {
                    const int at = (4 * ra + r) * D + cb + 32 * hh;
                    *reinterpret_cast<float4*>(part + at) =
                        make_float4(dka[r][4 * hh], dka[r][4 * hh + 1], dka[r][4 * hh + 2], dka[r][4 * hh + 3]);
                    *reinterpret_cast<float4*>(part + 64 * D + at) =
                        make_float4(dva[r][4 * hh], dva[r][4 * hh + 1], dva[r][4 * hh + 2], dva[r][4 * hh + 3]);
                }
            named_bar_sync(1, KV_CONSUMERS);
            if (tid == 0) {
                __threadfence();
                st_release_gpu(flag, 1);
            }
            return;
        }
        if (tid == 0) wait_turn(flag, 1);  // half 0's dK, dV are in place
        named_bar_sync(1, KV_CONSUMERS);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int hh = 0; hh < OC / 4; ++hh) {
                const int at = (4 * ra + r) * D + cb + 32 * hh;
                const float4 pk = __ldcg(reinterpret_cast<const float4*>(part + at));
                const float4 pv = __ldcg(reinterpret_cast<const float4*>(part + 64 * D + at));
                const float ok[4] = {pk.x, pk.y, pk.z, pk.w}, ov[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    dka[r][4 * hh + c] = ok[c] + dka[r][4 * hh + c];
                    dva[r][4 * hh + c] = ov[c] + dva[r][4 * hh + c];
                }
            }
    }

    float* dkb = dk + b * dks.b + h * dks.h;
    float* dvb = dv + b * dvs.b + h * dvs.h;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
        const int key = key0 + 4 * ra + r;
        if (key >= n) continue;
#pragma unroll
        for (int hh = 0; hh < OC / 4; ++hh) {
            const int c = cb + 32 * hh;
            *reinterpret_cast<float4*>(dkb + (long long)key * dks.n + c) =
                make_float4(dka[r][4 * hh], dka[r][4 * hh + 1], dka[r][4 * hh + 2], dka[r][4 * hh + 3]);
            *reinterpret_cast<float4*>(dvb + (long long)key * dvs.n + c) =
                make_float4(dva[r][4 * hh], dva[r][4 * hh + 1], dva[r][4 * hh + 2], dva[r][4 * hh + 3]);
        }
    }
}

// Both kernels' dynamic shared memory, and the carve-out as large as it
// goes, so that their MIN_BLOCKS fit an SM.
template <int D>
cudaError_t configure() {
    cudaError_t err = cudaFuncSetAttribute(bwd32_stats_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           S_SMEM<D>);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(bwd32_kv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, KV_SMEM<D>);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(bwd32_stats_kernel<D>, cudaFuncAttributePreferredSharedMemoryCarveout,
                                   cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(bwd32_kv_kernel<D>, cudaFuncAttributePreferredSharedMemoryCarveout,
                                   cudaSharedmemCarveoutMaxShared);
    return err;
}

// Blocks of kernel S and of kernel KV an SM holds at once (the occupancy
// query).
template <int D>
cudaError_t occupancy(int* stats_blocks, int* kv_blocks) {
    cudaError_t err = configure<D>();
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(stats_blocks, bwd32_stats_kernel<D>, S_THREADS, S_SMEM<D>);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(kv_blocks, bwd32_kv_kernel<D>, KV_THREADS, KV_SMEM<D>);
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

// The card's slots for kernel KV at head dim D: the SMs times its blocks an
// SM; 0 where the occupancy query fails.
template <int D>
int kv_slots(int sms) {
    int stats_blocks = 0, kv_blocks = 0;
    return occupancy<D>(&stats_blocks, &kv_blocks) == cudaSuccess ? sms * kv_blocks : 0;
}

// Floats of scratch the call takes (see passt_attention_bwd_fp32_scratch).
long long scratch_floats(int batch, int n, int heads, int d, int halves) {
    const long long tiles = (n + 63) / 64, bh = (long long)batch * heads;
    const long long split = halves == 2 ? 2 * 64 * d : 0;
    return bh * tiles * (3 * 64 + 64 * d + split) + 2 * ((bh * tiles + 3) / 4 * 4);
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, const float* dout, float* dq, float* dk, float* dv,
                   float* scratch, int batch, int n, int heads, Strides qs, Strides ks, Strides vs, Strides dos,
                   Strides dqs, Strides dks, Strides dvs, float scale, int plus1, int slots, cudaStream_t st) {
    const int tiles = (n + 63) / 64;
    const long long bh = (long long)batch * heads;
    float* stats = scratch;
    float* dqacc = stats + bh * tiles * 3 * 64;
    int* counters = reinterpret_cast<int*>(dqacc + bh * tiles * 64 * D);
    const long long ints = (bh * tiles + 3) / 4 * 4;  // counters and flags, each 16-byte aligned
    int* flags = counters + ints;
    float* kvacc = reinterpret_cast<float*>(flags + ints);
    const int halves = kv_halves(batch, n, heads, slots);
    const Stats sts{stats, tiles * 64};
    cudaError_t err = configure<D>();
    if (err != cudaSuccess) return err;
    bwd32_stats_kernel<D><<<dim3(tiles, heads, batch), S_THREADS, S_SMEM<D>, st>>>(
        q, k, v, dout, qs, ks, vs, dos, sts, counters, flags, n, scale, plus1);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    // With the rotated order a block may wait on a block of its (batch,
    // head) with a higher index, so a head's blocks must all fit on the
    // card at once (kv_halves asks that of both halves); otherwise blocks
    // wait only on lower indices, which the hardware dispatches first.
    const int rotate = tiles <= slots;
    bwd32_kv_kernel<D><<<dim3(tiles * halves, heads, batch), KV_THREADS, KV_SMEM<D>, st>>>(
        q, k, v, dout, dq, dk, dv, qs, ks, vs, dos, dqs, dks, dvs, sts, dqacc, counters, kvacc, flags, n, scale, rotate,
        halves);
    return cudaSuccess;
}

}  // namespace

// Blocks of kernel S and of kernel KV of the head-dim-d instance (32 or 64)
// an SM holds at once (the occupancy query). Returns a CUDA error code.
extern "C" int passt_attention_bwd_fp32_occupancy(int d, int* stats_blocks, int* kv_blocks) {
    if (d != 32 && d != 64) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(d == 64 ? occupancy<64>(stats_blocks, kv_blocks) : occupancy<32>(stats_blocks, kv_blocks));
}

// Floats of scratch (16-byte aligned) the call takes at head dim d (32 or
// 64) on a card of `sms` multiprocessors: the row statistics
// [B*H][tiles][3][64], the dQ sums [B*H][tiles][64][d], the per-tile
// counters and dK/dV hand-over flags, and where the query walk is split in
// two halves the hand-over's dK and dV [B*H][tiles][2][64][d]. -1 for
// another d or where the occupancy query fails.
extern "C" long long passt_attention_bwd_fp32_scratch(int batch, int n, int heads, int d, int sms) {
    if (d != 32 && d != 64) return -1;
    const int slots = d == 64 ? kv_slots<64>(sms) : kv_slots<32>(sms);
    if (slots <= 0) return -1;
    return scratch_floats(batch, n, heads, d, kv_halves(batch, n, heads, slots));
}

// q, k, v, dout, dq, dk, dv: fp32, element (b, t, h, c) at
// ptr[b * sb + t * sn + h * sh + c]; d must be 64 or 32 and every operand
// 16-byte aligned with strides in multiples of 8 elements (else
// cudaErrorInvalidValue and nothing launched). sms: the card's
// multiprocessor count. Returns cudaGetLastError() after the launches.
extern "C" int passt_attention_bwd_fp32(const void* q, const void* k, const void* v, const void* dout, void* dq,
                                        void* dk, void* dv, void* scratch, int batch, int n, int heads, int d,
                                        long long qsb, long long qsn, long long qsh,
                                        long long ksb, long long ksn, long long ksh,
                                        long long vsb, long long vsn, long long vsh,
                                        long long dosb, long long dosn, long long dosh,
                                        long long dqsb, long long dqsn, long long dqsh,
                                        long long dksb, long long dksn, long long dksh,
                                        long long dvsb, long long dvsn, long long dvsh,
                                        float scale, int plus1, int sms, void* stream) {
    const Strides qs{qsb, qsn, qsh}, ks{ksb, ksn, ksh}, vs{vsb, vsn, vsh}, dos{dosb, dosn, dosh};
    const Strides dqs{dqsb, dqsn, dqsh}, dks{dksb, dksn, dksh}, dvs{dvsb, dvsn, dvsh};
    const bool aligned = vectors_aligned(q, qs) && vectors_aligned(k, ks) && vectors_aligned(v, vs) &&
                         vectors_aligned(dout, dos) && vectors_aligned(dq, dqs) && vectors_aligned(dk, dks) &&
                         vectors_aligned(dv, dvs) && reinterpret_cast<uintptr_t>(scratch) % 16 == 0;
    if ((d != 64 && d != 32) || n <= 0 || batch <= 0 || heads <= 0 || batch > 65535 || heads > 65535 || !aligned)
        return static_cast<int>(cudaErrorInvalidValue);
    const int slots = d == 64 ? kv_slots<64>(sms) : kv_slots<32>(sms);
    if (slots <= 0) return static_cast<int>(cudaErrorInvalidValue);
    const auto f = [](const void* p) { return static_cast<const float*>(p); };
    const auto g = [](void* p) { return static_cast<float*>(p); };
    const auto st = static_cast<cudaStream_t>(stream);
    const cudaError_t err =
        d == 64 ? launch<64>(f(q), f(k), f(v), f(dout), g(dq), g(dk), g(dv), g(scratch), batch, n, heads, qs, ks, vs, dos,
                             dqs, dks, dvs, scale, plus1, slots, st)
                : launch<32>(f(q), f(k), f(v), f(dout), g(dq), g(dk), g(dv), g(scratch), batch, n, heads, qs, ks, vs, dos,
                             dqs, dks, dvs, scale, plus1, slots, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    return passt_launch_status();
}
