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
// What the bf16 design does about it (both entries share one kernel, BWD
// picks the operands; tests/test_torch_fused_mlp_cluster.py emulates its
// order on the CPU):
// - A thread-block cluster of CS CTAs shares one row block of BM = 128 rows
//   (two consumer warpgroups of 64 rows). The hidden dimension is walked in
//   chunks of HC = 64 CS units; CTA r of the cluster owns units
//   [64 r, 64 (r + 1)) of every chunk (one 128-byte swizzle span) and
//   columns [64 NB r, 64 NB (r + 1)) of y (dx). C = 64 q takes
//   CS = ceil(q / 3) CTAs of NB = ceil(q / CS) <= 3 column blocks
//   (mlp_split; C = 768: four CTAs of 192 columns, HC = 256); the last CTA's
//   blocks past C load as zeros and store nothing, as do units past H.
// - First product, per chunk: h (dg) [BM, 64] over the whole K = C on wgmma
//   m64n64k16, x's (dy's) [BM x 64] K stages and W1's [64 x 64] tiles
//   (MN-major B; the backward's W2 rows are K-major) by TMA, zero fill past
//   M. Its epilogue in registers: + b1 and the GELU (the backward: times d,
//   loaded by TMA), rounded to bf16 into this CTA's block of the chunk's g
//   (dh) buffer, 128-byte swizzled as wgmma reads it; then each warpgroup's
//   rows of the block go to every other CTA's buffer by bulk async copies
//   (shared memory to shared memory across the cluster, completing on the
//   receiver's mbarrier), and by TMA stores to g (dh) (and, forward, d)
//   where the entry writes them, clipped at M and H.
// - Second product: y (dx) [BM, 64 NB] += g (dh) [BM, HC] W2 [HC, cols]
//   (W1 [cols, HC]^T) on one wgmma m64n(64 NB)k16 a k step, the weight's
//   NB blocks of 64 columns by TMA. y's accumulator stays in registers for
//   the whole walk (96 fp32 a thread at NB = 3). Each h unit and each y
//   column is summed whole by one CTA, chunk by chunk in order (within a
//   chunk the CTA's own block first): no sum crosses CTAs, so every run
//   gives the same bits.
// - Per chunk j a warpgroup runs j's epilogue, j's second product over its
//   CTA's own block, chunk j + 1's first product while the other CTAs'
//   copies land, then j's second product over their blocks.
// - A producer warpgroup (one thread) issues every TMA load into one ring in
//   that order; it gives its registers up (setmaxnreg). One g (dh) buffer:
//   per consumer warpgroup, an mbarrier that the other CTAs' copies of its
//   rows complete, and one that every CTA's warpgroup of the same rows
//   arrives on once its products have read the chunk. Every wait traps after
//   WAIT_LIMIT_NS. Generic writes of g (dh) are fenced to the async proxy
//   before the copies, the stores and the products read them.
// - Rows: 128 (two consumer warpgroups). Three would hold 96 + 32
//   accumulators a thread, and ptxas gives a 416- or 512-thread block at
//   most 128 registers: it spilled and serialized the products (2.6x
//   slower). Nor does setmaxnreg raise ptxas's cap of 168 for this block:
//   128 units a CTA (N = 128 in the first product) spilled the same way. So
//   M = 5688 takes 45 clusters of 4, M = 14280 112. The pick (mlp_plan,
//   mirrored by ops/fused_mlp.py plan) reports rows, CTAs, the clusters
//   the card holds at once (cudaOccupancyMaxActiveClusters) and waves.
// - What sets the time (a clock64 timeline of one CTA and
//   tools/fused_mlp_variants, PERF.md): per 256-unit chunk about 4.2 us of
//   the first product (N = 64 runs at ~40% of the tensor rate), 2.6 of the
//   GELU epilogue, 2.2 of the second product (~75%), 0.6 of the exchange.
//   The epilogue cannot run under the products: a read of an accumulator
//   while any wgmma is in flight makes ptxas serialize them all.
// - fp32 runs on FMA in full fp32 (the reference asks for HIGHEST there; no
//   TF32): x (dy) in shared memory, one thread per (row, hidden unit) for
//   the first product and 4 rows x C/32 columns of y (dx) for the second.
//
// Limits: C a multiple of 64 up to 768, H a multiple of 64 (the wrapper
// raises outside them); any M >= 1.
#include "common.cuh"
#include "hopper.cuh"

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using passt::gelu;
using passt::load2;
using passt::store2;

namespace H = passt_hopper;
using T = __nv_bfloat16;

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// ---- bf16 on wgmma in a thread-block cluster ----------------------------------------

constexpr int KS = 64;                      // K a first-product stage
constexpr int BLOCK = H::MN_BLOCK_BYTES;    // a [64 x 64] bf16 tile, 128-byte rows
constexpr int MAX_NB = 3;                   // 64-column blocks of y (dx) a CTA holds at most
constexpr int MAX_CS = (768 / 64 + MAX_NB - 1) / MAX_NB;  // CTAs a cluster at most (C = 768)
constexpr int ROW_WG = 2;                    // consumer warpgroups of a CTA, 64 rows each (see above)
constexpr uint32_t W_TILE = BLOCK;          // bytes of a weight tile

// Shared memory besides the ring at bm rows and cs CTAs: the alignment, the
// chunk's g (dh) [cs][bm x 128 bytes], the d block [bm x 128 bytes], the
// barriers.
constexpr int mlp_fixed(int bm, int cs) { return 1024 + (cs + 1) * bm * 128 + 128; }

template <int W> struct MlpTile {
    static constexpr int BM = 64 * W;                // rows of a cluster
    static constexpr int CONSUMERS = 128 * W;        // the consumer warpgroups, 64 rows each ...
    static constexpr int THREADS = CONSUMERS + 128;  // ... then the producer warpgroup
    static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = W == 2 ? 232 : 152;
    static constexpr int A_BYTES = BM * 128;         // a first-product stage's x (dy) tile: BM rows x 64 of K
    static constexpr int STAGE = A_BYTES + BLOCK;    // and its weight tile; a second-product stage: NB
    static constexpr int HBLOCK = BM * 128;          // 64 units of g (dh) for the cluster's rows
    // as many stages as fit at C = 768, at most 4 (3 took 10% longer at
    // M = 5688, 5 were no faster: tools/fused_mlp_variants)
    static constexpr int FIT = (227 * 1024 - mlp_fixed(BM, MAX_CS)) / STAGE;
    static constexpr int STAGES = FIT < 4 ? FIT : 4;
    static constexpr int smem(int cs) { return mlp_fixed(BM, cs) + STAGES * STAGE; }
    static_assert(PRODUCER_REGS * 128 + CONSUMER_REGS * CONSUMERS <= 65536, "the register file");
    static_assert(MAX_NB * BLOCK <= STAGE && STAGES >= 2, "the ring");
    static_assert((2 * STAGES + 2 * W + 2) * 8 <= 128, "the barriers");
};
static_assert(MlpTile<ROW_WG>::smem(MAX_CS) <= 227 * 1024, "shared memory");

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
    return p + ((1024 - (H::smem_u32(p) & 1023)) & 1023);
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// gelu's value alone, in its order (so bit-equal to gelu's h): the forward
// without residuals needs no derivative.
__device__ __forceinline__ float gelu_value(float z) {
    constexpr float C = static_cast<float>(0.7978845608028654);  // sqrt(2 / pi)
    constexpr float A = 0.044715f;
    const float t = tanhf(__fmul_rn(C, __fadd_rn(z, __fmul_rn(__fmul_rn(__fmul_rn(A, z), z), z))));
    return __fmul_rn(__fmul_rn(0.5f, z), __fadd_rn(1.f, t));
}

// A weight tile by TMA.
__device__ __forceinline__ void load_w(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
    H::tma_load_2d(dst, map, bar, c0, c1);
}

// One k step (16) of the first product: h (dg) [64 x 64] [+]= A [64 x 16] B,
// B the stage's weight tile: W1's [64 K rows x 64 units] (MN-major) or, in
// the backward, W2's [64 unit rows x 64 K] (K-major).
template <bool BWD>
__device__ __forceinline__ void first_mma(float (&d)[32], uint64_t a, const unsigned char* b, int kk, int acc) {
    if constexpr (BWD) H::WgmmaF32<T, 64, 0>::mma(d, a, H::sw128_desc(b) + 2 * kk, acc);
    else H::WgmmaF32<T, 64, 1>::mma(d, a, H::sw128_mn_blocks_desc(b) + 128 * kk, acc);
}

// One k step of the second product: y (dx) [64 x 64 NB] += A [64 x 16] B, B
// the stage's NB weight blocks: W2's [64 unit rows x 64 columns] each
// (MN-major) or W1's [64 column rows x 64 units] each (K-major).
template <bool BWD, int NB>
__device__ __forceinline__ void second_mma(float (&d)[32 * NB], uint64_t a, const unsigned char* b, int kk) {
    if constexpr (BWD) H::WgmmaF32<T, 64 * NB, 0>::mma(d, a, H::sw128_desc(b) + 2 * kk, 1);
    else H::WgmmaF32<T, 64 * NB, 1>::mma(d, a, H::sw128_mn_blocks_desc(b) + 128 * kk, 1);
}

// One cluster of cs CTAs per BM rows; CTA `rank` owns units [64 rank,
// 64 (rank + 1)) of every chunk of 64 cs and columns [64 NB rank,
// 64 NB (rank + 1)) of the output. Forward: a = x, out = y, b1 and b2
// added, hmap / dmap the residuals g and d (stored where store_h).
// Backward: a = dy, out = dx, hmap dh (stored), dmap d (loaded). See the
// file's comment.
template <bool BWD, int W, int NB>
__global__ void __launch_bounds__(MlpTile<W>::THREADS, 1) mlp_kernel(
    const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap w1map,
    const __grid_constant__ CUtensorMap w2map, const __grid_constant__ CUtensorMap hmap,
    const __grid_constant__ CUtensorMap dmap, const T* __restrict__ b1, const T* __restrict__ b2,
    T* __restrict__ out, int m, int c, int h, int store_h) {
    using Tl = MlpTile<W>;
    constexpr int BM = Tl::BM, CW = Tl::CONSUMERS / 32;  // consumer warps
    extern __shared__ unsigned char smem_raw[];
    const uint32_t rank = H::cluster_rank(), cs = H::cluster_size();
    const int kbs = cs;  // 64-unit blocks of a chunk, one a CTA
    unsigned char* ring = align1024(smem_raw);
    unsigned char* hbuf = ring + Tl::STAGES * Tl::STAGE;  // [kbs][HBLOCK]: block kb holds units 64 kb of the chunk
    unsigned char* dblk = hbuf + kbs * Tl::HBLOCK;        // [HBLOCK] d of this CTA's units: loaded, or staged out
    uint64_t* full = reinterpret_cast<uint64_t*>(dblk + Tl::HBLOCK);
    uint64_t* empty = full + Tl::STAGES;
    // per consumer warpgroup: every other CTA's share of the chunk for its
    // rows has landed here; every CTA's warpgroup of the same rows is done
    // reading the last chunk's
    uint64_t* hfull = empty + Tl::STAGES;
    uint64_t* hfree = hfull + W;
    uint64_t* dfull = hfree + W;
    uint64_t* dempty = dfull + 1;

    const int row0 = (blockIdx.x / cs) * BM, n0 = rank * 64 * NB;
    const int ktiles = c / KS, hc = 64 * kbs, chunks = (h + hc - 1) / hc;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

    if (threadIdx.x == 0) {
        for (int s = 0; s < Tl::STAGES; ++s) {
            H::mbar_init(full + s, 1);
            H::mbar_init(empty + s, CW);
        }
        for (int w = 0; w < W; ++w) {
            H::mbar_init(hfull + w, 1);
            H::mbar_init(hfree + w, cs);
        }
        H::mbar_init(dfull, 1);
        H::mbar_init(dempty, CW);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    H::cluster_sync();  // (1) every CTA's barriers are ready before a copy or an arrival reaches them

    if (warp >= CW) {  // the producer warpgroup: one thread issues every load
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(Tl::PRODUCER_REGS));
        if (warp == CW && lane == 0) {
            int it = 0;
            auto stage = [&](uint32_t bytes) {  // the next stage's slot, once free, expecting `bytes`
                const int s = it % Tl::STAGES;
                if (it >= Tl::STAGES) H::mbar_wait_or_trap(empty + s, (it / Tl::STAGES - 1) & 1);
                H::mbar_expect_tx(full + s, bytes);
                ++it;
                return s;
            };
            auto first = [&](int jc) {  // chunk jc's first product, then (backward) its d
                const int u0 = jc * hc + 64 * rank;  // this CTA's first unit of the chunk
                for (int kt = 0; kt < ktiles; ++kt) {
                    const int s = stage(Tl::A_BYTES + W_TILE);
                    unsigned char* sp = ring + s * Tl::STAGE;
                    H::tma_load_2d(sp, &amap, full + s, kt * KS, row0);
                    if (BWD) load_w(sp + Tl::A_BYTES, &w2map, full + s, kt * KS, u0);
                    else load_w(sp + Tl::A_BYTES, &w1map, full + s, u0, kt * KS);
                }
                if (BWD) {  // read in the chunk's epilogue
                    if (jc > 0) H::mbar_wait_or_trap(dempty, (jc - 1) & 1);
                    H::mbar_expect_tx(dfull, Tl::HBLOCK);
                    for (int w = 0; w < W; ++w)
                        H::tma_load_2d(dblk + w * BLOCK, &dmap, dfull, u0, row0 + 64 * w);
                }
            };
            auto second = [&](int jc, int i0, int i1) {  // chunk jc's second product, K blocks i0 .. i1 - 1
                for (int i = i0; i < i1; ++i) {
                    const int kb = (rank + i) % kbs;  // this CTA's own block first
                    const int s = stage(NB * W_TILE);
                    unsigned char* sp = ring + s * Tl::STAGE;
                    for (int b = 0; b < NB; ++b) {
                        if (BWD) load_w(sp + b * BLOCK, &w1map, full + s, jc * hc + 64 * kb, n0 + 64 * b);
                        else load_w(sp + b * BLOCK, &w2map, full + s, n0 + 64 * b, jc * hc + 64 * kb);
                    }
                }
            };
            // the consumers' order (see below)
            first(0);
            for (int j = 0; j < chunks; ++j) {
                second(j, 0, 1);
                if (j + 1 < chunks) first(j + 1);
                second(j, 1, kbs);
            }
        }
        H::cluster_sync();  // (2) no CTA leaves while another may still reach its shared memory
        return;
    }

    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(Tl::CONSUMER_REGS));
    const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, t4 = lane & 3;
    const int tw = threadIdx.x & 127;  // the thread within its warpgroup
    float acc[32 * NB];                // y (dx): the warpgroup's 64 rows x this CTA's 64 NB columns
    float hacc[32];                    // h (dg): its 64 rows x this CTA's 64 units of a chunk
#pragma unroll
    for (int i = 0; i < 32 * NB; ++i) acc[i] = 0.f;
    int it = 0, pend = -1;  // the next stage; the stage whose products are last in flight
    // the products committed before the last group have completed: free
    // the stage they read
    auto retire = [&]() {
        if (pend >= 0 && lane == 0) H::mbar_arrive(empty + pend % Tl::STAGES);
        pend = it++;
    };
    // the warpgroup's rows of this CTA's block and of the d block
    unsigned char* mine = hbuf + rank * Tl::HBLOCK + wg * BLOCK;
    unsigned char* dw = dblk + wg * BLOCK;
    // Per chunk j: its epilogue (g of the first product, shared through the
    // cluster), its second product over this CTA's own blocks, chunk j + 1's
    // first product while the other CTAs' copies land, then j's second
    // product over their blocks. Iteration -1 runs chunk 0's first product.
    for (int j = -1; j < chunks; ++j) {
        const int u0 = j * hc + 64 * rank;  // this CTA's first unit of chunk j
        if (j >= 0) {
            // the epilogue: g (dh) of the chunk into this CTA's block, once
            // every CTA's warpgroup of these rows is done reading the last
            // chunk's (and so every copy of the last chunk has landed), and
            // this warpgroup's stores of the last chunk have read the block
            if (j > 0) H::mbar_wait_or_trap(hfree + wg, (j - 1) & 1);
            if (tw == 0) {
                H::bulk_wait_read();
                H::mbar_expect_tx(hfull + wg, (cs - 1) * BLOCK);  // the other CTAs' shares of these rows
            }
            if (BWD) H::mbar_wait_or_trap(dfull, j & 1);
            H::named_bar_sync(1 + wg, 128);
            // accumulator element 4 jj + e: row 16 wq + g + 8 (e / 2), unit 8 jj +
            // 2 t4 + e % 2; the 128-byte swizzle puts 16-byte chunk jj of row r
            // at chunk jj ^ (r % 8)
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) {
                const int cu = 8 * jj + 2 * t4;
                float2 bb = make_float2(0.f, 0.f);
                if (!BWD && u0 + cu < h) bb = load2(b1 + u0 + cu);
#pragma unroll
                for (int hh = 0; hh < 2; ++hh) {
                    const int r = 16 * wq + g + 8 * hh;
                    const int off = r * 128 + ((jj ^ (r & 7)) << 4) + 4 * t4;
                    const float v0 = hacc[4 * jj + 2 * hh], v1 = hacc[4 * jj + 2 * hh + 1];
                    if (BWD) {
                        const float2 dv = unpack_bf16(*reinterpret_cast<const uint32_t*>(dw + off));
                        *reinterpret_cast<uint32_t*>(mine + off) = pack_bf16(__fmul_rn(v0, dv.x), __fmul_rn(v1, dv.y));
                    } else if (store_h) {
                        float g0, d0, g1, d1;
                        gelu(__fadd_rn(v0, bb.x), g0, d0);
                        gelu(__fadd_rn(v1, bb.y), g1, d1);
                        *reinterpret_cast<uint32_t*>(mine + off) = pack_bf16(g0, g1);
                        *reinterpret_cast<uint32_t*>(dw + off) = pack_bf16(d0, d1);
                    } else {
                        *reinterpret_cast<uint32_t*>(mine + off) =
                            pack_bf16(gelu_value(__fadd_rn(v0, bb.x)), gelu_value(__fadd_rn(v1, bb.y)));
                    }
                }
            }
            H::fence_proxy_async();  // for the copies, the stores and the products below (async proxy)
            H::named_bar_sync(1 + wg, 128);
            if (BWD && lane == 0) H::mbar_arrive(dempty);  // this warp is done with the d block
            if (tw == 0) {
                // the warpgroup's rows of the block into every other CTA's buffer,
                // completing on that CTA's barrier of these rows
                for (uint32_t dq = 1; dq < cs; ++dq) {
                    const uint32_t q = (rank + dq) % cs;
                    H::bulk_copy_cluster(H::map_rank(mine, q), mine, BLOCK, H::map_rank(hfull + wg, q));
                }
                if (BWD || store_h) {  // g (dh) and, forward, d: out by TMA, clipped at M and H
                    H::tma_store_2d(&hmap, mine, u0, row0 + 64 * wg);
                    if (!BWD) H::tma_store_2d(&dmap, dw, u0, row0 + 64 * wg);
                    H::bulk_commit();
                }
            }
        }
        // segment 0: chunk j's second product over this CTA's own K block,
        // y (dx) += g (dh) [rows, the blocks' units] W2 [units, columns]
        // (W1 [columns, units]^T); 1: chunk j + 1's first product; 2: chunk
        // j's second product over the other CTAs' blocks, once they landed
        for (int seg = 0; seg < 3; ++seg) {
            if (seg == 1) {
                if (j + 1 == chunks) continue;
                // chunk j + 1's h (dg) = x W1 (dy W2^T) over K = C, this CTA's units
                for (int kt = 0; kt < ktiles; ++kt) {
                    const int s = it % Tl::STAGES;
                    H::mbar_wait_or_trap(full + s, (it / Tl::STAGES) & 1);
                    const unsigned char* sp = ring + s * Tl::STAGE;
                    const uint64_t ad = H::sw128_desc(sp + wg * BLOCK);
                    H::fence_regs(hacc);
                    H::wgmma_fence();
#pragma unroll
                    for (int kk = 0; kk < KS / 16; ++kk)
                        first_mma<BWD>(hacc, ad + 2 * kk, sp + Tl::A_BYTES, kk, (kt | kk) != 0);
                    H::wgmma_commit();
                    H::wgmma_wait<1>();
                    H::fence_regs(hacc);
                    H::fence_regs(acc);
                    retire();
                }
                continue;
            }
            if (j < 0) continue;
            if (seg == 2 && kbs > 1) H::mbar_wait_or_trap(hfull + wg, j & 1);
            for (int i = seg == 0 ? 0 : 1; i < (seg == 0 ? 1 : kbs); ++i) {
                const int kb = (rank + i) % kbs;
                const int s = it % Tl::STAGES;
                H::mbar_wait_or_trap(full + s, (it / Tl::STAGES) & 1);
                const unsigned char* sp = ring + s * Tl::STAGE;
                const uint64_t ad = H::sw128_desc(hbuf + kb * Tl::HBLOCK + wg * BLOCK);
                H::fence_regs(acc);
                H::wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < 4; ++kk) second_mma<BWD, NB>(acc, ad + 2 * kk, sp, kk);
                H::wgmma_commit();
                H::wgmma_wait<1>();
                H::fence_regs(acc);
                H::fence_regs(hacc);
                retire();
            }
        }
        H::wgmma_wait<0>();
        H::fence_regs(acc);
        H::fence_regs(hacc);
        if (pend >= 0 && lane == 0) H::mbar_arrive(empty + pend % Tl::STAGES);
        pend = -1;
        if (j >= 0 && j + 1 < chunks) {
            // this warpgroup's products have read the chunk's blocks: tell
            // every CTA (thread q tells CTA q; no data is handed over)
            H::named_bar_sync(1 + wg, 128);
            if (tw < static_cast<int>(cs)) H::mbar_arrive_remote(H::map_rank(hfree + wg, tw));
        }
    }

    // y = round(acc + b2) (dx = round(acc)): the warpgroup's rows, this CTA's
    // columns, clipped at M and C
#pragma unroll
    for (int jb = 0; jb < 8 * NB; ++jb) {
        const int col = n0 + 8 * jb + 2 * t4;
        if (col >= c) continue;
        const float2 bb = BWD ? make_float2(0.f, 0.f) : load2(b2 + col);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
            const int row = row0 + 64 * wg + 16 * wq + g + 8 * hh;
            if (row < m)
                store2(out + static_cast<long long>(row) * c + col, __fadd_rn(acc[4 * jb + 2 * hh], bb.x),
                       __fadd_rn(acc[4 * jb + 2 * hh + 1], bb.y));
        }
    }
    if (tw == 0) H::bulk_wait();
    H::cluster_sync();  // (2)
}

// The split of C = 64 q over a cluster: ceil(q / 3) CTAs of nb = ceil(q /
// cs) 64-column blocks each. ops/fused_mlp.py split mirrors it.
inline void mlp_split(int c, int& cs, int& nb) {
    const int q = c / 64;
    cs = cdiv(q, MAX_NB);
    nb = cdiv(q, cs);
}

struct MlpPlan {
    int w, cs, nb, clusters;
};

// What the bf16 entries launch at (m, c): the split of C and one cluster
// per 64 ROW_WG rows. ops/fused_mlp.py plan mirrors it.
inline MlpPlan mlp_plan(int m, int c) {
    MlpPlan p{};
    mlp_split(c, p.cs, p.nb);
    p.w = ROW_WG;
    p.clusters = cdiv(m, 64 * ROW_WG);
    return p;
}

// The operands of one bf16 launch: a = x (dy), out = y (dx), hres = g (dh),
// dres = d; hres and dres may be null (the forward without residuals).
struct MlpArgs {
    const void *a, *w1, *w2, *b1, *b2;
    void *out, *hres, *dres;
    int m, c, h;
};

template <bool BWD, int W, int NB>
int launch_mlp(const MlpArgs& x, const MlpPlan& p, cudaStream_t stream) {
    using Tl = MlpTile<W>;
    auto kernel = mlp_kernel<BWD, W, NB>;
    const int smem = Tl::smem(p.cs);
    // a runtime call first: it makes the device's context current, which
    // the tensor-map encoder needs
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const bool store_h = x.hres != nullptr;
    CUtensorMap amap, w1map, w2map, hmap, dmap;
    bool ok = H::make_map_2d(&amap, x.a, true, x.m, x.c, 2LL * x.c, Tl::BM) &&
              H::make_map_2d(&w1map, x.w1, true, x.c, x.h, 2LL * x.h, 64) &&
              H::make_map_2d(&w2map, x.w2, true, x.h, x.c, 2LL * x.c, 64);
    hmap = dmap = amap;  // unused without residuals
    if (store_h)
        ok = ok && H::make_map_2d(&hmap, x.hres, true, x.m, x.h, 2LL * x.h, 64) &&
             H::make_map_2d(&dmap, x.dres, true, x.m, x.h, 2LL * x.h, 64);
    if (!ok) return static_cast<int>(cudaErrorInvalidValue);
    H::Launch l(p.clusters * p.cs, Tl::THREADS, smem, stream, p.cs, false);
    err = cudaLaunchKernelEx(&l.cfg, kernel, amap, w1map, w2map, hmap, dmap, static_cast<const T*>(x.b1),
                             static_cast<const T*>(x.b2), static_cast<T*>(x.out), x.m, x.c, x.h, int(store_h));
    if (err != cudaSuccess) return static_cast<int>(err);
    return passt_launch_status();
}

// How many clusters of plan p's kernel the card holds at once
// (cudaOccupancyMaxActiveClusters), into *active.
template <bool BWD, int W, int NB>
int resident_clusters(const MlpPlan& p, int* active) {
    auto kernel = mlp_kernel<BWD, W, NB>;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MlpTile<W>::smem(p.cs));
    if (err != cudaSuccess) return static_cast<int>(err);
    H::Launch l(p.cs, MlpTile<W>::THREADS, MlpTile<W>::smem(p.cs), nullptr, p.cs, false);
    return static_cast<int>(cudaOccupancyMaxActiveClusters(active, kernel, &l.cfg));
}

template <bool BWD>
int resident_bf16(const MlpPlan& p, int* active) {
    switch (p.nb) {
        case 1: return resident_clusters<BWD, ROW_WG, 1>(p, active);
        case 2: return resident_clusters<BWD, ROW_WG, 2>(p, active);
        case 3: return resident_clusters<BWD, ROW_WG, 3>(p, active);
    }
    return static_cast<int>(cudaErrorInvalidValue);
}

template <bool BWD>
int launch_bf16(const MlpArgs& x, cudaStream_t stream) {
    const MlpPlan p = mlp_plan(x.m, x.c);
    switch (p.nb) {
        case 1: return launch_mlp<BWD, ROW_WG, 1>(x, p, stream);
        case 2: return launch_mlp<BWD, ROW_WG, 2>(x, p, stream);
        case 3: return launch_mlp<BWD, ROW_WG, 3>(x, p, stream);
    }
    return static_cast<int>(cudaErrorInvalidValue);
}

// ---- fp32 on FMA -------------------------------------------------------------------

constexpr int NT_MAX = 24;     // columns of y (dx) a lane holds: C / 32 <= 24

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

bool shapes_ok(int m, int c, int h) {
    return m > 0 && c > 0 && c % 64 == 0 && c <= 32 * NT_MAX && h > 0 && h % 64 == 0;
}

}  // namespace

// What a bfloat16 entry (the backward where bwd) launches at M = m, width c
// on this card: plan[0..4] = rows a cluster, CTAs a cluster, CTAs (mlp_plan),
// the clusters the card holds at once (the occupancy query) and the waves
// they make. Returns a CUDA error code.
extern "C" int passt_fused_mlp_plan(int m, int c, int bwd, int* plan) {
    if (!shapes_ok(m, c, 64)) return static_cast<int>(cudaErrorInvalidValue);
    const MlpPlan p = mlp_plan(m, c);
    int active = 0;
    const int err = bwd ? resident_bf16<true>(p, &active) : resident_bf16<false>(p, &active);
    if (err != 0) return err;
    if (active <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    plan[0] = 64 * p.w, plan[1] = p.cs, plan[2] = p.clusters * p.cs, plan[3] = active;
    plan[4] = cdiv(p.clusters, active);
    return 0;
}

// x [m, c], w1 [c, h], b1 [h], w2 [h, c], b2 [c] -> y [m, c] (and, under
// residuals, g and d [m, h]), all in dtype (0 float32, 1 bfloat16),
// contiguous and 16-byte aligned; c a multiple of 64 up to 768, h a multiple
// of 64. Returns cudaGetLastError() after the launch.
extern "C" int passt_fused_mlp_fwd(const void* x, const void* w1, const void* b1, const void* w2, const void* b2,
                                   void* y, void* g, void* d, int residuals, int dtype, int m, int c, int h,
                                   void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    if (!shapes_ok(m, c, h)) return static_cast<int>(cudaErrorInvalidValue);
    if (dtype == 1) {
        const MlpArgs a{x, w1, w2, b1, b2, y, residuals ? g : nullptr, residuals ? d : nullptr, m, c, h};
        return launch_bf16<false>(a, st);
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
        const MlpArgs a{dy, w1, w2, nullptr, nullptr, dx, dh, const_cast<void*>(d), m, c, h};
        return launch_bf16<true>(a, st);
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
