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
// with g = dxn * s; per-row-tile partials of dscale = sum(dxn * x_hat) and
// dbias = sum(dxn) over the tile's rows, summed by the wrapper.
//
// What bounds them: operations. At the training step (M = 5688, C = 768)
// each is a [M, C] x [C, 3C] product, 20.1 GFLOP, against ~35 MB of bytes;
// the fp32 step's (M = 308) 1.09 GFLOP of fp32 FMA.
//
// What the design does about it:
// - The statistics of F1 (both dtypes) come from a prologue kernel, one
//   warp a row, into an [M] (mu, rstd) scratch; the main kernel is launched
//   behind it by programmatic dependent launch and waits for it
//   (griddepcontrol.wait) only where it first reads the statistics.
// - F1 (bf16 / fp16) on wgmma fed by TMA, persistent (one CTA an SM
//   walking the output tiles): a producer warpgroup issues TMA loads of x's
//   and W's K-tiles (64 of K, 128-byte swizzle, zero fill past M and 3C)
//   into a 3-deep mbarrier ring and gives its registers to the consumers
//   (setmaxnreg). Each consumer warpgroup owns 64 rows of the tile and
//   builds xn in registers as the A operand of wgmma (A from registers):
//   ldmatrix of x's fragment, normalized in fp32 and rounded to the dtype,
//   one k step of 16 at a time with F1_PENDING products left in flight, so
//   the next fragment is built while the products run. So xn is built once per output tile, never stored, and no
//   generic write to shared memory feeds the async proxy. Tiles 192 x 192
//   (three consumer warpgroups) or 128 x 256 (two), chosen per call for
//   the least wave time (f1_pick). The epilogue rounds the fp32 sum and
//   adds the bias in the dtype into a buffer of the warp's 16 rows x 64
//   columns, which goes out as 16-byte row chunks (stores straight from the
//   accumulators, 16 bytes of each of 8 rows a warp store, took about half
//   the kernel's time). Normalizing each landed x tile in place by the
//   producer warpgroup's three idle warps, for wgmma from shared memory,
//   was slower (0.088 ms against 0.052 at the training step: three warps
//   cannot keep up with the products; tools/ln_qkv_variants).
// - fp32 (F1 and B2) runs the products on FMA in full fp32 (the JAX
//   package asks for Precision.HIGHEST there): no TF32. Both share one main
//   loop (fp32_loop): a cp.async ring of K-tiles, each thread an 8 x 8
//   register tile from 16-byte shared loads (4 FMA a float loaded). At the
//   fp32 step's M = 308 neither product fills the card by its rows, so K is
//   split over a thread-block cluster and the partials are added through
//   distributed shared memory in rank order (no atomics, the same bits on
//   every run):
//   - F1 fp32: 64 x 64 output tiles; where the tiles do not give four
//     CTAs an SM, K = C is split over a cluster of 2 or 4 (M = 308: 4, 720
//     CTAs). x's K-tile lands raw and is normalized in place before the
//     products (128 x 128 tiles of 256 threads, one CTA an SM, were slower
//     at M = 3584: 0.437 ms against 0.385).
//   - B2 fp32: a cluster of 8 CTAs per 16 rows, each one eighth of K = 3C
//     over all C columns. Each CTA then adds the eight partials of two of
//     the rows (whole rows of dxn, so the LayerNorm backward's row means
//     need no further exchange), runs the LayerNorm backward on them, and
//     the columns' dscale and dbias sums are added over the cluster's rows
//     in order through distributed shared memory.
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
// - Ragged M: rows past M read as zero (TMA's zero fill or cp.async's
//   zero-size copies, which also cover the bf16 B2's last CTA's blocks past
//   C) and are never stored; they add nothing to the dscale/dbias partials.
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
using passt_attn::to_f;

using passt::cp_async16;
using passt::ldmatrix_x4;
using passt::load2;
using passt::store2;
using passt::warp_sum;

namespace H = passt_hopper;
using H::cluster_arrive;
using H::cluster_rank;
using H::cluster_size;
using H::cluster_sync;
using H::cluster_wait;
using H::ld_cluster;
using H::ld_cluster4;
using H::map_rank;
using H::sw128_mn_blocks_desc;
using H::Launch;

constexpr int MAX_C = 1024;

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// ---- shared pieces ---------------------------------------------------------------------

// A packed pair of T as two floats, and two floats rounded to a packed pair.
template <typename T> __device__ __forceinline__ float2 unpack2(uint32_t u);
template <> __device__ __forceinline__ float2 unpack2<__nv_bfloat16>(uint32_t u) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}
template <> __device__ __forceinline__ float2 unpack2<__half>(uint32_t u) {
    return __half22float2(*reinterpret_cast<const __half2*>(&u));
}
template <typename T> __device__ __forceinline__ uint32_t pack2(float a, float b);
template <> __device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float a, float b) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&v);
}
template <> __device__ __forceinline__ uint32_t pack2<__half>(float a, float b) {
    const __half2 v = __floats2half2_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&v);
}

// 16 bytes of x as floats: 8 bf16 / fp16 values or 4 fp32 ones.
template <typename T>
__device__ __forceinline__ void load16(const T* p, float (&v)[16 / sizeof(T)]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    if constexpr (std::is_same<T, float>::value) {
        v[0] = __uint_as_float(u.x);
        v[1] = __uint_as_float(u.y);
        v[2] = __uint_as_float(u.z);
        v[3] = __uint_as_float(u.w);
    } else {
        const float2 a = unpack2<T>(u.x), b = unpack2<T>(u.y), c = unpack2<T>(u.z), d = unpack2<T>(u.w);
        v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y, v[4] = c.x, v[5] = c.y, v[6] = d.x, v[7] = d.y;
    }
}

// The JAX ln_stats of one row, computed by one warp: lane l adds its
// 16-byte chunks l, l + 32, ... of the row in order (x, and x * x rounded),
// the lanes' sums are added by a butterfly (offsets 16, 8, 4, 2, 1); mean
// and rstd in fp32, the variance clamped at 0. Every lane gets both.
// tests/test_torch_ln_qkv_f1.py emulates the order.
template <typename T>
__device__ __forceinline__ void row_stats(const T* xr, int c, float eps, float& mu, float& rstd) {
    constexpr int V = 16 / sizeof(T);
    const int lane = threadIdx.x & 31;
    float s = 0.f, s2 = 0.f;
    for (int col = V * lane; col < c; col += 32 * V) {
        float v[V];
        load16<T>(xr + col, v);
#pragma unroll
        for (int e = 0; e < V; ++e) {
            s = __fadd_rn(s, v[e]);
            s2 = __fadd_rn(s2, __fmul_rn(v[e], v[e]));
        }
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

// x_hat, without contraction: (x - mu) * rstd.
__device__ __forceinline__ float xhat_of(float x, float mu, float rstd) { return __fmul_rn(__fsub_rn(x, mu), rstd); }

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
    return p + ((1024 - (H::smem_u32(p) & 1023)) & 1023);
}

// A 2-D tensor map over a row-major [rows, cols] 2-byte operand (row pitch
// cols * 2 bytes): boxes of 64 columns x box_rows rows, 128-byte swizzle,
// zero fill past the edges.
inline bool tma_map(CUtensorMap* map, const void* ptr, bool bf16, long long rows, long long cols, int box_rows) {
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

// ---- F1's statistics: the prologue kernel -----------------------------------------------

constexpr int STATS_THREADS = 256;  // one row a warp

template <typename T>
__global__ void __launch_bounds__(STATS_THREADS) ln_qkv_stats_kernel(const T* __restrict__ x,
                                                                     float2* __restrict__ stats, int m, int c,
                                                                     float eps) {
    // the main kernel may start now; it waits for this grid before it reads
    // the statistics
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
    const int row = blockIdx.x * (STATS_THREADS / 32) + (threadIdx.x >> 5);
    if (row >= m) return;  // the whole warp
    float mu, rstd;
    row_stats(x + static_cast<long long>(row) * c, c, eps, mu, rstd);
    if ((threadIdx.x & 31) == 0) stats[row] = make_float2(mu, rstd);
}

template <typename T>
int launch_stats(const void* x, float2* stats, int m, int c, float eps, cudaStream_t stream) {
    ln_qkv_stats_kernel<T><<<cdiv(m, STATS_THREADS / 32), STATS_THREADS, 0, stream>>>(static_cast<const T*>(x),
                                                                                      stats, m, c, eps);
    return passt_launch_status();
}

// ---- F1 on wgmma, fed by TMA (bf16 / fp16) -----------------------------------------------

constexpr int F1_KS = 64;      // K a stage: one 128-byte swizzle span
constexpr int F1_STAGES = 3;
// products a consumer warpgroup keeps in flight after each issue (1 to 3:
// its four fragment registers hold the stage's four k steps)
constexpr int F1_PENDING = 2;
static_assert(F1_PENDING >= 1 && F1_PENDING <= 3, "a fragment is rebuilt four steps after its product");
constexpr int F1_EPI_COLS = 64;                    // output columns a warp stages at a time
constexpr int F1_EPI_ROW = F1_EPI_COLS * 2 + 16;   // the staged row pitch (bytes)
constexpr int F1_EPI_BYTES = 16 * F1_EPI_ROW;      // a warp's 16 rows

// The compiled tiles (rows, columns): three consumer warpgroups of 64 x 192
// or two of 64 x 256. ops/ln_qkv.py F1_TILES mirrors them.
constexpr int F1_TILES[2][2] = {{192, 192}, {128, 256}};

template <int CW, int BN> struct F1Tile {
    static constexpr int BM = 64 * CW;
    static constexpr int CONSUMERS = 128 * CW;
    static constexpr int THREADS = CONSUMERS + 128;  // the consumer warpgroups, then the producer warpgroup
    static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = CW == 2 ? 232 : 152;
    static constexpr int X_BYTES = BM * 128;        // a stage's x tile: BM rows x 64 of K
    static constexpr int STAGE = X_BYTES + BN * 128;  // and W's: BN rows (output columns) x 64 of K
    // the ring (1024-aligned), the consumer warps' epilogue buffers, s and
    // b by column pairs, the barriers
    static constexpr int SMEM =
        1024 + F1_STAGES * STAGE + CONSUMERS / 32 * F1_EPI_BYTES + 2 * MAX_C * 4 + 2 * F1_STAGES * 8;
    static_assert(PRODUCER_REGS * 128 + CONSUMER_REGS * CONSUMERS <= 65536, "the register file");
    static_assert(SMEM <= 227 * 1024, "shared memory");
};

// The tile with the least wave time for an [m, 3c] output over sms SMs:
// rounds of tiles (ceil(tiles / sms)) times the tile's area, which a round's
// time is proportional to; a tie goes to the first. ops/ln_qkv.py f1_tile
// mirrors it.
inline int f1_pick(int m, int c, int sms) {
    int best = 0;
    long long best_cost = -1;
    for (int i = 0; i < 2; ++i) {
        const int bm = F1_TILES[i][0], bn = F1_TILES[i][1];
        const long long cost = static_cast<long long>(cdiv(cdiv(m, bm) * cdiv(3 * c, bn), sms)) * bm * bn;
        if (best_cost < 0 || cost < best_cost) best = i, best_cost = cost;
    }
    return best;
}

// The A fragment of one k step of 16 (the mma.sync m16n8k16 layout: rows g
// and g + 8 of the warp's 16; columns col and col + 1, then col + 8 and
// col + 9, col = k + 2 (lane % 4)) of xn: x from the stage by ldmatrix
// (xrow: this lane's row of the 128-byte-swizzled tile, chunk: its 16-byte
// chunk before the swizzle), normalized in fp32 and rounded to T. sb: s and
// b by column pairs, {s[2 i], s[2 i + 1], b[2 i], b[2 i + 1]}; sta, stb:
// (mu, rstd) of rows g and g + 8.
template <typename T>
__device__ __forceinline__ void f1_fragment(uint32_t (&a)[4], const unsigned char* xrow, int xsw, int chunk, int col,
                                            const float4* sb, float2 sta, float2 stb) {
    uint32_t r[4];
    ldmatrix_x4(r, xrow + ((chunk ^ xsw) << 4));
    const float4 p0 = sb[col / 2], p1 = sb[col / 2 + 4];
    const float2 s0 = make_float2(p0.x, p0.y), b0 = make_float2(p0.z, p0.w);
    const float2 s1 = make_float2(p1.x, p1.y), b1 = make_float2(p1.z, p1.w);
    const float2 x0 = unpack2<T>(r[0]), x1 = unpack2<T>(r[1]), x2 = unpack2<T>(r[2]), x3 = unpack2<T>(r[3]);
    a[0] = pack2<T>(ln_affine(x0.x, sta.x, sta.y, s0.x, b0.x), ln_affine(x0.y, sta.x, sta.y, s0.y, b0.y));
    a[1] = pack2<T>(ln_affine(x1.x, stb.x, stb.y, s0.x, b0.x), ln_affine(x1.y, stb.x, stb.y, s0.y, b0.y));
    a[2] = pack2<T>(ln_affine(x2.x, sta.x, sta.y, s1.x, b1.x), ln_affine(x2.y, sta.x, sta.y, s1.y, b1.y));
    a[3] = pack2<T>(ln_affine(x3.x, stb.x, stb.y, s1.x, b1.x), ln_affine(x3.y, stb.x, stb.y, s1.y, b1.y));
}

// Persistent: CTA i takes output tiles i, i + grid, ..., tile t at row tile
// t % tiles_m, column tile t / tiles_m. See the file's comment.
template <typename T, int CW, int BN>
__global__ void __launch_bounds__(F1Tile<CW, BN>::THREADS, 1) ln_qkv_f1_wgmma_kernel(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
    const float2* stats, const float* __restrict__ s, const float* __restrict__ b,
    const T* __restrict__ wb, T* __restrict__ out, int m, int c) {
    using Tl = F1Tile<CW, BN>;
    constexpr int BM = Tl::BM;
    extern __shared__ unsigned char smem_raw[];
    unsigned char* ring = align1024(smem_raw);
    unsigned char* epi = ring + F1_STAGES * Tl::STAGE;                  // [consumer warp][16 rows][F1_EPI_ROW]
    float4* sb = reinterpret_cast<float4*>(epi + Tl::CONSUMERS / 32 * F1_EPI_BYTES);  // s and b [c / 2]
    uint64_t* full = reinterpret_cast<uint64_t*>(sb + MAX_C / 2);
    uint64_t* empty = full + F1_STAGES;

    const int c3 = 3 * c, ktiles = c / F1_KS;
    const int tiles_m = (m + BM - 1) / BM, tiles = tiles_m * ((c3 + BN - 1) / BN);
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

    for (int i = threadIdx.x; i < c / 2; i += Tl::THREADS) sb[i] = make_float4(s[2 * i], s[2 * i + 1], b[2 * i], b[2 * i + 1]);
    if (threadIdx.x == 0) {
        for (int st = 0; st < F1_STAGES; ++st) {
            H::mbar_init(full + st, 1);
            H::mbar_init(empty + st, Tl::CONSUMERS / 32);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (warp >= Tl::CONSUMERS / 32) {  // the producer warpgroup: one thread issues every copy
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(Tl::PRODUCER_REGS));
        if (warp == Tl::CONSUMERS / 32 && lane == 0) {
            int it = 0;
            for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
                const int tm = t % tiles_m, tn = t / tiles_m;
                for (int kt = 0; kt < ktiles; ++kt, ++it) {
                    const int st = it % F1_STAGES;
                    if (it >= F1_STAGES) H::mbar_wait_or_trap(empty + st, (it / F1_STAGES - 1) & 1);
                    unsigned char* sp = ring + st * Tl::STAGE;
                    H::mbar_expect_tx(full + st, Tl::STAGE);
                    H::tma_load_2d(sp, &xmap, full + st, kt * F1_KS, tm * BM);
                    H::tma_load_2d(sp + Tl::X_BYTES, &wmap, full + st, kt * F1_KS, tn * BN);
                }
            }
        }
        return;
    }

    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(Tl::CONSUMER_REGS));
    asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the statistics are complete
    const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, t4 = lane & 3;
    // this lane's ldmatrix row of a stage's x tile, and its chunk's swizzle
    const int xr = wg * 64 + wq * 16 + (lane & 15);
    const int xsw = xr & 7, xhalf = lane >> 4;
    float acc[BN / 2];
    uint32_t a[4][4];  // the fragments of the stage's four k steps
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int tm = t % tiles_m, tn = t / tiles_m;
        const int ra = tm * BM + wg * 64 + wq * 16 + g, rb = ra + 8;
        const float2 sta = ra < m ? stats[ra] : make_float2(0.f, 0.f);
        const float2 stb = rb < m ? stats[rb] : make_float2(0.f, 0.f);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
        for (int kt = 0; kt < ktiles; ++kt, ++it) {
            const int st = it % F1_STAGES;
            H::mbar_wait_or_trap(full + st, (it / F1_STAGES) & 1);
            const unsigned char* sp = ring + st * Tl::STAGE;
            const uint64_t bd = H::sw128_desc(sp + Tl::X_BYTES);
#pragma unroll
            for (int kk = 0; kk < F1_KS / 16; ++kk) {
                // a[kk] was read by the product four steps back, which has
                // completed (the wait below leaves F1_PENDING in flight)
                f1_fragment<T>(a[kk], sp + xr * 128, xsw, 2 * kk + xhalf, kt * F1_KS + 16 * kk + 2 * t4, sb, sta, stb);
                H::wgmma_fence();
                H::WgmmaRsF32<T, BN>::mma(acc, a[kk], bd + 2 * kk, 1);
                H::wgmma_commit();
                H::wgmma_wait<F1_PENDING>();
                H::fence_regs(a);  // the fragments stay live until their products have read them
                // the previous stage's last product has completed: free it
                if (kk == F1_PENDING - 1 && kt > 0 && lane == 0) H::mbar_arrive(empty + (it - 1) % F1_STAGES);
            }
        }
        H::wgmma_wait<0>();
        H::fence_regs(acc);
        H::fence_regs(a);
        if (lane == 0) H::mbar_arrive(empty + (it - 1) % F1_STAGES);

        // round the fp32 sum to T, then add the bias in T (accumulator
        // element 4 j + e is row g + 8 (e / 2), column 8 j + 2 t4 + e % 2),
        // into the warp's buffer 64 columns at a time; then 16-byte rows out
        unsigned char* buf = epi + warp * F1_EPI_BYTES;
        const int row0 = tm * BM + wg * 64 + wq * 16;
#pragma unroll
        for (int ch = 0; ch < BN / F1_EPI_COLS; ++ch) {
            const int col0 = tn * BN + ch * F1_EPI_COLS;
            if (col0 >= c3) break;  // 3C is a multiple of 64: a chunk is whole or past the end
            __syncwarp();           // the buffer's last rows have been copied out
#pragma unroll
            for (int jj = 0; jj < F1_EPI_COLS / 8; ++jj) {
                const int j = ch * (F1_EPI_COLS / 8) + jj, cl = 8 * jj + 2 * t4;
                const float2 bias = unpack2<T>(*reinterpret_cast<const uint32_t*>(wb + col0 + cl));
                *reinterpret_cast<uint32_t*>(buf + g * F1_EPI_ROW + cl * 2) =
                    pack2<T>(to_f(from_f<T>(acc[4 * j])) + bias.x, to_f(from_f<T>(acc[4 * j + 1])) + bias.y);
                *reinterpret_cast<uint32_t*>(buf + (g + 8) * F1_EPI_ROW + cl * 2) =
                    pack2<T>(to_f(from_f<T>(acc[4 * j + 2])) + bias.x, to_f(from_f<T>(acc[4 * j + 3])) + bias.y);
            }
            __syncwarp();
#pragma unroll
            for (int i = 0; i < 16 * (F1_EPI_COLS / 8) / 32; ++i) {
                const int idx = 32 * i + lane, rr = idx / (F1_EPI_COLS / 8), cc = idx % (F1_EPI_COLS / 8);
                if (row0 + rr < m)
                    *reinterpret_cast<uint4*>(out + static_cast<long long>(row0 + rr) * c3 + col0 + 8 * cc) =
                        *reinterpret_cast<const uint4*>(buf + rr * F1_EPI_ROW + 16 * cc);
            }
        }
    }
}

template <typename T, int CW, int BN>
int launch_f1_wgmma_n(const void* x, const float* s, const float* b, const void* w, const void* wb, void* out,
                      float2* stats, int m, int c, float eps, int sms, cudaStream_t stream) {
    using Tl = F1Tile<CW, BN>;
    auto kernel = ln_qkv_f1_wgmma_kernel<T, CW, BN>;
    // a runtime call first: it makes the device's context current, which
    // the tensor-map encoder needs
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    const bool bf16 = std::is_same<T, __nv_bfloat16>::value;
    CUtensorMap xmap, wmap;
    if (!tma_map(&xmap, x, bf16, m, c, Tl::BM) || !tma_map(&wmap, w, bf16, 3LL * c, c, BN))
        return static_cast<int>(cudaErrorInvalidValue);
    const int e = launch_stats<T>(x, stats, m, c, eps, stream);
    if (e) return e;
    const int tiles = cdiv(m, Tl::BM) * cdiv(3 * c, BN);
    Launch l(tiles < sms ? tiles : sms, Tl::THREADS, Tl::SMEM, stream, 0, true);
    err = cudaLaunchKernelEx(&l.cfg, kernel, xmap, wmap, static_cast<const float2*>(stats), s, b,
                             static_cast<const T*>(wb), static_cast<T*>(out), m, c);
    if (err != cudaSuccess) return static_cast<int>(err);
    return passt_launch_status();
}

template <typename T>
int launch_f1_wgmma(const void* x, const float* s, const float* b, const void* w, const void* wb, void* out,
                    float2* stats, int m, int c, float eps, int sms, cudaStream_t stream) {
    if (f1_pick(m, c, sms) == 0)
        return launch_f1_wgmma_n<T, 3, 192>(x, s, b, w, wb, out, stats, m, c, eps, sms, stream);
    return launch_f1_wgmma_n<T, 2, 256>(x, s, b, w, wb, out, stats, m, c, eps, sms, stream);
}

// ---- the fp32 main loop (F1 and B2 on FMA) ------------------------------------------------

// acc[i][j] += the sum over ktiles K-tiles of BK of a[i][k] b[j][k]: a
// STAGES-deep cp.async ring; load(slot, kt) issues tile kt's copies
// into the slot, prepare(slot, kt) runs on the landed tile before the
// products (if PREPARE), frag(slot, kq, a, b) reads the fragments of k
// 4 kq .. 4 kq + 3 of the thread's 8 rows and 8 columns from the slot.
// Each output's K is summed in order, one fmaf a k.
template <int BK, int STAGES, bool PREPARE, class Load, class Prepare, class Frag>
__device__ __forceinline__ void fp32_loop(float (&acc)[8][8], int ktiles, Load load, Prepare prepare, Frag frag) {
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
        if (st < ktiles) load(st, st);
        cp_async_commit();
    }
    for (int kt = 0; kt < ktiles; ++kt) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();  // tile kt has landed for every thread; every thread is done with tile kt - 1
        if (kt + STAGES - 1 < ktiles) load((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
        cp_async_commit();
        const int slot = kt % STAGES;
        if constexpr (PREPARE) {
            prepare(slot, kt);
            __syncthreads();
        }
#pragma unroll
        for (int kq = 0; kq < BK / 4; ++kq) {
            float a[8][4], bf[8][4];
            frag(slot, kq, a, bf);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
#pragma unroll
                for (int i = 0; i < 8; ++i)
#pragma unroll
                    for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i][kk], bf[j][kk], acc[i][j]);
        }
    }
    cp_async_wait<0>();
}

__device__ __forceinline__ void put4(float (&dst)[8][4], int i, float4 v) {
    dst[i][0] = v.x, dst[i][1] = v.y, dst[i][2] = v.z, dst[i][3] = v.w;
}

// ---- F1 in fp32 on FMA --------------------------------------------------------------------

constexpr int F1F_BM = 64, F1F_BN = 64, F1F_BK = 16;
constexpr int F1F_STAGES = 2;           // a third stage took 254 registers and 40% longer
constexpr int F1F_THREADS = 64;         // 8 x 8 threads of 8 x 8 outputs
constexpr int F1F_LD = F1F_BK + 4;      // the K-tiles' row pitch (floats)
constexpr int F1F_PLD = F1F_BN + 8;     // the partial's row pitch (floats)

// CTAs a cluster (the K split) for `tiles` output tiles: the fewest of 1, 2
// and 4 that give four CTAs (eight warps) an SM. ops/ln_qkv.py
// f1_fp32_split mirrors it.
inline int f1f_split(int tiles, int sms) { return tiles >= 4 * sms ? 1 : tiles >= 2 * sms ? 2 : 4; }

// Output tile blockIdx.x / ck (row tile t % tiles_m, column tile t /
// tiles_m), K range `rank` of the cluster's ck. See the file's comment.
__global__ void __launch_bounds__(F1F_THREADS) ln_qkv_f1_fp32_kernel(
    const float* __restrict__ x, const float2* stats, const float* __restrict__ s,
    const float* __restrict__ b, const float* __restrict__ w, const float* __restrict__ wb, float* __restrict__ out,
    int m, int c) {
    // the ring: [stage][x rows | W rows][F1F_LD]; the partial [64][F1F_PLD] over it afterwards
    __shared__ __align__(16) float ring[F1F_STAGES * (F1F_BM + F1F_BN) * F1F_LD];
    __shared__ __align__(16) float sk[MAX_C];  // s and b of the K range
    __shared__ __align__(16) float bk[MAX_C];
    static_assert(F1F_BM * F1F_PLD <= F1F_STAGES * (F1F_BM + F1F_BN) * F1F_LD, "the partial fits the ring");
    const int rank = cluster_rank(), ck = cluster_size();
    const int tiles_m = (m + F1F_BM - 1) / F1F_BM, t = blockIdx.x / ck;
    const int row0 = (t % tiles_m) * F1F_BM, col0 = (t / tiles_m) * F1F_BN, c3 = 3 * c;
    const int kr = c / ck, kbeg = rank * kr;
    const int tid = threadIdx.x, rg = tid >> 3, cg = tid & 7;  // rows rg + 8 i, columns cg + 8 j
    auto xs = [&](int slot, int r) { return ring + (slot * (F1F_BM + F1F_BN) + r) * F1F_LD; };
    auto ws = [&](int slot, int n) { return ring + (slot * (F1F_BM + F1F_BN) + F1F_BM + n) * F1F_LD; };

    for (int i = tid; i < kr; i += F1F_THREADS) {
        sk[i] = s[kbeg + i];
        bk[i] = b[kbeg + i];
    }
    __syncthreads();

    auto load = [&](int slot, int kt) {
        const int k0 = kbeg + kt * F1F_BK;
        for (int idx = tid; idx < F1F_BM * (F1F_BK / 4); idx += F1F_THREADS) {
            const int r = idx / (F1F_BK / 4), h = idx % (F1F_BK / 4);
            const int row = row0 + r;
            cp_async16(xs(slot, r) + 4 * h, x + static_cast<long long>(row < m ? row : 0) * c + k0 + 4 * h,
                       row < m ? 16 : 0);
            // 3C is a multiple of 64: every column tile is whole
            cp_async16(ws(slot, r) + 4 * h, w + static_cast<long long>(col0 + r) * c + k0 + 4 * h);
        }
    };
    // x's K-tile to xn in place: a thread takes the 4-column chunk pc of rows
    // pr + 16 i, with those rows' statistics in registers (a pass element by
    // element cost a quarter of the kernel's time)
    constexpr int PCH = F1F_BK / 4, PROWS = F1F_BM * PCH / F1F_THREADS;
    const int pc = tid % PCH, pr = tid / PCH;
    float2 pst[PROWS];
    asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the statistics are complete
#pragma unroll
    for (int i = 0; i < PROWS; ++i) {
        const int row = row0 + pr + i * (F1F_THREADS / PCH);
        pst[i] = row < m ? stats[row] : make_float2(0.f, 0.f);
    }
    auto prepare = [&](int slot, int kt) {
        const float4 sv = *reinterpret_cast<const float4*>(sk + kt * F1F_BK + 4 * pc);
        const float4 bv = *reinterpret_cast<const float4*>(bk + kt * F1F_BK + 4 * pc);
#pragma unroll
        for (int i = 0; i < PROWS; ++i) {
            float4* p = reinterpret_cast<float4*>(xs(slot, pr + i * (F1F_THREADS / PCH)) + 4 * pc);
            float4 v = *p;
            v.x = ln_affine(v.x, pst[i].x, pst[i].y, sv.x, bv.x);
            v.y = ln_affine(v.y, pst[i].x, pst[i].y, sv.y, bv.y);
            v.z = ln_affine(v.z, pst[i].x, pst[i].y, sv.z, bv.z);
            v.w = ln_affine(v.w, pst[i].x, pst[i].y, sv.w, bv.w);
            *p = v;
        }
    };
    auto frag = [&](int slot, int kq, float (&a)[8][4], float (&bf)[8][4]) {
#pragma unroll
        for (int i = 0; i < 8; ++i) put4(a, i, *reinterpret_cast<const float4*>(xs(slot, rg + 8 * i) + 4 * kq));
#pragma unroll
        for (int j = 0; j < 8; ++j) put4(bf, j, *reinterpret_cast<const float4*>(ws(slot, cg + 8 * j) + 4 * kq));
    };
    float acc[8][8] = {};
    fp32_loop<F1F_BK, F1F_STAGES, true>(acc, kr / F1F_BK, load, prepare, frag);

    __syncthreads();  // every thread is done with the ring
    float* part = ring;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) part[(rg + 8 * i) * F1F_PLD + cg + 8 * j] = acc[i][j];
    cluster_sync();  // (1) every CTA's partial is in place
    // CTA `rank` stores rows [rank 64 / ck, (rank + 1) 64 / ck) of the tile:
    // the K ranges' partials added in rank order, then the bias
    const int rows = F1F_BM / ck;
    for (int idx = tid; idx < rows * (F1F_BN / 4); idx += F1F_THREADS) {
        const int r = rank * rows + idx / (F1F_BN / 4), c4 = 4 * (idx % (F1F_BN / 4));
        const int row = row0 + r, col = col0 + c4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int q = 0; q < ck; ++q) {
            const float4 p = ld_cluster4(map_rank(part + r * F1F_PLD + c4, q));
            v.x += p.x, v.y += p.y, v.z += p.z, v.w += p.w;
        }
        if (row < m) {
            const float4 bb = *reinterpret_cast<const float4*>(wb + col);
            *reinterpret_cast<float4*>(out + static_cast<long long>(row) * c3 + col) =
                make_float4(v.x + bb.x, v.y + bb.y, v.z + bb.z, v.w + bb.w);
        }
    }
    cluster_sync();  // (2) no CTA leaves while another reads its shared memory
}

// The fp32 F1's output tiles and K split at (m, c).
inline void f1f_plan(int m, int c, int sms, int& tiles, int& ck) {
    tiles = cdiv(m, F1F_BM) * (3 * c / F1F_BN);
    ck = f1f_split(tiles, sms);
}

int launch_f1_fp32(const void* x, const float* s, const float* b, const void* w, const void* wb, void* out,
                   float2* stats, int m, int c, float eps, int sms, cudaStream_t stream) {
    int tiles, ck;
    f1f_plan(m, c, sms, tiles, ck);
    const int e = launch_stats<float>(x, stats, m, c, eps, stream);
    if (e) return e;
    Launch l(tiles * ck, F1F_THREADS, 0, stream, ck, true);
    const cudaError_t err = cudaLaunchKernelEx(&l.cfg, ln_qkv_f1_fp32_kernel, static_cast<const float*>(x),
                                               static_cast<const float2*>(stats), s, b,
                                               static_cast<const float*>(w), static_cast<const float*>(wb),
                                               static_cast<float*>(out), m, c);
    if (err != cudaSuccess) return static_cast<int>(err);
    return passt_launch_status();
}

// ---- B2 on wgmma, fed by TMA (bf16 / fp16) ------------------------------------------

constexpr int B2_CW = 3;                    // consumer warpgroups of a CTA: 64 rows each
constexpr int B2_BM = 64 * B2_CW;           // rows of a cluster (the partials' row tile)
constexpr int B2_KS = 64;                   // K (= 3C) a stage: one 128-byte swizzle span
constexpr int B2_STAGES = 3;
constexpr int B2_CONSUMERS = 128 * B2_CW;
constexpr int B2_THREADS = B2_CONSUMERS + 128;  // the consumer warpgroups, then the producer warpgroup
constexpr int B2_PRODUCER_REGS = 40, B2_CONSUMER_REGS = 152;
constexpr int B2_A_BYTES = B2_BM * 128;     // a stage's dqkv tile: B2_BM rows x 64 of K
constexpr int B2_W_BLOCK = B2_KS * 128;     // a stage's block of W: 64 rows of K x 64 columns
static_assert(B2_W_BLOCK == H::MN_BLOCK_BYTES, "sw128_mn_blocks_desc steps between W's blocks");
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

// The pair of x at column cl (even) of block nb, row r, from x's blocks in
// shared memory (B2_BM rows of 128 bytes each, 128-byte swizzle: the
// 16-byte chunk cl / 8 of row r sits at chunk (cl / 8) ^ (r % 8)).
__device__ __forceinline__ uint32_t x_pair(const unsigned char* xs, int nb, int r, int cl) {
    return *reinterpret_cast<const uint32_t*>(xs + nb * B2_BM * 128 + r * 128 + (((cl >> 3) ^ (r & 7)) << 4) +
                                              (cl & 7) * 2);
}

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
    if (!tma_map(&dmap, dqkv, bf16, m, 3LL * c, B2_BM) || !tma_map(&wmap, w, bf16, 3LL * c, c, B2_KS) ||
        !tma_map(&xmap, x, bf16, m, c, B2_BM))
        return static_cast<int>(cudaErrorInvalidValue);
    Launch l(cdiv(m, B2_BM) * ncta, B2_THREADS, B2Tile<NB>::SMEM, stream, ncta, false);
    err = cudaLaunchKernelEx(&l.cfg, kernel, dmap, wmap, xmap, s, b, static_cast<T*>(dx),
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
    Launch l(*ncta, B2_THREADS, B2Tile<NB>::SMEM, nullptr, *ncta, false);
    return static_cast<int>(cudaOccupancyMaxActiveClusters(active, kernel, &l.cfg));
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

// ---- B2 in fp32 on FMA, a cluster per 16 rows -------------------------------------------

constexpr int B2F_ROWS = 16;    // rows a cluster: the dscale/dbias partials' row tile
constexpr int B2F_CK = 8;       // CTAs a cluster: K = 3C in eight ranges (3C / 8 = 24 C / 64)
constexpr int B2F_BK = 8;       // K a tile
constexpr int B2F_STAGES = 3;
constexpr int B2F_LDA = B2F_BK + 4;  // dqkv's tile row pitch (floats)

// Threads of a CTA: C / 8 column groups of 8 for each of the two 8-row
// halves, rounded up to whole warps, and at least the two warps that run
// the LayerNorm backward of the CTA's two rows.
inline int b2f_threads(int c) { return c / 4 <= 64 ? 64 : cdiv(c / 4, 32) * 32; }
// Shared memory of a CTA (bytes): W's K-tiles [stage][BK][c], dqkv's
// [stage][16][LDA], dxn of the CTA's two rows [2][c], their (dxn x_hat,
// dxn) [2][c] float2.
inline int b2f_smem(int c) { return 4 * (B2F_STAGES * (B2F_BK * c + B2F_ROWS * B2F_LDA) + 2 * c + 4 * c); }

// Cluster blockIdx.x / 8 holds rows [16 t, 16 t + 16); CTA `rank` sums K in
// [rank 3C / 8, (rank + 1) 3C / 8) over all C columns, then owns rows
// 2 rank and 2 rank + 1 of the tile. See the file's comment.
__global__ void __launch_bounds__(MAX_C / 4) ln_qkv_b2_fp32_kernel(
    const float* __restrict__ x, const float* __restrict__ dqkv, const float* __restrict__ w,
    const float* __restrict__ s, const float* __restrict__ b, float* __restrict__ dx, float* __restrict__ xn,
    float* __restrict__ dsc_part, float* __restrict__ dbi_part, int m, int c, float eps) {
    extern __shared__ __align__(16) float smf[];
    float* ws = smf;                                              // [stage][BK][c]
    float* ds = ws + B2F_STAGES * B2F_BK * c;                     // [stage][16][LDA]
    float* dxn = ds + B2F_STAGES * B2F_ROWS * B2F_LDA;            // [2][c]
    float2* col_sums = reinterpret_cast<float2*>(dxn + 2 * c);    // [2][c]
    float* part = smf;  // [16][c]: this CTA's partial, over the ring once the products are done

    const int rank = cluster_rank(), tile = blockIdx.x / B2F_CK;
    const int row0 = tile * B2F_ROWS, c3 = 3 * c, kr = c3 / B2F_CK, kbeg = rank * kr;
    const int tid = threadIdx.x, nthr = blockDim.x, ng = c / 8, hc = c / 2;
    // rows 8 rg .. 8 rg + 7; columns 4 cg .. 4 cg + 3 and hc + 4 cg .. + 3
    // (threads past 2 ng compute a copy of thread 0's and store nothing)
    const bool owner = tid < 2 * ng;
    const int rg = owner ? tid / ng : 0, cg = owner ? tid % ng : 0;

    auto load = [&](int slot, int kt) {
        const int k0 = kbeg + kt * B2F_BK;
        if (tid < 2 * B2F_ROWS) {  // dqkv: 16 rows x 8 of K, two 16-byte chunks a row
            const int r = tid >> 1, h = tid & 1, row = row0 + r;
            cp_async16(ds + (slot * B2F_ROWS + r) * B2F_LDA + 4 * h,
                       dqkv + static_cast<long long>(row < m ? row : 0) * c3 + k0 + 4 * h, row < m ? 16 : 0);
        }
        const int cq = c / 4;  // W: 8 rows of K x c
        for (int idx = tid; idx < B2F_BK * cq; idx += nthr) {
            const int kk = idx / cq, ch = idx - kk * cq;
            cp_async16(ws + (slot * B2F_BK + kk) * c + 4 * ch, w + static_cast<long long>(k0 + kk) * c + 4 * ch);
        }
    };
    auto frag = [&](int slot, int kq, float (&a)[8][4], float (&bf)[8][4]) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
            put4(a, i, *reinterpret_cast<const float4*>(ds + (slot * B2F_ROWS + 8 * rg + i) * B2F_LDA + 4 * kq));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
            const float* wr = ws + (slot * B2F_BK + 4 * kq + kk) * c;
            const float4 lo = *reinterpret_cast<const float4*>(wr + 4 * cg);
            const float4 hi = *reinterpret_cast<const float4*>(wr + hc + 4 * cg);
            bf[0][kk] = lo.x, bf[1][kk] = lo.y, bf[2][kk] = lo.z, bf[3][kk] = lo.w;
            bf[4][kk] = hi.x, bf[5][kk] = hi.y, bf[6][kk] = hi.z, bf[7][kk] = hi.w;
        }
    };
    float acc[8][8] = {};
    fp32_loop<B2F_BK, B2F_STAGES, false>(acc, kr / B2F_BK, load, [](int, int) {}, frag);

    __syncthreads();  // every thread is done with the ring
    if (owner) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            float* pr = part + (8 * rg + i) * c;
            *reinterpret_cast<float4*>(pr + 4 * cg) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
            *reinterpret_cast<float4*>(pr + hc + 4 * cg) = make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
        }
    }
    cluster_sync();  // (1) every CTA's partial is in place
    // rows 2 rank and 2 rank + 1 of dxn: the eight K ranges' partials added in rank order
    for (int idx = tid; idx < c; idx += nthr) {
        const int rr = idx / hc, cc = 2 * (idx - rr * hc);
        const float* p = part + (2 * rank + rr) * c + cc;
        float2 v = make_float2(0.f, 0.f);
        for (int q = 0; q < B2F_CK; ++q) {
            const float2 u = ld_cluster(map_rank(p, q));
            v.x += u.x, v.y += u.y;
        }
        *reinterpret_cast<float2*>(dxn + rr * c + cc) = v;
    }
    __syncthreads();

    // the LayerNorm backward of the two rows, a warp each: xn, dx, and each
    // column's (dxn x_hat, dxn) for the cluster's dscale / dbias sums
    const int warp = tid >> 5, lane = tid & 31;
    if (warp < 2) {
        const int row = row0 + 2 * rank + warp;
        const float* d = dxn + warp * c;
        float2* cs = col_sums + warp * c;
        if (row < m) {
            const float* xr = x + static_cast<long long>(row) * c;
            float mu, rstd;
            row_stats<float>(xr, c, eps, mu, rstd);
            float s1 = 0.f, s2 = 0.f;
            for (int col = 2 * lane; col < c; col += 64) {
                const float2 xv = load2(xr + col), sv = load2(s + col), bv = load2(b + col), dv = load2(d + col);
                const float xh0 = xhat_of(xv.x, mu, rstd), xh1 = xhat_of(xv.y, mu, rstd);
                store2(xn + static_cast<long long>(row) * c + col, __fadd_rn(__fmul_rn(xh0, sv.x), bv.x),
                       __fadd_rn(__fmul_rn(xh1, sv.y), bv.y));
                const float g0 = dv.x * sv.x, g1 = dv.y * sv.y;
                s1 += g0 + g1;
                s2 += g0 * xh0 + g1 * xh1;
                cs[col] = make_float2(dv.x * xh0, dv.x);
                cs[col + 1] = make_float2(dv.y * xh1, dv.y);
            }
            s1 = warp_sum(s1);
            s2 = warp_sum(s2);
            const float inv_c = 1.0f / static_cast<float>(c), m1 = s1 * inv_c, m2 = s2 * inv_c;
            for (int col = 2 * lane; col < c; col += 64) {
                const float2 xv = load2(xr + col), sv = load2(s + col), dv = load2(d + col);
                const float xh0 = xhat_of(xv.x, mu, rstd), xh1 = xhat_of(xv.y, mu, rstd);
                const float g0 = dv.x * sv.x, g1 = dv.y * sv.y;
                store2(dx + static_cast<long long>(row) * c + col, rstd * (g0 - m1 - xh0 * m2),
                       rstd * (g1 - m1 - xh1 * m2));
            }
        } else {
            for (int col = lane; col < c; col += 32) cs[col] = make_float2(0.f, 0.f);
        }
    }
    cluster_sync();  // (2) every CTA's column sums are in place
    // the tile's dscale / dbias partials of columns [rank c / 8, (rank + 1)
    // c / 8): the 16 rows in order (rank order, then the CTA's two rows)
    const int cs_n = c / B2F_CK;
    for (int i = tid; i < cs_n; i += nthr) {
        const int col = rank * cs_n + i;
        float a = 0.f, bb = 0.f;
        for (int q = 0; q < B2F_CK; ++q)
            for (int rr = 0; rr < 2; ++rr) {
                const float2 v = ld_cluster(map_rank(col_sums + rr * c + col, q));
                a += v.x;
                bb += v.y;
            }
        dsc_part[static_cast<long long>(tile) * c + col] = a;
        dbi_part[static_cast<long long>(tile) * c + col] = bb;
    }
    cluster_sync();  // (3) no CTA leaves while another reads its shared memory
}

int launch_b2_fp32(const void* x, const void* dqkv, const void* w, const float* s, const float* b, void* dx,
                   void* xn, float* dsc, float* dbi, int m, int c, float eps, cudaStream_t stream) {
    const int smem = b2f_smem(c);
    cudaError_t err = cudaFuncSetAttribute(ln_qkv_b2_fp32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    Launch l(cdiv(m, B2F_ROWS) * B2F_CK, b2f_threads(c), smem, stream, B2F_CK, false);
    err = cudaLaunchKernelEx(&l.cfg, ln_qkv_b2_fp32_kernel, static_cast<const float*>(x),
                             static_cast<const float*>(dqkv), static_cast<const float*>(w), s, b,
                             static_cast<float*>(dx), static_cast<float*>(xn), dsc, dbi, m, c, eps);
    if (err != cudaSuccess) return static_cast<int>(err);
    return passt_launch_status();
}

bool shape_ok(int m, int c) { return m > 0 && c >= 64 && c <= MAX_C && c % 64 == 0; }

}  // namespace

// Rows of a dscale/dbias partial of passt_ln_qkv_b2 for a dtype (its
// partials have ceil(m / rows) rows): the fp32 kernel's cluster row tile,
// or the bf16/fp16 kernel's.
extern "C" int passt_ln_qkv_b2_rows(int dtype) { return dtype == 0 ? B2F_ROWS : B2_BM; }

// The B2 kernel's cluster for a dtype at width c: its CTAs (ncta) and how
// many such clusters the card holds at once (active). Returns a CUDA error
// code.
extern "C" int passt_ln_qkv_b2_clusters(int dtype, int c, int* ncta, int* active) {
    if (!shape_ok(1, c) || dtype < 0 || dtype > 2) return static_cast<int>(cudaErrorInvalidValue);
    if (dtype == 0) {
        const int smem = b2f_smem(c);
        const cudaError_t err =
            cudaFuncSetAttribute(ln_qkv_b2_fp32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (err != cudaSuccess) return static_cast<int>(err);
        *ncta = B2F_CK;
        Launch l(B2F_CK, b2f_threads(c), smem, nullptr, B2F_CK, false);
        return static_cast<int>(cudaOccupancyMaxActiveClusters(active, ln_qkv_b2_fp32_kernel, &l.cfg));
    }
    int q, nb;
    b2_split(c, q, nb);
    switch (nb) {
        case 1: return b2_clusters_n<__nv_bfloat16, 1>(c, ncta, active);
        case 2: return b2_clusters_n<__nv_bfloat16, 2>(c, ncta, active);
        case 3: return b2_clusters_n<__nv_bfloat16, 3>(c, ncta, active);
    }
    return static_cast<int>(cudaErrorInvalidValue);
}

// How many CTAs of F1's main kernel for (dtype, m, c) the card holds at once
// (the occupancy query), into *ctas. Returns a CUDA error code.
template <typename T, int CW, int BN>
int f1_resident_n(int sms, int* ctas) {
    using Tl = F1Tile<CW, BN>;
    auto kernel = ln_qkv_f1_wgmma_kernel<T, CW, BN>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::SMEM);
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kernel, Tl::THREADS, Tl::SMEM);
    *ctas *= sms;
    return static_cast<int>(err);
}

// What passt_ln_qkv_f1 launches for (dtype, m, c) on a card of sms SMs:
// plan = {tile rows, tile columns, CTAs a cluster (the fp32 K split; 1 for
// bf16/fp16), output tiles, CTAs of the main grid, CTAs the card holds at
// once}. Returns a CUDA error code.
extern "C" int passt_ln_qkv_f1_plan(int dtype, int m, int c, int sms, int* plan) {
    if (!shape_ok(m, c) || sms <= 0 || dtype < 0 || dtype > 2) return static_cast<int>(cudaErrorInvalidValue);
    if (dtype == 0) {
        int tiles, ck;
        f1f_plan(m, c, sms, tiles, ck);
        plan[0] = F1F_BM, plan[1] = F1F_BN, plan[2] = ck, plan[3] = tiles, plan[4] = tiles * ck;
        Launch l(ck, F1F_THREADS, 0, nullptr, ck, false);
        const cudaError_t err = cudaOccupancyMaxActiveClusters(plan + 5, ln_qkv_f1_fp32_kernel, &l.cfg);
        plan[5] *= ck;
        return static_cast<int>(err);
    }
    const int i = f1_pick(m, c, sms);
    const int tiles = cdiv(m, F1_TILES[i][0]) * cdiv(3 * c, F1_TILES[i][1]);
    plan[0] = F1_TILES[i][0], plan[1] = F1_TILES[i][1], plan[2] = 1, plan[3] = tiles;
    plan[4] = tiles < sms ? tiles : sms;
    if (dtype == 1) return i == 0 ? f1_resident_n<__nv_bfloat16, 3, 192>(sms, plan + 5)
                                  : f1_resident_n<__nv_bfloat16, 2, 256>(sms, plan + 5);
    return i == 0 ? f1_resident_n<__half, 3, 192>(sms, plan + 5) : f1_resident_n<__half, 2, 256>(sms, plan + 5);
}

// x [m, c], w [3c, c], wb [3c], out [m, 3c] in dtype (0 float32, 1 bfloat16,
// 2 float16), row-major, 16-byte aligned; s, b [c] float32; stats [m] of
// float2 (scratch for the statistics). c a multiple of 64, 64 <= c <= 1024;
// sms: the card's SMs (the persistent grid's size, the fp32 K split).
// Launches the statistics' prologue, then the main kernel behind it.
// Returns cudaGetLastError() after the launches.
extern "C" int passt_ln_qkv_f1(const void* x, const void* s, const void* b, const void* w, const void* wb,
                               void* out, void* stats, int dtype, int m, int c, float eps, int sms, void* stream) {
    if (!shape_ok(m, c) || sms <= 0) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const float* sf = static_cast<const float*>(s);
    const float* bf = static_cast<const float*>(b);
    float2* sc = static_cast<float2*>(stats);
    switch (dtype) {
        case 0: return launch_f1_fp32(x, sf, bf, w, wb, out, sc, m, c, eps, sms, st);
        case 1: return launch_f1_wgmma<__nv_bfloat16>(x, sf, bf, w, wb, out, sc, m, c, eps, sms, st);
        case 2: return launch_f1_wgmma<__half>(x, sf, bf, w, wb, out, sc, m, c, eps, sms, st);
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
        case 0: return launch_b2_fp32(x, dqkv, w, sf, bf, dx, xn, dsc, dbi, m, c, eps, st);
        case 1: return launch_b2_wgmma<__nv_bfloat16>(x, dqkv, w, sf, bf, dx, xn, dsc, dbi, m, c, eps, st);
        case 2: return launch_b2_wgmma<__half>(x, dqkv, w, sf, bf, dx, xn, dsc, dbi, m, c, eps, st);
    }
    return static_cast<int>(cudaErrorInvalidValue);
}
