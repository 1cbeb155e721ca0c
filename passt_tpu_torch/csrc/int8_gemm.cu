// The int8 Dense family's GEMM on wgmma, fed by TMA, for Hopper (sm_90a):
// the main loop that every public int8 call takes on the card.
//
// Replaces: passt_tpu/ops/pallas/int8_dense.py:_dense_kernel (epilogue
// DENSE) and :_dense_gelu_kernel (epilogue GELU), and
// scripts/int8_matmul_micro.py:_mm_kernel (epilogue RAW), as int8_dense.cu
// did with mma.sync (that loop stays as the private path "mma"). The port's
// wrappers are in passt_tpu_torch/ops/int8.py.
//
// out[M, N] = epilogue(A[M, K] . B[N, K]^T), both operands K-major (8-bit
// wgmma takes no other layout; the wrapper writes the quantized weight as
// [N, K]). The epilogues are int8_dense.cu's, element for element (fp32,
// no contraction): DENSE ((acc * sx[row]) * sw[col]) + b[col], rounded once;
// GELU the same z, then h and the saved derivative d, each rounded once;
// RAW the accumulator as is (int32), or through fp32 to bf16.
//
// Design (what bounds it: 8192^3 int8 is operations-bound, 0.556 ms at
// 1979 TOP/s; fc1 + GELU at M = 5688 writes 69.9 of its 76.7 MB, bytes):
// - the products: wgmma m64nNk32 s8 x s8 -> s32 (m64nNk16 bf16 -> f32 for
//   the micro-benchmark's bf16 RAW mode), both operands from shared memory;
// - a BM = 128 x BN output tile (BN 128, 192 or 256, the template
//   parameter with the ring depth), two consumer warpgroups of 64 rows
//   each, both reading the same B tile;
// - one producer thread keeps TMA loads of 128 bytes of K (A: BM rows, B:
//   BN rows, 128-byte swizzle, zero fill past M, N and K) in flight in a
//   STAGES-deep mbarrier ring; a consumer keeps one wgmma group in flight
//   and frees a slot once the group that read it has completed;
// - the producer is a whole warpgroup so that setmaxnreg can move its
//   registers to the consumers (40 and 232 a thread): ptxas caps a
//   kernel of this size at 168, where the 128 x 256 tile's accumulators and
//   the GELU epilogue spilled;
// - a persistent grid (one block an SM) walks the output tiles in groups of
//   GROUP_M row tiles (tile_coords; the B tiles of a group stay in L2), so
//   a tile's epilogue overlaps the next tile's loads;
// - the epilogue stages each warp's 16 rows x 64 columns in shared memory
//   and stores them as 16-byte rows (elementwise where a row's end is not
//   16-byte aligned, predicated on M and N).
// The wrapper (ops/int8.py pick_tile) picks BN per call for the least wave
// time: the fewest rounds of tiles over the SMs, weighted by the tile's
// width (a round of 128 x 256 tiles takes about twice one of 128 x 128);
// of tiles that tie, the narrowest under GELU (the shorter epilogue) and
// the widest under DENSE and RAW (fewer bytes read per product).
#include "common.cuh"
#include "hopper.cuh"

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace passt_hopper;
using passt::gelu;

constexpr int BM = 128;                     // rows per tile: two warpgroups of 64
constexpr int KB = 128;                     // K bytes per stage: one 128-byte swizzle span
constexpr int CONSUMERS = 256;
constexpr int THREADS = CONSUMERS + 128;    // the consumer warpgroups, then the producer warpgroup
// registers a thread after setmaxnreg: the producer gives up what the
// consumers' accumulators (up to 128 a thread at BN = 256) take
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int GROUP_M = 8;                  // row tiles per group of the tile order
constexpr int EPI_COLS = 64;                // output columns a warp stages at a time
constexpr int EPI_ROW = EPI_COLS * 4 + 16;  // staged row pitch (bytes)
constexpr int EPI_BYTES = 8 * 16 * EPI_ROW;  // eight consumer warps, 16 rows each

enum { EPI_DENSE = 0, EPI_GELU = 1, EPI_RAW = 2 };

template <int BN, int STAGES>
struct Tile {
    static constexpr int STAGE_BYTES = (BM + BN) * KB;
    static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + EPI_BYTES + 16 * STAGES;
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
    return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

template <int N>
__device__ __forceinline__ void fence_acc(int (&r)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_acc(float (&r)[N]) { fence_regs(r); }

// Output tile t of the persistent order: groups of GROUP_M row tiles, each
// group walked column by column (the row tiles of a column in turn).
// ops/int8.py tile_order mirrors it.
__device__ __forceinline__ void tile_coords(int t, int tiles_m, int tiles_n, int& tm, int& tn) {
    const int per_group = GROUP_M * tiles_n;
    const int group = t / per_group, first = group * GROUP_M;
    const int size = min(tiles_m - first, GROUP_M);
    const int r = t - group * per_group;
    tm = first + r % size;
    tn = r / size;
}

__device__ __forceinline__ float dequant(int acc, float sx, float sw, float b) {
    return __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc), sx), sw), b);
}

__device__ __forceinline__ void put2(int* p, int a, int b) { *reinterpret_cast<int2*>(p) = make_int2(a, b); }
__device__ __forceinline__ void put2(float* p, float a, float b) { passt::store2(p, a, b); }
__device__ __forceinline__ void put2(__nv_bfloat16* p, float a, float b) { passt::store2(p, a, b); }

// One warp's staged 16 rows x EPI_COLS columns (buf) to out rows row0 ..,
// columns col0 ..: 16-byte stores where the row pitch allows, elementwise
// at the ragged edge; nothing past m or n.
template <typename TOut>
__device__ __forceinline__ void copy_out(TOut* out, const unsigned char* buf, int row0, int col0, int m, int n,
                                         bool vec, int lane) {
    constexpr int EPC = 16 / sizeof(TOut);           // elements a 16-byte chunk
    constexpr int CPR = EPI_COLS / EPC;              // chunks a row
#pragma unroll
    for (int it = 0; it < 16 * CPR / 32; ++it) {
        const int idx = it * 32 + lane, rr = idx / CPR, cc = idx % CPR;
        const int row = row0 + rr, col = col0 + cc * EPC;
        if (row >= m || col >= n) continue;
        const unsigned char* src = buf + rr * EPI_ROW + cc * 16;
        TOut* dst = out + (long long)row * n + col;
        if (vec && col + EPC <= n) {
            *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
        } else {
            const TOut* s = reinterpret_cast<const TOut*>(src);
            for (int e = 0; e < EPC && col + e < n; ++e) dst[e] = s[e];
        }
    }
}

template <typename TIn, int EPI, typename TOut, int BN, int STAGES>
__global__ void __launch_bounds__(THREADS, 1) gemm_wgmma_kernel(
    const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap, TOut* __restrict__ out,
    TOut* __restrict__ out2, const float* __restrict__ sx, const float* __restrict__ sw,
    const float* __restrict__ bias, int m, int n, int ktiles, int vec) {
    using Acc = typename std::conditional<std::is_same<TIn, int8_t>::value, int, float>::type;
    // the value an epilogue stores: int32 kept as is, everything else fp32
    using Val = typename std::conditional<EPI == EPI_RAW && std::is_same<TOut, int>::value, int, float>::type;
    using T = Tile<BN, STAGES>;
    constexpr int KE = KB / sizeof(TIn);  // K elements a stage
    extern __shared__ unsigned char smem_raw[];
    unsigned char* base = align1024(smem_raw);
    unsigned char* epi = base + STAGES * T::STAGE_BYTES;
    uint64_t* full = reinterpret_cast<uint64_t*>(epi + EPI_BYTES);
    uint64_t* empty = full + STAGES;

    const int tiles_m = (m + BM - 1) / BM, tiles_n = (n + BN - 1) / BN, tiles = tiles_m * tiles_n;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(full + s, 1);
            mbar_init(empty + s, CONSUMERS / 32);
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();

    if (warp >= CONSUMERS / 32) {  // the producer warpgroup: one thread issues every copy
        asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
        if (warp == CONSUMERS / 32 && lane == 0) {
            int it = 0;
            for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
                int tm, tn;
                tile_coords(t, tiles_m, tiles_n, tm, tn);
                for (int kt = 0; kt < ktiles; ++kt, ++it) {
                    const int s = it % STAGES;
                    if (it >= STAGES) mbar_wait(empty + s, (it / STAGES - 1) & 1);
                    unsigned char* st = base + s * T::STAGE_BYTES;
                    mbar_expect_tx(full + s, T::STAGE_BYTES);
                    tma_load_2d(st, &amap, full + s, kt * KE, tm * BM);
                    tma_load_2d(st + BM * KB, &bmap, full + s, kt * KE, tn * BN);
                }
            }
        }
        return;
    }

    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
    const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, t4 = lane & 3;
    unsigned char* buf = epi + warp * 16 * EPI_ROW;
    Acc acc[BN / 2];
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int tm, tn;
        tile_coords(t, tiles_m, tiles_n, tm, tn);
        for (int kt = 0; kt < ktiles; ++kt, ++it) {
            const int s = it % STAGES;
            mbar_wait(full + s, (it / STAGES) & 1);
            const unsigned char* st = base + s * T::STAGE_BYTES;
            const uint64_t ad = sw128_desc(st + wg * 64 * KB), bd = sw128_desc(st + BM * KB);
            fence_acc(acc);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < KB / 32; ++kk)
                WgmmaGemm<Acc, BN>::mma(acc, ad + 2 * kk, bd + 2 * kk, kt > 0 || kk > 0);
            wgmma_commit();
            wgmma_wait<1>();  // the group that read the previous slot has completed
            fence_acc(acc);
            if (kt > 0 && lane == 0) mbar_arrive(empty + (it - 1) % STAGES);
        }
        wgmma_wait<0>();
        fence_acc(acc);
        if (lane == 0) mbar_arrive(empty + (it - 1) % STAGES);

        // the epilogue, EPI_COLS columns at a time through this warp's buffer
        const int row0 = tm * BM + wg * 64 + wq * 16;
        const int ra = row0 + g, rb = ra + 8;
        float sxa = 0.f, sxb = 0.f;
        if constexpr (EPI != EPI_RAW) {
            sxa = ra < m ? sx[ra] : 0.f;
            sxb = rb < m ? sx[rb] : 0.f;
        }
#pragma unroll
        for (int c = 0; c < BN / EPI_COLS; ++c) {
            const int col0 = tn * BN + c * EPI_COLS;
            // the first output straight into the buffer; GELU's d kept for a
            // second pass
            float d2[EPI == EPI_GELU ? 32 : 1];
            __syncwarp();  // the buffer's last rows have been copied out
#pragma unroll
            for (int jj = 0; jj < 8; ++jj)
#pragma unroll
                for (int hh = 0; hh < 2; ++hh) {
                    const int x = 32 * c + 4 * jj + 2 * hh, col = col0 + 8 * jj + 2 * t4;
                    TOut* p = reinterpret_cast<TOut*>(buf + (g + 8 * hh) * EPI_ROW) + 8 * jj + 2 * t4;
                    if constexpr (EPI == EPI_RAW) {
                        // int -> int, int -> fp32 (rn) -> TOut, fp32 -> TOut
                        put2(p, static_cast<Val>(acc[x]), static_cast<Val>(acc[x + 1]));
                    } else {
                        const float sxr = hh ? sxb : sxa;
                        const bool ok0 = col < n, ok1 = col + 1 < n;
                        const float z0 = dequant(acc[x], sxr, ok0 ? sw[col] : 0.f, ok0 ? bias[col] : 0.f);
                        const float z1 = dequant(acc[x + 1], sxr, ok1 ? sw[col + 1] : 0.f, ok1 ? bias[col + 1] : 0.f);
                        if constexpr (EPI == EPI_DENSE) {
                            put2(p, z0, z1);
                        } else {
                            float h0, h1;
                            gelu(z0, h0, d2[4 * jj + 2 * hh]);
                            gelu(z1, h1, d2[4 * jj + 2 * hh + 1]);
                            put2(p, h0, h1);
                        }
                    }
                }
            __syncwarp();
            copy_out<TOut>(out, buf, row0, col0, m, n, vec, lane);
            if constexpr (EPI == EPI_GELU) {
                __syncwarp();
#pragma unroll
                for (int jj = 0; jj < 8; ++jj)
#pragma unroll
                    for (int hh = 0; hh < 2; ++hh) {
                        TOut* p = reinterpret_cast<TOut*>(buf + (g + 8 * hh) * EPI_ROW) + 8 * jj + 2 * t4;
                        put2(p, d2[4 * jj + 2 * hh], d2[4 * jj + 2 * hh + 1]);
                    }
                __syncwarp();
                copy_out<TOut>(out2, buf, row0, col0, m, n, vec, lane);
            }
        }
    }
}

template <typename TIn, int EPI, typename TOut, int BN, int STAGES>
int launch(const void* a, const void* bt, void* out, void* out2, const void* sx, const void* sw, const void* bias,
           int m, int n, int k, int sms, cudaStream_t stream) {
    using T = Tile<BN, STAGES>;
    auto kernel = gemm_wgmma_kernel<TIn, EPI, TOut, BN, STAGES>;
    // a runtime call first: on a thread that has made none yet it makes the
    // device's context current, which the tensor-map encoder needs
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    const bool bf16 = std::is_same<TIn, __nv_bfloat16>::value;
    const long long pitch = (long long)k * sizeof(TIn);
    CUtensorMap amap, bmap;
    if (!make_map_2d(&amap, a, bf16, m, k, pitch, BM) || !make_map_2d(&bmap, bt, bf16, n, k, pitch, BN))
        return static_cast<int>(cudaErrorInvalidValue);
    const int ktiles = static_cast<int>((pitch + KB - 1) / KB);
    const long long tiles = (long long)((m + BM - 1) / BM) * ((n + BN - 1) / BN);
    if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    const int grid = static_cast<int>(tiles < sms ? tiles : sms);
    const int vec = (static_cast<long long>(n) * sizeof(TOut)) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(out) % 16 == 0 && reinterpret_cast<uintptr_t>(out2) % 16 == 0;
    kernel<<<grid, THREADS, T::SMEM, stream>>>(amap, bmap, static_cast<TOut*>(out), static_cast<TOut*>(out2),
                                               static_cast<const float*>(sx), static_cast<const float*>(sw),
                                               static_cast<const float*>(bias), m, n, ktiles, vec);
    return passt_launch_status();
}

// The compiled tiles, by the index the wrapper passes (ops/int8.py TILES).
template <typename TIn, int EPI, typename TOut>
int launch_tile(int tile, const void* a, const void* bt, void* out, void* out2, const void* sx, const void* sw,
                const void* bias, int m, int n, int k, int sms, cudaStream_t st) {
    switch (tile) {
        case 0: return launch<TIn, EPI, TOut, 128, 5>(a, bt, out, out2, sx, sw, bias, m, n, k, sms, st);
        case 1: return launch<TIn, EPI, TOut, 192, 4>(a, bt, out, out2, sx, sw, bias, m, n, k, sms, st);
        case 2: return launch<TIn, EPI, TOut, 256, 3>(a, bt, out, out2, sx, sw, bias, m, n, k, sms, st);
    }
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// As passt_int8_gemm (int8_dense.cu): a [m, k] and bt [n, k] row-major in
// in_dtype (0 int8, 1 bfloat16), 16-byte aligned, k * element size a
// multiple of 16; out (and out2 for GELU) [m, n] in out_dtype (0 float32,
// 1 bfloat16, 2 int32); sx [m], sw [n], bias [n] float32 (DENSE and GELU
// only); epilogue 0 DENSE, 1 GELU, 2 RAW. tile: 0 (128 x 128, 5 stages),
// 1 (128 x 192, 4 stages), 2 (128 x 256, 3 stages); sms: the persistent
// grid's size limit (the card's multiprocessors). Returns
// cudaGetLastError() after the launch, cudaErrorInvalidValue for a call it
// cannot take (nothing launched).
extern "C" int passt_int8_gemm_wgmma(const void* a, const void* bt, void* out, void* out2, const void* sx,
                                     const void* sw, const void* bias, int in_dtype, int epilogue, int out_dtype,
                                     int m, int n, int k, int tile, int sms, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const int elem = in_dtype == 1 ? 2 : 1;
    if (m <= 0 || n <= 0 || k <= 0 || sms <= 0 || (static_cast<long long>(k) * elem) % 16 ||
        reinterpret_cast<uintptr_t>(a) % 16 || reinterpret_cast<uintptr_t>(bt) % 16)
        return static_cast<int>(cudaErrorInvalidValue);
#define PASST_TILE(TIN, EPI, TOUT) return launch_tile<TIN, EPI, TOUT>(tile, a, bt, out, out2, sx, sw, bias, m, n, k, sms, st)
    if (in_dtype == 0) {
        if (epilogue == EPI_DENSE && out_dtype == 0) PASST_TILE(int8_t, EPI_DENSE, float);
        if (epilogue == EPI_DENSE && out_dtype == 1) PASST_TILE(int8_t, EPI_DENSE, __nv_bfloat16);
        if (epilogue == EPI_GELU && out_dtype == 0) PASST_TILE(int8_t, EPI_GELU, float);
        if (epilogue == EPI_GELU && out_dtype == 1) PASST_TILE(int8_t, EPI_GELU, __nv_bfloat16);
        if (epilogue == EPI_RAW && out_dtype == 2) PASST_TILE(int8_t, EPI_RAW, int);
        if (epilogue == EPI_RAW && out_dtype == 1) PASST_TILE(int8_t, EPI_RAW, __nv_bfloat16);
    } else if (in_dtype == 1 && epilogue == EPI_RAW && out_dtype == 1) {
        PASST_TILE(__nv_bfloat16, EPI_RAW, __nv_bfloat16);
    }
#undef PASST_TILE
    return static_cast<int>(cudaErrorInvalidValue);
}
