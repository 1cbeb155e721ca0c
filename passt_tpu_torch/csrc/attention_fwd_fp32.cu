// Attention forward for Hopper (sm_90a), fp32 at D = 64 and D = 32: the
// "simt" path of ops/attention.py forward_path (every aligned fp32 call at
// those head dims: the fp32 Predictor's and exported program's B = 20,
// N = 1190 and the fp32 training step's B = 2, N = 474 at D = 64; the
// convergence demo's reduced PaSST at model.dtype=float32, 6 heads of
// D = 32, B = 25, N = 79 in training and B = 50, N = 110 in eval).
//
// Replaces, for fp32 inputs at D = 64 or 32 with 16-byte aligned strides:
// passt_tpu/ops/pallas/attention.py:171 _fwd_kernel (the pallas_call at
// :245), :373 _flat_fwd_kernel (:446) and scripts/proto_attn_qkv.py:63
// _fwd_kernel_flat through the qkv entry, as attention_fwd.cu's "fma" path
// did (which stays for fp32 at another D and for unaligned views). Both
// entries: q, k, v and o are base pointers with (batch, token, head)
// strides, so q/k/v views into qkv are read in place. The kernel is a
// template on D; the D = 64 instance is the one of the first design, bit
// for bit.
//
// The math is the reference's at Precision.HIGHEST (_softmax_parts): s =
// (q . k) * scale in fp32; m = the row max (from 0 under plus1); p =
// exp(s - m); l = sum p (+ exp(-m) under plus1); o = (P v) / l, every
// product full fp32 on the FMA units (no TF32, no split products: the
// contract). At fp32, rounding P to the input dtype is the identity.
//
// What bounds it: fp32 FMA. The function is 4 N^2 D FLOP a head: 87.0
// GFLOP at B = 20, H = 12, N = 1190 (1.2986 ms at 67 TFLOP/s; bytes 292 MB,
// 0.0872 ms) and 1.38 GFLOP at B = 2, N = 474 (0.0206 ms); at D = 32, 0.12
// GFLOP at B = 25, H = 6, N = 79 (0.0018 ms, bytes 6.07 MB: 0.0018) and
// 0.46 GFLOP at B = 50, N = 110 (0.0069 ms). Against the "fma" kernel's
// limits:
// 1. Two passes over K (6 N^2 D of FMA work, K read twice): one pass with
//    a running row max. It starts at -inf (at 0 under plus1, so the final m
//    is exactly max(0, row max)); when a key tile raises it, l and the fp32
//    accumulator are rescaled by exp(m_old - m_new). That rescale is the
//    only difference from the exact-max order (a few ulps);
//    tests/test_torch_attention_online.py holds an fp32 emulation of this
//    order against the Pallas kernel interpreted, at both D.
// 2. Scalar shared loads (8 loads a 16 FMA): register micro-tiles. A thread
//    holds the scores of QR = 4 queries x KC = 8 keys and the output of the
//    same 4 queries x OC = D / 8 columns (8 at D = 64, 4 at D = 32). Q, K
//    and V lie in shared memory as in device memory (rows of D floats,
//    pitch D + 4: 68 or 36). S = Q K^T runs along D with float4 loads: 4 +
//    8 of them a 128 FMA; O += P V is an outer product over the keys, a row
//    of P^T and of V a step: 1 + OC / 4 float4 a 4 OC FMA. P^T is staged
//    through shared memory as [key][query] (pitch 68 at either D), the
//    queries of a thread side by side (column 4 tq + i holds query tq +
//    16 i), so the rows a thread needs in either product are its own. The
//    rows a warp reads at once fall in distinct banks or are broadcast:
//    each float4 load and P^T store is one wavefront a quarter warp.
// 3. expf(__fmul_rn(s, scale) - m) a score: one FMA and ex2.approx,
//    2^(s_raw (scale log2 e) - m log2 e), as the bf16 paths and the simt
//    backward take it; a few fp32 ulps from expf.
// 4. Synchronous scalar copies: 16-byte cp.async, K and V each in one
//    buffer, their loads staggered: K(t + 1) lands during PV(t), V(t + 1)
//    during S(t + 1). Q is loaded once. Rows past N are zero-filled, keys
//    past N get p = 0 before the max, queries past N are not stored.
// Occupancy: 128 threads a block, one block per (64 queries, head, batch);
// the launch bounds ask for three blocks an SM (at most 170 registers).
// Shared memory (Q, K, V, P^T): 68 KB at D = 64, three blocks an SM; 44 KB
// at D = 32, where the registers (128), not shared memory, set the blocks
// an SM: four. 4560 blocks at B = 20, N = 1190; 192 at B = 2, N = 474
// (under one round on 132 SMs); 300 at the demo's B = 25, N = 79 (one
// round) and 600 at B = 50, N = 110 (two).
// What sets its time is read from text variants
// (tools/attention_fwd_fp32_variants, PERF.md).
#include "common.cuh"
#include "attention_common.cuh"
#include "hopper.cuh"  // ex2_approx, LOG2E

#include <math.h>
#include <stdint.h>

namespace {

using namespace passt_attn;
using namespace passt_hopper;

// A thread's micro-tile: QR queries x KC keys of S, the same QR queries x
// OC<D> columns of O. KS threads (neighbouring lanes) share a query row.
constexpr int QR = 4, KC = 8;
constexpr int QS = 64 / QR, KS = 64 / KC;  // query and key (column) steps
constexpr int THREADS = QS * KS;
constexpr int PLD = SIMT_LD;               // P^T's row pitch: 64 queries (272 bytes)
template <int D>
constexpr int LD = simt_ld<D>;             // Q, K, V row pitch in floats: load_rows' layout
template <int D>
constexpr int TILE = 64 * LD<D>;           // floats of a padded 64-row tile of Q, K or V
template <int D>
constexpr int OC = D / KS;                 // O columns a thread
template <int D>
constexpr int MIN_BLOCKS = 3;              // blocks an SM the registers must allow
template <int D>
constexpr int SMEM = (3 * TILE<D> + 64 * PLD) * 4;  // Q, K, V, P^T
static_assert(QR == 4, "P^T holds a thread's queries as one float4");
static_assert(KS <= 32 && OC<32> % 4 == 0 && OC<64> == KC,
              "a query row's threads lie in one warp; O columns go by float4");

// s[i][j] = Q[tq + QS i] . K[tk + KS j] over D, unscaled (attention_bwd_fp32.cu's
// dot<4, 8>, kept in this file so that its text variants can edit it, as
// pv below is that file's outer).
template <int D>
__device__ __forceinline__ void scores(float (&s)[QR][KC], const float* Qs, const float* Ks, int tq, int tk) {
#pragma unroll
    for (int i = 0; i < QR; ++i)
#pragma unroll
        for (int j = 0; j < KC; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int c = 0; c < D; c += 4) {
        float4 a[QR], b[KC];
#pragma unroll
        for (int i = 0; i < QR; ++i) a[i] = *reinterpret_cast<const float4*>(Qs + (tq + QS * i) * LD<D> + c);
#pragma unroll
        for (int j = 0; j < KC; ++j) b[j] = *reinterpret_cast<const float4*>(Ks + (tk + KS * j) * LD<D> + c);
#pragma unroll
        for (int i = 0; i < QR; ++i)
#pragma unroll
            for (int j = 0; j < KC; ++j) {
                float x = fmaf(a[i].x, b[j].x, s[i][j]);
                x = fmaf(a[i].y, b[j].y, x);
                x = fmaf(a[i].z, b[j].z, x);
                s[i][j] = fmaf(a[i].w, b[j].w, x);
            }
    }
}

// acc[i][4 h + c] += sum over the 64 keys x of P^T[x][4 tq + i]
// V[x][4 tk + 4 KS h + c]: an outer product, a row of P^T and of V a step.
template <int D>
__device__ __forceinline__ void pv(float (&acc)[QR][OC<D>], const float* Pt, const float* Vs, int tq, int tk) {
#pragma unroll 8
    for (int x = 0; x < 64; ++x) {
        const float4 a = *reinterpret_cast<const float4*>(Pt + x * PLD + 4 * tq);
        const float av[4] = {a.x, a.y, a.z, a.w};
        float bv[OC<D>];
#pragma unroll
        for (int h = 0; h < OC<D> / 4; ++h) {
            const float4 b = *reinterpret_cast<const float4*>(Vs + x * LD<D> + 4 * tk + 4 * KS * h);
            bv[4 * h] = b.x;
            bv[4 * h + 1] = b.y;
            bv[4 * h + 2] = b.z;
            bv[4 * h + 3] = b.w;
        }
#pragma unroll
        for (int i = 0; i < QR; ++i)
#pragma unroll
            for (int c = 0; c < OC<D>; ++c) acc[i][c] = fmaf(av[i], bv[c], acc[i][c]);
    }
}

// One block per (64-query tile, head, batch). Thread (tq, tk) = (tid / KS,
// tid % KS) holds queries tq + QS i, keys tk + KS j of each key tile and
// output columns 4 tk + 4 KS h + c.
template <int D>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS<D>) attn32_fwd_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v, float* __restrict__ o,
    Strides qs, Strides ks, Strides vs, Strides os, int n, float scale, int plus1) {
    extern __shared__ __align__(16) float smem[];
    float* Qs = smem;          // [64 queries][LD]
    float* Ks = Qs + TILE<D>;  // [64 keys][LD]
    float* Vs = Ks + TILE<D>;  // [64 keys][LD]
    float* Pt = Vs + TILE<D>;  // [64 keys][PLD] p, a thread's queries side by side

    const int tid = threadIdx.x, tk = tid % KS, tq = tid / KS;
    const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * 64;
    const int tiles = (n + 63) / 64;
    const float* qb = q + b * qs.b + h * qs.h;
    const float* kb = k + b * ks.b + h * ks.h;
    const float* vb = v + b * vs.b + h * vs.h;

    // two groups in flight at the top of every turn: Q with K(0), then V(0)
    load_rows<D>(Qs, qb, qs.n, q0, n, tid, THREADS);
    load_rows<D>(Ks, kb, ks.n, 0, n, tid, THREADS);
    cp_async_commit();
    load_rows<D>(Vs, vb, vs.n, 0, n, tid, THREADS);
    cp_async_commit();

    const float sl2 = scale * LOG2E;
    float m[QR], l[QR], acc[QR][OC<D>];
#pragma unroll
    for (int i = 0; i < QR; ++i) {
        m[i] = plus1 ? 0.f : -INFINITY;  // running max, scaled
        l[i] = 0.f;                      // this thread's share of the row sum
#pragma unroll
        for (int c = 0; c < OC<D>; ++c) acc[i][c] = 0.f;
    }
    for (int t = 0; t < tiles; ++t) {
        const int k0 = t * 64;
        const bool ragged = k0 + 64 > n;  // the last tile, where keys pass N
        cp_async_wait<1>();  // K(t) has landed (and Q); V(t) may still be in flight
        __syncthreads();     // for every thread; every thread is done with PV(t - 1), so P^T is free
        float s[QR][KC];
        scores<D>(s, Qs, Ks, tq, tk);
#pragma unroll
        for (int i = 0; i < QR; ++i) {
            float x = -INFINITY;
#pragma unroll
            for (int j = 0; j < KC; ++j) {
                if (ragged && k0 + tk + KS * j >= n) s[i][j] = -INFINITY;  // keys past N: p = 0
                x = fmaxf(x, s[i][j]);
            }
#pragma unroll
            for (int off = 1; off < KS; off <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
            // key k0 < N, so x is finite; m_old = -inf gives alpha = 0
            const float mn = fmaxf(m[i], x * scale);
            const float alpha = ex2_approx((m[i] - mn) * LOG2E), ml = mn * LOG2E;
            float pl = 0.f;
#pragma unroll
            for (int j = 0; j < KC; ++j) {
                s[i][j] = ex2_approx(fmaf(s[i][j], sl2, -ml));
                pl += s[i][j];
            }
            l[i] = l[i] * alpha + pl;
            m[i] = mn;
#pragma unroll
            for (int c = 0; c < OC<D>; ++c) acc[i][c] *= alpha;
        }
#pragma unroll
        for (int j = 0; j < KC; ++j)
            *reinterpret_cast<float4*>(Pt + (tk + KS * j) * PLD + 4 * tq) = make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
        cp_async_wait<0>();  // V(t) has landed
        __syncthreads();     // P^T and V(t) for every thread; every thread is done with K(t)
        if (t + 1 < tiles) load_rows<D>(Ks, kb, ks.n, k0 + 64, n, tid, THREADS);
        cp_async_commit();
        pv<D>(acc, Pt, Vs, tq, tk);
        __syncthreads();     // every thread is done with V(t)
        if (t + 1 < tiles) load_rows<D>(Vs, vb, vs.n, k0 + 64, n, tid, THREADS);
        cp_async_commit();
    }

    float* ob = o + b * os.b + h * os.h;
#pragma unroll
    for (int i = 0; i < QR; ++i) {
#pragma unroll
        for (int off = 1; off < KS; off <<= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
        if (plus1) l[i] += ex2_approx(-m[i] * LOG2E);
        const int row = q0 + tq + QS * i;
        if (row >= n) continue;
#pragma unroll
        for (int hh = 0; hh < OC<D> / 4; ++hh)
            *reinterpret_cast<float4*>(ob + (long long)row * os.n + 4 * tk + 4 * KS * hh) =
                make_float4(acc[i][4 * hh] / l[i], acc[i][4 * hh + 1] / l[i], acc[i][4 * hh + 2] / l[i],
                            acc[i][4 * hh + 3] / l[i]);
    }
}

// The shared-memory carve-out as large as it goes, so that MIN_BLOCKS
// blocks fit an SM.
template <int D>
cudaError_t configure() {
    cudaError_t err = cudaFuncSetAttribute(attn32_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM<D>);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(attn32_fwd_kernel<D>, cudaFuncAttributePreferredSharedMemoryCarveout,
                                   cudaSharedmemCarveoutMaxShared);
    return err;
}

template <int D>
cudaError_t occupancy(int* blocks) {
    cudaError_t err = configure<D>();
    if (err == cudaSuccess) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, attn32_fwd_kernel<D>, THREADS, SMEM<D>);
    return err;
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* o, int batch, int n, int heads, Strides qs,
                   Strides ks, Strides vs, Strides os, float scale, int plus1, cudaStream_t stream) {
    const cudaError_t err = configure<D>();
    if (err != cudaSuccess) return err;
    attn32_fwd_kernel<D><<<dim3((n + 63) / 64, heads, batch), THREADS, SMEM<D>, stream>>>(
        q, k, v, o, qs, ks, vs, os, n, scale, plus1);
    return cudaSuccess;
}

}  // namespace

// Blocks of the head-dim-d instance (32 or 64) an SM holds at once (the
// occupancy query), into *blocks. Returns a CUDA error code.
extern "C" int passt_attention_fwd_fp32_occupancy(int d, int* blocks) {
    if (d != 32 && d != 64) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(d == 64 ? occupancy<64>(blocks) : occupancy<32>(blocks));
}

// q, k, v, o: fp32, element (b, t, h, c) at ptr[b * sb + t * sn + h * sh + c];
// d must be 64 or 32 and every operand 16-byte aligned with strides in
// multiples of 8 elements (else cudaErrorInvalidValue and nothing
// launched). Returns cudaGetLastError() after the launch.
extern "C" int passt_attention_fwd_fp32(const void* q, const void* k, const void* v, void* o,
                                        int batch, int n, int heads, int d,
                                        long long qsb, long long qsn, long long qsh,
                                        long long ksb, long long ksn, long long ksh,
                                        long long vsb, long long vsn, long long vsh,
                                        long long osb, long long osn, long long osh,
                                        float scale, int plus1, void* stream) {
    const Strides qs{qsb, qsn, qsh}, ks{ksb, ksn, ksh}, vs{vsb, vsn, vsh}, os{osb, osn, osh};
    const bool aligned = vectors_aligned(q, qs) && vectors_aligned(k, ks) && vectors_aligned(v, vs) &&
                         vectors_aligned(o, os);
    if ((d != 64 && d != 32) || n <= 0 || batch <= 0 || heads <= 0 || batch > 65535 || heads > 65535 || !aligned)
        return static_cast<int>(cudaErrorInvalidValue);
    const auto qf = static_cast<const float*>(q), kf = static_cast<const float*>(k), vf = static_cast<const float*>(v);
    const auto st = static_cast<cudaStream_t>(stream);
    const cudaError_t err = d == 64 ? launch<64>(qf, kf, vf, static_cast<float*>(o), batch, n, heads, qs, ks, vs, os,
                                                 scale, plus1, st)
                                    : launch<32>(qf, kf, vf, static_cast<float*>(o), batch, n, heads, qs, ks, vs, os,
                                                 scale, plus1, st);
    if (err != cudaSuccess) return static_cast<int>(err);
    return passt_launch_status();
}
