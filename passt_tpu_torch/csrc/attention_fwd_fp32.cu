// Attention forward for Hopper (sm_90a) in fp32 FMA: the "simt" path of
// ops/attention.py forward_path, which takes every fp32 call (any head dim
// d, a multiple of 8 up to 128, any strides) and the bf16 / fp16 calls no
// tensor-core path takes (d = 8 mod 16, or unaligned views): the fp32
// Predictor's and exported program's B = 20, N = 1190 and the fp32 training
// step's B = 2, N = 474 at D = 64; the convergence demo's reduced PaSST at
// model.dtype=float32, 6 heads of D = 32 (B = 25, N = 79 in training,
// B = 50, N = 110 in eval), and the same demo with 2 heads of D = 96.
//
// Replaces passt_tpu/ops/pallas/attention.py:171 _fwd_kernel (the
// pallas_call at :245), :373 _flat_fwd_kernel (:446) and
// scripts/proto_attn_qkv.py:63 _fwd_kernel_flat through the qkv entry, for
// those calls, as attention_fwd.cu's "fma" kernel did (which no call
// dispatches to now; the private path override still reaches it). Both
// entries: q, k, v and o are base pointers with (batch, token, head)
// strides, so q/k/v views into qkv are read in place.
//
// A template on the input type T (float, bf16, fp16) and on the padded head
// dim DP (32, 64, 96, 128; simt_dp in attention_common.cuh): the call's d is
// a run-time argument of the loads and stores only. Columns d .. DP - 1 are
// zeroed once in shared memory and never stored, so they add exact zeros to
// every FMA chain. Operands are converted to fp32 in shared memory: with
// 16-byte aligned operands by 16-byte cp.async (fp32) or 16-byte loads
// (bf16 / fp16), otherwise by 4-byte cp.async (fp32) or element loads,
// chosen once per launch. An fp32 call at d = DP with aligned operands
// takes a FULL instance (a third template argument), whose copies and
// stores check nothing at run time: with the checks in, the D = 64
// instance ran 4-6% slower and the backward 9-11% on an H100 (PERF.md).
// The fp32 instances at D = 64 and 32 are those of the first design, bit
// for bit (tools/attention_same_bits).
//
// The math is the reference's at Precision.HIGHEST (_softmax_parts): s =
// (q . k) * scale in fp32; m = the row max (from 0 under plus1); p =
// exp(s - m); l = sum p (+ exp(-m) under plus1); o = (P v) / l, every
// product full fp32 on the FMA units (no TF32, no split products: the
// contract). P is rounded to T for the PV product against the running max,
// as the bf16 "wgmma" path rounds it; l sums the unrounded p; o is rounded
// to T once. At fp32 both roundings are the identity.
//
// What bounds it: fp32 FMA. The function is 4 N^2 D FLOP a head: 87.0
// GFLOP at B = 20, H = 12, N = 1190 (1.2986 ms at 67 TFLOP/s; bytes 292 MB,
// 0.0872 ms) and 1.38 GFLOP at B = 2, N = 474 (0.0206 ms; the same at 6
// heads of D = 128 or 16 of D = 48); at D = 32, 0.12 GFLOP at B = 25,
// H = 6, N = 79 (0.0018 ms, bytes 6.07 MB: 0.0018) and 0.46 GFLOP at
// B = 50, N = 110 (0.0069 ms); 2 heads of D = 96 do the same work. A
// padded instance does DP / d of it. Against the "fma" kernel's limits:
// 1. Two passes over K (6 N^2 D of FMA work, K read twice): one pass with
//    a running row max. It starts at -inf (at 0 under plus1, so the final m
//    is exactly max(0, row max)); when a key tile raises it, l and the fp32
//    accumulator are rescaled by exp(m_old - m_new). That rescale is the
//    only difference from the exact-max order (a few ulps);
//    tests/test_torch_attention_online.py holds an emulation of this order
//    (padded, and in bf16 / fp16) against the Pallas kernel interpreted.
// 2. Scalar shared loads (8 loads a 16 FMA): register micro-tiles. A thread
//    holds the scores of QR = 4 queries x KC = 8 keys and the output of the
//    same 4 queries x OC = DP / 8 columns (4 to 16). Q, K and V lie in
//    shared memory as in device memory (rows of DP floats, pitch DP + 4).
//    S = Q K^T runs along D with float4 loads: 4 + 8 of them a 128 FMA;
//    O += P V is an outer product over the keys, a row of P^T and of V a
//    step: 1 + OC / 4 float4 a 4 OC FMA. P^T is staged through shared
//    memory as [key][query] (pitch 68), the queries of a thread side by
//    side (column 4 tq + i holds query tq + 16 i), so the rows a thread
//    needs in either product are its own. The rows a warp reads at once
//    fall in distinct banks or are broadcast: each float4 load and P^T
//    store is one wavefront a quarter warp.
// 3. expf(__fmul_rn(s, scale) - m) a score: one FMA and ex2.approx,
//    2^(s_raw (scale log2 e) - m log2 e), as the bf16 paths and the simt
//    backward take it; a few fp32 ulps from expf.
// 4. Synchronous scalar copies: cp.async, K and V each in one buffer,
//    their loads staggered: K(t + 1) lands during PV(t), V(t + 1) during
//    S(t + 1) (the bf16 / fp16 loads are synchronous, where the other
//    blocks of the SM cover them). Q is loaded once. Rows past N are
//    zero-filled, keys past N get p = 0 before the max, queries past N are
//    not stored.
// Occupancy: 128 threads a block, one block per (64 queries, head, batch);
// the launch bounds ask for three blocks an SM (at most 170 registers) at
// DP = 32 and 64. Shared memory (Q, K, V, P^T): 68 KB at DP = 64, three
// blocks an SM; 44 KB at DP = 32, where the registers (128), not shared
// memory, set the blocks an SM: four; 92 KB at DP = 96, two; 116 KB at
// DP = 128, one. 4560 blocks at B = 20, N = 1190; 192 at B = 2, N = 474
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
// OC<DP> columns of O. KS threads (neighbouring lanes) share a query row.
constexpr int QR = 4, KC = 8;
constexpr int QS = 64 / QR, KS = 64 / KC;  // query and key (column) steps
constexpr int THREADS = QS * KS;
constexpr int PLD = SIMT_LD;               // P^T's row pitch: 64 queries (272 bytes)
template <int DP>
constexpr int LD = simt_ld<DP>;            // Q, K, V row pitch in floats: load_rows' layout
template <int DP>
constexpr int TILE = 64 * LD<DP>;          // floats of a padded 64-row tile of Q, K or V
template <int DP>
constexpr int OC = DP / KS;                // O columns a thread
template <int DP>                          // blocks an SM the registers must allow
constexpr int MIN_BLOCKS = DP <= 64 ? 3 : DP == 96 ? 2 : 1;
template <int DP>
constexpr int SMEM = (3 * TILE<DP> + 64 * PLD) * 4;  // Q, K, V, P^T
static_assert(QR == 4, "P^T holds a thread's queries as one float4");
static_assert(KS <= 32 && OC<32> % 4 == 0 && OC<64> == KC,
              "a query row's threads lie in one warp; O columns go by float4");
static_assert(SMEM<128> <= 227 * 1024, "one block of the widest instance fits an SM");

// s[i][j] = Q[tq + QS i] . K[tk + KS j] over DP, unscaled (attention_bwd_fp32.cu's
// dot<4, 8>, kept in this file so that its text variants can edit it, as
// pv below is that file's outer).
template <int DP>
__device__ __forceinline__ void scores(float (&s)[QR][KC], const float* Qs, const float* Ks, int tq, int tk) {
#pragma unroll
    for (int i = 0; i < QR; ++i)
#pragma unroll
        for (int j = 0; j < KC; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int c = 0; c < DP; c += 4) {
        float4 a[QR], b[KC];
#pragma unroll
        for (int i = 0; i < QR; ++i) a[i] = *reinterpret_cast<const float4*>(Qs + (tq + QS * i) * LD<DP> + c);
#pragma unroll
        for (int j = 0; j < KC; ++j) b[j] = *reinterpret_cast<const float4*>(Ks + (tk + KS * j) * LD<DP> + c);
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
template <int DP>
__device__ __forceinline__ void pv(float (&acc)[QR][OC<DP>], const float* Pt, const float* Vs, int tq, int tk) {
#pragma unroll 8
    for (int x = 0; x < 64; ++x) {
        const float4 a = *reinterpret_cast<const float4*>(Pt + x * PLD + 4 * tq);
        const float av[4] = {a.x, a.y, a.z, a.w};
        float bv[OC<DP>];
#pragma unroll
        for (int h = 0; h < OC<DP> / 4; ++h) {
            const float4 b = *reinterpret_cast<const float4*>(Vs + x * LD<DP> + 4 * tk + 4 * KS * h);
            bv[4 * h] = b.x;
            bv[4 * h + 1] = b.y;
            bv[4 * h + 2] = b.z;
            bv[4 * h + 3] = b.w;
        }
#pragma unroll
        for (int i = 0; i < QR; ++i)
#pragma unroll
            for (int c = 0; c < OC<DP>; ++c) acc[i][c] = fmaf(av[i], bv[c], acc[i][c]);
    }
}

// One block per (64-query tile, head, batch). Thread (tq, tk) = (tid / KS,
// tid % KS) holds queries tq + QS i, keys tk + KS j of each key tile and
// output columns 4 tk + 4 KS h + c.
template <typename T, int DP, bool FULL>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS<DP>) attn32_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v, T* __restrict__ o,
    Strides qs, Strides ks, Strides vs, Strides os, int n, int d, float scale, int plus1, int vec) {
    if constexpr (FULL) {  // d = DP and every operand aligned: the checks below fold away
        d = DP;
        vec = 1;
    }
    extern __shared__ __align__(16) float smem[];
    float* Qs = smem;           // [64 queries][LD]
    float* Ks = Qs + TILE<DP>;  // [64 keys][LD]
    float* Vs = Ks + TILE<DP>;  // [64 keys][LD]
    float* Pt = Vs + TILE<DP>;  // [64 keys][PLD] p, a thread's queries side by side

    const int tid = threadIdx.x, tk = tid % KS, tq = tid / KS;
    const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * 64;
    const int tiles = (n + 63) / 64;
    const T* qb = q + b * qs.b + h * qs.h;
    const T* kb = k + b * ks.b + h * ks.h;
    const T* vb = v + b * vs.b + h * vs.h;

    if (d < DP) simt_zero_pad<DP>(Qs, 3 * 64, d, tid, THREADS);  // Q, K and V lie side by side
    // two groups in flight at the top of every turn: Q with K(0), then V(0)
    load_rows<T, DP, FULL>(Qs, qb, qs.n, q0, n, d, vec, tid, THREADS);
    load_rows<T, DP, FULL>(Ks, kb, ks.n, 0, n, d, vec, tid, THREADS);
    cp_async_commit();
    load_rows<T, DP, FULL>(Vs, vb, vs.n, 0, n, d, vec, tid, THREADS);
    cp_async_commit();

    const float sl2 = scale * LOG2E;
    float m[QR], l[QR], acc[QR][OC<DP>];
#pragma unroll
    for (int i = 0; i < QR; ++i) {
        m[i] = plus1 ? 0.f : -INFINITY;  // running max, scaled
        l[i] = 0.f;                      // this thread's share of the row sum
#pragma unroll
        for (int c = 0; c < OC<DP>; ++c) acc[i][c] = 0.f;
    }
    for (int t = 0; t < tiles; ++t) {
        const int k0 = t * 64;
        const bool ragged = k0 + 64 > n;  // the last tile, where keys pass N
        cp_async_wait<1>();  // K(t) has landed (and Q); V(t) may still be in flight
        __syncthreads();     // for every thread; every thread is done with PV(t - 1), so P^T is free
        float s[QR][KC];
        scores<DP>(s, Qs, Ks, tq, tk);
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
            for (int c = 0; c < OC<DP>; ++c) acc[i][c] *= alpha;
        }
#pragma unroll
        for (int j = 0; j < KC; ++j)  // P rounded to T for PV (the identity at fp32)
            *reinterpret_cast<float4*>(Pt + (tk + KS * j) * PLD + 4 * tq) =
                make_float4(round_to<T>(s[0][j]), round_to<T>(s[1][j]), round_to<T>(s[2][j]), round_to<T>(s[3][j]));
        cp_async_wait<0>();  // V(t) has landed
        __syncthreads();     // P^T and V(t) for every thread; every thread is done with K(t)
        if (t + 1 < tiles) load_rows<T, DP, FULL>(Ks, kb, ks.n, k0 + 64, n, d, vec, tid, THREADS);
        cp_async_commit();
        pv<DP>(acc, Pt, Vs, tq, tk);
        __syncthreads();     // every thread is done with V(t)
        if (t + 1 < tiles) load_rows<T, DP, FULL>(Vs, vb, vs.n, k0 + 64, n, d, vec, tid, THREADS);
        cp_async_commit();
    }

    T* ob = o + b * os.b + h * os.h;
#pragma unroll
    for (int i = 0; i < QR; ++i) {
#pragma unroll
        for (int off = 1; off < KS; off <<= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
        if (plus1) l[i] += ex2_approx(-m[i] * LOG2E);
        const int row = q0 + tq + QS * i;
        if (row >= n) continue;
#pragma unroll
        for (int hh = 0; hh < OC<DP> / 4; ++hh) {
            const int c = 4 * tk + 4 * KS * hh;
            if (c < d)
                store4<T>(ob + (long long)row * os.n + c,
                          make_float4(acc[i][4 * hh] / l[i], acc[i][4 * hh + 1] / l[i], acc[i][4 * hh + 2] / l[i],
                                      acc[i][4 * hh + 3] / l[i]),
                          vec);
        }
    }
}

// The shared-memory carve-out as large as it goes, so that MIN_BLOCKS
// blocks fit an SM.
template <typename T, int DP, bool FULL>
cudaError_t configure() {
    const auto kernel = attn32_fwd_kernel<T, DP, FULL>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM<DP>);
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                   cudaSharedmemCarveoutMaxShared);
    return err;
}

template <typename T, int DP, bool FULL>
cudaError_t occupancy(int* blocks) {
    cudaError_t err = configure<T, DP, FULL>();
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, attn32_fwd_kernel<T, DP, FULL>, THREADS, SMEM<DP>);
    return err;
}

struct Args {
    const void *q, *k, *v;
    void* o;
    int batch, n, heads, d;
    Strides qs, ks, vs, os;
    float scale;
    int plus1, vec;
    cudaStream_t stream;
};

template <typename T, int DP, bool FULL>
cudaError_t launch(const Args& a) {
    const cudaError_t err = configure<T, DP, FULL>();
    if (err != cudaSuccess) return err;
    attn32_fwd_kernel<T, DP, FULL><<<dim3((a.n + 63) / 64, a.heads, a.batch), THREADS, SMEM<DP>, a.stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v), static_cast<T*>(a.o),
        a.qs, a.ks, a.vs, a.os, a.n, a.d, a.scale, a.plus1, a.vec);
    return cudaSuccess;
}

}  // namespace

// Blocks of the instance that takes dtype code `dtype` at head dim d
// (`aligned`: every operand 16-byte aligned) an SM holds at once (the
// occupancy query), into *blocks. Returns a CUDA error code.
extern "C" int passt_attention_fwd_fp32_occupancy(int dtype, int d, int aligned, int* blocks) {
    return static_cast<int>(PASST_SIMT_DISPATCH(occupancy, dtype, d, aligned, blocks));
}

// q, k, v, o: dtype code `dtype` (0 fp32, 1 bf16, 2 fp16), element
// (b, t, h, c) at ptr[b * sb + t * sn + h * sh + c]; d a multiple of 8 up to
// 128 (else cudaErrorInvalidValue and nothing launched). Every operand
// 16-byte aligned with strides in multiples of 8 elements takes the 16-byte
// copies and stores. Returns cudaGetLastError() after the launch.
extern "C" int passt_attention_fwd_fp32(const void* q, const void* k, const void* v, void* o, int dtype,
                                        int batch, int n, int heads, int d,
                                        long long qsb, long long qsn, long long qsh,
                                        long long ksb, long long ksn, long long ksh,
                                        long long vsb, long long vsn, long long vsh,
                                        long long osb, long long osn, long long osh,
                                        float scale, int plus1, void* stream) {
    const Strides qs{qsb, qsn, qsh}, ks{ksb, ksn, ksh}, vs{vsb, vsn, vsh}, os{osb, osn, osh};
    const int vec = vectors_aligned(q, qs) && vectors_aligned(k, ks) && vectors_aligned(v, vs) &&
                    vectors_aligned(o, os);
    if (n <= 0 || batch <= 0 || heads <= 0 || batch > 65535 || heads > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    const Args a{q, k, v, o, batch, n, heads, d, qs, ks, vs, os, scale, plus1, vec, static_cast<cudaStream_t>(stream)};
    const cudaError_t err = PASST_SIMT_DISPATCH(launch, dtype, d, vec, a);
    if (err != cudaSuccess) return static_cast<int>(err);
    return passt_launch_status();
}
