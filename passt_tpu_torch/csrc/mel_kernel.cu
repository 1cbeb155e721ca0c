// Log-mel spectrogram kernel for Hopper (sm_90a): raw wave -> pre-emphasis
// -> reflect padding -> Hann window -> one real FFT per frame -> power ->
// the mel bank's non-zero span per mel -> log -> affine.
//
// Replaces: passt_tpu/ops/pallas/mel_kernel.py:_mel_kernel (entry
// fused_log_mel). The port's wrapper is passt_tpu_torch/ops/mel_kernel.py.
//
// What bounds it: bytes. At B = 20 x 10 s, hop 320, the wave (25.6 MB), the
// bank (0.26 MB) and the mels (10.2 MB) take 0.0108 ms at 3.35 TB/s; a real
// FFT of n_fft = 1024 points is ~25.6 kFLOP a frame (0.51 GFLOP for the
// call, 0.0092 ms at the fp32 FMA peak), and the default bank has 947
// non-zero taps of 65 536. The products stay in full fp32 on the FMA units
// (the contract: full fp32 for the DFT and mel products; no TF32).
//
// What the design does about it:
// - A prologue kernel (one block) finds each mel row's non-zero span and
//   compacts the bank's taps on the card: the bank is rebuilt on the card
//   from the jittered fmin / fmax each training step, so there is no host
//   sync. The main kernel is launched behind it with programmatic
//   dependent launch and waits for it (griddepcontrol.wait) only after
//   starting its own copies.
// - A block owns 16 frames of one clip (8 where its shared memory would
//   not fit). It copies the raw samples its frames reach by cp.async, all
//   in flight at once; the first FFT pass forms the pre-emphasis
//   y[t] = x[t+1] - 0.97 x[t] (a rounded multiply, then a rounded subtract,
//   as ops/stft.py preemphasis) at torch's reflect index (n_fft / 2 on both
//   sides) as it reads them. The wave is read once, and nothing but the
//   output reaches device memory.
// - Each warp transforms one frame at a time: the windowed frame packed as
//   n_fft / 2 complex points z[n] = x[2n] + i x[2n+1], a Stockham FFT of
//   n_fft / 2 points in radix-8 passes (a first radix-2 or radix-4 pass
//   where log2(n_fft / 2) is not a multiple of 3) through a padded
//   shared-memory buffer of its own, then the real-to-complex post-step by
//   pairs of bins (k and n_fft / 2 - k from the same loads) and the power.
//   The twiddles and the window come from a table computed in float64 and
//   rounded to fp32 (ops/mel_kernel.py fft_tables), each pass's twiddles
//   laid out so that neighbouring lanes read neighbouring entries.
// - The mel stage sums bank[m, k] |X_k|^2 over k in [lo_m, hi_m) only, the
//   taps from shared memory (the first 2048; any more from device memory),
//   in two sums over the span's even and odd places. Any bank works: an
//   all-zero row gives log(log_offset), a full row sums every bin.
// - The mels go to a [n_mels][16 + 1] tile in shared memory, with the log
//   and the affine applied, and leave as rows of consecutive frames.
#include "common.cuh"

#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr float PREEMPHASIS = 0.97f;
constexpr float SQRT_HALF = 0.70710678118654752f;  // rounded to fp32
constexpr int MIN_LOG2_NFFT = 6, MAX_LOG2_NFFT = 11;
constexpr int SPAN_THREADS = 1024;  // the prologue's one block
constexpr int MAX_TAPS = 2048;      // the bank's non-zero taps kept in shared memory (the default bank has 947)

// cp.async of 4 or 16 bytes into shared memory; wait for all of the
// thread's copies.
__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
    const uint32_t to = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    if (bytes == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(to), "l"(src) : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(to), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// The pre-emphasised sample y[i] = x[i+1] - 0.97 x[i] (a rounded multiply,
// then a rounded subtract) at torch's reflect index of i (n_fft / 2 on both
// sides of the len = T - 1 samples), from the raw samples x[lo ..] in xr.
__device__ __forceinline__ float preemph_at(const float* xr, int i, int len, int lo) {
    int idx = i < 0 ? -i : i;
    idx = idx >= len ? 2 * (len - 1) - idx : idx;
    return __fsub_rn(xr[idx + 1 - lo], __fmul_rn(PREEMPHASIS, xr[idx - lo]));
}

// A warp buffer's float2 index: one spare slot every 8, against bank
// conflicts in the strided passes.
__device__ __forceinline__ int pad2(int i) { return i + (i >> 3); }

__device__ __forceinline__ float2 cadd(float2 a, float2 b) { return make_float2(a.x + b.x, a.y + b.y); }
__device__ __forceinline__ float2 csub(float2 a, float2 b) { return make_float2(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
    return make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}
__device__ __forceinline__ float2 mul_minus_i(float2 a) { return make_float2(a.y, -a.x); }

// In-place DFT of R points, X_k = sum_n v_n e^{-2 pi i n k / R}.
template <int R> __device__ __forceinline__ void dft(float2 (&v)[R]);
template <> __device__ __forceinline__ void dft<2>(float2 (&v)[2]) {
    const float2 a = v[0];
    v[0] = cadd(a, v[1]);
    v[1] = csub(a, v[1]);
}
template <> __device__ __forceinline__ void dft<4>(float2 (&v)[4]) {
    const float2 t0 = cadd(v[0], v[2]), t1 = csub(v[0], v[2]);
    const float2 t2 = cadd(v[1], v[3]), t3 = mul_minus_i(csub(v[1], v[3]));
    v[0] = cadd(t0, t2);
    v[2] = csub(t0, t2);
    v[1] = cadd(t1, t3);
    v[3] = csub(t1, t3);
}
template <> __device__ __forceinline__ void dft<8>(float2 (&v)[8]) {
    float2 e[4] = {v[0], v[2], v[4], v[6]}, o[4] = {v[1], v[3], v[5], v[7]};
    dft<4>(e);
    dft<4>(o);
    o[1] = make_float2((o[1].x + o[1].y) * SQRT_HALF, (o[1].y - o[1].x) * SQRT_HALF);  // W8
    o[2] = mul_minus_i(o[2]);                                                           // W8^2
    o[3] = make_float2((o[3].y - o[3].x) * SQRT_HALF, -(o[3].x + o[3].y) * SQRT_HALF);  // W8^3
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        v[k] = cadd(e[k], o[k]);
        v[k + 4] = csub(e[k], o[k]);
    }
}

// Where a Stockham pass of radix R writes output r of butterfly j, after
// sub-transforms of length ns.
__device__ __forceinline__ int stockham_out(int j, int ns, int R, int r) {
    return (j & ~(ns - 1)) * R + (j & (ns - 1)) + r * ns;
}

// One radix-R pass of the M-point Stockham FFT held in buf (ns > 1): read
// every butterfly of the lane, twiddle, transform, then write. ptw is the
// pass's twiddle table, ptw[(r - 1) ns + k] = e^{-2 pi i k r / (ns R)}, so
// that neighbouring lanes read neighbouring entries.
template <int M, int R>
__device__ __forceinline__ void fft_pass(float2* buf, const float2* ptw, int ns, int lane) {
    constexpr int BF = M / R, PER = (BF + 31) / 32;
    float2 v[PER][R];
#pragma unroll
    for (int q = 0; q < PER; ++q) {
        const int j = lane + 32 * q;
        if (j < BF) {
            const int k = j & (ns - 1);
#pragma unroll
            for (int r = 0; r < R; ++r) v[q][r] = buf[pad2(j + r * BF)];
#pragma unroll
            for (int r = 1; r < R; ++r) v[q][r] = cmul(v[q][r], ptw[(r - 1) * ns + k]);
            dft<R>(v[q]);
        }
    }
    __syncwarp();
#pragma unroll
    for (int q = 0; q < PER; ++q) {
        const int j = lane + 32 * q;
        if (j < BF) {
#pragma unroll
            for (int r = 0; r < R; ++r) buf[pad2(stockham_out(j, ns, R, r))] = v[q][r];
        }
    }
    __syncwarp();
}

// The first pass (ns = 1, no twiddles), reading the packed, windowed frame
// straight from the raw samples: z[n] = w[2n] y[2n] + i w[2n+1] y[2n+1],
// y[n] = preemph_at(ybase + n) for n in the window's span [left, left +
// win), 0 outside it (win holds the span's values).
template <int M, int R>
__device__ __forceinline__ void fft_first_pass(float2* buf, const float* xr, const float* win, int left,
                                               int win_length, int ybase, int len, int lo, int lane) {
    constexpr int BF = M / R, PER = (BF + 31) / 32;
    float2 v[PER][R];
#pragma unroll
    for (int q = 0; q < PER; ++q) {
        const int j = lane + 32 * q;
        if (j < BF) {
#pragma unroll
            for (int r = 0; r < R; ++r) {
                // the even sample n: its place u in the window's span, its y index i
                const int n = 2 * (j + r * BF), u = n - left, i = ybase + n;
                float a, b;
                if (u >= 0 && u + 1 < win_length && i >= 0 && i + 1 < len) {
                    // no reflection: y[i] and y[i+1] from x[i], x[i+1], x[i+2]
                    const float x0 = xr[i - lo], x1 = xr[i + 1 - lo], x2 = xr[i + 2 - lo];
                    a = win[u] * __fsub_rn(x1, __fmul_rn(PREEMPHASIS, x0));
                    b = win[u + 1] * __fsub_rn(x2, __fmul_rn(PREEMPHASIS, x1));
                } else {
                    a = (u >= 0 && u < win_length) ? win[u] * preemph_at(xr, i, len, lo) : 0.f;
                    b = (u + 1 >= 0 && u + 1 < win_length) ? win[u + 1] * preemph_at(xr, i + 1, len, lo) : 0.f;
                }
                v[q][r] = make_float2(a, b);
            }
            dft<R>(v[q]);
        }
    }
#pragma unroll
    for (int q = 0; q < PER; ++q) {
        const int j = lane + 32 * q;
        if (j < BF) {
#pragma unroll
            for (int r = 0; r < R; ++r) buf[pad2(j * R + r)] = v[q][r];
        }
    }
    __syncwarp();
}

__host__ __device__ constexpr int ilog2(int n) { return n <= 1 ? 0 : 1 + ilog2(n / 2); }

// The M-point FFT of one frame into buf (natural order): a radix-2 or -4
// pass first where log2(M) is not a multiple of 3, then radix 8.
template <int M>
__device__ __forceinline__ void frame_fft(float2* buf, const float2* ptw, const float* xr, const float* win, int left,
                                          int win_length, int ybase, int len, int lo, int lane) {
    constexpr int LOGM = ilog2(M);
    constexpr int R0 = LOGM % 3 == 0 ? 8 : (LOGM % 3 == 1 ? 2 : 4);
    fft_first_pass<M, R0>(buf, xr, win, left, win_length, ybase, len, lo, lane);
    int off = 0;  // the passes' tables follow one another
#pragma unroll
    for (int ns = R0; ns < M; ns *= 8) {
        fft_pass<M, 8>(buf, ptw + off, ns, lane);
        off += 7 * ns;
    }
}

// The prologue, one block: each mel row's non-zero span [lo, hi) (lo = hi
// = 0 for an all-zero row) and the offset of its taps in the compacted
// tap list (spans[m] = {lo, hi, offset, 0}; spans[n_mels].x = the list's
// length), then the list itself: taps[offset + k - lo] = bank[m, k].
__global__ void __launch_bounds__(SPAN_THREADS) mel_span_kernel(const float* __restrict__ bank, int n_mels,
                                                                int n_freq, int4* __restrict__ spans,
                                                                float* __restrict__ taps) {
    __shared__ int lo_s[256], hi_s[256], offset[257];
    // the main kernel may start now: it stages its samples and waits for
    // this grid (griddepcontrol.wait) before it reads the spans and taps
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int m = threadIdx.x; m < n_mels; m += SPAN_THREADS) {
        lo_s[m] = n_freq;
        hi_s[m] = 0;
    }
    __syncthreads();
    // every (row, bin) in parallel, four bins a load where the rows allow;
    // min and max do not depend on the order
    if (n_freq % 4 == 0 && reinterpret_cast<uintptr_t>(bank) % 16 == 0) {
        const int q = n_freq / 4, n = n_mels * q;
#pragma unroll 8
        for (int i = threadIdx.x; i < n; i += SPAN_THREADS) {
            const float4 v = __ldg(reinterpret_cast<const float4*>(bank) + i);
            const int m = i / q, k = 4 * (i - m * q);
            const int first = v.x != 0.f ? 0 : v.y != 0.f ? 1 : v.z != 0.f ? 2 : v.w != 0.f ? 3 : 4;
            const int last = v.w != 0.f ? 4 : v.z != 0.f ? 3 : v.y != 0.f ? 2 : v.x != 0.f ? 1 : 0;
            if (first < 4) {
                atomicMin(lo_s + m, k + first);
                atomicMax(hi_s + m, k + last);
            }
        }
    } else {
        const int n = n_mels * n_freq;
#pragma unroll 4
        for (int i = threadIdx.x; i < n; i += SPAN_THREADS) {
            if (bank[i] != 0.f) {
                const int m = i / n_freq, k = i - m * n_freq;
                atomicMin(lo_s + m, k);
                atomicMax(hi_s + m, k + 1);
            }
        }
    }
    __syncthreads();
    if (warp == 0) {  // the offsets: each lane sums 8 rows' widths, then a scan across the lanes
        int w[8], sum = 0;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int m = 8 * lane + i;
            w[i] = m < n_mels && hi_s[m] > 0 ? hi_s[m] - lo_s[m] : 0;
            sum += w[i];
        }
        int incl = sum;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const int v = __shfl_up_sync(0xffffffffu, incl, off);
            if (lane >= off) incl += v;
        }
        int run = incl - sum;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
            const int m = 8 * lane + i;
            if (m < n_mels) offset[m] = run;
            run += w[i];
        }
        if (lane == 31) offset[n_mels] = incl;
    }
    __syncthreads();
    for (int m = threadIdx.x; m <= n_mels; m += SPAN_THREADS) {
        const bool any = m < n_mels && hi_s[m] > 0;
        spans[m] = m < n_mels ? make_int4(any ? lo_s[m] : 0, any ? hi_s[m] : 0, offset[m], 0)
                              : make_int4(offset[m], 0, 0, 0);
    }
    // one tap a thread: its row by a binary search of the offsets
    for (int t = threadIdx.x; t < offset[n_mels]; t += SPAN_THREADS) {
        int a = 0, z = n_mels - 1;  // the last row whose offset is <= t (and has taps)
        while (a < z) {
            const int mid = (a + z + 1) >> 1;
            if (offset[mid] <= t) a = mid;
            else z = mid - 1;
        }
        taps[t] = bank[(long long)a * n_freq + lo_s[a] + t - offset[a]];
    }
}

// Shared memory of a block, in bytes, and the offsets of its parts.
struct Layout {
    int tw, bufs, spans, taps, win, tile, xs, total;
};

__host__ __device__ inline int buf_len(int m) { return m + m / 8 + 8; }  // float2s a warp buffer holds

__host__ __device__ inline Layout layout(int n_fft, int n_mels, int tf, int span) {
    Layout l;
    l.tw = 0;                          // the post-step's twiddles (n_fft / 2 + 2), then the passes' (n_fft / 2)
    l.bufs = l.tw + 8 * (n_fft + 2);
    l.spans = l.bufs + 8 * WARPS * buf_len(n_fft / 2);
    l.taps = l.spans + 16 * n_mels;
    l.win = l.taps + 4 * MAX_TAPS;
    l.tile = l.win + 4 * n_fft;
    l.xs = l.tile + 4 * n_mels * (tf + 1);
    l.total = l.xs + 4 * span;
    return l;
}

template <int N>
__global__ void __launch_bounds__(THREADS, 2) log_mel_fft_kernel(
    const float* __restrict__ x, long long x_stride, long long t_len, int frames, int hop, int win_length,
    const float* __restrict__ tables, const float* __restrict__ taps_g, const int4* __restrict__ spans_g,
    int n_mels, int n_freq, float* __restrict__ out, int log2_tf, int span, int raw_alloc, float log_offset,
    float norm_shift, float norm_scale) {
    constexpr int M = N / 2;
    extern __shared__ __align__(16) unsigned char smem[];
    const int tf = 1 << log2_tf;
    const Layout l = layout(N, n_mels, tf, raw_alloc);
    float2* tw = reinterpret_cast<float2*>(smem + l.tw);  // [M + 2] e^{-2 pi i k / N}
    float2* ptw = tw + M + 2;                             // [M] the passes' twiddles
    float2* bufs = reinterpret_cast<float2*>(smem + l.bufs);
    int4* spans = reinterpret_cast<int4*>(smem + l.spans);  // [n_mels] {lo, hi, tap offset, 0}
    float* taps = reinterpret_cast<float*>(smem + l.taps);   // the first MAX_TAPS taps
    float* win = reinterpret_cast<float*>(smem + l.win);  // [win_length] the window's non-zero span
    float* tile = reinterpret_cast<float*>(smem + l.tile);  // [n_mels][tf + 1]
    float* xs = reinterpret_cast<float*>(smem + l.xs);      // [raw_alloc] raw samples x[lo, hi)

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int b = blockIdx.y, f0 = blockIdx.x * tf;
    const int left = (N - win_length) / 2, pad = N / 2;
    const long long len = t_len - 1;  // pre-emphasised samples

    // the tables, and the raw samples x[lo, hi) the block's frames reach
    // through the pre-emphasis and the reflect index, by cp.async
    for (int i = tid; i < M / 2 + 1; i += THREADS) cp_async(tw + 2 * i, tables + 4 * i, 16);
    for (int i = tid; i < M / 2; i += THREADS) cp_async(ptw + 2 * i, tables + 2 * N + 4 * i, 16);
    for (int i = tid; i < win_length; i += THREADS) cp_async(win + i, tables + 3 * N + left + i, 4);
    const long long a = (long long)f0 * hop + left - pad;  // y index of the block's first sample
    const long long e = min(a + span, len + pad);
    const long long lo = max(0LL, min(a, 2 * (len - 1) - (e - 1)));
    const long long hi = min(len, max(e, 1 - a)) + 1;
    if (hi - lo > raw_alloc) __trap();  // the host sizes raw_alloc for every block
    const float* xb = x + (long long)b * x_stride + lo;
#pragma unroll 4
    for (int i = tid; i < hi - lo; i += THREADS) cp_async(xs + i, xb + i, 4);
    asm volatile("griddepcontrol.wait;\n" ::: "memory");  // the prologue's spans and taps are complete
    for (int i = tid; i < n_mels; i += THREADS) cp_async(spans + i, spans_g + i, 16);
    const int n_taps = min(spans_g[n_mels].x, MAX_TAPS);
    for (int i = tid; i < n_taps; i += THREADS) cp_async(taps + i, taps_g + i, 4);
    cp_async_wait_all();
    __syncthreads();

    float2* buf = bufs + warp * buf_len(M);
    const float* pw = reinterpret_cast<const float*>(buf);  // the frame's power, after the post-step
    constexpr int PK = (M / 2 + 1 + 31) / 32;               // bin pairs (k, M - k) a lane holds at most
    for (int fl = warp; fl < tf && f0 + fl < frames; fl += WARPS) {
        frame_fft<M>(buf, ptw, xs, win, left, win_length, (f0 + fl) * hop - pad, static_cast<int>(len),
                     static_cast<int>(lo), lane);
        // X_k = E_k + W^k O_k, E_k = (Z_k + conj Z_{M-k}) / 2,
        // O_k = (Z_k - conj Z_{M-k}) / 2i, indices mod M; and from the same
        // loads X_{M-k} = conj(E_k - W^k O_k), since E_{M-k} = conj E_k,
        // O_{M-k} = conj O_k and W^{M-k} = -conj W^k
        float p[PK][2];
#pragma unroll
        for (int i = 0; i < PK; ++i) {
            const int k = lane + 32 * i;
            p[i][0] = p[i][1] = 0.f;
            if (k <= M / 2) {
                const float2 z = buf[pad2(k)], y = buf[pad2((M - k) & (M - 1))];
                const float er = 0.5f * (z.x + y.x), ei = 0.5f * (z.y - y.y);
                const float orr = 0.5f * (z.y + y.y), oi = 0.5f * (y.x - z.x);
                const float2 w = tw[k];
                const float tr = w.x * orr - w.y * oi, ti = w.x * oi + w.y * orr;
                p[i][0] = (er + tr) * (er + tr) + (ei + ti) * (ei + ti);
                p[i][1] = (er - tr) * (er - tr) + (ei - ti) * (ei - ti);
            }
        }
        __syncwarp();
        float* pwr = reinterpret_cast<float*>(buf);
#pragma unroll
        for (int i = 0; i < PK; ++i) {
            const int k = lane + 32 * i;
            if (k <= M / 2) {
                if (k < n_freq) pwr[k] = p[i][0];
                if (M - k < n_freq && M - k != k) pwr[M - k] = p[i][1];
            }
        }
        __syncwarp();
        for (int m = lane; m < n_mels; m += 32) {
            const int4 sp = spans[m];
            const int t0 = sp.z - sp.x;  // tap t0 + k is bank[m, k]
            // two sums, over the span's even and odd places, then added
            float a0 = 0.f, a1 = 0.f;
            int k = sp.x;
            for (; k + 1 < sp.y; k += 2) {
                a0 = fmaf(t0 + k < MAX_TAPS ? taps[t0 + k] : __ldg(taps_g + t0 + k), pw[k], a0);
                a1 = fmaf(t0 + k + 1 < MAX_TAPS ? taps[t0 + k + 1] : __ldg(taps_g + t0 + k + 1), pw[k + 1], a1);
            }
            if (k < sp.y) a0 = fmaf(t0 + k < MAX_TAPS ? taps[t0 + k] : __ldg(taps_g + t0 + k), pw[k], a0);
            const float acc = a0 + a1;
            tile[m * (tf + 1) + fl] = (logf(acc + log_offset) + norm_shift) / norm_scale;
        }
        __syncwarp();  // the buffer is the next frame's
    }
    __syncthreads();

    for (int i = tid; i < n_mels * tf; i += THREADS) {
        const int m = i >> log2_tf, fl = i & (tf - 1);
        if (f0 + fl < frames) out[((long long)b * n_mels + m) * frames + f0 + fl] = tile[m * (tf + 1) + fl];
    }
}

}  // namespace

// x: [batch, x_stride] fp32, the raw wave, t_len samples a row. tables:
// fp32 [4 n_fft]: e^{-2 pi i u / n_fft} for u < n_fft as (cos, -sin) pairs;
// the Stockham passes' tables, n_fft / 2 pairs (ops/mel_kernel.py
// fft_tables); the Hann window zero-padded into the n_fft frame. bank: [n_mels, n_freq]
// fp32. spans: [n_mels + 1] int4 and taps: [n_mels n_freq] fp32, scratch
// the prologue fills. out: [batch, n_mels, frames] fp32 with frames =
// 1 + (t_len - 1) / hop. n_fft a power of two from 64 to 2048; n_freq <=
// n_fft / 2 + 1; n_mels <= 256; t_len - 1 > n_fft / 2 (the reflect pad).
// Launches the prologue and the main kernel; returns cudaGetLastError()
// after them, cudaErrorInvalidValue for a call it cannot take (nothing
// launched).
extern "C" int passt_log_mel(const void* x, long long x_stride, long long t_len, int batch, int frames, int n_fft,
                             int hop, int win_length, const void* tables, const void* bank, int n_mels,
                             int n_freq, void* spans, void* taps, void* out, float log_offset, float norm_shift,
                             float norm_scale, void* stream) {
    int log2n = 0;
    while ((1 << log2n) < n_fft) ++log2n;
    if ((1 << log2n) != n_fft || log2n < MIN_LOG2_NFFT || log2n > MAX_LOG2_NFFT || hop <= 0 ||
        win_length <= 0 || win_length > n_fft || n_freq <= 0 || n_freq > n_fft / 2 + 1 || n_mels <= 0 || n_mels > 256 ||
        batch <= 0 || t_len - 1 <= n_fft / 2 || frames != 1 + (t_len - 1) / hop)
        return static_cast<int>(cudaErrorInvalidValue);
    // 16 frames a block, or 8 where the shared memory would not fit
    int log2_tf = 4, span = 0, raw_alloc = 0;
    Layout l;
    for (;; --log2_tf) {
        span = ((1 << log2_tf) - 1) * hop + win_length;
        // the raw samples a block reads: its span and one more, or at a
        // clip's ends the reflected part (at most n_fft / 2) and all of a
        // short clip (less than one block's frames: tf hop samples)
        raw_alloc = span + hop + n_fft / 2 + 8;
        l = layout(n_fft, n_mels, 1 << log2_tf, raw_alloc);
        if (l.total <= 227 * 1024) break;
        if (log2_tf == 3) return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    mel_span_kernel<<<1, SPAN_THREADS, 0, st>>>(static_cast<const float*>(bank), n_mels, n_freq,
                                               static_cast<int4*>(spans), static_cast<float*>(taps));
    int err = passt_launch_status();
    if (err) return err;
    const dim3 grid((frames + (1 << log2_tf) - 1) >> log2_tf, batch);
    // the main kernel may launch while the prologue runs (programmatic
    // dependent launch); it waits for the prologue before it reads the spans
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = l.total;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
#define PASST_MEL_CASE(LOG2N)                                                                              \
    case LOG2N: {                                                                                          \
        auto kernel = log_mel_fft_kernel<1 << LOG2N>;                                                      \
        const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, l.total); \
        if (e != cudaSuccess) return static_cast<int>(e);                                                  \
        const cudaError_t e2 = cudaLaunchKernelEx(                                                         \
            &cfg, kernel, static_cast<const float*>(x), x_stride, t_len, frames, hop, win_length,          \
            static_cast<const float*>(tables), static_cast<const float*>(taps),                            \
            static_cast<const int4*>(spans), n_mels, n_freq, static_cast<float*>(out), log2_tf, span,      \
            raw_alloc, log_offset, norm_shift, norm_scale);                                                \
        if (e2 != cudaSuccess) return static_cast<int>(e2);                                                \
        return passt_launch_status();                                                                      \
    }
    switch (log2n) {
        PASST_MEL_CASE(6)
        PASST_MEL_CASE(7)
        PASST_MEL_CASE(8)
        PASST_MEL_CASE(9)
        PASST_MEL_CASE(10)
        PASST_MEL_CASE(11)
    }
#undef PASST_MEL_CASE
    return static_cast<int>(cudaErrorInvalidValue);
}
