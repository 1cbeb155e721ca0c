// Log-mel spectrogram kernel for Hopper (sm_90a): framed wave -> windowed
// real DFT -> power -> mel bank -> log -> affine, for one (clip, tile of
// frames) per block.
//
// Replaces: passt_tpu/ops/pallas/mel_kernel.py:_mel_kernel (entry
// fused_log_mel). The port's wrapper is passt_tpu_torch/ops/mel_kernel.py.
//
// What bounds it: fp32 FMA throughput. The DFT is 2 * frames * n_fft *
// 2 * n_freq FLOP (about 2.1 GFLOP per 10-s clip at hop 320); the mel bank,
// the log and the bytes (a clip is 1.3 MB in, 0.5 MB out) are small beside
// it. Both products must stay in full fp32 (a single-pass low-precision dot
// gave errors of ~1.2 on normalised log-mels), so the tensor cores (TF32 at
// best) are not used: every product is an fmaf.
//
// What the design does about it:
// - The framing is plain addressing. The wrapper applies pre-emphasis and
//   reflect padding, and offsets the wave by the window's first non-zero
//   sample; frame f then reads x[f * hop + r], r < k_len. The block stages
//   the whole sample span of its 64 frames in shared memory once, so every
//   sample is read from device memory once per block, for any hop (no
//   parity layout, no hop % 128 gate, no 128-frame blocks).
// - The Hann window is zero outside its win_length samples, so the basis is
//   passed with only those rows (800 of 1024 at n_fft 1024): the same sums
//   without the zero products.
// - The basis streams through shared memory in tiles of 16 rows x 128 bins
//   (re and im), double-buffered with cp.async so that the next tile is
//   copied while this one is computed; each thread keeps 8 frames x 4 bins of re and im in
//   registers (16 shared loads per 64 FMA; the 8 sample loads of a warp are
//   broadcasts). The power of a 128-bin chunk goes to shared memory and is
//   folded into the 64 x n_mels mel accumulators at once, so the spectrum
//   never reaches device memory. The Nyquist bin is never computed.
#include "common.cuh"

#include <math.h>
#include <stdint.h>

namespace {

constexpr int TF = 64;        // frames per block
constexpr int FB = 128;       // frequency bins per chunk (re and im each)
constexpr int KT = 16;        // basis rows per shared-memory tile
constexpr int THREADS = 256;
constexpr int MJ = 16;        // mels per thread in the mel stage: m = mm + 8 j
constexpr int MAX_MELS = 8 * MJ;

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most `pending` committed groups are still in flight.
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(pending));
}

// Start copying basis rows k0 .. k0 + KT - 1, bins c0 .. c0 + FB - 1 (re,
// then im) into a [KT][2 * FB] tile with 16-byte cp.async; rows past k_len
// are zero-filled.
__device__ __forceinline__ void load_basis_tile(float* dst, const float* __restrict__ basis, int c0,
                                                int k0, int k_len, int n_freq) {
    constexpr int C = 2 * FB / 4;  // 16-byte chunks per tile row
    for (int i = threadIdx.x; i < KT * C; i += THREADS) {
        const int r = i / C;
        const int c = i - r * C;
        const int col = c < C / 2 ? c0 + 4 * c : n_freq + c0 + 4 * (c - C / 2);
        const bool valid = k0 + r < k_len;
        const float* from = valid ? basis + (long long)(k0 + r) * 2 * n_freq + col : basis;
        const uint32_t to = static_cast<uint32_t>(__cvta_generic_to_shared(dst + r * 2 * FB + 4 * c));
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(to), "l"(from), "r"(valid ? 16 : 0));
    }
}

__global__ void __launch_bounds__(THREADS) log_mel_kernel(
    const float* __restrict__ x, long long x_stride, long long x_len,
    int frames, int hop,
    const float* __restrict__ basis, int k_len, int n_freq,
    const float* __restrict__ bank_t, int n_mels,
    float* __restrict__ out, int span, int span_alloc,
    float log_offset, float norm_shift, float norm_scale) {
    extern __shared__ float smem[];
    float* xs = smem;                  // [span_alloc] samples of the tile
    float* bt = xs + span_alloc;       // [2][KT][2 * FB] basis tiles: re | im
    float* pw = bt + 2 * KT * 2 * FB;  // [TF][FB + 1] power of one chunk

    const int tid = threadIdx.x;
    const int b = blockIdx.y;
    const int f0 = blockIdx.x * TF;
    const float* xb = x + (long long)b * x_stride;
    const long long start = (long long)f0 * hop;

    // Past the span (and past the wave) the samples are zero: the last
    // basis tile may run past k_len, where its rows are zero too.
    for (int i = tid; i < span_alloc; i += THREADS) {
        const long long idx = start + i;
        xs[i] = (i < span && idx < x_len) ? xb[idx] : 0.f;
    }

    // DFT: bins tb + 32 j, frames tf + 8 i; a warp shares its frames, so the
    // sample loads are broadcasts
    const int tb = tid & 31, tf = tid >> 5;
    const int mf = tid & 31, mm = tid >> 5;  // mel: frames mf + 32 i, mels mm + 8 j

    float macc[2][MJ];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < MJ; ++j) macc[i][j] = 0.f;

    // One sequence of basis tiles over (chunk, k-tile); tile t + 1 is copied
    // while tile t is computed.
    const int k_tiles = (k_len + KT - 1) / KT;
    const int total = (n_freq / FB) * k_tiles;
    load_basis_tile(bt, basis, 0, 0, k_len, n_freq);
    cp_async_commit();
    float re[8][4], im[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) re[i][j] = im[i][j] = 0.f;

    for (int t = 0; t < total; ++t) {
        const int c0 = (t / k_tiles) * FB;
        const int k0 = (t % k_tiles) * KT;
        if (t + 1 < total)
            load_basis_tile(bt + ((t + 1) & 1) * KT * 2 * FB, basis, ((t + 1) / k_tiles) * FB,
                            ((t + 1) % k_tiles) * KT, k_len, n_freq);
        cp_async_commit();
        cp_async_wait<1>();
        __syncthreads();
        const float* tile = bt + (t & 1) * KT * 2 * FB;
#pragma unroll
        for (int r = 0; r < KT; ++r) {
            float xa[8], br[4], bi[4];
#pragma unroll
            for (int i = 0; i < 8; ++i) xa[i] = xs[(tf + 8 * i) * hop + k0 + r];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                br[j] = tile[r * 2 * FB + tb + 32 * j];
                bi[j] = tile[r * 2 * FB + FB + tb + 32 * j];
            }
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    re[i][j] = fmaf(xa[i], br[j], re[i][j]);
                    im[i][j] = fmaf(xa[i], bi[j], im[i][j]);
                }
        }

        if (k0 + KT >= k_len) {  // the chunk's spectrum is complete: fold it into the mels
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    pw[(tf + 8 * i) * (FB + 1) + tb + 32 * j] =
                        __fadd_rn(__fmul_rn(re[i][j], re[i][j]), __fmul_rn(im[i][j], im[i][j]));
                    re[i][j] = im[i][j] = 0.f;
                }
            __syncthreads();
            for (int bb = 0; bb < FB; ++bb) {
                const float p0 = pw[mf * (FB + 1) + bb];
                const float p1 = pw[(mf + 32) * (FB + 1) + bb];
                const float* w = bank_t + (long long)(c0 + bb) * n_mels;
#pragma unroll
                for (int j = 0; j < MJ; ++j) {
                    const int m = mm + 8 * j;
                    const float wv = m < n_mels ? __ldg(w + m) : 0.f;
                    macc[0][j] = fmaf(p0, wv, macc[0][j]);
                    macc[1][j] = fmaf(p1, wv, macc[1][j]);
                }
            }
        }
        __syncthreads();  // tile buffer t & 1 (and pw) are reused from here on
    }
    cp_async_wait<0>();

#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int f = f0 + mf + 32 * i;
        if (f >= frames) continue;
#pragma unroll
        for (int j = 0; j < MJ; ++j) {
            const int m = mm + 8 * j;
            if (m < n_mels)
                out[((long long)b * n_mels + m) * frames + f] =
                    (logf(macc[i][j] + log_offset) + norm_shift) / norm_scale;
        }
    }
}

}  // namespace

// x: [batch, x_stride] fp32, already pre-emphasised, reflect-padded and
// offset by the window's first non-zero sample (x_len samples remain in a
// row). basis: [k_len, 2 * n_freq] fp32, re columns then im columns, bins
// 0 .. n_freq - 1. bank_t: [n_freq, n_mels] fp32. out: [batch, n_mels,
// frames] fp32. Returns cudaGetLastError() after the launch.
extern "C" int passt_log_mel(const void* x, long long x_stride, long long x_len,
                             int batch, int frames, int hop,
                             const void* basis, int k_len, int n_freq,
                             const void* bank_t, int n_mels, void* out,
                             float log_offset, float norm_shift, float norm_scale,
                             void* stream) {
    if (n_freq % FB != 0 || n_mels > MAX_MELS || frames <= 0 || batch <= 0)
        return static_cast<int>(cudaErrorInvalidValue);
    const int span = (TF - 1) * hop + k_len;
    const int span_alloc = (span + KT + 3) & ~3;
    const size_t smem = sizeof(float) * (size_t)(span_alloc + 2 * KT * 2 * FB + TF * (FB + 1));
    cudaError_t err = cudaFuncSetAttribute(
        log_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((frames + TF - 1) / TF, batch);
    log_mel_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), x_stride, x_len, frames, hop,
        static_cast<const float*>(basis), k_len, n_freq,
        static_cast<const float*>(bank_t), n_mels,
        static_cast<float*>(out), span, span_alloc,
        log_offset, norm_shift, norm_scale);
    return passt_launch_status();
}

