// The train step's optimizer phase in one pass: AdamW with a bf16 first
// moment, a stochastically rounded (SR) bf16 second moment, and the SR apply
// of the update to bf16 parameters (fp32 parameters take the fp32 sum), over
// every leaf (passt_tpu_torch/train/optim.py adamw_sr, whose plain version
// holds the same arithmetic in PyTorch).
//
// Replaces no TPU kernel: on the TPU, XLA fuses the JAX package's
// adamw_bf16sr and apply_updates_sr. The port's composition of _foreach ops
// moved ~28 GB a step at PaSST-S for ~1.2 GB of state (fp32 copies of every
// leaf, an int32 tensor of random bits per SR store, the rounding's passes).
// Bound: bytes. Each value is read once (g, mu, nu, p) and written once (mu,
// nu, p): 14 bytes a value with bf16 leaves, 0.36 ms for PaSST-S's 86 M
// values at 3.35 TB/s. The design does the least the bytes allow: one launch
// over a table of segments (a leaf, or one block of a stacked leaf) passed by
// value, eight values a thread read and written 16 bytes at a time where
// every pointer of the segment allows, and the random bits made in registers
// by a Philox4x32-10 counter (one call gives 16 bits for 8 values), so
// nothing but the state crosses device memory.
//
// Arithmetic: fp32 in the JAX package's adamw_bf16sr order, each product and
// sum rounded on its own (__fmul_rn / __fadd_rn: nothing is contracted into
// an FMA), IEEE division and square root:
//   m = b1 mu + (1 - b1) g,  v = b2 nu + ((1 - b2) g) g,
//   s = (m / c1) / (sqrt(v / c2) + eps) [+ wd p],  q = p + s (-lr);
// mu <- bf16(m) rounded to nearest, nu <- SR(v), p <- SR(q) (bf16) or q.
// SR adds a 16-bit value below the bf16 mantissa and truncates; NaN and inf
// are stored as bf16(x). Stream k's value for draw d is 16 bits of
// Philox4x32-10 under the key seed_k at the counter d / 8: lane d % 8, word
// lane / 2, its low half for an even lane. A segment's draws are consecutive
// from its own start, so a thread whose values start at a draw off a
// multiple of 8 takes two counters and shifts their 256 bits into place.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;                           // values a thread, one Philox call
constexpr int kPerBlock = kThreads * kPerThread;        // values a block
constexpr int kMaxSegs = 240;                           // segments a launch (the table is ~20 KB of parameters)

enum : uint32_t { kGradF32 = 1u, kParamF32 = 2u, kVector = 4u };

struct Seg {
    const void* g;
    const __nv_bfloat16* mu;
    const __nv_bfloat16* nu;
    const void* p;
    __nv_bfloat16* mu_out;
    __nv_bfloat16* nu_out;
    void* p_out;
    unsigned long long nu_draw;  // draw of the segment's first value in the nu stream
    unsigned long long p_draw;   // ... in the apply stream (bf16 parameters only)
    uint32_t n;                  // values
    uint32_t flags;              // kGradF32 | kParamF32 | kVector
};

struct Args {
    Seg seg[kMaxSegs];
    uint32_t first_block[kMaxSegs + 1];  // block index where each segment starts; the last: the grid
    int nseg;
    const float* lr_ptr;  // the scalars and seeds in device memory, or null: then the values below
    const float* c1_ptr;
    const float* c2_ptr;
    const long long* nu_seed_ptr;
    const long long* p_seed_ptr;
    float lr, c1, c2;
    unsigned long long nu_seed, p_seed;
    float b1, omb1, b2, omb2, eps, wd;  // fp32 constants, 1 - b1 and 1 - b2 rounded from double
};

__device__ __forceinline__ void mulhilo(uint32_t a, uint32_t b, uint32_t& hi, uint32_t& lo) {
    lo = a * b;
    hi = __umulhi(a, b);
}

// Philox4x32-10 (Salmon et al., SC'11) of the counter (c, 0) under the key seed.
__device__ __forceinline__ uint4 philox(unsigned long long seed, unsigned long long c) {
    uint32_t c0 = static_cast<uint32_t>(c), c1 = static_cast<uint32_t>(c >> 32), c2 = 0, c3 = 0;
    uint32_t k0 = static_cast<uint32_t>(seed), k1 = static_cast<uint32_t>(seed >> 32);
#pragma unroll
    for (int r = 0; r < 10; ++r) {
        uint32_t hi0, lo0, hi1, lo1;
        mulhilo(0xD2511F53u, c0, hi0, lo0);
        mulhilo(0xCD9E8D57u, c2, hi1, lo1);
        c0 = hi1 ^ c1 ^ k0;
        c1 = lo1;
        c2 = hi0 ^ c3 ^ k1;
        c3 = lo0;
        k0 += 0x9E3779B9u;
        k1 += 0xBB67AE85u;
    }
    return make_uint4(c0, c1, c2, c3);
}

// The 16-bit values of draws d .. d + 7 of a stream, two a word, lane j in
// word j / 2 (low half for even j).
__device__ __forceinline__ uint4 draws8(unsigned long long seed, unsigned long long d) {
    const uint4 a = philox(seed, d >> 3);
    const uint32_t sh = static_cast<uint32_t>(d & 7);
    if (sh == 0) return a;
    const uint4 b = philox(seed, (d >> 3) + 1);
    uint32_t w0 = a.x, w1 = a.y, w2 = a.z, w3 = a.w, w4 = b.x, w5 = b.y, w6 = b.z, w7 = b.w;
    if (sh & 4) { w0 = w2; w1 = w3; w2 = w4; w3 = w5; w4 = w6; w5 = w7; }  // 64 bits
    if (sh & 2) { w0 = w1; w1 = w2; w2 = w3; w3 = w4; w4 = w5; }           // 32 bits
    if (sh & 1) {                                                          // 16 bits
        w0 = __funnelshift_r(w0, w1, 16);
        w1 = __funnelshift_r(w1, w2, 16);
        w2 = __funnelshift_r(w2, w3, 16);
        w3 = __funnelshift_r(w3, w4, 16);
    }
    return make_uint4(w0, w1, w2, w3);
}

__device__ __forceinline__ uint32_t lane16(const uint4& r, int j) {
    const uint32_t w = (j >> 1) == 0 ? r.x : (j >> 1) == 1 ? r.y : (j >> 1) == 2 ? r.z : r.w;
    return (j & 1) ? (w >> 16) : (w & 0xFFFFu);
}

// fp32 -> bf16 by adding r below the bf16 mantissa and truncating.
__device__ __forceinline__ __nv_bfloat16 sr_bf16(float x, uint32_t r) {
    if (!isfinite(x)) return __float2bfloat16_rn(x);
    const uint32_t bits = (__float_as_uint(x) + r) & 0xFFFF0000u;
    return __ushort_as_bfloat16(static_cast<unsigned short>(bits >> 16));
}

__device__ __forceinline__ void load8(const __nv_bfloat16* src, float* out) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        out[2 * i] = f.x;
        out[2 * i + 1] = f.y;
    }
}

__device__ __forceinline__ void load8(const float* src, float* out) {
    const float4 a = reinterpret_cast<const float4*>(src)[0];
    const float4 b = reinterpret_cast<const float4*>(src)[1];
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}

__device__ __forceinline__ void store8(__nv_bfloat16* dst, const __nv_bfloat16* v) {
    uint4 raw;
    __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) h[i] = v[i];
    *reinterpret_cast<uint4*>(dst) = raw;
}

__device__ __forceinline__ void store8(float* dst, const float* v) {
    reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// Values e .. e + k - 1 (k <= 8) of a bf16 or fp32 array, as floats.
__device__ __forceinline__ void load_vals(const void* src, bool f32, bool vec, uint32_t e, int k, float* out) {
    if (vec) {
        if (f32) load8(static_cast<const float*>(src) + e, out);
        else load8(static_cast<const __nv_bfloat16*>(src) + e, out);
        return;
    }
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
        out[j] = 0.0f;
        if (j < k) out[j] = f32 ? static_cast<const float*>(src)[e + j]
                                : __bfloat162float(static_cast<const __nv_bfloat16*>(src)[e + j]);
    }
}

__device__ __forceinline__ void store_bf16(__nv_bfloat16* dst, bool vec, uint32_t e, int k, const __nv_bfloat16* v) {
    if (vec) {
        store8(dst + e, v);
        return;
    }
#pragma unroll
    for (int j = 0; j < kPerThread; ++j)
        if (j < k) dst[e + j] = v[j];
}

__global__ void __launch_bounds__(kThreads) adamw_sr_kernel(const __grid_constant__ Args a) {
    // the block's segment: the last whose first block is at or before it
    const uint32_t block = blockIdx.x;
    int lo = 0, hi = a.nseg - 1;
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (a.first_block[mid] <= block) lo = mid;
        else hi = mid - 1;
    }
    const Seg& s = a.seg[lo];
    const uint32_t e = ((block - a.first_block[lo]) * kThreads + threadIdx.x) * kPerThread;
    if (e >= s.n) return;
    const int k = min(kPerThread, static_cast<int>(s.n - e));
    const bool g32 = s.flags & kGradF32, p32 = s.flags & kParamF32;
    const bool vec = (s.flags & kVector) && k == kPerThread;

    const float lr = a.lr_ptr ? *a.lr_ptr : a.lr;
    const float c1 = a.c1_ptr ? *a.c1_ptr : a.c1;
    const float c2 = a.c2_ptr ? *a.c2_ptr : a.c2;
    const unsigned long long nu_seed = a.nu_seed_ptr ? static_cast<unsigned long long>(*a.nu_seed_ptr) : a.nu_seed;

    float g[kPerThread], mu[kPerThread], nu[kPerThread], p[kPerThread];
    load_vals(s.g, g32, vec, e, k, g);
    load_vals(s.mu, false, vec, e, k, mu);
    load_vals(s.nu, false, vec, e, k, nu);
    load_vals(s.p, p32, vec, e, k, p);

    const uint4 rn = draws8(nu_seed, s.nu_draw + e);
    uint4 rp = make_uint4(0, 0, 0, 0);
    if (!p32) {
        const unsigned long long p_seed = a.p_seed_ptr ? static_cast<unsigned long long>(*a.p_seed_ptr) : a.p_seed;
        rp = draws8(p_seed, s.p_draw + e);
    }

    const float neg_lr = -lr;
    __nv_bfloat16 mu_o[kPerThread], nu_o[kPerThread], p_o[kPerThread];
    float q[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
        const float m = __fadd_rn(__fmul_rn(mu[j], a.b1), __fmul_rn(g[j], a.omb1));
        const float v = __fadd_rn(__fmul_rn(nu[j], a.b2), __fmul_rn(__fmul_rn(g[j], a.omb2), g[j]));
        const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, c2)), a.eps);
        float st = __fdiv_rn(__fdiv_rn(m, c1), den);
        if (a.wd != 0.0f) st = __fadd_rn(st, __fmul_rn(p[j], a.wd));
        q[j] = __fadd_rn(p[j], __fmul_rn(st, neg_lr));
        mu_o[j] = __float2bfloat16_rn(m);
        nu_o[j] = sr_bf16(v, lane16(rn, j));
        p_o[j] = sr_bf16(q[j], lane16(rp, j));
    }
    store_bf16(s.mu_out, vec, e, k, mu_o);
    store_bf16(s.nu_out, vec, e, k, nu_o);
    if (!p32) {
        store_bf16(static_cast<__nv_bfloat16*>(s.p_out), vec, e, k, p_o);
    } else if (vec) {
        store8(static_cast<float*>(s.p_out) + e, q);
    } else {
#pragma unroll
        for (int j = 0; j < kPerThread; ++j)
            if (j < k) static_cast<float*>(s.p_out)[e + j] = q[j];
    }
}

}  // namespace

// The table's row of a segment: 10 words, pointers as integers.
enum { kRowG, kRowMu, kRowNu, kRowP, kRowMuOut, kRowNuOut, kRowPOut, kRowNuDraw, kRowPDraw, kRowNFlags, kRowWords };

// One pass over nseg segments, rows of `table` (kRowWords uint64 each: the
// seven pointers, the two streams' first draws, n | flags << 32), in
// launches of up to kMaxSegs segments. consts: b1, 1 - b1, b2, 1 - b2, eps,
// wd, lr, c1, c2 (the last three used where their pointer is null); seeds:
// the nu and apply streams' (used where their pointer is null). Returns
// cudaGetLastError() after the last launch; a segment table that is empty or
// holds an empty or oversized segment returns cudaErrorInvalidValue.
extern "C" int passt_adamw_sr(const unsigned long long* table, int nseg, const float* consts,
                              const unsigned long long* seeds, const void* lr_ptr, const void* c1_ptr,
                              const void* c2_ptr, const void* nu_seed_ptr, const void* p_seed_ptr, void* stream) {
    if (nseg <= 0) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    Args* a = new Args();
    a->lr_ptr = static_cast<const float*>(lr_ptr);
    a->c1_ptr = static_cast<const float*>(c1_ptr);
    a->c2_ptr = static_cast<const float*>(c2_ptr);
    a->nu_seed_ptr = static_cast<const long long*>(nu_seed_ptr);
    a->p_seed_ptr = static_cast<const long long*>(p_seed_ptr);
    a->b1 = consts[0]; a->omb1 = consts[1]; a->b2 = consts[2]; a->omb2 = consts[3];
    a->eps = consts[4]; a->wd = consts[5]; a->lr = consts[6]; a->c1 = consts[7]; a->c2 = consts[8];
    a->nu_seed = seeds[0];
    a->p_seed = seeds[1];
    int status = 0;
    for (int at = 0; at < nseg && status == 0; at += kMaxSegs) {
        const int n = min(kMaxSegs, nseg - at);
        uint32_t blocks = 0;
        for (int i = 0; i < n; ++i) {
            const unsigned long long* row = table + static_cast<size_t>(at + i) * kRowWords;
            Seg& s = a->seg[i];
            s.g = reinterpret_cast<const void*>(row[kRowG]);
            s.mu = reinterpret_cast<const __nv_bfloat16*>(row[kRowMu]);
            s.nu = reinterpret_cast<const __nv_bfloat16*>(row[kRowNu]);
            s.p = reinterpret_cast<const void*>(row[kRowP]);
            s.mu_out = reinterpret_cast<__nv_bfloat16*>(row[kRowMuOut]);
            s.nu_out = reinterpret_cast<__nv_bfloat16*>(row[kRowNuOut]);
            s.p_out = reinterpret_cast<void*>(row[kRowPOut]);
            s.nu_draw = row[kRowNuDraw];
            s.p_draw = row[kRowPDraw];
            s.n = static_cast<uint32_t>(row[kRowNFlags] & 0xFFFFFFFFull);
            s.flags = static_cast<uint32_t>(row[kRowNFlags] >> 32);
            if (s.n == 0 || s.n > 0x7FFFFFFFu) {
                delete a;
                return static_cast<int>(cudaErrorInvalidValue);
            }
            a->first_block[i] = blocks;
            blocks += (s.n + kPerBlock - 1) / kPerBlock;
        }
        a->first_block[n] = blocks;
        a->nseg = n;
        adamw_sr_kernel<<<blocks, kThreads, 0, st>>>(*a);
        status = passt_launch_status();
    }
    delete a;
    return status;
}
