// Shared by the port's kernel libraries: each one is its own shared object
// with a plain C interface, loaded with ctypes (passt_tpu_torch/ops/_build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// The wrapper turns a non-zero return code of an entry point into a message.
extern "C" const char* passt_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Entry points return cudaGetLastError() right after the launch: a launch
// refused for its configuration never runs and no later synchronize reports
// it.
static inline int passt_launch_status() {
    return static_cast<int>(cudaGetLastError());
}

namespace passt {

// Two neighbouring elements (an even column) as floats, and back.
__device__ __forceinline__ float2 load2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const __half* p) {
    return __half22float2(*reinterpret_cast<const __half2*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
    *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// ldmatrix of four 8x8 b16 matrices; lanes 8q .. 8q + 7 give matrix q's rows.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
    const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

// Start a cp.async of 16 bytes; src_bytes 0 zero-fills.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes = 16) {
    const uint32_t to = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" :: "r"(to), "l"(src), "r"(src_bytes));
}

// The reference's tanh-GELU value h and saved derivative d of z, in its
// evaluation order (passt_tpu/ops/activations.py _fwd), with fp32 constants
// and no contraction: t = tanh(C (z + A z z z)), h = 0.5 z (1 + t),
// d = 0.5 (1 + t) + 0.5 z (1 - t t) C (1 + 3A z z).
__device__ __forceinline__ void gelu(float z, float& h, float& d) {
    constexpr float C = static_cast<float>(0.7978845608028654);  // sqrt(2 / pi)
    constexpr float A = 0.044715f;
    constexpr float A3 = static_cast<float>(3.0 * 0.044715);
    const float t = tanhf(__fmul_rn(C, __fadd_rn(z, __fmul_rn(__fmul_rn(__fmul_rn(A, z), z), z))));
    const float one_t = __fadd_rn(1.f, t);
    h = __fmul_rn(__fmul_rn(0.5f, z), one_t);
    const float tail = __fmul_rn(__fmul_rn(__fmul_rn(__fmul_rn(0.5f, z), __fsub_rn(1.f, __fmul_rn(t, t))), C),
                                 __fadd_rn(1.f, __fmul_rn(__fmul_rn(A3, z), z)));
    d = __fadd_rn(__fmul_rn(0.5f, one_t), tail);
}

}  // namespace passt
