// Shared by the port's kernel libraries: each one is its own shared object
// with a plain C interface, loaded with ctypes (passt_tpu_torch/ops/_build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

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

}  // namespace passt
