// Shared by the port's kernel libraries: each one is its own shared object
// with a plain C interface, loaded with ctypes (passt_tpu_torch/ops/_build.py).
#pragma once

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
