// Phase marks on the device timeline (passt_tpu_torch/tracing.py): one empty
// one-thread kernel per phase, whose name carries the phase. Launched on the
// caller's stream, a mark lies between the kernels of the phase it closes and
// those of the next; under CUDA-graph capture it becomes a node of the graph,
// so every replay runs it and a profiler trace shows it. The phase order is
// tracing.PHASES's.
#include "common.cuh"

#define PASST_TRACE_MARKS(X) X(ungraphed) X(frontend) X(forward) X(backward) X(collective) X(optimizer) X(writeback)

#define PASST_MARK_KERNEL(phase) extern "C" __global__ void trace_mark_##phase() {}
PASST_TRACE_MARKS(PASST_MARK_KERNEL)
#undef PASST_MARK_KERNEL

// Launch phase `phase`'s mark on `stream`. Returns cudaGetLastError() after
// the launch; an unknown phase returns cudaErrorInvalidValue.
extern "C" int passt_trace_mark(int phase, void* stream) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    int at = 0;
#define PASST_MARK_CASE(name)                      \
    if (phase == at++) {                           \
        trace_mark_##name<<<1, 1, 0, st>>>();      \
        return passt_launch_status();              \
    }
    PASST_TRACE_MARKS(PASST_MARK_CASE)
#undef PASST_MARK_CASE
    return static_cast<int>(cudaErrorInvalidValue);
}
