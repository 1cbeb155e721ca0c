"""A clock64 timeline of one CTA of the bf16 fused-MLP kernel on the card:
where a 256-unit chunk's time goes.

    python3 -m passt_tpu_torch.tools.fused_mlp_timeline [M ...]

Builds a copy of ``csrc/fused_mlp.cu`` under ``build/fused_mlp_timeline/``
with ``EDITS`` applied (they stamp ``clock64`` into a device array at fixed
points of CTA 0: its producer thread's issues, consumer thread 0's stage
waits, and the events of each chunk), runs the forward (no residuals) and
the backward at each M (default 5688; C = 768, H = 3072, bf16, random
inputs from seed 0) and prints, per chunk, the microseconds of: the wait
for the buffer to be free, the epilogue, the copies' issue, the second
product over the CTA's own block, the next chunk's first product, the wait
for the other CTAs' copies, and the second product over their blocks; then
the sum of the stage waits. clock64 ticks become microseconds by the SM
clock the run itself measures (clock64 against %globaltimer from the
consumers' start to their stores). A stamp is one store. Raises without a
card.
"""

from __future__ import annotations

import ctypes
import shutil
import sys

import numpy as np
import torch

from passt_tpu_torch.ops import _build
from passt_tpu_torch.ops import fused_mlp as F
from passt_tpu_torch.tools.timing import gpu_line

TRACE_CTA = 0
# the stamps: producer issue of stage i at [i], consumer wait on stage i at
# [2048 + i] and its data at [4096 + i], chunk j's events at [6144 + 8 j + k],
# the consumer's start and end at [8000], [8001] (and in %globaltimer
# nanoseconds at [8002], [8003])
EDITS = [
    ("using T = __nv_bfloat16;\n",
     "using T = __nv_bfloat16;\n__device__ long long g_trace[8192];\n"
     "#define TRC(i) if (blockIdx.x == TRACE_CTA && threadIdx.x == 0) g_trace[i] = clock64();\n"
     "#define TRP(i) if (blockIdx.x == TRACE_CTA) g_trace[i] = clock64();\n"),
    ("                if (it >= Tl::STAGES) H::mbar_wait_or_trap(empty + s, (it / Tl::STAGES - 1) & 1);\n",
     "                if (it >= Tl::STAGES) H::mbar_wait_or_trap(empty + s, (it / Tl::STAGES - 1) & 1);\n"
     "                TRP(it)\n"),
    ("H::mbar_wait_or_trap(full + s, (it / Tl::STAGES) & 1);",
     "TRC(2048 + it) H::mbar_wait_or_trap(full + s, (it / Tl::STAGES) & 1); TRC(4096 + it)"),
    ("            if (j > 0) H::mbar_wait_or_trap(hfree + wg, (j - 1) & 1);\n",
     "            TRC(6144 + 8 * j)\n            if (j > 0) H::mbar_wait_or_trap(hfree + wg, (j - 1) & 1);\n"
     "            TRC(6144 + 8 * j + 1)\n"),
    ("            if (BWD && lane == 0) H::mbar_arrive(dempty);  // this warp is done with the d block\n",
     "            TRC(6144 + 8 * j + 2)\n"
     "            if (BWD && lane == 0) H::mbar_arrive(dempty);  // this warp is done with the d block\n"),
    ("        for (int seg = 0; seg < 3; ++seg) {\n",
     "        for (int seg = 0; seg < 3; ++seg) {\n            if (j >= 0) TRC(6144 + 8 * j + 3 + seg)\n"),
    ("            if (seg == 2 && kbs > 1) H::mbar_wait_or_trap(hfull + wg, j & 1);\n",
     "            if (seg == 2 && kbs > 1) H::mbar_wait_or_trap(hfull + wg, j & 1);\n"
     "            if (j >= 0 && seg == 2) TRC(6144 + 8 * j + 6)\n"),
    ("        H::wgmma_wait<0>();\n        H::fence_regs(acc);\n        H::fence_regs(hacc);\n"
     "        if (pend >= 0 && lane == 0) H::mbar_arrive(",
     "        if (j >= 0) TRC(6144 + 8 * j + 7)\n        H::wgmma_wait<0>();\n        H::fence_regs(acc);\n"
     "        H::fence_regs(hacc);\n        if (pend >= 0 && lane == 0) H::mbar_arrive("),
    ("    const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, t4 = lane & 3;\n",
     "    const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, t4 = lane & 3;\n    TRC(8000)\n"
     "    if (blockIdx.x == TRACE_CTA && threadIdx.x == 0) g_trace[8002] = H::global_ns();\n"),
    ("    // y = round(acc + b2) (dx = round(acc)): the warpgroup's rows, this CTA's\n",
     "    TRC(8001)\n    if (blockIdx.x == TRACE_CTA && threadIdx.x == 0) g_trace[8003] = H::global_ns();\n"
     "    // y = round(acc + b2) (dx = round(acc)): the warpgroup's rows, this CTA's\n"),
]
PARTS = ("buffer free", "epilogue", "copies", "own block", "next first product", "copies landed",
         "other blocks")


def traced_source(src: str) -> str:
    """``fused_mlp.cu``'s text with the stamps in and an entry that copies
    them out (``passt_fused_mlp_trace``)."""
    for old, new in EDITS:
        if old not in src:
            raise SystemExit(f"fused_mlp_timeline: text not found in fused_mlp.cu: {old!r}")
        src = src.replace(old, new)
    src = src.replace('#include "hopper.cuh"\n', f'#include "hopper.cuh"\n#define TRACE_CTA {TRACE_CTA}\n', 1)
    return src + ('\nextern "C" int passt_fused_mlp_trace(void* dst) {\n'
                  '    return static_cast<int>(cudaMemcpyFromSymbol(dst, g_trace, sizeof(g_trace)));\n}\n')


def timeline(m: int, bwd: bool) -> np.ndarray:
    """The stamps of TRACE_CTA after three calls at [m, 768]."""
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    c, h = 768, 3072

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=gen) * scale).to(torch.bfloat16)

    x, w1, b1, w2, b2 = rand(m, c), rand(c, h, scale=0.02), rand(h, scale=0.1), rand(h, c, scale=0.02), rand(c)
    dy, d = rand(m, c), rand(m, h)
    for _ in range(3):
        if bwd:
            F.fused_mlp_bwd(dy, d, w1, w2)
        else:
            F.fused_mlp_fwd(x, w1, b1, w2, b2, residuals=False)
    torch.cuda.synchronize()
    lib = F._lib()
    lib.passt_fused_mlp_trace.argtypes = [ctypes.c_void_p]
    buf = np.zeros(8192, np.int64)
    _build.check(lib, lib.passt_fused_mlp_trace(buf.ctypes.data), "fused MLP timeline")
    return buf


def report(buf: np.ndarray, what: str) -> None:
    ghz = (buf[8001] - buf[8000]) / (buf[8003] - buf[8002])
    us = lambda ticks: ticks / (ghz * 1000.0)  # noqa: E731
    stages = int(np.count_nonzero(buf[4096:6144]))
    ends = buf[6144 + 7:8000:8]
    chunks = int(np.count_nonzero(ends))
    print(f"{what}: CTA {TRACE_CTA} {us(buf[8001] - buf[8000]):.2f} us from the consumers' start to their "
          f"stores at {ghz:.3f} GHz, {chunks} chunks, {stages} stages", flush=True)
    prev = buf[8000]
    for j in range(chunks):
        e = buf[6144 + 8 * j:6144 + 8 * j + 8]
        parts = ", ".join(f"{name} {us(e[k + 1] - e[k]):.2f}" for k, name in enumerate(PARTS))
        print(f"  chunk {j:2d}: {us(e[7] - prev):6.2f} us: {parts}", flush=True)
        prev = e[7]
    waits = us(np.sum(buf[4096:4096 + stages] - buf[2048:2048 + stages]))
    print(f"  stage waits: {waits:.2f} us in all", flush=True)


def main(argv=None) -> int:
    sizes = [int(a) for a in (sys.argv[1:] if argv is None else argv)] or [5688]
    if not torch.cuda.is_available():
        raise SystemExit("fused_mlp_timeline: no CUDA device; the timeline runs on the card only")
    print(gpu_line(), flush=True)
    csrc, where = _build.CSRC, _build.BUILD_DIR.parent / "fused_mlp_timeline"
    shutil.rmtree(where, ignore_errors=True)
    shutil.copytree(csrc, where)
    (where / "fused_mlp.cu").write_text(traced_source((csrc / "fused_mlp.cu").read_text()))
    try:
        _build.CSRC = where
        F._lib.cache_clear()
        for m in sizes:
            for bwd in (False, True):
                rows, cs, ctas, resident, waves = F.plan_kernel(m, 768, bwd)
                report(timeline(m, bwd), f"M={m} {'backward' if bwd else 'forward'} (rows {rows}, {cs} CTAs a "
                                         f"cluster, {ctas} CTAs, {resident} clusters resident, {waves} waves)")
    finally:
        _build.CSRC = csrc
        F._lib.cache_clear()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
