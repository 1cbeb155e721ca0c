"""Spans on the host and phase marks on the device, read from a
``torch.profiler`` trace.

- :func:`span` names a stretch of host work. While a profiler records, it
  enters ``torch.profiler.record_function``, so the span lies in the same
  trace, on the same clock, as the card's kernels, and a gap in the card's
  work can be put down to the span the host was in. While none records it
  returns one shared no-op context: one flag read, no allocation. A span
  encloses host work only. A kernel launched inside one would make the
  profiler mirror the span on the device's timeline as if it were a
  kernel; a caller splits its code around its launches instead.
- :func:`mark` launches an empty one-thread kernel named
  ``trace_mark_<phase>`` (``csrc/trace_mark.cu``) on the current stream:
  the end of a phase of the device's work. Under CUDA-graph capture the
  mark becomes a node of the graph, so every replay runs it, and a trace
  of replays splits the graph's kernels by phase, which no host range can
  (a replay runs no host code). Marks are always issued, as a graph is
  captured before any profiler starts; they are not counted in
  ``ops._build.LAUNCHES``. On a CPU tensor a mark does nothing.

The train step's marks, in order (``train/steps.py``): ``ungraphed``
(the graph body's first node: it closes what ran outside the graph),
``frontend``, ``forward``, ``backward``, ``collective`` (data parallelism
only: after the all-reduce; with gradient accumulation and no gradient
norms logged, after the loss's alone, as the gradients' all-reduce runs
once an update inside the optimizer, in its phase), ``optimizer``,
``writeback`` (after the graph's write-back of the new state; the eager
step has none).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch
import torch.autograd.profiler as _profiler
from torch.profiler import record_function

from passt_tpu_torch.ops import _build

#: every phase a mark can close, in ``csrc/trace_mark.cu``'s order
PHASES = ("ungraphed", "frontend", "forward", "backward", "collective", "optimizer", "writeback")
_CODE = {phase: i for i, phase in enumerate(PHASES)}

_NOOP = contextlib.nullcontext()


def span(name: str):
    """A context naming host-only work in a profiler's trace; a shared
    no-op while no profiler records."""
    if not _profiler._is_profiler_enabled:
        return _NOOP
    return record_function(name)


@functools.cache
def _lib():
    lib = _build.load("trace_mark")
    lib.passt_trace_mark.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.passt_trace_mark.restype = ctypes.c_int
    return lib


def mark(phase: str, like: torch.Tensor) -> None:
    """Close ``phase`` (one of :data:`PHASES`) on the current stream of
    ``like``'s device; nothing on a CPU tensor."""
    code = _CODE[phase]
    if like.device.type != "cuda":
        return
    lib = _lib()
    _build.check(lib, lib.passt_trace_mark(code, _build.stream_of(like)), f"trace mark {phase!r}")
