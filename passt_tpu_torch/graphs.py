"""CUDA graphs of the port's entry points: its counterpart of ``jax.jit``.

The JAX package jits its train step (with the state donated), its eval step
and its ``Predictor``. The port captures the same functions as CUDA graphs,
so one replay launches the whole step instead of its ~2000 kernels one by
one from the host.

A :class:`GraphCache` wraps a function of tensors and keeps one graph per
call signature, as jit keeps one compiled program per signature: the
arguments' pytree structure, the shape, dtype and device of each tensor
leaf (and the value of any other leaf), a ``key`` of host values the
function branches on, and the identity (``data_ptr``, shape, dtype, strides)
of the tensors the function reads in place (arguments wrapped in
:class:`InPlace`).

- Arguments. The first call of a signature allocates buffers like the
  arguments' tensors; every call copies its arguments into them (a tensor
  that already is its buffer is not copied) and the function runs on the
  buffers. A batch is an argument, never a captured constant.
- Warm-up and capture. The first :data:`WARMUP_CALLS` calls of a signature
  run the function eagerly on a side stream: real calls, whose results are
  returned, which also load the kernels and fill every cached device
  constant (a pageable host-to-device copy cannot be captured). The next
  call captures the function on that side stream, into the memory pool all
  the cache's graphs on a device share, and replays the graph; later calls
  replay it on the caller's stream.
- Outputs. Inside the graph, every output tensor is written into one packed
  buffer, and a call returns views of one copy of it: a replay rewrites the
  graph's buffers, and callers keep outputs across calls.
- Generators. The cache's generators are registered with each graph it
  captures, and a replay reads each generator's seed and offset as they
  stand when it starts: reseed them before a call to make its draws a
  function of the call.
- Launch counts. Capturing runs no kernel and a replay runs no wrapper, so
  the counts that capturing added to ``ops._build``'s counters are taken
  back, and added once per replay: a count is of kernels run. The cache's
  own counts, :data:`COUNTS` (``_build.COUNTERS["graphs"]``), are added
  outside any capture: eager calls of a signature before its capture,
  captures, replays and graphs pruned.
- Spans. The host's work before the argument copies is one
  ``tracing.span`` ("graphs.key": the flatten, the signature, the buffer
  and graph lookups), and the views of the copied outputs another
  ("graphs.unpack"); neither encloses a launch.

On a CPU tensor the function runs eagerly, since the caller asked for the
CPU. On a CUDA device a capture or replay that fails raises: nothing falls
back to the eager call.

The graphs of one cache share a memory pool. That is safe because every
call replays on the caller's stream and copies the graph's outputs before
it returns, so no replay can overwrite another graph's outputs that a
caller still reads.
"""

from __future__ import annotations

import contextlib
import gc
import weakref
from typing import Callable, Dict, Iterable, Optional

import torch
from torch.utils import _pytree as pytree

from passt_tpu_torch import tracing
from passt_tpu_torch.ops import _build

#: eager calls of a signature before its capture
WARMUP_CALLS = 1
#: what every cache did on a device with graphs: eager (warm-up) calls,
#: captures, replays, graphs pruned (module docstring)
COUNTS: Dict[str, int] = {"eager": 0, "captures": 0, "replays": 0, "pruned": 0}
_build.COUNTERS["graphs"] = COUNTS
#: byte alignment of each output in the packed buffer
_ALIGN = 16


class InPlace:
    """An argument the function reads where it lies: not copied; the cache
    keys its graphs on the identity of the argument's tensors."""

    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value


class CudaGraph:
    """One ``torch.cuda.CUDAGraph``, captured on the cache's side stream
    into the pool its graphs on the device share, replayed on the caller's
    stream. ``shared`` is the cache's per-device dict of the two."""

    def __init__(self, device: torch.device, shared: dict, generators: Iterable[torch.Generator]):
        self.shared = self._resources(device, shared)
        self.device = device
        self.graph = torch.cuda.CUDAGraph()
        for gen in generators:
            self.graph.register_generator_state(gen)

    @staticmethod
    def _resources(device: torch.device, shared: dict) -> dict:
        if not shared:
            with torch.cuda.device(device):
                shared["stream"] = torch.cuda.Stream(device)
                shared["pool"] = torch.cuda.graph_pool_handle()
        return shared

    @classmethod
    @contextlib.contextmanager
    def side(cls, device: torch.device, shared: dict):
        """Run the enclosed eager call on the side stream, ordered after the
        caller's stream's work and before its later work."""
        stream = cls._resources(device, shared)["stream"]
        caller = torch.cuda.current_stream(device)
        stream.wait_stream(caller)
        with torch.cuda.stream(stream):
            yield
        caller.wait_stream(stream)

    def capture(self, fn: Callable):
        """Capture ``fn()``; returns its outputs, which every replay rewrites.
        ``thread_local``: other threads (a loader feeding the card) may keep
        allocating and copying while this one captures. Python's cyclic
        collector runs before, and not during, the capture
        (:func:`no_collection`)."""
        with no_collection(), torch.cuda.device(self.device), torch.cuda.graph(
            self.graph, pool=self.shared["pool"], stream=self.shared["stream"],
            capture_error_mode="thread_local",
        ):
            return fn()

    def replay(self) -> None:
        self.graph.replay()


@contextlib.contextmanager
def no_collection():
    """Collect the garbage now and keep the cyclic collector off inside:
    a graph of a dropped cache that waits in a reference cycle, destroyed
    by a collection in the middle of a capture, invalidates that capture
    (``cudaErrorStreamCaptureInvalidated``)."""
    gc.collect()
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def graph_type(device: torch.device):
    """The graph class a cache captures with on ``device``; None runs the
    function eagerly (the CPU)."""
    return CudaGraph if device.type == "cuda" else None


def _pack(outputs):
    """One uint8 buffer holding every output tensor (each at a 16-byte
    aligned offset) and the layout that unpacks it."""
    leaves, spec = pytree.tree_flatten(outputs)
    parts, layout, offset = [], [], 0
    for t in leaves:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"a graphed function returns tensors only, got {type(t).__name__}")
        flat = t.detach().contiguous().reshape(-1).view(torch.uint8)
        pad = -flat.numel() % _ALIGN
        parts.append(flat)
        if pad:
            parts.append(flat.new_empty(pad))
        layout.append((offset, t.shape, t.dtype))
        offset += flat.numel() + pad
    packed = torch.cat(parts) if parts else None
    return packed, (spec, layout)


def _unpack(packed: Optional[torch.Tensor], layout):
    spec, parts = layout
    views = []
    for offset, shape, dtype in parts:
        nbytes = shape.numel() * dtype.itemsize
        views.append(packed[offset: offset + nbytes].view(dtype).view(shape))
    return pytree.tree_unflatten(views, spec)


class _Entry:
    __slots__ = ("graph", "packed", "layout", "delta", "reads")

    def __init__(self, graph, packed, layout, delta, reads):
        self.graph, self.packed, self.layout, self.delta, self.reads = graph, packed, layout, delta, reads


class GraphCache:
    """``fn`` run as CUDA graphs, one per call signature (module docstring).

    ``cache(*args, key=())`` returns ``(outputs, args_run)``: ``fn``'s
    outputs and the arguments it ran on (the cache's buffers, with
    :class:`InPlace` arguments unwrapped; on the CPU, the arguments
    themselves). ``generators``: a mapping or an iterable of the
    ``torch.Generator``s ``fn`` draws from, registered with each graph as
    they stand at its capture."""

    def __init__(self, fn: Callable, generators=()):
        self.fn = fn
        self.generators = generators
        self._buffers: Dict[tuple, list] = {}  # argument signature -> buffer leaves
        self._calls: Dict[tuple, int] = {}  # full signature -> eager calls made
        self._graphs: Dict[tuple, _Entry] = {}  # full signature -> its graph
        self._shared: Dict[torch.device, dict] = {}  # device -> side stream and pool

    def __len__(self) -> int:
        """The graphs captured so far."""
        return len(self._graphs)

    def __call__(self, *args, key=()):
        with tracing.span("graphs.key"):
            leaves, spec = pytree.tree_flatten(args)
            device, sig, reads = None, [], []
            for leaf in leaves:
                if isinstance(leaf, torch.Tensor):
                    sig.append((leaf.shape, leaf.dtype, leaf.device))
                    device = leaf.device if device is None else device
                elif isinstance(leaf, InPlace):
                    inner, inner_spec = pytree.tree_flatten(leaf.value)
                    sig.append(inner_spec)
                    for t in inner:
                        if isinstance(t, torch.Tensor):
                            reads.append(t)
                            device = t.device if device is None else device
                else:
                    sig.append(("value", leaf))
            plain = [leaf.value if isinstance(leaf, InPlace) else leaf for leaf in leaves]
            graph_cls = graph_type(device) if device is not None else None
            if graph_cls is not None:
                arg_sig = (spec, tuple(sig))
                buffers = self._buffers.get(arg_sig)
                if buffers is None:
                    with torch.inference_mode(False), torch.no_grad():
                        buffers = [torch.empty_like(leaf) if isinstance(leaf, torch.Tensor) else None
                                   for leaf in leaves]
                    self._buffers[arg_sig] = buffers
                run = [value if buf is None else buf for value, buf in zip(plain, buffers)]
                args_run = pytree.tree_unflatten(run, spec)
                full = (arg_sig, key, tuple((t.data_ptr(), t.shape, t.dtype, t.stride()) for t in reads))
                entry = self._graphs.get(full)
                shared = self._shared.setdefault(device, {})
        if graph_cls is None:
            args_run = pytree.tree_unflatten(plain, spec)
            return self.fn(*args_run), args_run

        with torch.no_grad():
            for leaf, buf in zip(leaves, buffers):
                if buf is not None and leaf is not buf:
                    buf.copy_(leaf)
        if entry is None:
            calls = self._calls.get(full, 0)
            if calls < WARMUP_CALLS:
                self._calls[full] = calls + 1
                COUNTS["eager"] += 1
                with graph_cls.side(device, shared):
                    return self.fn(*args_run), args_run
            entry = self._capture(graph_cls, device, shared, args_run, reads)
            COUNTS["captures"] += 1
            self._prune()
            self._graphs[full] = entry
        entry.graph.replay()
        COUNTS["replays"] += 1
        _build.add_launches(entry.delta)
        packed = None if entry.packed is None else entry.packed.clone()
        with tracing.span("graphs.unpack"):
            return _unpack(packed, entry.layout), args_run

    def _capture(self, graph_cls, device, shared, args_run, reads) -> _Entry:
        gens = self.generators.values() if hasattr(self.generators, "values") else self.generators
        graph = graph_cls(device, shared, list(gens))
        before = _build.launch_counts()
        packed, layout = graph.capture(lambda: _pack(self.fn(*args_run)))
        delta = _build.launch_delta(before)
        _build.add_launches(delta, -1)  # capturing ran no kernel
        return _Entry(graph, packed, layout, delta, tuple(weakref.ref(t) for t in reads))

    def _prune(self) -> None:
        """Drop the graphs whose in-place tensors are gone (an SWA average
        replaced by the next one), so the cache does not grow with them."""
        dead = [full for full, e in self._graphs.items() if any(r() is None for r in e.reads)]
        for full in dead:
            del self._graphs[full]
            self._calls.pop(full, None)
        COUNTS["pruned"] += len(dead)
