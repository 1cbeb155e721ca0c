"""The port's tracing (passt_tpu_torch.tracing) on the CPU: the graph
cache's counters, the host spans of a graphed ``Predictor`` call and a
graphed train step under ``torch.profiler``, and the train step's phase
marks.

The graph path runs through test_torch_graphs.py's ``RecordingGraph``. A
span must enclose host work only: on the card a kernel launched inside a
``record_function`` range is mirrored on the device's timeline as if it
were a kernel. Here no span may enclose an ATen op that would launch on a
card (``aten::copy_``, ``aten::fill_``, ``aten::clone``), which is the same
rule seen from the host.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from passt_tpu_torch import graphs, tracing
from passt_tpu_torch.hear import Predictor
from passt_tpu_torch.models.passt import PaSST, PaSSTConfig, init_weights
from passt_tpu_torch.ops import _build
from passt_tpu_torch.ops.frontend import MelConfig
from passt_tpu_torch.parallel.mesh import DataParallel
from passt_tpu_torch.train.steps import make_train_step
from test_torch_graphs import TINY, RecordingGraph, _tiny, _tiny_batch

#: the phases a graphed train step without data parallelism closes, in order
STEP_PHASES = ["ungraphed", "frontend", "forward", "backward", "optimizer", "writeback"]
#: ATen ops that launch on a card; no span may enclose one
LAUNCHING = ("aten::copy_", "aten::fill_", "aten::clone")


@pytest.fixture
def recording(monkeypatch):
    RecordingGraph.log = []
    monkeypatch.setattr(graphs, "graph_type", lambda device: RecordingGraph)
    return RecordingGraph.log


def _counts():
    return dict(graphs.COUNTS)


def _moved(before):
    return {k: v - before[k] for k, v in graphs.COUNTS.items() if v != before[k]}


def _predictor():
    cfg = dict(TINY, num_classes=8, distilled=True)
    model = init_weights(PaSST(PaSSTConfig(**cfg)), torch.Generator().manual_seed(4))
    return Predictor(model=model, mel_cfg=MelConfig(n_mels=32))


def _wave(seed, b=2):
    return np.random.default_rng(seed).standard_normal((b, 16000)).astype(np.float32)


def _spans(prof, names):
    """(name, start, end) of the named host events, in start order, and
    every launching ATen event's (name, start)."""
    spans, ops = [], []
    for ev in prof.events():
        if ev.name in names:
            spans.append((ev.name, ev.time_range.start, ev.time_range.end))
        elif ev.name in LAUNCHING:
            ops.append((ev.name, ev.time_range.start))
    return sorted(spans, key=lambda s: s[1]), ops


def _assert_host_only(spans, ops):
    for name, s, e in spans:
        inside = [op for op, t in ops if s <= t <= e]
        assert not inside, f"span {name!r} encloses {inside}"


def test_graph_counters_eager_capture_replays(recording):
    """eager 1, then capture 1 and replay 1, then replays only; a capture's
    launch delta carries the wrapper's counts and never the cache's own."""
    _build.LAUNCHES["test_kernel"] = 0

    def fn(x):
        _build.LAUNCHES["test_kernel"] += 1
        return {"y": x + 1}

    cache = graphs.GraphCache(fn)
    try:
        before = _counts()
        cache(torch.zeros(2))
        assert _moved(before) == {"eager": 1}
        before = _counts()
        cache(torch.zeros(2))
        assert _moved(before) == {"captures": 1, "replays": 1}
        for _ in range(3):
            before = _counts()
            cache(torch.zeros(2))
            assert _moved(before) == {"replays": 1}
        (entry,) = cache._graphs.values()
        assert entry.delta == {"launches": {"test_kernel": 1}}
        assert _build.LAUNCHES["test_kernel"] == 5
    finally:
        del _build.LAUNCHES["test_kernel"]


def test_graph_counters_count_pruned_graphs(monkeypatch):
    """A graph whose in-place tensors are gone is dropped at the next
    capture and counted under "pruned"."""

    class Forgetful(RecordingGraph):
        """Captures without keeping the function (and so its arguments)."""

        def capture(self, fn):
            return fn()

        def replay(self):
            pass

    monkeypatch.setattr(graphs, "graph_type", lambda device: Forgetful)
    cache = graphs.GraphCache(lambda x, w: {"y": x * w})
    w1 = torch.tensor(2.0)
    for _ in range(2):
        cache(torch.ones(2), graphs.InPlace(w1))
    del w1
    before = _counts()
    w2 = torch.tensor(3.0)
    for _ in range(2):
        cache(torch.ones(2), graphs.InPlace(w2))
    assert _moved(before) == {"eager": 1, "captures": 1, "replays": 1, "pruned": 1}
    assert len(cache) == 1


def test_cpu_calls_count_nothing():
    """Without a graph type (the CPU) the cache calls the function and
    counts nothing: there is no graph to fall back from."""
    cache = graphs.GraphCache(lambda x: {"y": x})
    before = _counts()
    for _ in range(3):
        cache(torch.zeros(1))
    assert _moved(before) == {}


def test_predictor_call_spans_in_order_and_host_only(recording):
    pred = _predictor()
    for i in range(2):  # warm-up, capture
        pred(_wave(i))
    names = ("predictor.args", "graphs.key", "graphs.unpack")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        pred(_wave(2))
    spans, ops = _spans(prof, names)
    assert [s[0] for s in spans] == list(names)
    assert ops, "the call's copies are seen by the profiler"
    _assert_host_only(spans, ops)


def test_train_step_spans_in_order_and_host_only(recording):
    model, tx, state, mcfg = _tiny()
    step = make_train_step(model, tx, mcfg, param_sr=True)
    for i in range(2):  # warm-up, capture
        state, _ = step(state, _tiny_batch(i), 5)
    names = ("step.plan", "graphs.key", "graphs.unpack")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        state, _ = step(state, _tiny_batch(2), 5)
    spans, ops = _spans(prof, names)
    assert [s[0] for s in spans] == list(names)
    assert {op for op, _ in ops} >= {"aten::copy_", "aten::fill_", "aten::clone"}
    _assert_host_only(spans, ops)


def test_no_record_function_without_a_profiler(recording, monkeypatch):
    """With no profiler recording, a span enters no ``record_function``;
    with one, every span does."""
    entered = []

    def recorder(name):
        entered.append(name)
        return tracing._NOOP

    monkeypatch.setattr(tracing, "record_function", recorder)
    pred = _predictor()
    model, tx, state, mcfg = _tiny()
    step = make_train_step(model, tx, mcfg)
    for i in range(3):
        pred(_wave(i))
        state, _ = step(state, _tiny_batch(i), 5)
    assert entered == []
    assert tracing.span("anything") is tracing._NOOP
    with profile(activities=[ProfilerActivity.CPU]):
        pred(_wave(3))
        state, _ = step(state, _tiny_batch(3), 5)
    assert entered == ["predictor.args", "graphs.key", "graphs.unpack", "step.plan", "graphs.key", "graphs.unpack"]


class _OneRank(DataParallel):
    """Data parallelism over one rank without a process group: the body's
    data-parallel branch, with the collectives as identities."""

    def __init__(self):
        super().__init__(1, 0)

    def gather_rows(self, x):
        return x

    def all_reduce_mean(self, tensors, scalars=()):
        return dict(tensors), list(scalars)


@pytest.mark.parametrize("jit,data_parallel,grad_accum",
                         [(True, False, 1), (False, False, 1), (True, True, 1), (True, True, 2)])
def test_train_step_marks_its_phases_in_order(recording, monkeypatch, jit, data_parallel, grad_accum):
    """Every call of the step body, eager, captured or replayed, closes its
    phases in order: the graphed step six, the eager one all but the
    graph's write-back, and under data parallelism the all-reduce's
    ``collective`` after the backward, once a call also under gradient
    accumulation, where it closes the loss's all-reduce alone (recorded
    through a hook in place of ``mark``)."""
    marks = []
    monkeypatch.setattr(tracing, "mark", lambda phase, like: marks.append(phase))
    model, tx, state, mcfg = _tiny(grad_accum=grad_accum)
    step = make_train_step(model, tx, mcfg, param_sr=True, jit=jit,
                           data_parallel=_OneRank() if data_parallel else None)
    want = STEP_PHASES if jit else STEP_PHASES[:-1]
    if data_parallel:
        want = want[:4] + ["collective"] + want[4:]
    for i in range(4 * grad_accum):  # graphed: warm-up, capture, two replays of each branch
        marks.clear()
        state, _ = step(state, _tiny_batch(i), 5)
        assert marks == want, i


def test_mark_on_a_cpu_tensor_loads_nothing(monkeypatch):
    def refuse(name):
        raise AssertionError(f"loaded {name}")

    monkeypatch.setattr(_build, "load", refuse)
    for phase in tracing.PHASES:
        tracing.mark(phase, torch.zeros(1))
    with pytest.raises(KeyError):
        tracing.mark("no_such_phase", torch.zeros(1))


def test_kernel_source_names_every_phase_in_order():
    """``csrc/trace_mark.cu`` launches phase i's kernel for code i."""
    src = (Path(tracing.__file__).parent / "csrc" / "trace_mark.cu").read_text()
    listed = re.search(r"#define PASST_TRACE_MARKS\(X\) (.*)", src).group(1)
    assert tuple(re.findall(r"X\((\w+)\)", listed)) == tracing.PHASES
    assert "trace_mark" in _build.KERNELS
