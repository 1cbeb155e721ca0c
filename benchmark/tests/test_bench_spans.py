"""The readers of the program's spans and phase marks (``lib/spans.py``
and the metric files that use it) on synthetic traces: kernels, marks and
host events with made-up times, in microseconds."""

import pytest

from benchmark.lib import harness, spans
from benchmark.lib import trace as T

PHASE_METRICS = ["ungraphed_ms.train", "frontend_ms.train", "forward_ms.train", "backward_ms.train",
                 "optimizer_ms.train", "writeback_ms.train"]
PHASES = [m.split("_ms")[0] for m in PHASE_METRICS]


def _step(t0: float):
    """One step's device work from ``t0``: per phase two kernels (10 and
    20 us times the phase's index + 1), then its mark (1 us)."""
    out, t = [], t0
    for i, phase in enumerate(PHASES):
        for name, us in (("void at::native::copy_kernel", 10.0 * (i + 1)), ("nvjet_tst_gemm", 20.0 * (i + 1))):
            out.append((name, t, t + us))
            t += us + 2.0
        out.append((f"trace_mark_{phase}", t, t + 1.0))
        t += 3.0
    return out, t


def _trace(steps: int = 3, host=(), marks: bool = True, shuffle: bool = True) -> T.Trace:
    kernels, t = [], 100.0
    for _ in range(steps):
        step, t = _step(t)
        kernels += step
    if not marks:
        kernels = [k for k in kernels if not k[0].startswith("trace_mark_")]
    if shuffle:  # listed out of start order, as Trace keeps them (by name)
        kernels = kernels[::-1]
    return T.Trace(kernels, list(host) + [(T.WINDOW_SPAN, 0.0, t + 50.0)], (0.0, t + 50.0), steps)


def _read(name: str, tr: T.Trace):
    return harness.metric_reader(name)({"trace": tr})


def test_phases_sum_to_the_kernels_without_marks():
    tr = _trace()
    read = {p: _read(m, tr) for p, m in zip(PHASES, PHASE_METRICS)}
    for i, p in enumerate(PHASES):
        assert read[p] == pytest.approx(1e-3 * 30.0 * (i + 1))
    kernel_ms = sum(e - s for n, s, e in tr.kernels if not n.startswith("trace_mark_")) * 1e-3 / tr.units
    assert sum(read.values()) == pytest.approx(kernel_ms)


def test_kernels_listed_out_of_start_order_are_put_in_order():
    assert ({m: _read(m, _trace(shuffle=True)) for m in PHASE_METRICS}
            == {m: _read(m, _trace(shuffle=False)) for m in PHASE_METRICS})
    # Trace keeps its kernels sorted by name: start order is the reader's own
    assert [k[0] for k in _trace().kernels] == sorted(k[0] for k in _trace().kernels)


def test_kernels_after_the_last_mark_belong_to_the_first_phase():
    """A window that ends inside a step: what ran after its last mark is
    counted in the phase its first mark closes (the next step's)."""
    tr = _trace(steps=2)
    tail = [("void at::native::copy_kernel", 5000.0, 5040.0)]
    tr2 = T.Trace(tr.kernels + tail, tr.host, (0.0, 6000.0), tr.units)
    ms = spans.phase_ms(tr2)
    assert ms["ungraphed"] == pytest.approx(spans.phase_ms(tr)["ungraphed"] + 0.040)
    assert sum(ms.values()) == pytest.approx(sum(spans.phase_ms(tr).values()) + 0.040)


def test_a_trace_without_marks_reads_none():
    tr = _trace(marks=False)
    assert all(_read(m, tr) is None for m in PHASE_METRICS)
    assert spans.phase_ms(tr) is None
    assert all(_read(m, None) is None for m in PHASE_METRICS)


def test_host_prep_sums_the_named_spans_inside_the_window():
    host = [("predictor.args", 10.0, 30.0), ("graphs.key", 30.0, 80.0), ("graphs.unpack", 90.0, 95.0),
            ("predictor.args", 200.0, 220.0), ("graphs.key", 220.0, 270.0), ("step.plan", 300.0, 400.0),
            ("graphs.key", -100.0, -50.0)]  # before the window: left out
    tr = T.Trace([("k", 0.0, 1.0)], host, (0.0, 1000.0), 2)
    assert _read("host_prep_ms.serve", tr) == pytest.approx(1e-3 * (20 + 50 + 20 + 50) / 2)
    assert _read("host_prep_ms.train", tr) == pytest.approx(1e-3 * (50 + 50 + 100) / 2)
    assert _read("host_prep_ms.serve", T.Trace([], [("bench.call", 0.0, 9.0)], (0.0, 10.0), 1)) is None


def test_no_mark_falls_into_a_kernel_group():
    """The program's marks match none of the trace's groups, so no group's
    metric moves with them."""
    from passt_tpu_torch import tracing

    for phase in tracing.PHASES:
        name = f"trace_mark_{phase}"
        assert T.group_of(name) == "other" and spans.mark_phase(name) == phase
