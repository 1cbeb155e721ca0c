"""Per-layer metric: see PERF.md, section 3."""

from benchmark.lib import spans


def read(r):
    """Device ms a step of the model's forward and the loss, up to trace_mark_forward."""
    return spans.phase_ms_per_unit(r, "forward")
