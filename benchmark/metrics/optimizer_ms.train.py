"""Per-layer metric: see PERF.md, section 3."""

from benchmark.lib import spans


def read(r):
    """Device ms a step of AdamW and the SR apply, up to trace_mark_optimizer."""
    return spans.phase_ms_per_unit(r, "optimizer")
