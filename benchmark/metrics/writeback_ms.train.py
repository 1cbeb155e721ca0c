"""Per-layer metric: see PERF.md, section 3."""

from benchmark.lib import spans


def read(r):
    """Device ms a step of the graph's write-back of the new state, up to trace_mark_writeback."""
    return spans.phase_ms_per_unit(r, "writeback")
