"""Per-layer metric: see PERF.md, section 3."""

from benchmark.lib import spans


def read(r):
    """Device ms a step of the work issued outside the graph (batch copy, fills), up to trace_mark_ungraphed."""
    return spans.phase_ms_per_unit(r, "ungraphed")
