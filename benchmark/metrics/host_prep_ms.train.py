"""Per-layer metric: see PERF.md, section 3."""

from benchmark.lib import spans


def read(r):
    """Host ms a step in the train step's spans before its replay: step.plan and graphs.key."""
    return spans.host_ms_per_unit(r, ("step.plan", "graphs.key"))
