"""Per-layer metric: see PERF.md, section 3."""

from benchmark.lib import spans


def read(r):
    """Host ms a call in the Predictor's spans before its replay: predictor.args and graphs.key."""
    return spans.host_ms_per_unit(r, ("predictor.args", "graphs.key"))
