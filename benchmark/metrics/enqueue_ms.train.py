"""Per-layer metric: see PERF.md, section 3."""

from benchmark.lib import readers


def read(r):
    """Host ms from issuing a train step until the call returns (no sync)."""
    return readers.enqueue_ms(r)
