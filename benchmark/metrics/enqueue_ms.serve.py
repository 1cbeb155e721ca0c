"""Per-layer metric: see PERF.md, section 3."""

from benchmark.lib import readers


def read(r):
    """Host ms from issuing a Predictor call until it returns, before the logits' copy to the host."""
    return readers.enqueue_ms(r)
