"""Per-layer metric: see PERF.md, section 3."""

from benchmark.lib import readers


def read(r):
    """The window's model FLOPs (3 x the forward) per second per card over the bf16 peak, in percent."""
    return readers.mfu(r)
