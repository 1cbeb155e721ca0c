"""Per-layer metric: see PERF.md, section 3."""

from benchmark.lib import readers


def read(r):
    """The attention backward kernels' bound over their profiled time, in percent."""
    return readers.attention_roofline(r, backward=True)
