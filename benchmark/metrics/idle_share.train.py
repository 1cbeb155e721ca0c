"""Per-layer metric: see PERF.md, section 3."""

from benchmark.lib import readers


def read(r):
    """One minus the union of kernel intervals over the traced window, in percent."""
    return readers.idle_share(r)
