"""Per-layer metric: see PERF.md, section 3."""

from benchmark.lib import readers


def read(r):
    """Device kernels a train step, from the profiler."""
    return readers.kernels_per_unit(r)
