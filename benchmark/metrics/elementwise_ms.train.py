"""Per-layer metric: see PERF.md, section 3."""

from benchmark.lib import readers


def read(r):
    """Device ms a step in the elementwise and the copy/cast kernel groups."""
    return readers.groups_ms_per_unit(r, "elementwise (adds, muls, GELU, optimizer)",
                                      "copies, casts, indexing, cat")
