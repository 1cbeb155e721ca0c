"""Cells of the manifest cut to a size the CPU can run in a test: two
blocks of 64 wide, 2 heads, 10 classes, a tenth of a second's audio.
Every other setting (precision, recipe, limits) is the cell's own."""

import copy

from benchmark.lib import harness


def tiny_cell(name: str) -> harness.Cell:
    cell = harness.load_cell(name)
    cfg = dict(cell.config, embed_dim=64, depth=2, num_heads=2, num_classes=10, input_tdim=98)
    w = copy.deepcopy(cell.workload)
    p = w["params"]
    if w["traffic"] == "serve_closed":
        p.update(batch=4, clip_samples=31360, pool_batches=3, trace_calls=2)
    else:
        p.update(batch_per_chip=4, clip_samples=31360, pool_batches=3, trace_steps=2)
    return harness.Cell(name, w, cfg, cell.end_to_end, cell.per_layer)
