"""Data-parallel training across processes (port of passt_tpu/parallel):
``torch.distributed`` with NCCL on the card and gloo on the CPU.

- :mod:`passt_tpu_torch.parallel.runtime`: ``trainer.n_data`` ->
  :class:`DDPRuntime` (the process group, the rank's device, the surface
  ``fit``/``evaluate`` and the recipes use);
- :mod:`passt_tpu_torch.parallel.mesh`: the train step's collectives over
  the global batch (:class:`DataParallel`), ``replicate``, ``shard_batch``
  and ``make_parallel_train_step``.
"""

from passt_tpu_torch.parallel.mesh import (
    COLLECTIVES,
    DataParallel,
    make_parallel_train_step,
    replicate,
    reset_collectives,
    shard_batch,
)
from passt_tpu_torch.parallel.runtime import DDPRuntime, init_process_group, maybe_ddp_runtime

__all__ = [
    "COLLECTIVES",
    "DDPRuntime",
    "DataParallel",
    "init_process_group",
    "make_parallel_train_step",
    "maybe_ddp_runtime",
    "replicate",
    "reset_collectives",
    "shard_batch",
]
