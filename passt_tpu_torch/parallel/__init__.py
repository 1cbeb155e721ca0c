"""Data- and tensor-parallel training across processes (port of
passt_tpu/parallel): ``torch.distributed`` with NCCL on the card and gloo
on the CPU.

- :mod:`passt_tpu_torch.parallel.runtime`: ``trainer.n_data`` and
  ``trainer.n_model`` -> :class:`DDPRuntime` (the process group and its
  (data, model) grid, the rank's device, the surface ``fit``/``evaluate``
  and the recipes use);
- :mod:`passt_tpu_torch.parallel.mesh`: the train step's collectives over
  the global batch (:class:`DataParallel`), the model axis's split of the
  blocks (:class:`TensorParallel`, the JAX package's ``TP_RULES`` and
  ``param_partition_spec``), ``replicate``, ``shard_batch`` and
  ``make_parallel_train_step``.
"""

from passt_tpu_torch.parallel.mesh import (
    COLLECTIVES,
    TP_RULES,
    DataParallel,
    TensorParallel,
    make_parallel_train_step,
    param_partition_spec,
    process_grid,
    replicate,
    reset_collectives,
    shard_batch,
)
from passt_tpu_torch.parallel.runtime import DDPRuntime, init_process_group, maybe_ddp_runtime

__all__ = [
    "COLLECTIVES",
    "DDPRuntime",
    "DataParallel",
    "TP_RULES",
    "TensorParallel",
    "init_process_group",
    "make_parallel_train_step",
    "maybe_ddp_runtime",
    "param_partition_spec",
    "process_grid",
    "replicate",
    "reset_collectives",
    "shard_batch",
]
