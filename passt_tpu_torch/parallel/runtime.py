"""Recipe-level data parallelism: ``trainer.n_data`` (port of
passt_tpu/parallel/runtime.py).

The reference trains data-parallel with one env var (``DDP=2`` forks N
processes, reference: ex_audioset.py:499-524); the JAX package with one
override, ``trainer.n_data=N``, over a device mesh. Here one process drives
one device, and N processes started by ``torchrun`` form one
``torch.distributed`` group::

    torchrun --nproc-per-node N -m passt_tpu_torch.cli audioset main \\
        trainer.n_data=N data.num_replicas=0 ...

(``data.num_replicas=0`` gives each rank its slice of every epoch, as in the
JAX package.) The group comes from torchrun's environment (``WORLD_SIZE``,
``RANK``, ``LOCAL_RANK``, ``MASTER_ADDR``/``MASTER_PORT``), NCCL on the card
(``cuda:LOCAL_RANK``) and gloo on the CPU, with an explicit timeout, so a
lost peer fails the run instead of hanging it; a group the caller made
first is used as it is, and one process outside torchrun forms a one-rank
group of its own. ``trainer.n_data`` must equal the group's size.

Each rank's loader builds ``data.batch_size`` rows (``local_batch_scale`` is
1), so the global batch is ``batch_size * n_data``, as in the JAX package.
The train step computes the step over that global batch
(:mod:`passt_tpu_torch.parallel.mesh`); eval runs each rank's slice of the
eval set and gathers the outputs before the metrics
(``train/loop.py``).

``trainer.n_model=M`` adds tensor parallelism: the group of ``n_data * M``
processes forms a (data, model) grid (``mesh.process_grid``), each data
rank's block weights split over its M model ranks
(``mesh.TensorParallel``), every model rank of a data rank reading the same
rows. The train state lives as each rank's share; checkpoints are written
by rank 0 in the full, gathered layout (which the JAX loader and a run
without tensor parallelism read), and a resume shards them again. Eval
gathers outputs over the data group only::

    torchrun --nproc-per-node 4 -m passt_tpu_torch.cli audioset main \
        trainer.n_data=2 trainer.n_model=2 data.num_replicas=0 ...

(gloo on the CPU; one H100 has no second card to split a model over).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from passt_tpu_torch.parallel.mesh import (
    DataParallel,
    TensorParallel,
    make_parallel_train_step,
    process_grid,
    replicate,
)
from passt_tpu_torch.train.optim import map_param_dicts

#: the process group's timeout: how long a collective waits for a lost peer
DEFAULT_TIMEOUT_S = 600.0


def init_process_group(device="cuda", timeout_s: float = DEFAULT_TIMEOUT_S) -> Tuple[int, int, torch.device]:
    """The process group of this run, formed if it is not yet: from
    torchrun's environment where ``WORLD_SIZE`` is set, else a one-rank
    group on an in-process store. Returns (world size, rank, this rank's
    device): ``cuda:LOCAL_RANK`` (NCCL) for a CUDA ``device``, the CPU
    (gloo) for a CPU one."""
    device = torch.device(device)
    if device.type == "cuda":
        local_rank = int(os.environ.get("LOCAL_RANK", 0))
        device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        backend = "nccl" if device.type == "cuda" else "gloo"
        timeout = datetime.timedelta(seconds=timeout_s)
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, init_method="env://", timeout=timeout)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1, timeout=timeout)
    return dist.get_world_size(), dist.get_rank(), device


@dataclasses.dataclass
class DDPRuntime:
    """Everything the recipes, ``fit`` and ``evaluate`` need to train and
    evaluate data-parallel (and, with ``n_model > 1``, tensor-parallel)
    across the processes of the default group."""

    world_size: int
    rank: int
    device: torch.device
    n_model: int = 1

    def __post_init__(self):
        (self.n_data, self.data_rank, self.model_rank,
         self.data_group, self.model_group) = process_grid(self.world_size, self.rank, self.n_model)

    @property
    def data_parallel(self) -> DataParallel:
        return DataParallel(self.n_data, self.data_rank, self.data_group)

    @property
    def tensor_parallel(self) -> Optional[TensorParallel]:
        """This rank's model share, None without a model axis."""
        if self.n_model == 1:
            return None
        return TensorParallel(self.n_model, self.model_rank, self.model_group)

    @property
    def spans_processes(self) -> bool:
        """True when the group has more than one process: host arrays are
        each rank's own rows, and eval outputs are gathered across ranks."""
        return self.world_size > 1

    @property
    def is_main(self) -> bool:
        """Rank 0: the rank that writes checkpoints, logs and profiles."""
        return self.rank == 0

    def local_replica(self, tree):
        """This rank's copy of replicated parameters: the tensors themselves
        (every rank holds the whole model)."""
        return tree

    @property
    def local_batch_scale(self) -> int:
        """Per-replica batches this process's loader builds: one (one
        process drives one device)."""
        return 1

    def pad_eval_batch(self, arrays: Dict[str, object]) -> Tuple[Dict[str, object], int]:
        """(the batch, its row count): each rank evaluates its own rows, so
        no batch is split over devices and nothing is padded."""
        return arrays, len(next(iter(arrays.values())))

    def replicate_state(self, state):
        """Rank 0's full parameters and optimizer state on every rank (the
        JAX package's ``replicate``), in place; under tensor parallelism
        then each rank's share of them (:meth:`shard_state`)."""
        tensors = list(state.params.values())
        tensors += [x for x in pytree.tree_leaves(state.opt_state) if isinstance(x, torch.Tensor)]
        replicate(tensors)
        return self.shard_state(state)

    def shard_params(self, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Full parameters -> this rank's share (the identity without a
        model axis)."""
        tp = self.tensor_parallel
        return params if tp is None else tp.shard(params)

    def shard_state(self, state):
        """A full train state -> this rank's share (the identity without a
        model axis)."""
        tp = self.tensor_parallel
        if tp is None:
            return state
        return dataclasses.replace(state, params=tp.shard(state.params),
                                   opt_state=map_param_dicts(state.opt_state, state.params, tp.shard))

    def gather_params(self, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Shares -> the full parameters (collective over the model group;
        the identity without a model axis)."""
        tp = self.tensor_parallel
        return params if tp is None else tp.gather(params)

    def gather_state(self, state):
        """This rank's share of a train state -> the full one (collective;
        the identity without a model axis)."""
        tp = self.tensor_parallel
        if tp is None:
            return state
        return dataclasses.replace(state, params=tp.gather(state.params),
                                   opt_state=map_param_dicts(state.opt_state, state.params, tp.gather))

    def wrap_train_step(self, step):
        """The parallel form of a step of ``make_train_step``
        (:func:`~passt_tpu_torch.parallel.mesh.make_parallel_train_step`)."""
        return make_parallel_train_step(step, self.data_parallel, self.tensor_parallel)


def maybe_ddp_runtime(trainer_cfg, device="cuda", timeout_s: float = DEFAULT_TIMEOUT_S) -> Optional[DDPRuntime]:
    """A :class:`DDPRuntime` iff the config asks for one (``n_data`` set or
    ``n_model > 1``); None keeps the plain one-device step. Raises before
    any work where the config and the group disagree; ``n_data`` unset
    under ``n_model > 1`` is the group's size over ``n_model``."""
    n_data = getattr(trainer_cfg, "n_data", None)
    n_model = getattr(trainer_cfg, "n_model", 1) or 1
    if n_data is None and n_model == 1:
        return None
    have = dist.get_world_size() if dist.is_initialized() else int(os.environ.get("WORLD_SIZE", 1))
    if n_model > have:
        raise RuntimeError(f"trainer.n_model={n_model} exceeds the {have} available devices")
    if n_data is None:
        n_data = max(1, have // n_model)
    if n_data < 1:
        raise RuntimeError(f"trainer.n_data must be >= 1, got {n_data}")
    need = n_data * n_model
    if need != have:
        raise RuntimeError(
            f"trainer.n_data={n_data} n_model={n_model} needs {need} devices, have {have} "
            f"(one process per device, and the process group has {have}: start "
            f"torchrun --nproc-per-node {need})"
        )
    world, rank, device = init_process_group(device, timeout_s)
    return DDPRuntime(world_size=world, rank=rank, device=device, n_model=n_model)
