"""Data parallelism across processes (port of the data-parallel half of
passt_tpu/parallel/mesh.py).

The JAX package runs one SPMD program over the global batch: the mesh's
data axis splits the batch, and GSPMD inserts the gradient sum. Here each
process drives one device through ``torch.distributed`` (NCCL on the card,
gloo on the CPU), and the train step computes the same function over the
global batch of ``world_size`` per-rank batches, in rank order:

- every draw with a value per example (SpecAugment's iid masks, the mixup
  permutation and lambda, dropout and drop-path masks) is made at the
  global batch from the step's generators, which every rank seeds alike,
  and each rank keeps its own rows (:meth:`DataParallel.rows`);
- mixup's partners live on other ranks, so the post-frontend batch and the
  targets are all-gathered before it (:meth:`DataParallel.gather_rows`);
- the gradients are averaged by one all-reduce over one flat fp32 buffer
  of every leaf, which also carries the loss
  (:meth:`DataParallel.all_reduce_mean`), before the optimizer, so every
  rank applies the same update and the parameters stay bit-identical.

The collectives are plain ``torch.distributed`` calls on the step's
stream, so a CUDA graph of the step captures them with the rest of it.
``COLLECTIVES`` counts them where they are issued (registered with the
kernels' launch counters, so a graph's replays count them too).

``replicate`` (the JAX ``replicate``) is a broadcast from rank 0,
``shard_batch`` takes a rank's rows of a global batch, and
``make_parallel_train_step`` gives a step of ``make_train_step`` these
collectives. The JAX package's tensor-parallel rules
(``param_partition_spec``) are not ported: ``trainer.n_model > 1`` raises
(ROADMAP.md queue 1 item 10).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from passt_tpu_torch.ops import _build

#: collective -> calls issued since the last reset (counted like the kernels)
COLLECTIVES: Dict[str, int] = {"all_reduce": 0, "all_gather": 0}
_build.COUNTERS["collectives"] = COLLECTIVES


def reset_collectives() -> None:
    for name in COLLECTIVES:
        COLLECTIVES[name] = 0


class DataParallel:
    """The collectives of one data-parallel train step, over ``group``
    (the default group when None) of ``world_size`` ranks."""

    def __init__(self, world_size: int, rank: int, group=None):
        self.world_size = world_size
        self.rank = rank
        self.group = group

    def rows(self, local_batch: int) -> Tuple[int, int]:
        """(first row, global batch) of this rank's rows: ranks hold equal
        batches, in rank order."""
        return self.rank * local_batch, self.world_size * local_batch

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's ``x`` concatenated on the batch axis, in rank order."""
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.world_size)]
        dist.all_gather(parts, x, group=self.group)
        COLLECTIVES["all_gather"] += 1
        return torch.cat(parts)

    def all_reduce_mean(
        self, tensors: Dict[str, torch.Tensor], scalars: Sequence[torch.Tensor] = ()
    ) -> Tuple[Dict[str, torch.Tensor], List[torch.Tensor]]:
        """The mean over ranks of every tensor of ``tensors`` and of
        ``scalars``, by one all-reduce of one flat fp32 buffer; each comes
        back in its own dtype."""
        leaves = list(tensors.values()) + list(scalars)
        flat = torch.cat([t.reshape(-1).float() for t in leaves])
        dist.all_reduce(flat, group=self.group)
        COLLECTIVES["all_reduce"] += 1
        flat = flat / self.world_size
        parts = [p.view(t.shape).to(t.dtype) for p, t in zip(flat.split([t.numel() for t in leaves]), leaves)]
        return dict(zip(tensors, parts[: len(tensors)])), parts[len(tensors):]


def replicate(tensors: Sequence[torch.Tensor], group=None) -> None:
    """Make every rank's ``tensors`` rank 0's, in place (a broadcast from
    rank 0 per tensor)."""
    for t in tensors:
        dist.broadcast(t, src=0, group=group)


def shard_batch(batch: Dict[str, object], world_size: int, rank: int) -> Dict[str, object]:
    """A rank's rows of each array of a global batch (equal shares, in rank
    order)."""
    out = {}
    for k, a in batch.items():
        n = len(a)
        if n % world_size:
            raise ValueError(f"batch {k!r} of {n} rows does not split over {world_size} ranks")
        share = n // world_size
        out[k] = a[rank * share: (rank + 1) * share]
    return out


def make_parallel_train_step(step, data_parallel: Optional[DataParallel]):
    """The step of ``make_train_step`` that ``step`` is, rebuilt with the
    collectives of ``data_parallel`` (the body is the same function; see the
    module docstring). ``step`` must come from ``make_train_step``."""
    from passt_tpu_torch.train.steps import make_train_step

    args, kwargs = step.build_args
    return make_train_step(*args, **dict(kwargs, data_parallel=data_parallel))
