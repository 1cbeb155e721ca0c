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
collectives.

Tensor parallelism (the JAX mesh's ``model`` axis, Megatron's split) runs
``n_model`` processes per data rank (:func:`process_grid`: rank ``r`` is
data rank ``r // n_model``, model rank ``r % n_model``). The JAX package's
rules (:data:`TP_RULES`, :func:`param_partition_spec`) say which leaves
split: qkv and fc1 on their output, proj and fc2 on their input, with a
stacked leaf's depth axis left whole. :class:`TensorParallel` holds a model
rank's share: qkv by heads (q, k and v of ``heads / n_model`` heads, so the
flat attention kernel sees ``[B, N, 3, H_local, D]``), fc1 and fc2 by
hidden units; every other leaf whole. In the block each sublayer takes one
all-reduce, as two autograd functions: :meth:`TensorParallel.copy` (the
identity forward, an all-reduce of the gradient backward) before the split
product, :meth:`TensorParallel.reduce` (an all-reduce forward, the identity
backward) after the row-split product, before its bias, which is added
once. :meth:`TensorParallel.shard` and :meth:`TensorParallel.gather` move a
parameter dict between the full layout and a rank's share; gathered, it
equals the unsharded one.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

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


def make_parallel_train_step(step, data_parallel: Optional[DataParallel], tensor_parallel=None):
    """The step of ``make_train_step`` that ``step`` is, rebuilt with the
    collectives of ``data_parallel`` and ``tensor_parallel`` (the body is
    the same function; see the module docstring). ``step`` must come from
    ``make_train_step``."""
    from passt_tpu_torch.train.steps import make_train_step

    args, kwargs = step.build_args
    return make_train_step(*args, **dict(kwargs, data_parallel=data_parallel, tensor_parallel=tensor_parallel))


# ---------------------------------------------------------------------------
# tensor parallelism
# ---------------------------------------------------------------------------
DATA_AXIS = "data"
MODEL_AXIS = "model"

#: (regex on the JAX package's flattened param path, partition spec) — first
#: match wins; JAX kernels are (in, out) (passt_tpu/parallel/mesh.py:55-80)
TP_RULES = [
    (r"attn/qkv/kernel$", (None, MODEL_AXIS)),
    (r"attn/qkv/bias$", (MODEL_AXIS,)),
    (r"attn/proj/kernel$", (MODEL_AXIS, None)),
    (r"mlp/fc1/kernel$", (None, MODEL_AXIS)),
    (r"mlp/fc1/bias$", (MODEL_AXIS,)),
    (r"mlp/fc2/kernel$", (MODEL_AXIS, None)),
]


def param_partition_spec(path: str, tp: bool, ndim: Optional[int] = None) -> tuple:
    """The partition spec of the leaf at JAX tree ``path`` (the JAX
    package's function): a TP rule's spec, with the stack axis of a leaf one
    rank larger (``ndim``) left unsplit; ``()`` (replicated) otherwise."""
    if tp:
        for pattern, spec in TP_RULES:
            if re.search(pattern, path):
                if ndim is not None and ndim == len(spec) + 1:
                    return (None,) + spec
                return spec
    return ()


def jax_path(name: str) -> str:
    """The JAX tree path of a port parameter name (``blocks.3.attn.qkv.weight``
    -> ``blocks_3/attn/qkv/kernel``, ``blocks.block.norm1.weight`` ->
    ``blocks/block/norm1/scale``, ``head.0.weight`` -> ``head_norm/scale``;
    the names ``state_dict_from_flax`` gives)."""
    parts = name.split(".")
    if parts[0] == "blocks" and parts[1].isdigit():
        parts = [f"blocks_{parts[1]}"] + parts[2:]
    elif parts[0] == "head":
        parts = [{"0": "head_norm", "1": "head_linear"}[parts[1]]] + parts[2:]
    elif parts[0] == "pre_logits":
        parts = ["pre_logits"] + parts[2:]
    if parts[-1] == "weight":
        norm = parts[-2].startswith("norm") or parts[-2] == "head_norm"
        parts[-1] = "scale" if norm else "kernel"
    return "/".join(parts)


def shard_layout(name: str, ndim: int) -> Optional[Tuple[int, int]]:
    """How a port leaf splits over the model axis: (its axis, the number of
    interleaved groups along it), or None for a whole leaf. The axis is the
    JAX spec's, in torch orientation (a Linear weight is ``[out, in]``); qkv
    interleaves three groups (q, k, v), each split by heads."""
    spec = param_partition_spec(jax_path(name), True, ndim)
    if MODEL_AXIS not in spec:
        return None
    axis = spec.index(MODEL_AXIS)
    if name.endswith(".weight"):  # (in, out) -> (out, in): the last two swap
        axis = {ndim - 1: ndim - 2, ndim - 2: ndim - 1}.get(axis, axis)
    return axis, 3 if ".attn.qkv." in name else 1


class _CopyToModel(torch.autograd.Function):
    """The identity forward; the gradient all-reduced over the model group."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.all_reduce(g.clone()), None


class _ReduceFromModel(torch.autograd.Function):
    """The partial sums all-reduced over the model group; the identity
    backward."""

    @staticmethod
    def forward(ctx, x, tp):
        return tp.all_reduce(x.clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class TensorParallel:
    """A model rank's share of the model: ``size`` ranks in ``group`` (the
    model group of one data rank; the default group when None), this one
    ``rank`` among them. See the module docstring."""

    def __init__(self, size: int, rank: int, group=None):
        self.size = size
        self.rank = rank
        self.group = group

    def local(self, n: int, what: str) -> int:
        """This rank's share of ``n`` heads or hidden units."""
        if n % self.size:
            raise ValueError(f"{what}={n} does not divide by n_model={self.size}")
        return n // self.size

    def check_model(self, cfg) -> None:
        """Raise unless the model's heads and MLP hidden units divide by
        the model axis (a :class:`~passt_tpu_torch.models.passt.PaSSTConfig`)."""
        self.local(cfg.num_heads, "num_heads")
        self.local(int(cfg.embed_dim * cfg.mlp_ratio), "mlp_hidden")

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(t, group=self.group)
        COLLECTIVES["all_reduce"] += 1
        return t

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyToModel.apply(x, self)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return _ReduceFromModel.apply(x, self)

    def shard_one(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's share of the full leaf ``t`` (a copy), or ``t``."""
        layout = shard_layout(name, t.ndim)
        if layout is None:
            return t
        axis, groups = layout
        full = t.shape[axis]
        inner = self.local(full // groups, f"{name} axis {axis}")
        view = t.reshape(t.shape[:axis] + (groups, full // groups) + t.shape[axis + 1:])
        part = view.narrow(axis + 1, self.rank * inner, inner)
        return part.reshape(t.shape[:axis] + (groups * inner,) + t.shape[axis + 1:]).clone()

    def shard(self, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """A full parameter dict -> this rank's share of it."""
        return {k: self.shard_one(k, t) for k, t in params.items()}

    def gather(self, params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Every rank's share -> the full parameter dict, on every rank
        (collective: every model rank calls it with the same names)."""
        out = {}
        for k, t in params.items():
            layout = shard_layout(k, t.ndim)
            if layout is None:
                out[k] = t
                continue
            axis, groups = layout
            t = t.contiguous()
            parts = [torch.empty_like(t) for _ in range(self.size)]
            dist.all_gather(parts, t, group=self.group)
            COLLECTIVES["all_gather"] += 1
            inner = t.shape[axis] // groups
            views = [p.reshape(t.shape[:axis] + (groups, inner) + t.shape[axis + 1:]) for p in parts]
            full = torch.cat(views, dim=axis + 1)
            out[k] = full.reshape(t.shape[:axis] + (groups * inner * self.size,) + t.shape[axis + 1:])
        return out

    def full_shapes(self, params: Dict[str, torch.Tensor]) -> Dict[str, Tuple[Tuple[int, ...], Callable]]:
        """name -> (the full leaf's shape, full -> this rank's share) for each
        split leaf: what draws per element of the full leaf and keeps this
        rank's (stochastic rounding) needs."""
        out = {}
        for k, t in params.items():
            layout = shard_layout(k, t.ndim)
            if layout is not None:
                axis = layout[0]
                shape = t.shape[:axis] + (t.shape[axis] * self.size,) + t.shape[axis + 1:]
                out[k] = (tuple(shape), lambda full, k=k: self.shard_one(k, full))
        return out

    def global_norm(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The full gradient's global norm from this rank's share: the
        squares of split leaves summed over the model group, each whole leaf
        counted once."""
        split = [g for k, g in grads.items() if shard_layout(k, g.ndim) is not None]
        whole = [g for k, g in grads.items() if shard_layout(k, g.ndim) is None]
        sq = sum(((g * g).sum() for g in split), torch.zeros((), dtype=torch.float32, device=_device(grads)))
        sq = self.all_reduce(sq.float().reshape(1)).reshape(())
        return torch.sqrt(sq + sum((g * g).sum() for g in whole))


def _device(tensors: Dict[str, torch.Tensor]) -> torch.device:
    return next(iter(tensors.values())).device


def process_grid(world_size: int, rank: int, n_model: int):
    """The (data, model) grid of ``world_size`` ranks, as the JAX mesh's
    (n_data, n_model) device grid: rank r is data rank ``r // n_model`` and
    model rank ``r % n_model``. Forms the groups (every rank must call this,
    in the same order) and returns (n_data, data rank, model rank, data
    group, model group); without a model axis (``n_model == 1``) the data
    group is the whole world (None) and there is no model group."""
    if world_size % n_model:
        raise RuntimeError(f"trainer.n_model={n_model} does not divide the {world_size} processes")
    n_data = world_size // n_model
    data_rank, model_rank = divmod(rank, n_model)
    if n_model == 1:
        return n_data, data_rank, model_rank, None, None
    data_group = model_group = None
    for m in range(n_model):  # the data groups: one model rank across data ranks
        g = dist.new_group([d * n_model + m for d in range(n_data)])
        if m == model_rank:
            data_group = g
    for d in range(n_data):  # the model groups: one data rank's model ranks
        g = dist.new_group([d * n_model + m for m in range(n_model)])
        if d == data_rank:
            model_group = g
    return n_data, data_rank, model_rank, data_group, model_group
