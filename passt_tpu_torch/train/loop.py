"""The training and eval loop (port of passt_tpu/train/loop.py, one process):
the reference's PL Trainer + ``M`` LightningModule + callbacks collapsed
into one explicit loop.

Covers (reference file:line):
- epoch loop with per-epoch sampler and augmentation reseed (trainer
  ``reload_dataloaders_every_epoch=True``, ex_audioset.py:75),
- train steps queued on the card with no per-step synchronisation: the loss
  is read (``float``) only every ``log_every_steps`` and at the epoch's
  end, and the step count is mirrored on the host; with the steps of
  ``make_train_step`` / ``make_eval_step`` at their default (``jit=True``)
  each step and eval batch is one CUDA graph replay, whose metrics and
  outputs are copies the next replay leaves alone (``pending_loss``, the
  grad norms and ``evaluate``'s ``outs`` hold them across steps), and
  whose returned state holds the train graph's own tensors (donated: the
  next step overwrites them, and the state is copied into them when it is
  not theirs, as at a resume),
- validation with per-class AP / ROC-AUC and 'allap' (ex_audioset.py:245-291),
- SWA running average on epoch boundaries + separate eval of the averaged
  weights (helpers/swa_callback.py; ex_audioset.py:231-243),
- checkpoints with keep-last-N or keep-N-best by a monitored metric
  (ModelCheckpoint at ex_audioset.py:315-319, ex_fsd50k.py:292-294) and
  resume,
- JSONL metrics logging (wandb optional).

Batches reach the card through :class:`~passt_tpu_torch.data.pipeline.DeviceFeed`
(pinned staging, a side-stream copy) on the device of the state's tensors:
the loop runs wherever the state lives and starts no other path. With
``transfer_dtype="int16"`` the feed thread quantizes the wave on the host
and the main thread dequantizes it on the card, on the consumer's stream.

Checkpoints are the port's own format (``torch.save``; the JAX package's
orbax is not on the card's machine): one file per epoch,
``<checkpoint_dir>/epoch_<e>.pt``, written to a temporary name and renamed,
holding the params, the optimizer state's leaves, the step, the epoch, the
SWA average and count, and the monitored metric.

With a ``runtime`` (``passt_tpu_torch.parallel.runtime.DDPRuntime``)
spanning processes, as in the JAX loop: each rank evaluates its slice of
the eval set and the outputs are gathered (padded to the largest count,
gathered, trimmed; a rank with no rows takes part) before the metrics, so
``allap`` is the same on every rank; a SIGTERM seen by any rank stops every
rank at the same batch (the flag is agreed on at the log cadence and at
each epoch's end); progress, logging, the spectrogram dump, checkpoint
writes and profiling run on rank 0, the other ranks waiting for each
checkpoint; and a restore reads on every rank what rank 0 wrote.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import sys
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from passt_tpu_torch.data.pipeline import DeviceFeed
from passt_tpu_torch.train.metrics import (
    masked_mean_average_precision,
    masked_roc_auc,
    mean_average_precision,
    roc_auc,
)
from passt_tpu_torch.models.pretrained import match_block_layout
from passt_tpu_torch.train.optim import map_param_dicts
from passt_tpu_torch.train.steps import TrainState, step_generators
from passt_tpu_torch.train.swa import SWAState, swa_init, swa_should_update, swa_update


class MetricsLogger:
    """JSONL + stdout metrics sink, with an optional wandb forwarder
    (the reference's primary logger is WandbLogger, ex_audioset.py:38,72;
    here wandb is optional — pass ``wandb_project`` and it activates when
    the package is importable)."""

    def __init__(
        self,
        path: Optional[str] = None,
        quiet: bool = False,
        wandb_project: Optional[str] = None,
        wandb_config: Optional[dict] = None,
    ):
        self.path = path
        self.quiet = quiet
        self._wandb = None
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            self._f = open(path, "a")
        else:
            self._f = None
        if wandb_project:
            try:
                import wandb

                self._wandb = wandb.init(project=wandb_project, config=wandb_config or {})
            except ImportError:
                print("wandb not installed; logging to JSONL/stdout only")

    def log(self, record: Dict[str, Any]) -> None:
        record = {k: (float(v) if hasattr(v, "item") else v) for k, v in record.items()}
        if self._f:
            self._f.write(json.dumps(record) + "\n")
            self._f.flush()
        if self._wandb is not None:
            self._wandb.log(record)
        if not self.quiet:
            parts = " ".join(
                f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}" for k, v in record.items()
            )
            print(parts, flush=True)

    def close(self):
        if self._f:
            self._f.close()
        if self._wandb is not None:
            self._wandb.finish()


def _check_transfer_dtype(transfer_dtype: str):
    """Shared train/eval validation of the feed transfer dtype."""
    if transfer_dtype not in ("float32", "int16"):
        raise ValueError(f"transfer_dtype must be 'float32' or 'int16', got {transfer_dtype!r}")


def _quantize_wave_int16(wave) -> np.ndarray:
    """Host-side symmetric-clip int16 quantization of a waveform batch, the
    one implementation fit() and evaluate() share (scale 32768: int16
    container values round-trip exactly; post-augment values re-quantize
    with error <= 2^-16 full scale). Runs on the feed thread; its twin
    :func:`_dequant_int16` runs on the card from the main thread."""
    q = np.multiply(np.asarray(wave, np.float32), 32768.0)
    np.rint(q, out=q)
    np.clip(q, -32768.0, 32767.0, out=q)
    return q.astype(np.int16)


def _dequant_int16(q: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * (1.0 / 32768.0)


def _device_of(params: Dict[str, torch.Tensor]) -> torch.device:
    return next(iter(params.values())).device


def _feed(loader_it, convert: Callable, device: torch.device, depth: int):
    """``DeviceFeed`` over ``loader_it`` (depth > 0), or the same transfer
    inline on the main thread (depth 0)."""
    if depth > 0:
        return DeviceFeed(loader_it, convert, device, depth=depth)

    def inline():
        for batch in loader_it:
            arrays, extra = convert(batch)
            yield {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in arrays.items()}, extra

    return inline()


def _stop_iter(it, base_it=None) -> None:
    """Release the feed thread and the wrapped prefetcher (or, with the
    inline feed, the loader's own prefetcher)."""
    if hasattr(it, "stop"):
        it.stop()
    elif base_it is not None and hasattr(base_it, "stop"):
        base_it.stop()


def _spans(runtime) -> bool:
    return runtime is not None and runtime.spans_processes


def _all_gather_np(a: np.ndarray, runtime) -> np.ndarray:
    """Every data rank's ``a`` (the same shape and dtype on every rank),
    stacked in data-rank order, through the group's backend on the rank's
    device (the model ranks of a data rank hold the same rows)."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(runtime.device)
    parts = [torch.empty_like(t) for _ in range(runtime.n_data)]
    dist.all_gather(parts, t, group=runtime.data_group)
    return np.stack([p.cpu().numpy() for p in parts])


def _gather_across_processes(out: np.ndarray, target: np.ndarray, loss: np.ndarray, runtime):
    """Concatenate every rank's eval outputs in rank order — the reference's
    DDP ``all_gather`` before 'allap' (ex_audioset.py:274-285). Ranks may
    hold different example counts (rank-sliced loaders), so each pads to the
    largest count, and the gathered rows are trimmed by the gathered counts.
    A rank with no rows cannot know the trailing shapes, yet it must enter
    every collective: the shapes are gathered too, and it sends zero rows of
    them. Everything travels as float32 (labels are small integers, exactly
    cast). The identity without a runtime spanning processes."""
    if not _spans(runtime):
        return out, target, loss
    counts = _all_gather_np(np.array([len(out)], np.int64), runtime).reshape(-1)
    m = int(counts.max())
    if m == 0:
        raise ValueError("no eval batches on any process")

    def shape_desc(a):
        return (list(a.shape[1:]) + [-1, -1])[:2] if len(a) else [-2, -2]

    descs = _all_gather_np(np.array(shape_desc(out) + shape_desc(target) + shape_desc(loss), np.int64),
                           runtime).reshape(len(counts), 3, 2)
    ref = descs[int(np.argmax(counts > 0))]

    def norm(a, r):
        if len(a):
            return np.asarray(a, np.float32)
        return np.zeros((0,) + tuple(int(x) for x in r if x >= 0), np.float32)

    def gathered(a):
        padded = np.pad(a, ((0, m - len(a)),) + ((0, 0),) * (a.ndim - 1))
        g = _all_gather_np(padded, runtime)
        return np.concatenate([g[p, : int(counts[p])] for p in range(len(counts))])

    return tuple(gathered(norm(a, r)) for a, r in zip((out, target, loss), ref))


def evaluate(
    eval_step: Callable,
    params: Dict[str, torch.Tensor],
    loader,
    limit_batches: Optional[int] = None,
    single_label: bool = False,
    masked: bool = False,
    device_prefetch: int = 2,
    transfer_dtype: str = "float32",
    runtime=None,
) -> Dict[str, float]:
    """Run the eval loader on the device of ``params`` and compute loss +
    AP/ROC (multilabel), the masked OpenMIC metrics, or accuracy
    (single-label) on the host — reference validation_epoch_end
    (ex_audioset.py:245-291; esc50 accuracy variant ex_esc50.py).

    val_loss is the mean of the per-example losses, so a ragged tail batch
    is weighted by its examples. The outputs stay on the card until the
    loader is done (one copy to the host at the end, no per-batch
    synchronisation). ``device_prefetch`` is the feed's depth (0: inline
    transfer); ``transfer_dtype="int16"`` halves the host->card bytes with
    fit()'s quantization. ``runtime`` spanning processes: ``loader`` is this
    rank's slice (possibly empty), and the metrics are those of every
    rank's outputs gathered, the same on every rank."""
    _check_transfer_dtype(transfer_dtype)
    int16 = transfer_dtype == "int16"
    device = _device_of(params)

    def convert(batch):
        wave = np.asarray(batch["wave"])
        wave = _quantize_wave_int16(wave) if int16 else wave.astype(np.float32, copy=False)
        target = np.asarray(batch["target"])
        arrays = {"wave": wave, "target": target.astype(np.int64 if single_label else np.float32)}
        return arrays, target

    outs: List[torch.Tensor] = []
    losses: List[torch.Tensor] = []
    targets: List[np.ndarray] = []
    base_it = iter(loader)
    it = _feed(base_it, convert, device, device_prefetch)
    try:
        for i, (dev_batch, host_target) in enumerate(it):
            if limit_batches is not None and i >= limit_batches:
                break
            if int16:
                dev_batch = dict(dev_batch, wave=_dequant_int16(dev_batch["wave"]))
            res = eval_step(params, dev_batch)
            n = len(host_target)
            outs.append(res["out"][:n])
            losses.append(res["loss_per_example"][:n])
            targets.append(host_target)
    finally:
        _stop_iter(it, base_it)
    if not outs and not _spans(runtime):
        raise ValueError("no eval batches (empty eval loader)")
    empty = np.zeros((0,), np.float32)  # a rank with no rows: its shapes come from the others
    out = torch.cat(outs).float().cpu().numpy() if outs else empty
    loss = torch.cat(losses).float().cpu().numpy() if outs else empty
    target = np.concatenate(targets) if outs else empty
    out, target, loss = _gather_across_processes(out, target, loss, runtime)
    metrics: Dict[str, float] = {"val_loss": float(np.mean(loss)), "n_eval": len(out)}
    if single_label:
        metrics["accuracy"] = float((out.argmax(axis=1) == target.reshape(-1)).mean())
    elif masked:
        # OpenMIC protocol: targets are [labels || observed-mask]; every
        # metric counts only observed labels per class
        k = target.shape[1] // 2
        labels, mask = (target[:, :k] > 0.5).astype(np.float64), target[:, k:]
        metrics["ap"] = masked_mean_average_precision(labels, out, mask)
        roc = masked_roc_auc(labels, out, mask)
        if np.isnan(roc):
            print("masked roc_auc undefined on this eval set; omitting 'roc'")
        else:
            metrics["roc"] = float(roc)
        metrics["allap"] = metrics["ap"]
    else:
        metrics["ap"] = mean_average_precision(target, out)
        # roc_auc marks single-sign classes NaN; when every class is
        # undefined (tiny evals) the metric is left out, not recorded as NaN
        per_class = roc_auc(target, out)
        if np.isnan(per_class).all():
            print("roc_auc undefined on this eval set (no two-class labels); omitting 'roc'")
        else:
            metrics["roc"] = float(np.nanmean(per_class))
        metrics["allap"] = metrics["ap"]  # over every rank's outputs
    return metrics


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------
_CKPT = re.compile(r"^epoch_(\d+)\.pt$")


def _ckpt_path(checkpoint_dir: str, epoch: int) -> str:
    return os.path.join(checkpoint_dir, f"epoch_{epoch}.pt")


def checkpoint_epochs(checkpoint_dir: str) -> List[int]:
    """The epochs with a checkpoint in ``checkpoint_dir``, ascending."""
    if not os.path.isdir(checkpoint_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_CKPT.match, os.listdir(checkpoint_dir)) if m)


def _load(path: str, map_location=None) -> dict:
    # mmap: reading the metrics of a checkpoint does not read its tensors
    return torch.load(path, map_location=map_location, mmap=True, weights_only=True)


def _checkpoint_metrics(checkpoint_dir: str, epoch: int) -> Optional[Dict[str, float]]:
    return _load(_ckpt_path(checkpoint_dir, epoch), "cpu").get("metrics")


class _CheckpointManager:
    """Atomic epoch checkpoints with retention: the ``keep_last_n`` latest,
    or with ``monitor`` the ``keep_last_n`` best by that metric (ties drop
    the earlier epoch first; the latest checkpoint may go when it is not
    among the best, as orbax's best-N policy does)."""

    def __init__(self, checkpoint_dir: str, keep_last_n: int, monitor: Optional[str], monitor_mode: str):
        if monitor is not None and monitor_mode not in ("max", "min"):
            raise ValueError(f"monitor_mode must be 'max' or 'min', got {monitor_mode!r}")
        self.dir = os.path.abspath(checkpoint_dir)
        os.makedirs(self.dir, exist_ok=True)
        self.keep = keep_last_n
        self.monitor = monitor
        self.mode = monitor_mode

    def latest(self) -> Optional[int]:
        epochs = checkpoint_epochs(self.dir)
        return epochs[-1] if epochs else None

    def save(self, epoch: int, payload: dict) -> None:
        path = _ckpt_path(self.dir, epoch)
        tmp = f"{path}.tmp{os.getpid()}"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        self._prune()

    def _prune(self) -> None:
        epochs = checkpoint_epochs(self.dir)
        if self.keep is None or len(epochs) <= self.keep:
            return
        if self.monitor is None:
            drop = epochs[: len(epochs) - self.keep]
        else:
            metrics = {e: _checkpoint_metrics(self.dir, e) for e in epochs}
            without = [e for e in epochs if not metrics[e] or self.monitor not in metrics[e]]
            ranked = sorted((e for e in epochs if e not in without),
                            key=lambda e: metrics[e][self.monitor], reverse=self.mode == "min")
            drop = (without + ranked)[: len(epochs) - self.keep]
        for e in drop:
            os.remove(_ckpt_path(self.dir, e))


def _resolve_monitor_metric(metrics, key):
    """Tolerant monitor lookup for best-checkpoint restore: the exact key,
    the key without a "valid_"/"eval_" prefix, or with one (the prefixes
    depend on how many eval sets the saving run had); ambiguity raises."""
    if key in metrics:
        return metrics[key]
    hits = {}
    for p in ("valid_", "eval_"):
        if key.startswith(p) and key[len(p):] in metrics:
            hits[key[len(p):]] = metrics[key[len(p):]]
        if p + key in metrics:
            hits[p + key] = metrics[p + key]
    if len(hits) == 1:
        return next(iter(hits.values()))
    if len(hits) > 1:
        raise KeyError(
            f"monitor {key!r} is ambiguous among checkpoint metrics "
            f"{sorted(hits)}; pass the fully-prefixed monitor name"
        )
    raise KeyError(f"monitor {key!r} not among checkpoint metrics {sorted(metrics)}")


def restore_checkpoint(
    checkpoint_dir: str,
    state: TrainState,
    step: Optional[int] = None,
    monitor: Optional[str] = None,
    monitor_mode: str = "max",
    runtime=None,
):
    """Restore the latest (or the given epoch's) checkpoint into a TrainState
    template, on the template's device and in its dtypes. Returns (state,
    swa_or_None, epoch) where swa is (avg_params, n_averaged), fp32.

    With ``monitor`` set (and no explicit ``step``), restores the BEST
    checkpoint by that recorded metric instead of the latest — the partner
    of fit(monitor=...)'s best retention. The template's optimizer state
    must have the structure of the saved one (the same ``moments_dtype``
    and ``grad_accum``).

    ``runtime`` spanning processes: every rank waits for the others, reads
    the checkpoint (rank 0 wrote it), and takes rank 0's tensors, so the
    ranks start from one state; under tensor parallelism the checkpoint
    holds the full state and each rank keeps its share."""
    if _spans(runtime):
        dist.barrier()
        state = runtime.gather_state(state)  # the full template
    if monitor_mode not in ("max", "min"):
        raise ValueError(f"monitor_mode must be 'max' or 'min', got {monitor_mode!r}")
    epochs = checkpoint_epochs(checkpoint_dir)
    if step is not None:
        epoch = step
    elif monitor is not None:
        scored = []
        for e in epochs:
            m = _checkpoint_metrics(checkpoint_dir, e)
            if m:
                scored.append((_resolve_monitor_metric(m, monitor), e))
        sign = 1.0 if monitor_mode == "max" else -1.0
        # the best value; among equal values the latest epoch
        epoch = max(scored, key=lambda ve: (sign * ve[0], ve[1]))[1] if scored else None
    else:
        epoch = epochs[-1] if epochs else None
    if epoch is None or epoch not in epochs:
        raise FileNotFoundError(f"no checkpoint{'' if epoch is None else f' for epoch {epoch}'} in {checkpoint_dir}")
    saved = _load(_ckpt_path(checkpoint_dir, epoch), "cpu")
    # a checkpoint of another blocks_impl: its block layout, re-laid
    names = set(state.params)
    saved_names = set(saved["params"])
    relay = match_block_layout if saved_names != names else None

    def like(tmpl: Dict[str, torch.Tensor], got: Dict[str, torch.Tensor], what: str, dtype=None):
        if relay is not None:
            got = relay(got, tmpl)
        if set(got) != set(tmpl):
            raise RuntimeError(f"checkpoint {checkpoint_dir}@{epoch}: {what} keys differ from the template's")
        return {k: got[k].to(device=t.device, dtype=dtype or t.dtype).clone() for k, t in tmpl.items()}

    params = like(state.params, saved["params"], "params")
    opt_template = state.opt_state
    if relay is not None:
        # the template's optimizer state in the saved layout, to read the
        # saved leaves into; re-laid back after
        saved_layout = relay(state.params, saved["params"])
        opt_template = map_param_dicts(state.opt_state, names, lambda d: relay(d, saved_layout))
    leaves, spec = pytree.tree_flatten(opt_template)
    got = saved["opt_state"]
    if len(got) != len(leaves) or any(
        isinstance(a, torch.Tensor) != isinstance(b, torch.Tensor)
        or (isinstance(a, torch.Tensor) and (a.shape != b.shape or a.dtype != b.dtype))
        for a, b in zip(leaves, got)
    ):
        raise RuntimeError(
            f"checkpoint {checkpoint_dir}@{epoch} does not match the current TrainState "
            "template's optimizer state: it was written under another moments_dtype or grad_accum"
        )
    opt_state = pytree.tree_unflatten(
        [b.to(a.device).clone() if isinstance(b, torch.Tensor) else b for a, b in zip(leaves, got)], spec)
    if relay is not None:
        opt_state = map_param_dicts(opt_state, saved_names, lambda d: relay(d, state.params))
    new_state = TrainState(params=params, opt_state=opt_state, step=int(saved["step"]))
    swa = None
    if saved.get("swa_params") is not None:
        swa = (like(state.params, saved["swa_params"], "swa_params", torch.float32), int(saved["swa_n"]))
    if _spans(runtime):
        new_state = runtime.replicate_state(new_state)
        if swa is not None:
            from passt_tpu_torch.parallel.mesh import replicate

            replicate(list(swa[0].values()))
            swa = (runtime.shard_params(swa[0]), swa[1])
    return new_state, swa, epoch


# ---------------------------------------------------------------------------
# fit
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class FitResult:
    state: TrainState
    swa: Optional[SWAState]
    history: List[Dict[str, float]]
    interrupted: bool = False  # Ctrl-C / SIGTERM clean exit (resume from the last epoch checkpoint)


def fit(
    *,
    train_step: Callable,
    eval_step: Callable,
    state: TrainState,
    train_loader,
    val_loader=None,
    val_loaders: Optional[Dict[str, Any]] = None,
    max_epochs: int,
    seed: int,
    swa_epoch_start: Optional[int] = None,
    swa_freq: int = 5,
    limit_train_batches: Optional[int] = None,
    limit_eval_batches: Optional[int] = None,
    eval_every: int = 1,
    log_every_steps: int = 50,
    logger: Optional[MetricsLogger] = None,
    checkpoint_dir: Optional[str] = None,
    keep_last_n: int = 1,
    monitor: Optional[str] = None,
    monitor_mode: str = "max",
    single_label: bool = False,
    masked: bool = False,
    swa_restore=None,  # (avg_params, n_averaged) from restore_checkpoint
    start_epoch: int = 0,
    lr_schedule: Optional[Callable] = None,
    dump_spectrograms: int = 0,
    mel_cfg=None,
    handle_sigterm: bool = True,
    profile_dir: Optional[str] = None,
    profile_start_step: int = 10,
    profile_num_steps: int = 5,
    device_prefetch: int = 2,
    transfer_dtype: str = "float32",
    runtime=None,
) -> FitResult:
    """Train ``max_epochs - start_epoch`` epochs of ``train_step`` on the
    device of ``state.params``; ``seed`` is the step's base seed (the JAX
    package's ``base_rng``). Each epoch: set the loader's epoch, run its
    batches (``limit_train_batches``), log every ``log_every_steps``, then
    SWA (from ``swa_epoch_start`` every ``swa_freq`` epochs), eval every
    ``eval_every`` epochs on ``val_loader`` or ``val_loaders`` (several:
    metrics prefixed "<name>_"), the epoch record, and a checkpoint.
    ``profile_dir`` writes a ``torch.profiler`` chrome trace of
    ``profile_num_steps`` steps from ``profile_start_step``, which carries
    the step's host spans and its phase marks (``passt_tpu_torch.tracing``:
    the device kernels of each phase lie between two ``trace_mark_*``
    kernels);
    ``dump_spectrograms`` saves the train-mode mel of the first steps, drawn
    from the step's own generators.

    ``runtime`` (a ``DDPRuntime`` spanning processes; ``train_step`` its
    data-parallel step): every rank runs this loop on its own loader slice;
    see the module docstring for what runs on rank 0 and what is agreed."""
    logger = logger or MetricsLogger()
    multi = _spans(runtime)
    main = not multi or runtime.is_main
    device = _device_of(state.params)
    _check_transfer_dtype(transfer_dtype)
    int16 = transfer_dtype == "int16"

    def convert(batch):
        # feed thread: host-side casts and quantization only
        wave = np.asarray(batch["wave"])
        wave = _quantize_wave_int16(wave) if int16 else wave.astype(np.float32, copy=False)
        target = np.asarray(batch["target"]).astype(np.int64 if single_label else np.float32)
        return {"wave": wave, "target": target}, None

    # One loader -> unprefixed metrics (reference ex_audioset); several ->
    # every set's metrics carry a "{name}_" prefix, like the reference's
    # FSD50K dual validation (ex_fsd50k.py:220-260).
    if val_loaders is None:
        val_loaders = {"": val_loader} if val_loader is not None else {}
    elif val_loader is not None:
        raise ValueError("pass either val_loader or val_loaders, not both")
    multi_val = len(val_loaders) > 1
    swa_state = None
    if swa_restore is not None and swa_epoch_start is not None:
        avg_params, n_avg = swa_restore
        swa_state = dataclasses.replace(swa_init(avg_params, swa_epoch_start, swa_freq), n_averaged=n_avg)
    history: List[Dict[str, float]] = []
    ckpt = None
    if checkpoint_dir:
        # monitor=None keeps the latest N epochs (reference AudioSet
        # ModelCheckpoint, ex_audioset.py:315-319); monitor="allap" etc. the
        # N best (reference FSD50K ModelCheckpoint(monitor="allap"),
        # ex_fsd50k.py:292-294)
        ckpt = _CheckpointManager(checkpoint_dir, keep_last_n, monitor, monitor_mode)

    interrupted = False
    # SIGTERM -> clean preemption exit: the handler only sets a flag, which
    # the batch loop honours at the next batch boundary (during eval or a
    # checkpoint, at the epoch's end)
    stop = {"sig": None}

    def stop_agreed(collective_point: bool) -> bool:
        """One stop decision for every rank. One process: the flag, at every
        batch. Several: ranks may see a SIGTERM at different batches, and a
        rank that leaves mid-epoch blocks the others in the next step's
        collectives, so the flag is combined (any rank's) at the log cadence
        and the epoch's end only, where every rank reaches the same point."""
        if not multi:
            return stop["sig"] is not None
        if not collective_point:
            return False
        flag = torch.tensor([0 if stop["sig"] is None else 1], dtype=torch.int32, device=runtime.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        if int(flag.item()):
            stop["sig"] = stop["sig"] or -1  # this rank follows the agreement
            return True
        return False

    prev_sigterm = None
    if handle_sigterm:
        import signal

        def on_sigterm(signum, frame):
            # flag only: print() can raise if the signal lands mid-write
            stop["sig"] = signum
            os.write(2, b"SIGTERM: finishing current phase, then exiting cleanly (resumable)\n")

        try:
            prev_sigterm = signal.signal(signal.SIGTERM, on_sigterm)
        except ValueError:  # not the main thread
            prev_sigterm = None
    prof = None
    prof_done = False  # one-shot, at the first step >= profile_start_step
    prof_start = profile_start_step
    show_progress = sys.stdout.isatty() and main
    host_step = int(state.step)  # the step count, mirrored without a device read
    train_it = base_it = None
    try:
        for epoch in range(start_epoch, max_epochs):
            t_epoch = time.time()
            t_window = t_epoch
            n_batches = 0
            pending_loss = None
            progress_tail = ""
            try:
                train_loader.set_epoch(epoch)
                base_it = iter(train_loader)
                train_it = _feed(base_it, convert, device, device_prefetch)
                for i, (dev_batch, _) in enumerate(train_it):
                    if stop_agreed(i % log_every_steps == 0):
                        _stop_iter(train_it, base_it)
                        raise KeyboardInterrupt  # the same clean exit as Ctrl-C
                    if limit_train_batches is not None and i >= limit_train_batches:
                        _stop_iter(train_it, base_it)
                        break
                    if profile_dir and main and prof is None and not prof_done and host_step >= profile_start_step:
                        from torch.profiler import ProfilerActivity, profile

                        activities = [ProfilerActivity.CPU]
                        if device.type == "cuda":
                            activities.append(ProfilerActivity.CUDA)
                        prof = profile(activities=activities)
                        prof.start()
                        prof_start = host_step
                    if int16:
                        # main thread, the consumer's stream
                        dev_batch = dict(dev_batch, wave=_dequant_int16(dev_batch["wave"]))
                    if dump_spectrograms and main and host_step < dump_spectrograms and mel_cfg is not None:
                        # the train step's own mel generator for this step
                        # (rank 0's rows are the global batch's first)
                        from passt_tpu_torch.ops.frontend import log_mel_spectrogram

                        gen = step_generators(seed, host_step, device)["mel"]
                        b = len(dev_batch["wave"])
                        rows = (0, b * runtime.n_data) if multi else None
                        with torch.no_grad():
                            mel_img = log_mel_spectrogram(dev_batch["wave"], mel_cfg, generator=gen, train=True,
                                                          rows=rows)
                        out_dir = checkpoint_dir or "."
                        os.makedirs(out_dir, exist_ok=True)
                        np.save(os.path.join(out_dir, f"spectrograms_step{host_step}.npy"),
                                mel_img.float().cpu().numpy())
                    state, metrics = train_step(state, dev_batch, seed)
                    host_step += 1
                    n_batches += 1
                    pending_loss = metrics["loss"]
                    if prof is not None and host_step >= prof_start + profile_num_steps:
                        if device.type == "cuda":
                            torch.cuda.synchronize(device)
                        prof.stop()
                        os.makedirs(profile_dir, exist_ok=True)
                        prof.export_chrome_trace(os.path.join(profile_dir, f"trace_step{prof_start}.json"))
                        prof, prof_done = None, True
                    if (i + 1) % log_every_steps == 0:
                        now = time.time()
                        row = {"epoch": epoch, "step": host_step, "loss": float(pending_loss)}
                        row["it_per_s"] = round(log_every_steps / max(now - t_window, 1e-9), 3)
                        t_window = now
                        for k, v in metrics.items():  # extra step metrics (grad norms)
                            if k != "loss":
                                row[k] = float(v)
                        if show_progress:
                            print("\r\x1b[K", end="")
                        if main:
                            logger.log(row)
                        progress_tail = f"loss {row['loss']:.4f} {row['it_per_s']:.2f} it/s"
                    elif show_progress:
                        total = len(train_loader) if hasattr(train_loader, "__len__") else "?"
                        print(f"\repoch {epoch} [{i + 1}/{total}] "
                              + (progress_tail if n_batches > log_every_steps else "warmup"),
                              end="", flush=True)
            except KeyboardInterrupt:
                # mid-epoch state is not checkpointed: epoch checkpoints are
                # the resume points (the per-epoch reseed makes a mid-epoch
                # resume ill-defined)
                interrupted = True
                kept = None if ckpt is None else ckpt.latest()
                print("interrupted: exiting cleanly "
                      + (f"(resume from epoch checkpoint {kept})" if kept is not None
                         else "(no checkpoint_dir / no completed epoch)"))
                break

            if show_progress:
                print("\r\x1b[K", end="")
            epoch_time = time.time() - t_epoch
            record: Dict[str, float] = {"epoch": epoch, "step": host_step,
                                        "epoch_time_s": round(epoch_time, 2)}
            if n_batches:
                record["it_per_s"] = round(n_batches / max(epoch_time, 1e-9), 3)
            if pending_loss is not None:
                record["train_loss"] = float(pending_loss)
            if lr_schedule is not None:
                record["lr"] = float(lr_schedule(host_step))

            # SWA (helpers/swa_callback.py semantics: end of epoch e here ==
            # start of epoch e+1 there). The average is made at the first
            # epoch SWA fires, not before: no fp32 copy of the params lives
            # through the pre-SWA epochs.
            if swa_epoch_start is not None:
                cadence = SWAState(avg_params=None, n_averaged=0, swa_epoch_start=swa_epoch_start,
                                   swa_freq=swa_freq)
                if swa_should_update(swa_state if swa_state is not None else cadence, epoch, max_epochs):
                    if swa_state is None:
                        swa_state = swa_init(state.params, swa_epoch_start, swa_freq)
                    swa_state = swa_update(swa_state, state.params)
                    record["swa_n"] = swa_state.n_averaged

            if val_loaders and (epoch + 1) % eval_every == 0:
                for set_name, loader in val_loaders.items():
                    pre = f"{set_name}_" if (multi_val and set_name) else ""
                    em = evaluate(eval_step, state.params, loader, limit_eval_batches, single_label, masked,
                                  device_prefetch=device_prefetch, transfer_dtype=transfer_dtype, runtime=runtime)
                    record.update({f"{pre}{k}": v for k, v in em.items()})
                    if swa_state is not None and swa_state.n_averaged > 0:
                        sm = evaluate(eval_step, swa_state.avg_params, loader, limit_eval_batches, single_label,
                                      masked, device_prefetch=device_prefetch, transfer_dtype=transfer_dtype,
                                      runtime=runtime)
                        record.update({f"{pre}swa_{k}": v for k, v in sm.items()})

            if main:
                logger.log(record)
            history.append(record)

            if ckpt is not None:
                if monitor is not None and monitor not in record:
                    if bool(val_loaders) and (epoch + 1) % eval_every == 0:
                        # eval ran and still no such key: the name can never
                        # match, and a run would write no checkpoint at all
                        raise ValueError(
                            f"trainer.monitor={monitor!r} not found in the epoch record although eval ran; "
                            f"available metric keys: {sorted(record)}")
                    # best-metric retention needs the metric: epochs that ran
                    # no eval are not checkpointed
                    print(f"checkpoint skipped at epoch {epoch}: monitored metric {monitor!r} not in this "
                          "epoch's record (no eval ran)")
                else:
                    # the full state: under tensor parallelism every rank
                    # gathers its shares, and rank 0 writes
                    full = runtime.gather_state(state) if multi else state
                    swa_params = None if swa_state is None else swa_state.avg_params
                    if multi and swa_params is not None:
                        swa_params = runtime.gather_params(swa_params)
                    if main:
                        ckpt.save(epoch, {
                            "epoch": epoch,
                            "step": host_step,
                            "params": full.params,
                            "opt_state": pytree.tree_flatten(full.opt_state)[0],
                            "swa_params": swa_params,
                            "swa_n": 0 if swa_state is None else swa_state.n_averaged,
                            "metrics": {} if monitor is None else {monitor: float(record[monitor])},
                        })
                if multi:
                    dist.barrier()  # the other ranks go on once rank 0's checkpoint is on disk

            if stop_agreed(True):
                # SIGTERM landed during eval/checkpoint: this epoch is
                # complete and checkpointed
                interrupted = True
                print(f"preempted: exiting cleanly after completed epoch {epoch}")
                break
    finally:
        if train_it is not None:
            try:  # a no-op on an exhausted feed
                _stop_iter(train_it, base_it)
            except Exception:
                pass
        if prof is not None:  # the run ended inside the profile window
            prof.stop()
            os.makedirs(profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(profile_dir, f"trace_step{prof_start}.json"))
        if profile_dir and main and not prof_done and prof is None:
            print(f"profile_dir was set but the profile window never fired (run ended before step "
                  f"{profile_start_step})")
        if prev_sigterm is not None:
            import signal

            signal.signal(signal.SIGTERM, prev_sigterm)
    return FitResult(state=state, swa=swa_state, history=history, interrupted=interrupted)
