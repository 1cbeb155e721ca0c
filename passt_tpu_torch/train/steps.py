"""The train and eval steps (port of passt_tpu/train/steps.py): waveform ->
train-mode log-mel -> mixup -> PaSST in train mode -> loss -> backward ->
AdamW -> parameter apply.

The JAX package jits this as one graph (with the state donated); here one
body, in the same order of operations, runs as CUDA graphs on a CUDA device
(``passt_tpu_torch.graphs``, ``jit=True``, the default) or eagerly
(``jit=False``, or on the CPU), and on the card it goes through the Hopper
mel kernel and the attention forward and backward kernels. Nothing in the
step waits on the host: the step count is a Python int, and what the body
reads from the host (:class:`StepInputs`) is set before each call: the
optimizer's learning rate, bias corrections and divisor as 0-d fp32 tensors
on the device, and one persistent ``torch.Generator`` per random stream,
reseeded from ``(seed, step, stream)`` (the stand-in for the JAX package's
``step_keys``; :func:`step_generators` makes the same generators anew), so
resuming at step k reproduces the draws.

Parameters live in :class:`TrainState` as a dict of tensors keyed by the
module's parameter names; the step runs the module on them with
``torch.func.functional_call`` and returns a new state.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.func import functional_call
from torch.utils import _pytree as pytree

from passt_tpu_torch import graphs
from passt_tpu_torch.models.passt import PaSST, PaSSTConfig, init_weights
from passt_tpu_torch.models.registry import resolve_device
from passt_tpu_torch.ops.frontend import MelConfig, log_mel_spectrogram
from passt_tpu_torch.train import losses as L
from passt_tpu_torch.train.mixup import apply_mixup, apply_mixup_rows, sample_mixup
from passt_tpu_torch.train import optim
from passt_tpu_torch.train.optim import (
    GradientTransformation,
    apply_updates,
    apply_updates_sr,
    cast_params_storage,
    fold_seed,
    seeded_generator,
)
from passt_tpu_torch.train.schedules import get_scheduler_lambda, make_lr_schedule

#: the per-step random streams, in the JAX package's ``step_keys`` order
STREAMS = ("mel", "mix", "patchout", "dropout", "droppath")


@dataclasses.dataclass
class TrainState:
    params: Dict[str, torch.Tensor]
    opt_state: object
    step: int  # steps taken; a host int, so reading it never waits on the card


def make_schedule(
    lr: float = 0.00002,
    steps_per_epoch: int = 1000,
    schedule_mode: str = "exp_lin",
    warm_up_len: int = 5,
    ramp_down_start: int = 50,
    ramp_down_len: int = 50,
    last_lr_value: float = 0.01,
) -> Callable[[int], float]:
    """The step -> lr schedule :func:`make_optimizer` uses."""
    epoch_fn = get_scheduler_lambda(warm_up_len, ramp_down_start, ramp_down_len, last_lr_value, schedule_mode)
    return make_lr_schedule(lr, epoch_fn, steps_per_epoch)


def make_optimizer(
    lr: float = 0.00002,
    weight_decay: float = 0.0001,
    steps_per_epoch: int = 1000,
    schedule_mode: str = "exp_lin",
    warm_up_len: int = 5,
    ramp_down_start: int = 50,
    ramp_down_len: int = 50,
    last_lr_value: float = 0.01,
    adamw: bool = True,
    moments_dtype: Optional[str] = None,
    grad_accum: int = 1,
) -> GradientTransformation:
    """AdamW(lr=2e-5, wd=1e-4) with the warmup + linear-down epoch schedule;
    weight decay applies to every parameter, as in the reference.

    ``moments_dtype``: None keeps both moments in the parameters' dtype
    (optax AdamW), "bfloat16" stores the first moment in bf16,
    "bfloat16_sr" stores both in bf16 with a stochastically rounded second
    (:func:`adamw_bf16sr`). ``adamw=False`` drops the weight decay (Adam).
    ``grad_accum=K`` wraps the optimizer in :func:`optim.multi_steps`: K
    micro-batch gradients average into one update, and the inner schedule,
    indexed by update count u, reads the step schedule at u·K, so the
    learning rate against the epoch is the unaccumulated run's for any K.
    """
    schedule = make_schedule(lr, steps_per_epoch, schedule_mode, warm_up_len, ramp_down_start,
                             ramp_down_len, last_lr_value)
    if grad_accum > 1:
        base_schedule = schedule
        schedule = lambda u: base_schedule(u * grad_accum)  # noqa: E731
    wd = weight_decay if adamw else 0.0
    if moments_dtype == "bfloat16_sr":
        tx = optim.adamw_bf16sr(schedule, weight_decay=wd)
    elif moments_dtype in (None, "bfloat16"):
        tx = optim.adamw(schedule, weight_decay=wd, mu_dtype=torch.bfloat16 if moments_dtype else None)
    else:
        raise ValueError(f"unknown moments_dtype {moments_dtype!r}; known: None, bfloat16, bfloat16_sr")
    if grad_accum > 1:
        tx = optim.multi_steps(tx, grad_accum)
    return tx


def create_train_state(
    cfg: PaSSTConfig,
    tx: GradientTransformation,
    generator: Optional[torch.Generator] = None,
    param_dtype: Optional[str] = None,
    device="cuda",
    checkpoint_path: Optional[str] = None,
) -> Tuple[PaSST, TrainState]:
    """A model with random weights from ``generator`` (a CPU generator; seed
    0 when None), then the weights of ``checkpoint_path`` when given (an
    ``.npz`` of '/'-joined keys, :func:`~passt_tpu_torch.models.pretrained.load_pretrained`),
    and its train state on ``device``. The optimizer is initialised on
    those fp32 parameters *before* the storage cast
    (``param_dtype="bfloat16_sr"``), so no moment starts from random or
    nearest-rounded tensors."""
    device = resolve_device(device)
    model = PaSST(cfg)
    init_weights(model, generator if generator is not None else torch.Generator().manual_seed(0))
    if checkpoint_path is not None:
        from passt_tpu_torch.models.pretrained import load_pretrained

        load_pretrained(model, checkpoint_path)
    model = model.to(device)
    params = {k: p.detach() for k, p in model.named_parameters()}
    opt_state = tx.init(params)
    return model, TrainState(params=cast_params_storage(params, param_dtype), opt_state=opt_state, step=0)


def step_generators(seed: int, step: int, device) -> Dict[str, torch.Generator]:
    """The generators of one train step, one per stream of :data:`STREAMS`,
    seeded from ``(seed, step, stream)`` on the host: new ones, with the
    seeds the step's own generators take at that step."""
    return {name: seeded_generator(device, *parts) for name, parts in _stream_seeds(seed, step).items()}


def _stream_seeds(seed: int, step: int) -> Dict[str, tuple]:
    return {name: ("step", seed, step, name) for name in STREAMS}


class StepInputs:
    """What a step reads besides its state and batch, on the step's device:
    the optimizer's per-update scalars as 0-d fp32 tensors and one
    persistent generator per random stream. :meth:`refresh` sets them on
    the host before each call, so an eager call and a graph replay read the
    same values; a step's draws stay a function of ``(seed, step, stream)``.
    """

    def __init__(self, device):
        self.device = torch.device(device)
        self.scalars: Dict[str, torch.Tensor] = {}
        self.generators: Dict[str, torch.Generator] = {}

    def refresh(self, scalars: Dict[str, float], seeds: Dict[str, tuple]) -> None:
        for name, value in scalars.items():
            if name not in self.scalars:
                self.scalars[name] = torch.zeros((), dtype=torch.float32, device=self.device)
            self.scalars[name].fill_(value)
        for name, parts in seeds.items():
            if name not in self.generators:
                self.generators[name] = torch.Generator(device=self.device)
            self.generators[name].manual_seed(fold_seed(*parts))

    def optimizer(self) -> Dict[str, object]:
        """The ``inputs`` of the optimizer's update."""
        return {**self.scalars, **self.generators}


LOSS_FNS: Dict[str, Callable] = {
    "multilabel": L.multilabel_loss,  # AudioSet / FSD50K
    "single_label": L.single_label_mixup_loss,  # ESC-50
    "masked": L.masked_bce_loss,  # OpenMIC
}


def _param_group(name: str) -> str:
    """The JAX package's top-level parameter group of a port parameter name
    (``blocks.3.attn.qkv.weight`` -> ``blocks_3``; the inverse of the
    grouping ``state_dict_from_flax`` reads)."""
    parts = name.split(".")
    if parts[0] == "blocks":
        return f"blocks_{parts[1]}"
    if parts[0] == "head":
        return {"0": "head_norm", "1": "head_linear"}[parts[1]]
    return parts[0]


def make_train_step(
    model: PaSST,
    tx: GradientTransformation,
    mel_cfg: Optional[MelConfig] = MelConfig(),
    loss_type: str = "multilabel",
    use_mixup: bool = True,
    mixup_alpha: float = 0.3,
    input_tdim: Optional[int] = None,
    log_grad_norm: bool = False,
    log_grad_norm_per_block: bool = False,
    param_sr: bool = False,
    donate: bool = True,
    jit: bool = True,
    data_parallel=None,
):
    """Build the train step ``step(state, batch, seed) -> (state, metrics)``.

    ``batch`` holds ``wave`` [B, T] float32 (or ``mel`` [B, 1, F, T], which
    skips the frontend) and ``target`` ([B, C] multilabel/masked, [B] int for
    single-label), on the model's device. ``seed`` is the run's base seed
    (an int); the step's draws come from its generators seeded from
    ``(seed, state.step, stream)`` (:func:`step_generators` makes the same).
    ``input_tdim`` crops the mel frames (the model's ``input_tdim`` when
    None). Every metric stays on the device: ``metrics["loss"]``, and with
    ``log_grad_norm`` the gradients' global norm ``grad_norm``, with
    ``log_grad_norm_per_block`` one ``grad_norm/<group>`` per top-level
    parameter group of the JAX package (``patch_embed``, ``blocks_0``, ...,
    ``head_linear``).

    ``jit`` (the JAX step's switch): on a CUDA device the step runs as CUDA
    graphs (``passt_tpu_torch.graphs``), one per batch signature and
    optimizer branch; ``jit=False``, or a CPU batch, runs it eagerly. Both
    run one body. ``donate`` (the JAX step's ``donate_argnums=(0,)``): the
    graph writes the new parameters and optimizer state into its own state
    tensors, and the returned state holds them, so the step's next call
    overwrites them, as a donated buffer is consumed. A state whose tensors
    are not the graph's (fresh, restored, averaged) is copied in first.
    ``donate=False`` returns copies and leaves every state as it was.

    ``data_parallel`` (a :class:`passt_tpu_torch.parallel.mesh.DataParallel`,
    the JAX package's ``make_parallel_train_step``): the batch is this rank's
    rows of the global batch, and the step computes the step over the
    global batch: the per-example draws at the global batch (each rank
    keeps its rows), mixup over the all-gathered batch and targets, and the
    gradients and the loss averaged by one all-reduce of one flat buffer
    before the optimizer (under ``grad_accum``, the gradient mean once an
    update, unless grad norms are logged, which need the global gradient
    each micro-step). The metrics are the global ones, and every rank's
    new state is the same, bit for bit.
    """
    loss_fn = LOSS_FNS[loss_type]
    tdim = input_tdim if input_tdim is not None else model.cfg.input_tdim

    dp = data_parallel
    log_norms = log_grad_norm or log_grad_norm_per_block

    def body(params, opt_state, batch: Dict[str, torch.Tensor], inputs: StepInputs):
        """One step on tensors: (params, opt_state, metrics)."""
        gens = inputs.generators
        y = batch["target"]
        b = y.shape[0]
        rows = None if dp is None else dp.rows(b)
        if "mel" in batch:
            x = batch["mel"]
        else:
            mel = log_mel_spectrogram(batch["wave"], mel_cfg, generator=gens["mel"], train=True, rows=rows)
            x = mel[:, None, :, :tdim]

        perm = lam = loss_rows = None
        if use_mixup:
            if dp is None:
                perm, lam = sample_mixup(gens["mix"], b, mixup_alpha)
                x = apply_mixup(x, perm, lam)
            else:
                # the partners of a global permutation live on other ranks
                start, total = rows
                perm, lam = sample_mixup(gens["mix"], total, mixup_alpha)
                loss_rows = slice(start, start + b)
                x = apply_mixup_rows(dp.gather_rows(x), perm, lam, loss_rows)
                y = dp.gather_rows(y)

        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        logits, _ = functional_call(
            model, leaves, (x,),
            dict(train=True, generators={k: gens[k] for k in ("patchout", "dropout", "droppath")}, rows=rows),
        )
        loss = loss_fn(logits, y, perm, lam, rows=loss_rows)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True, materialize_grads=True)
        grads = dict(zip(leaves, grads))
        loss = loss.detach()

        opt_inputs = inputs.optimizer()
        if dp is not None:
            if isinstance(opt_state, optim.MultiStepsState) and not log_norms:
                # the gradient mean is reduced once an update, inside multi_steps
                _, (loss,) = dp.all_reduce_mean({}, [loss])
                opt_inputs["reduce_grads"] = lambda acc: dp.all_reduce_mean(acc)[0]
            else:
                grads, (loss,) = dp.all_reduce_mean(grads, [loss])

        updates, opt_state = tx.update(grads, opt_state, params, opt_inputs)
        if param_sr:
            # bf16 storage: fp32 add, stochastically rounded store, from a
            # stream apart from the augmentation's and the optimizer's
            params = apply_updates_sr(params, updates, gens["apply_updates_sr"])
        else:
            params = apply_updates(params, updates)
        metrics = {"loss": loss}
        if log_grad_norm:
            metrics["grad_norm"] = optim.global_norm(grads.values())
        if log_grad_norm_per_block:
            groups: Dict[str, list] = {}
            for k, g in grads.items():
                groups.setdefault(_param_group(k), []).append(g)
            for group, gs in groups.items():
                metrics[f"grad_norm/{group}"] = optim.global_norm(gs)
        return params, opt_state, metrics

    runners: Dict[torch.device, _TrainRunner] = {}

    def step(state: TrainState, batch: Dict[str, torch.Tensor], seed: int):
        device = batch["target"].device
        if device not in runners:
            runners[device] = _TrainRunner(body, tx, device, graphed=jit, donate=donate)
        seeds = _stream_seeds(seed, state.step)
        if param_sr:
            seeds["apply_updates_sr"] = ("apply_updates_sr", state.step)
        return runners[device](state, batch, seeds)

    # what make_parallel_train_step rebuilds the step from
    step.build_args = (
        (model, tx, mel_cfg),
        dict(loss_type=loss_type, use_mixup=use_mixup, mixup_alpha=mixup_alpha, input_tdim=input_tdim,
             log_grad_norm=log_grad_norm, log_grad_norm_per_block=log_grad_norm_per_block, param_sr=param_sr,
             donate=donate, jit=jit, data_parallel=data_parallel),
    )
    return step


def _with_tensors(tree, tensors):
    """``tree`` with its tensor leaves replaced, in order, by ``tensors``."""
    leaves, spec = pytree.tree_flatten(tree)
    it = iter(tensors)
    return pytree.tree_unflatten([next(it) if isinstance(x, torch.Tensor) else x for x in leaves], spec)


class _TrainRunner:
    """Runs the step body on one device, eagerly or as CUDA graphs (a
    :class:`~passt_tpu_torch.graphs.GraphCache` keyed on the batch
    signature and the optimizer's branch)."""

    def __init__(self, body, tx: GradientTransformation, device: torch.device, graphed: bool, donate: bool):
        self.body, self.tx, self.donate = body, tx, donate
        self.inputs = StepInputs(device)
        self.cache = None
        if graphed and graphs.graph_type(device) is not None:
            self.cache = graphs.GraphCache(self._graphed_body, generators=self.inputs.generators)
        self._opt_state = None  # the optimizer state of the call being run (its counts)

    def __call__(self, state: TrainState, batch: Dict[str, torch.Tensor], seeds: Dict[str, tuple]):
        plan = self.tx.plan(state.opt_state)
        self.inputs.refresh(plan.scalars, dict(seeds, **plan.seeds))
        if self.cache is None:
            params, opt_state, metrics = self.body(state.params, state.opt_state, batch, self.inputs)
            return TrainState(params=params, opt_state=opt_state, step=state.step + 1), metrics
        self._opt_state = state.opt_state
        opt_tensors = [x for x in pytree.tree_leaves(state.opt_state) if isinstance(x, torch.Tensor)]
        metrics, (params, opt_tensors, _) = self.cache(state.params, opt_tensors, batch, key=plan.branch)
        if not self.donate:
            params = {k: p.clone() for k, p in params.items()}
            opt_tensors = [t.clone() for t in opt_tensors]
        return TrainState(params=dict(params), opt_state=_with_tensors(plan.after, opt_tensors),
                          step=state.step + 1), metrics

    def _graphed_body(self, params, opt_tensors, batch):
        """The body on the cache's state tensors, with the new parameters and
        optimizer state written back into them (donation); returns the
        metrics."""
        opt_state = _with_tensors(self._opt_state, opt_tensors)
        new_params, new_opt, metrics = self.body(params, opt_state, batch, self.inputs)
        new_opt_tensors = [x for x in pytree.tree_leaves(new_opt) if isinstance(x, torch.Tensor)]
        pairs = [(d, s) for d, s in zip(list(params.values()) + list(opt_tensors),
                                        list(new_params.values()) + new_opt_tensors) if d is not s]
        for d, s in pairs:
            if d.shape != s.shape or d.dtype != s.dtype:
                raise RuntimeError(f"the step changed a state tensor's shape or dtype: {tuple(d.shape)} "
                                   f"{d.dtype} -> {tuple(s.shape)} {s.dtype}")
        if pairs:
            with torch.no_grad():
                torch._foreach_copy_([d for d, _ in pairs], [s for _, s in pairs])
        return metrics


def make_eval_step(
    model: PaSST,
    mel_cfg: Optional[MelConfig] = MelConfig(),
    loss_type: str = "multilabel",
    input_tdim: Optional[int] = None,
    jit: bool = True,
):
    """Eval step ``(params, batch) -> dict(out, loss, loss_per_example,
    features)``: ``out`` is sigmoid probabilities for multilabel/masked and
    the log-softmax for single-label. ``input_tdim`` crops the mel frames
    (the model's ``input_tdim`` when None). ``jit``: on a CUDA device the
    step runs as CUDA graphs, one per batch signature and per set of
    ``params`` (read in place, by identity); the outputs are copies the
    next call leaves alone. ``jit=False``, or a CPU batch, runs it
    eagerly."""
    if loss_type not in LOSS_FNS:
        raise KeyError(f"unknown loss_type {loss_type!r}; known: {sorted(LOSS_FNS)}")
    tdim = input_tdim if input_tdim is not None else model.cfg.input_tdim

    def body(batch: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor]):
        with torch.inference_mode():
            if "mel" in batch:
                x = batch["mel"]
            else:
                x = log_mel_spectrogram(batch["wave"], mel_cfg, train=False)[:, None, :, :tdim]
            logits, features = functional_call(model, params, (x,), dict(train=False))
            y = batch["target"]
            if loss_type == "single_label":
                loss_pe = L.softmax_ce(logits, y)
                out = torch.log_softmax(logits, dim=-1)
            elif loss_type == "masked":
                k = y.shape[1] // 2
                yb = (y[:, :k] > 0.5).to(logits.dtype)
                loss_pe = (y[:, k:] * L.bce_with_logits(logits, yb)).mean(dim=1)
                out = torch.sigmoid(logits)
            else:
                loss_pe = L.bce_with_logits(logits, y).mean(dim=1)
                out = torch.sigmoid(logits)
            return {"out": out, "loss": loss_pe.mean(), "loss_per_example": loss_pe, "features": features}

    if not jit:
        return lambda params, batch: body(batch, params)
    cache = graphs.GraphCache(body)
    return lambda params, batch: cache(batch, graphs.InPlace(params))[0]
