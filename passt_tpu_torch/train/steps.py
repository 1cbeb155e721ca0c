"""The train and eval steps (port of passt_tpu/train/steps.py): waveform ->
train-mode log-mel -> mixup -> PaSST in train mode -> loss -> backward ->
AdamW -> parameter apply.

The JAX package jits this as one graph; here it runs eagerly, with the same
order of operations, and on a CUDA device it goes through the Hopper mel
kernel and the attention forward and backward kernels. Nothing in the step
waits on the host: the step count is a Python int, the learning rate and
bias corrections are host scalars, and every random draw comes from a
``torch.Generator`` on the batch's device, seeded on the host from
``(seed, step, stream)`` by :func:`step_generators` (the stand-in for the
JAX package's ``step_keys``), so resuming at step k reproduces the draws.

Parameters live in :class:`TrainState` as a dict of tensors keyed by the
module's parameter names; the step runs the module on them with
``torch.func.functional_call`` and returns a new state.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
from torch.func import functional_call

from passt_tpu_torch.models.passt import PaSST, PaSSTConfig, init_weights
from passt_tpu_torch.models.registry import resolve_device
from passt_tpu_torch.ops.frontend import MelConfig, log_mel_spectrogram
from passt_tpu_torch.train import losses as L
from passt_tpu_torch.train.mixup import apply_mixup, sample_mixup
from passt_tpu_torch.train import optim
from passt_tpu_torch.train.optim import (
    GradientTransformation,
    apply_updates,
    apply_updates_sr,
    cast_params_storage,
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
) -> Tuple[PaSST, TrainState]:
    """A model with random weights from ``generator`` (a CPU generator; seed
    0 when None) and its train state on ``device``. The optimizer is
    initialised on the fp32 parameters *before* the storage cast
    (``param_dtype="bfloat16_sr"``), so no moment starts nearest-rounded."""
    device = resolve_device(device)
    model = PaSST(cfg)
    init_weights(model, generator if generator is not None else torch.Generator().manual_seed(0))
    model = model.to(device)
    params = {k: p.detach() for k, p in model.named_parameters()}
    opt_state = tx.init(params)
    return model, TrainState(params=cast_params_storage(params, param_dtype), opt_state=opt_state, step=0)


def step_generators(seed: int, step: int, device) -> Dict[str, torch.Generator]:
    """The generators of one train step, one per stream of :data:`STREAMS`,
    seeded from ``(seed, step, stream)`` on the host."""
    return {name: seeded_generator(device, "step", seed, step, name) for name in STREAMS}


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
):
    """Build the train step ``step(state, batch, seed) -> (state, metrics)``.

    ``batch`` holds ``wave`` [B, T] float32 (or ``mel`` [B, 1, F, T], which
    skips the frontend) and ``target`` ([B, C] multilabel/masked, [B] int for
    single-label), on the model's device. ``seed`` is the run's base seed
    (an int); the step's draws come from :func:`step_generators` at
    ``state.step``. ``input_tdim`` crops the mel frames (the model's
    ``input_tdim`` when None). Every metric stays on the device:
    ``metrics["loss"]``, and with ``log_grad_norm`` the gradients' global
    norm ``grad_norm``, with ``log_grad_norm_per_block`` one
    ``grad_norm/<group>`` per top-level parameter group of the JAX package
    (``patch_embed``, ``blocks_0``, ..., ``head_linear``).
    """
    loss_fn = LOSS_FNS[loss_type]
    tdim = input_tdim if input_tdim is not None else model.cfg.input_tdim

    def step(state: TrainState, batch: Dict[str, torch.Tensor], seed: int):
        y = batch["target"]
        gens = step_generators(seed, state.step, y.device)
        if "mel" in batch:
            x = batch["mel"]
        else:
            mel = log_mel_spectrogram(batch["wave"], mel_cfg, generator=gens["mel"], train=True)
            x = mel[:, None, :, :tdim]

        perm = lam = None
        if use_mixup:
            perm, lam = sample_mixup(gens["mix"], x.shape[0], mixup_alpha)
            x = apply_mixup(x, perm, lam)

        leaves = {k: p.detach().requires_grad_() for k, p in state.params.items()}
        logits, _ = functional_call(
            model, leaves, (x,),
            dict(train=True, generators={k: gens[k] for k in ("patchout", "dropout", "droppath")}),
        )
        loss = loss_fn(logits, y, perm, lam)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True, materialize_grads=True)
        grads = dict(zip(leaves, grads))

        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        if param_sr:
            # bf16 storage: fp32 add, stochastically rounded store, from a
            # stream apart from the augmentation's and the optimizer's
            gen = seeded_generator(y.device, "apply_updates_sr", state.step)
            params = apply_updates_sr(state.params, updates, gen)
        else:
            params = apply_updates(state.params, updates)
        metrics = {"loss": loss.detach()}
        if log_grad_norm:
            metrics["grad_norm"] = optim.global_norm(grads.values())
        if log_grad_norm_per_block:
            groups: Dict[str, list] = {}
            for k, g in grads.items():
                groups.setdefault(_param_group(k), []).append(g)
            for group, gs in groups.items():
                metrics[f"grad_norm/{group}"] = optim.global_norm(gs)
        return TrainState(params=params, opt_state=opt_state, step=state.step + 1), metrics

    return step


def make_eval_step(
    model: PaSST,
    mel_cfg: Optional[MelConfig] = MelConfig(),
    loss_type: str = "multilabel",
    input_tdim: Optional[int] = None,
):
    """Eval step ``(params, batch) -> dict(out, loss, loss_per_example,
    features)``: ``out`` is sigmoid probabilities for multilabel/masked and
    the log-softmax for single-label. ``input_tdim`` crops the mel frames
    (the model's ``input_tdim`` when None)."""
    if loss_type not in LOSS_FNS:
        raise KeyError(f"unknown loss_type {loss_type!r}; known: {sorted(LOSS_FNS)}")
    tdim = input_tdim if input_tdim is not None else model.cfg.input_tdim

    def step(params: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor]):
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

    return step
