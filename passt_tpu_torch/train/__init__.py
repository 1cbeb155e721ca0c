"""Training of the port: the train and eval steps, losses, mixup, schedules
and the AdamW variants (port of passt_tpu/train, the step and what it
calls; the loop, SWA, metrics and gradient accumulation are queued in
ROADMAP.md)."""

from passt_tpu_torch.train.losses import masked_bce_loss, multilabel_loss, single_label_mixup_loss
from passt_tpu_torch.train.mixup import apply_mixup, sample_mixup
from passt_tpu_torch.train.optim import (
    adamw,
    adamw_bf16sr,
    apply_updates,
    apply_updates_sr,
    cast_params_storage,
)
from passt_tpu_torch.train.schedules import get_scheduler_lambda, make_lr_schedule
from passt_tpu_torch.train.steps import (
    TrainState,
    create_train_state,
    make_eval_step,
    make_optimizer,
    make_schedule,
    make_train_step,
    step_generators,
)

__all__ = [
    "TrainState",
    "adamw",
    "adamw_bf16sr",
    "apply_mixup",
    "apply_updates",
    "apply_updates_sr",
    "cast_params_storage",
    "create_train_state",
    "get_scheduler_lambda",
    "make_eval_step",
    "make_lr_schedule",
    "make_optimizer",
    "make_schedule",
    "make_train_step",
    "masked_bce_loss",
    "multilabel_loss",
    "sample_mixup",
    "single_label_mixup_loss",
    "step_generators",
]
