"""Training of the port (port of passt_tpu/train): the train and eval
steps, losses, mixup, schedules, the AdamW variants and gradient
accumulation, the metrics, SWA, and the loop (``evaluate``, ``fit``,
checkpoints) in one process; the multi-process parts of the loop come with
the port's DDP (ROADMAP.md)."""

from passt_tpu_torch.train.losses import masked_bce_loss, multilabel_loss, single_label_mixup_loss
from passt_tpu_torch.train.mixup import apply_mixup, sample_mixup
from passt_tpu_torch.train.optim import (
    adamw,
    adamw_bf16sr,
    apply_updates,
    apply_updates_sr,
    cast_params_storage,
    multi_steps,
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
from passt_tpu_torch.train.swa import SWAState, swa_init, swa_should_update, swa_update
from passt_tpu_torch.train.metrics import average_precision, mean_average_precision, roc_auc
from passt_tpu_torch.train.loop import FitResult, MetricsLogger, evaluate, fit, restore_checkpoint

__all__ = [
    "FitResult",
    "MetricsLogger",
    "SWAState",
    "TrainState",
    "adamw",
    "adamw_bf16sr",
    "apply_mixup",
    "apply_updates",
    "apply_updates_sr",
    "average_precision",
    "cast_params_storage",
    "create_train_state",
    "evaluate",
    "fit",
    "get_scheduler_lambda",
    "make_eval_step",
    "make_lr_schedule",
    "make_optimizer",
    "make_schedule",
    "make_train_step",
    "masked_bce_loss",
    "mean_average_precision",
    "multi_steps",
    "multilabel_loss",
    "restore_checkpoint",
    "roc_auc",
    "sample_mixup",
    "single_label_mixup_loss",
    "step_generators",
    "swa_init",
    "swa_should_update",
    "swa_update",
]
