"""Training losses for the four recipes (port of passt_tpu/train/losses.py).

- AudioSet / FSD50K: multilabel BCE-with-logits against (optionally mixed)
  targets, mean-reduced.
- ESC-50: single-label cross-entropy; under mixup the lambda-weighted sum of
  two CE terms against the two integer labels.
- OpenMIC: targets are K labels + K observed-mask columns; BCE times the
  mask, mean-reduced. The reference applies the *un-mixed* mask under mixup;
  ``mix_masks=True`` opts into the OR-merged mask.
"""

from __future__ import annotations

from typing import Optional

import torch


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross entropy with logits (the numerically stable
    formulation)."""
    return torch.clamp(logits, min=0.0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def softmax_ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-sample cross entropy for integer labels [B]."""
    logp = torch.log_softmax(logits, dim=-1)
    return -logp.gather(-1, labels[:, None].long())[:, 0]


def multilabel_loss(
    logits: torch.Tensor,
    targets: torch.Tensor,
    perm: Optional[torch.Tensor] = None,
    lam: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """AudioSet/FSD50K loss; with mixup (perm, lam) the targets are blended
    as the inputs were."""
    if perm is not None:
        targets = targets * lam[:, None] + targets[perm] * (1.0 - lam[:, None])
    return bce_with_logits(logits, targets).mean()


def single_label_mixup_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    perm: Optional[torch.Tensor] = None,
    lam: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """ESC-50 loss."""
    if perm is None:
        return softmax_ce(logits, labels).mean()
    return (
        softmax_ce(logits, labels) * lam + softmax_ce(logits, labels[perm]) * (1.0 - lam)
    ).mean()


def masked_bce_loss(
    logits: torch.Tensor,
    targets_with_mask: torch.Tensor,
    perm: Optional[torch.Tensor] = None,
    lam: Optional[torch.Tensor] = None,
    mix_masks: bool = False,
) -> torch.Tensor:
    """OpenMIC loss: ``targets_with_mask`` is [B, 2K] = labels || mask.
    Labels are binarized at 0.5 first."""
    k = targets_with_mask.shape[1] // 2
    mask = targets_with_mask[:, k:]
    y = (targets_with_mask[:, :k] > 0.5).to(logits.dtype)
    if perm is not None:
        y = y * lam[:, None] + y[perm] * (1.0 - lam[:, None])
        if mix_masks:
            mask = ((mask > 0.5) | (mask[perm] > 0.5)).to(logits.dtype)
    return (mask * bce_with_logits(logits, y)).mean()
