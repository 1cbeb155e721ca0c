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


def _pair(targets: torch.Tensor, perm: torch.Tensor, lam: torch.Tensor, rows: Optional[slice]):
    """(own targets, partner targets, lambda) of the rows the logits cover:
    all of them, or ``rows`` of a global batch whose ``targets``, ``perm``
    and ``lam`` are global (data parallelism)."""
    if rows is None:
        return targets, targets[perm], lam
    return targets[rows], targets[perm[rows]], lam[rows]


def multilabel_loss(
    logits: torch.Tensor,
    targets: torch.Tensor,
    perm: Optional[torch.Tensor] = None,
    lam: Optional[torch.Tensor] = None,
    rows: Optional[slice] = None,
) -> torch.Tensor:
    """AudioSet/FSD50K loss; with mixup (perm, lam) the targets are blended
    as the inputs were. ``rows``: the logits are these rows of the global
    batch that ``targets``, ``perm`` and ``lam`` cover."""
    if perm is not None:
        own, other, lam = _pair(targets, perm, lam, rows)
        targets = own * lam[:, None] + other * (1.0 - lam[:, None])
    return bce_with_logits(logits, targets).mean()


def single_label_mixup_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    perm: Optional[torch.Tensor] = None,
    lam: Optional[torch.Tensor] = None,
    rows: Optional[slice] = None,
) -> torch.Tensor:
    """ESC-50 loss."""
    if perm is None:
        return softmax_ce(logits, labels).mean()
    own, other, lam = _pair(labels, perm, lam, rows)
    return (softmax_ce(logits, own) * lam + softmax_ce(logits, other) * (1.0 - lam)).mean()


def masked_bce_loss(
    logits: torch.Tensor,
    targets_with_mask: torch.Tensor,
    perm: Optional[torch.Tensor] = None,
    lam: Optional[torch.Tensor] = None,
    mix_masks: bool = False,
    rows: Optional[slice] = None,
) -> torch.Tensor:
    """OpenMIC loss: ``targets_with_mask`` is [B, 2K] = labels || mask.
    Labels are binarized at 0.5 first."""
    k = targets_with_mask.shape[1] // 2
    if perm is None:
        own = targets_with_mask
    else:
        own, other, lam = _pair(targets_with_mask, perm, lam, rows)
    mask = own[:, k:]
    y = (own[:, :k] > 0.5).to(logits.dtype)
    if perm is not None:
        y = y * lam[:, None] + (other[:, :k] > 0.5).to(logits.dtype) * (1.0 - lam[:, None])
        if mix_masks:
            mask = ((mask > 0.5) | (other[:, k:] > 0.5)).to(logits.dtype)
    return (mask * bce_with_logits(logits, y)).mean()
