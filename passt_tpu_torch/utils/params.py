"""Parameter accounting (port of passt_tpu/utils/params.py; reference:
helpers/models_size.py:7-32 — ``count_non_zero_params`` logged into run
info at ex_audioset.py:121-123).

``params`` is the port's parameter dict (``TrainState.params``, or
``dict(model.named_parameters())``): names -> tensors."""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch

from passt_tpu_torch.train.steps import _param_group


def count_params(params: Mapping[str, torch.Tensor]) -> int:
    return sum(int(t.numel()) for t in params.values())


def count_non_zero_params(params: Mapping[str, torch.Tensor]) -> Tuple[str, int, int]:
    """Returns (description, total, non_zero) like the reference helper."""
    total = count_params(params)
    non_zero = int(sum(torch.count_nonzero(t.detach()).item() for t in params.values()))
    desc = f"{total:,} params, {non_zero:,} non-zero ({non_zero / max(total, 1):.1%})"
    return desc, total, non_zero


def param_summary(params: Mapping[str, torch.Tensor]) -> str:
    """Parameter counts per top-level group of the JAX package's tree
    (``patch_embed``, ``blocks_0``, ..., ``head_linear``; sorted by name as
    the JAX ``param_summary(params, max_depth=1)`` lists them) and the
    total."""
    groups: Dict[str, int] = {}
    for name, t in params.items():
        group = _param_group(name)
        groups[group] = groups.get(group, 0) + int(t.numel())
    lines = [f"{group:<40s} {groups[group]:>12,}" for group in sorted(groups)]
    lines.append(f"{'TOTAL':<40s} {count_params(params):>12,}")
    return "\n".join(lines)
