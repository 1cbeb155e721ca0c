"""Stochastic weight averaging as a running average of the params dict
(port of passt_tpu/train/swa.py).

The reference averages the network's parameters every ``swa_freq`` epochs
from ``swa_epoch_start`` (reference: helpers/swa_callback.py:161-268;
defaults: AudioSet start=50 freq=5, ESC-50 start=2 freq=1, FSD50K start=10
freq=3): ``avg += (p - avg) / (n + 1)`` on the epochs where an update fires
(swa_callback.py:246-268). The average is an fp32 dict of tensors on the
parameters' device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch


@dataclasses.dataclass
class SWAState:
    avg_params: Optional[Dict[str, torch.Tensor]]
    n_averaged: int = 0
    swa_epoch_start: int = 50
    swa_freq: int = 5


def swa_init(params: Dict[str, torch.Tensor], swa_epoch_start: int = 50, swa_freq: int = 5) -> SWAState:
    """A zero-update average: an fp32 copy of ``params`` (never an alias of
    the live tensors). fp32 whatever the storage dtype: under
    ``param_dtype="bfloat16_sr"`` a bf16 running average would stop moving
    once (p - avg)/(n+1) falls below the bf16 ulp at weight scale."""
    return SWAState(
        avg_params={k: p.detach().to(torch.float32, copy=True) for k, p in params.items()},
        n_averaged=0,
        swa_epoch_start=swa_epoch_start,
        swa_freq=swa_freq,
    )


def swa_should_update(state: SWAState, epoch: int, max_epochs: Optional[int] = None) -> bool:
    """True at END of 0-based ``epoch`` exactly when the reference callback
    averages at START of epoch ``epoch + 1`` (identical params: end of
    epoch e == start of epoch e+1).

    Reference semantics (swa_callback.py:128,131,194): ``swa_start =
    swa_epoch_start - 1`` (0-based), updates fire on train-epoch start
    while ``swa_start <= t <= max_epochs - 1``, every ``swa_freq`` epochs.
    The last trained epoch's params therefore never enter the average."""
    t = epoch + 1
    start = max(state.swa_epoch_start - 1, 0)
    if t < start:
        return False
    if max_epochs is not None and t > max_epochs - 1:
        return False
    return (t - start) % state.swa_freq == 0


@torch.no_grad()
def swa_update(state: SWAState, params: Dict[str, torch.Tensor]) -> SWAState:
    """avg += (p - avg) / (n + 1)  (swa_callback.py:246-268), in fp32; the
    first update copies ``params``."""
    n = state.n_averaged
    keys = list(state.avg_params)
    avg = [state.avg_params[k] for k in keys]
    if n == 0:  # a copy, never an alias of the live tensors
        new = [params[k].to(a.dtype, copy=True) for k, a in zip(keys, avg)]
    else:
        delta = torch._foreach_sub([params[k].to(a.dtype) for k, a in zip(keys, avg)], avg)
        torch._foreach_div_(delta, n + 1.0)
        new = torch._foreach_add(avg, delta)
    return dataclasses.replace(state, avg_params=dict(zip(keys, new)), n_averaged=n + 1)


def swa_step(state: SWAState, params: Dict[str, torch.Tensor], epoch: int,
             max_epochs: Optional[int] = None) -> SWAState:
    """Convenience: update iff this epoch fires."""
    if swa_should_update(state, epoch, max_epochs):
        return swa_update(state, params)
    return state
