"""Learning-rate schedules (port of passt_tpu/train/schedules.py): the same
epoch-indexed closures (the LR factor is a pure function of the epoch and
stays constant within an epoch, as torch ``LambdaLR`` stepped per epoch), and
:func:`make_lr_schedule`, which adapts one to a step-indexed schedule given
``steps_per_epoch``.

The step schedule runs on the host: the train step keeps its step count as a
Python int, so looking up the rate never waits on the card. The table holds
fp32 values, as the JAX package's does.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np


def exp_rampup(rampup_length: int) -> Callable[[float], float]:
    """exp(-5 (1 - e/L)^2) warmup (ramp.py:21-30; arXiv 1610.02242)."""

    def f(epoch):
        if epoch < rampup_length:
            epoch = min(max(epoch, 0.5), rampup_length)
            phase = 1.0 - epoch / rampup_length
            return float(math.exp(-5.0 * phase * phase))
        return 1.0

    return f


def linear_rampdown(rampdown_length: int, start: int = 0, last_value: float = 0.0):
    """1.0 until ``start``, then linear to ``last_value`` over
    ``rampdown_length`` epochs (ramp.py:45-54)."""

    def f(epoch):
        if epoch <= start:
            return 1.0
        if epoch - start < rampdown_length:
            return last_value + (1.0 - last_value) * (rampdown_length - epoch + start) / rampdown_length
        return last_value

    return f


def exp_warmup_linear_down(
    warmup: int, rampdown_length: int, start_rampdown: int, last_value: float
):
    """The reference default schedule: exp warmup x linear rampdown
    (ramp.py:93-98; AudioSet defaults warmup=5, rampdown start=50 len=50,
    floor 1%, ex_audioset.py:87)."""
    up = exp_rampup(warmup)
    down = linear_rampdown(rampdown_length, start_rampdown, last_value)

    def f(epoch):
        return up(epoch) * down(epoch)

    return f


def pseudo_rampup(t1: int, t2: int):
    """0 until t1, linear to 1 between t1 and t2 (ramp.py:8-18)."""

    def f(epoch):
        if epoch > t1:
            return min((epoch - t1) / (t2 - t1), 1.0)
        return 0.0

    return f


def linear_rampup(rampup_length: int):
    """Linear 0 -> 1 over ``rampup_length`` epochs (ramp.py:33-42)."""

    def f(epoch):
        return min(epoch / rampup_length, 1.0) if rampup_length else 1.0

    return f


def exp_rampdown(rampdown_length: int, num_epochs: int):
    """Exponential tail-off over the last ``rampdown_length`` epochs
    (ramp.py:57-67; arXiv 1610.02242)."""

    def f(epoch):
        if epoch >= num_epochs - rampdown_length:
            ep = 0.5 * (epoch - (num_epochs - rampdown_length))
            return float(math.exp(-(ep * ep) / rampdown_length))
        return 1.0

    return f


def cosine_rampdown(rampdown_length: int, num_epochs: int):
    """Cosine tail-off (ramp.py:70-80; arXiv 1608.03983)."""

    def f(epoch):
        if epoch >= num_epochs - rampdown_length:
            ep = 0.5 * (epoch - (num_epochs - rampdown_length))
            return float(0.5 * (math.cos(math.pi * ep / rampdown_length) + 1.0))
        return 1.0

    return f


def exp_warmup(rampup_length: int, rampdown_length: int, num_epochs: int):
    """exp_rampup x exp_rampdown (ramp.py:83-90)."""
    up = exp_rampup(rampup_length)
    down = exp_rampdown(rampdown_length, num_epochs)

    def f(epoch):
        return up(epoch) * down(epoch)

    return f


def cosine_cycle(cycle_len: int = 20, ramp_down_start: int = 100, last_lr_value: float = 0.01):
    """Cyclic cosine with a floor after ``ramp_down_start`` (ramp.py:113-122,
    including its cycle-aligned rampdown adjustment)."""
    ramp_down_start = cycle_len + (ramp_down_start - 1) // cycle_len * cycle_len

    def f(epoch):
        # the reference uses floor division cycle_len//2. (ramp.py:117) —
        # differs from cycle_len/2 for odd cycle_len (half-epoch phase shift)
        ep = (epoch + float(cycle_len // 2)) / (1.0 * cycle_len)
        if epoch > ramp_down_start:
            return last_lr_value
        return float(last_lr_value + (1.0 - last_lr_value) * 0.5 * (math.cos(2.0 * math.pi * ep) + 1.0))

    return f


def make_lr_schedule(
    base_lr: float,
    epoch_fn: Callable[[float], float],
    steps_per_epoch: int,
    max_epochs: int = 1000,
):
    """Step schedule: ``lr(step) = base_lr * epoch_fn(step // steps_per_epoch)``
    as an fp32 value (a Python float), constant within an epoch."""
    table = np.asarray([base_lr * epoch_fn(e) for e in range(max_epochs + 1)], dtype=np.float32)

    def schedule(step: int) -> float:
        return float(table[min(int(step) // steps_per_epoch, max_epochs)])

    return schedule


def get_scheduler_lambda(
    warm_up_len: int = 5,
    ramp_down_start: int = 50,
    ramp_down_len: int = 50,
    last_lr_value: float = 0.01,
    schedule_mode: str = "exp_lin",
):
    """The reference's schedule dispatcher."""
    if schedule_mode == "exp_lin":
        return exp_warmup_linear_down(warm_up_len, ramp_down_len, ramp_down_start, last_lr_value)
    if schedule_mode == "cos_cyc":
        return cosine_cycle(warm_up_len, ramp_down_start, last_lr_value)
    raise RuntimeError(f"schedule_mode={schedule_mode} Unknown for a lambda function.")
