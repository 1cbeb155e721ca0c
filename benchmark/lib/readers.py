"""What the per-layer metric files read, from a traced run's readings.

``readings`` (filled by the traffic kind): ``enqueue_s`` (the host span of
each call in the window), ``window_s`` and ``units`` (the window's length
and its steps or calls), ``model_flops_per_unit`` (the model FLOPs of one
unit over every card), ``chips``, ``trace`` (:class:`lib.trace.Trace` of
the traced window, rank 0's) and ``attn`` (one attention call's shapes and
the calls a unit makes). A reader that finds nothing to read returns None.
"""

from __future__ import annotations

import statistics
from typing import Optional

from benchmark.lib import flops


def enqueue_ms(r: dict) -> Optional[float]:
    spans = r.get("enqueue_s") or []
    return 1e3 * statistics.fmean(spans) if spans else None


def mfu(r: dict) -> Optional[float]:
    if not r.get("units") or not r.get("window_s"):
        return None
    rate = r["units"] * r["model_flops_per_unit"] / r["window_s"] / r["chips"]
    return 100.0 * rate / flops.PEAK_BF16_FLOPS


def kernels_per_unit(r: dict) -> Optional[float]:
    t = r.get("trace")
    if t is None or not t.kernels or not t.units:
        return None
    return len(t.kernels) / t.units


def groups_ms_per_unit(r: dict, *groups: str) -> Optional[float]:
    t = r.get("trace")
    if t is None or not t.kernels or not t.units:
        return None
    return t.kernel_ms(groups=groups) / t.units


def pattern_ms_per_unit(r: dict, pattern: str) -> Optional[float]:
    t = r.get("trace")
    if t is None or not t.units:
        return None
    ms = t.kernel_ms(pattern)
    return ms / t.units if ms > 0 else None


def attention_roofline(r: dict, backward: bool) -> Optional[float]:
    """The attention kernels' least time from the calls' shapes over their
    profiled time, in percent."""
    t, a = r.get("trace"), r.get("attn")
    if t is None or a is None or not t.units:
        return None
    ms = t.kernel_ms(r"attention_bwd" if backward else r"attention_fwd")
    if ms <= 0:
        return None
    cost = flops.attention_bwd_cost if backward else flops.attention_fwd_cost
    ops, nbytes = cost(a["b"], a["n"], a["h"], a["d"], a.get("itemsize", 2))
    bound_ms = 1e3 * flops.bound_s(ops, nbytes) * a["calls_per_unit"] * t.units
    return 100.0 * bound_ms / ms


def idle_share(r: dict) -> Optional[float]:
    t = r.get("trace")
    if t is None or not t.kernels or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
