"""Reduce a ``torch.profiler`` trace of a window to what the per-layer
metrics read: the kernels that ran on the device, their union, the idle
gaps between them and what the host was doing in each.

``GROUPS`` is a frozen copy of the port's kernel grouping (its profile of
the train step); the idle share here is one minus the *union* of kernel
intervals over the window, so kernels that overlap (a side stream, NCCL
beside compute) are not counted twice.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

#: kernel name patterns -> group, first match wins
GROUPS = (
    ("LayerNorm backward kernel", r"layernorm_bwd"),
    ("ln_qkv kernels (F1, B2)", r"ln_qkv"),
    ("attention backward kernel", r"attention_bwd"),
    ("attention forward kernel", r"attention_fwd"),
    ("mel kernel", r"log_mel|mel_kernel|mel_span"),
    ("GEMMs (cuBLAS/CUTLASS)", r"gemm|sm90_|cutlass|nvjet|cublas|xmma"),
    ("reductions (LayerNorm means, sums)", r"reduce"),
    ("copies, casts, indexing, cat", r"copy|cast|index|scatter|gather|cat|fill"),
    ("elementwise (adds, muls, GELU, optimizer)", r"elementwise|foreach|multi_tensor|vectorized"),
)

WINDOW_SPAN = "bench.window"
#: the longest gaps that are named by what the host was doing
LABELLED_GAPS = 200


def group_of(name: str) -> str:
    return next((g for g, pat in GROUPS if re.search(pat, name, re.I)), "other")


class Trace:
    """The device kernels and host spans of one traced window.

    ``kernels``: (name, start_us, end_us) of every device operation that
    ran inside the window; ``host``: (name, start_us, end_us) of the host's
    events; ``window``: (start_us, end_us) of the harness's window span;
    ``units``: the steps or calls the window ran."""

    def __init__(self, kernels, host, window: Tuple[float, float], units: int):
        w0, w1 = window
        self.window = window
        self.units = units
        self.kernels = sorted((n, max(s, w0), min(e, w1)) for n, s, e in kernels if e > w0 and s < w1)
        self.host = host

    @classmethod
    def from_profiler(cls, prof, units: int) -> "Trace":
        import torch

        kernels, host, window = [], [], None
        for ev in prof.events():
            tr = ev.time_range
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                if not ev.name.startswith("bench."):  # the harness's ranges, mirrored on the device's timeline
                    kernels.append((ev.name, float(tr.start), float(tr.end)))
            else:
                host.append((ev.name, float(tr.start), float(tr.end)))
                if ev.name == WINDOW_SPAN:
                    window = (float(tr.start), float(tr.end))
        if window is None:
            raise RuntimeError(f"the trace has no {WINDOW_SPAN!r} span")
        return cls(kernels, host, window, units)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        merged: List[List[float]] = []
        for _, s, e in sorted(self.kernels, key=lambda k: k[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def gaps(self) -> List[Tuple[float, float]]:
        out, at = [], self.window[0]
        for s, e in self.busy_intervals():
            if s > at:
                out.append((at, s))
            at = max(at, e)
        if self.window[1] > at:
            out.append((at, self.window[1]))
        return out

    def kernel_ms(self, pattern: Optional[str] = None, groups: Tuple[str, ...] = ()) -> float:
        """Summed device ms of the kernels whose name matches ``pattern``
        or whose group is in ``groups``."""
        total = 0.0
        for name, s, e in self.kernels:
            if (pattern and re.search(pattern, name, re.I)) or (groups and group_of(name) in groups):
                total += e - s
        return total * 1e-3

    def host_doing(self, at_us: float) -> str:
        """The innermost host event running at ``at_us`` (the shortest that
        covers it), or "host: no event"."""
        best = None
        for name, s, e in self.host:
            if s <= at_us <= e and name != WINDOW_SPAN and (best is None or e - s < best[1]):
                best = (name, e - s)
        return best[0] if best else "host: no event"

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        ops: Dict[str, float] = {}
        for name, s, e in self.kernels:
            key = name[:160]
            ops[key] = ops.get(key, 0.0) + (e - s) * 1e-6
        idle: Dict[str, float] = {}
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])
        for i, (s, e) in enumerate(gaps):
            # the longest gaps are named by the host's event; the rest pooled
            key = self.host_doing((s + e) / 2.0)[:160] if i < LABELLED_GAPS else "shorter gaps, pooled"
            idle[key] = idle.get(key, 0.0) + (e - s) * 1e-6
        rank = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]  # noqa: E731
        return {"device_ops": rank(ops), "idle_gaps": rank(idle)}
