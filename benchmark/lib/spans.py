"""What the program's own tracing leaves in a traced window: its host
spans (named host events, ``passt_tpu_torch/tracing.py`` ``span``) and the
train step's phase marks (empty kernels named ``trace_mark_<phase>`` on
the device, each closing its phase). A program without them (an older
commit, or a CPU run for the marks) reads None, never an error.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, Optional

#: a phase mark's kernel name, and the phase it closes
MARK = re.compile(r"trace_mark_([A-Za-z]+)")


def mark_phase(name: str) -> Optional[str]:
    m = MARK.search(name)
    return m.group(1) if m else None


def host_ms_per_unit(r: dict, names: Iterable[str]) -> Optional[float]:
    """Mean host ms a step or call inside the named spans, over the traced
    window; None when the window holds none of them."""
    t = r.get("trace")
    if t is None or not t.units:
        return None
    names = set(names)
    w0, w1 = t.window
    spans = [e - s for name, s, e in t.host if name in names and s >= w0 and e <= w1]
    return 1e-3 * sum(spans) / t.units if spans else None


def phase_ms(t) -> Optional[Dict[str, float]]:
    """Device ms of each phase over the window: the kernels (marks left
    out), in order of their start, each counted in the phase of the next
    mark; those after the window's last mark in the phase of its first
    (the next step's). None when the window holds no mark."""
    phases: Dict[str, float] = {}
    pending, first = 0.0, None
    for name, s, e in sorted(t.kernels, key=lambda k: (k[1], k[2])):
        phase = mark_phase(name)
        if phase is None:
            pending += e - s
            continue
        first = first or phase
        phases[phase] = phases.get(phase, 0.0) + pending
        pending = 0.0
    if first is None:
        return None
    phases[first] += pending
    return {k: 1e-3 * v for k, v in phases.items()}


def phase_ms_per_unit(r: dict, phase: str) -> Optional[float]:
    """Device ms a step of one phase of the train step; None without its
    mark."""
    t = r.get("trace")
    if t is None or not t.units:
        return None
    ms = phase_ms(t)
    if ms is None or phase not in ms:
        return None
    return ms[phase] / t.units
