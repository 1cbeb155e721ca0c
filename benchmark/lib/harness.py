"""The benchmark's runner: finds a cell's files by name, runs its traffic
kind on the card, reads its per-layer metrics, judges ``correct`` and
prints the result line.

Everything that belongs to one cell, configuration, traffic kind or
per-layer metric is a file of its own, found by the name that
``BENCHMARK.json`` gives:

- ``workloads/<cell>.json``: the configuration's name, the traffic kind,
  its parameters, the chips, and the limits of the compared numbers;
- ``configs/<config>.json``: the model's published sizes and precision;
- ``traffic/<kind>.py``: ``run(cell, env) -> Outcome``;
- ``metrics/<metric>.py``: ``read(readings) -> float | None``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import math
import os
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple

HERE = Path(__file__).resolve().parent.parent  # the benchmark's folder
ROOT = HERE.parent  # the checkout
#: top-level modules that no process of a run may hold once its window closed
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "passt_tpu")


def cache_env() -> Dict[str, str]:
    """Build and kernel caches at fixed paths inside the checkout, so that
    every run after a checkout's first finds them built."""
    build = ROOT / "build"
    return {
        "TRITON_CACHE_DIR": str(build / "triton"),
        "TORCH_EXTENSIONS_DIR": str(build / "torch_extensions"),
        "USE_FLAX": "0",
    }


def sub_seed(seed: int, *tag) -> int:
    """A 63-bit seed for one use of the run's ``--seed``."""
    digest = hashlib.blake2b(repr((seed,) + tag).encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") & ((1 << 63) - 1)


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@dataclasses.dataclass
class Cell:
    """One entry of the manifest's ``workloads`` with its files."""

    name: str
    workload: dict  # workloads/<name>.json
    config: dict  # configs/<config>.json
    end_to_end: List[dict]  # the manifest's end-to-end metrics this cell reports
    per_layer: List[dict]  # the manifest's per-layer metrics this cell reports

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])

    @property
    def params(self) -> dict:
        return self.workload["params"]

    @property
    def limits(self) -> dict:
        return self.workload.get("limits", {})


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` and its files."""
    manifest = _load_json(root / "BENCHMARK.json")
    entry = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    bench = root / "benchmark"
    workload = _load_json(bench / "workloads" / f"{name}.json")
    for key in ("config", "traffic", "chips"):
        if workload[key] != entry[key]:
            raise SystemExit(f"{name}: {key} {workload[key]!r} in its file, {entry[key]!r} in BENCHMARK.json")
    config = _load_json(bench / "configs" / f"{workload['config']}.json")
    e2e = [m for m in manifest["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    per_layer = [m for m in manifest["per_layer"] if name in m["workloads"]]
    return Cell(name, workload, config, e2e, per_layer)


def traffic_module(cell: Cell, root: Path = ROOT):
    kind = cell.workload["traffic"]
    return _load_module(root / "benchmark" / "traffic" / f"{kind}.py", f"bench_traffic_{kind}")


def metric_reader(name: str, root: Path = ROOT) -> Callable:
    module = _load_module(root / "benchmark" / "metrics" / f"{name}.py", "bench_metric_" + name.replace(".", "_"))
    return module.read


@dataclasses.dataclass
class Env:
    """What a traffic kind is given besides its cell."""

    seed: int
    seconds: float
    trace: bool
    device: object  # torch.device
    t_start: float  # time.time() when the run's first process started
    rank: int = 0
    world: int = 1
    control: object = None  # a gloo group over the ranks (world > 1)
    marks: list = dataclasses.field(default_factory=list)  # (phase, time.time() at its end) before the traffic


@dataclasses.dataclass
class Outcome:
    """What a traffic kind measured; only rank 0's is printed."""

    end_to_end: Dict[str, float]
    readings: dict  # what the per-layer metric readers read
    checks: Dict[str, Tuple[float, float]]  # compared number -> (value, limit)
    shown: Dict[str, float]  # numbers printed beside the checks, not compared
    attempted: int
    failed: int
    memory_peak_bytes: int
    trace: object = None  # lib.trace.Trace of the traced window
    busy_s: Optional[float] = None  # averaged over the chips
    window_s: Optional[float] = None
    extra: dict = dataclasses.field(default_factory=dict)


def is_correct(checks: Dict[str, Tuple[float, float]]) -> bool:
    return bool(checks) and all(math.isfinite(v) and v <= lim for v, lim in checks.values())


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def result_line(cell: Cell, out: Outcome, device: dict, trace: bool) -> dict:
    metrics = {}
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if trace:
        for m in cell.per_layer:
            value = metric_reader(m["name"])(out.readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}
    else:
        for m in cell.end_to_end:
            if m["name"] in out.end_to_end:
                metrics[m["name"]] = {"value": out.end_to_end[m["name"]], "unit": units[m["name"]]}
    line = {
        "correct": is_correct(out.checks),
        "attempted": out.attempted,
        "failed": out.failed,
        "metrics": metrics,
        "device": device,
    }
    if trace and out.trace is not None:
        line["breakdown"] = out.trace.breakdown()
    line.update(out.extra)
    line["shown"] = out.shown
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in out.checks.items()}
    return line


def print_checks_line(line: dict) -> None:
    """The compared numbers beside their limits, as the last lines of
    standard error."""
    for k, v in line.get("shown", {}).items():
        print(f"shown {k} = {v!r}", file=sys.stderr)
    for k, c in line["checks"].items():
        verdict = "ok" if math.isfinite(c["value"]) and c["value"] <= c["limit"] else "FAILED"
        print(f"check {k} = {c['value']!r} limit {c['limit']!r} {verdict}", file=sys.stderr)
    sys.stderr.flush()


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run_rank(cell: Cell, env: Env) -> Optional[dict]:
    """Run the cell on this rank; rank 0 returns the result line."""
    import torch

    out = traffic_module(cell).run(cell, env)
    if out is None:
        return None
    device = {
        "platform": "gpu" if env.device.type == "cuda" else env.device.type,
        "kind": torch.cuda.get_device_name(env.device) if env.device.type == "cuda" else "cpu",
        "count": env.world,
        "memory_peak_bytes": out.memory_peak_bytes,
    }
    if env.trace:
        device["busy_s"] = out.busy_s
        device["window_s"] = out.window_s
    if env.device.type == "cuda":
        out.extra["power"] = power_limit()
    return result_line(cell, out, device, env.trace)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(argv: List[str], world: int, t_start: float, timeout_s: float) -> Tuple[int, Optional[str]]:
    """Run ``world`` ranks of this command, one process a card, with
    ``torch.distributed``'s env rendezvous on a free localhost port; waits
    for every one. Returns (exit code, rank 0's last stdout line)."""
    # NCCL's shared-memory transport would write under /dev/shm: NVLink
    # (peer to peer) or sockets carry the traffic instead
    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()), WORLD_SIZE=str(world),
               BENCH_T_START=repr(t_start), NCCL_SHM_DISABLE="1")
    procs = []
    for rank in range(world):
        penv = dict(env, RANK=str(rank), LOCAL_RANK=str(rank))
        procs.append(subprocess.Popen([sys.executable] + argv, env=penv, cwd=str(ROOT),
                                      stdout=subprocess.PIPE if rank == 0 else sys.stderr, text=True))
    deadline = time.time() + timeout_s
    out0 = ""
    code = 0
    try:
        out0, _ = procs[0].communicate(timeout=max(1.0, deadline - time.time()))
        for p in procs[1:]:
            p.wait(timeout=max(1.0, deadline - time.time()))
    except subprocess.TimeoutExpired:
        code = 124
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
    lines = out0.strip().splitlines()
    for line in lines[:-1]:
        print(line, file=sys.stderr)
    codes = [p.returncode for p in procs]
    if code == 0 and any(codes):
        code = next(c for c in codes if c)
    return code, (lines[-1] if lines else None)


def synchronize(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def reset_peak(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def memory_peak(device) -> int:
    import torch

    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def release(device) -> None:
    import gc

    import torch

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


class Phases:
    """Wall-clock marks of a run's set-up, shown beside its result, so that
    a slow or uneven set-up can be told apart by phase."""

    def __init__(self, t_start: float, marks=()):
        self.marks = [("start", t_start)] + list(marks)

    def mark(self, name: str) -> None:
        self.marks.append((name, time.time()))

    def seconds(self) -> Dict[str, float]:
        return {name: t - prev for (_, prev), (name, t) in zip(self.marks, self.marks[1:])}


def halves(stamps: List[float], t0: float, t1: float) -> List[float]:
    """Units a second in the first and the second half of a window, from
    the host times at which each unit completed."""
    mid = (t0 + t1) / 2.0
    first = sum(1 for t in stamps if t < mid)
    return [first / (mid - t0), (len(stamps) - first) / (t1 - mid)]
