"""Build and bind the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled on first use by ``nvcc`` into a shared
library with a plain C interface under ``build/passt_tpu_torch/`` at the root
of the checkout (listed in ``.gitignore``), then loaded with ``ctypes``. The
library's file name carries a hash of its sources, so an edited kernel is
rebuilt and a stale one is never loaded. Nothing is compiled or loaded when a
module is imported: the CPU tests import every module, and a CPU-only machine
has no ``nvcc``.

Every C entry point returns ``cudaGetLastError()`` right after its launch;
:func:`check` turns a non-zero code into an exception (a refused launch never
runs, and a later synchronize would not report it).

``LAUNCHES`` holds one plain integer per kernel wrapper: the wrapper adds one
where it launches its kernel, and nowhere else, so a run can show which
kernels its main path went through. A wrapper runs on the host, so a CUDA
graph's replay calls none: ``passt_tpu_torch.graphs`` takes the counts that
capturing a graph added (:func:`launch_counts` before and after), puts them
back, and adds them once per replay (:func:`add_launches`), so a count is
of kernels run. The attention and int8 wrappers' per-path counts are
registered here (:data:`COUNTERS`) and follow the same rule, and so do the
graph cache's own counts (``graphs``: eager calls, captures, replays,
graphs pruned), which it adds outside any capture.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "passt_tpu_torch"

#: every kernel source of the port (``csrc/<name>.cu``)
KERNELS = ("mel_kernel", "attention_fwd", "attention_fwd_fp32", "attention_bwd", "attention_bwd_fp32",
           "layernorm_bwd", "ln_qkv", "int8_dense", "int8_gemm", "fused_mlp", "trace_mark", "adamw_sr")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

#: wrapper name -> kernel launches since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {}

#: every launch counter by name: ``LAUNCHES`` and the per-path counts the
#: wrapper modules register when imported
COUNTERS: Dict[str, Dict[str, int]] = {"launches": LAUNCHES}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> Dict[str, Dict[str, int]]:
    """A snapshot of every counter of :data:`COUNTERS`."""
    return {name: dict(counts) for name, counts in COUNTERS.items()}


def launch_delta(before: Dict[str, Dict[str, int]]) -> Dict[str, Dict[str, int]]:
    """What the counters added since the snapshot ``before``: non-zero
    entries only."""
    delta = {}
    for name, counts in COUNTERS.items():
        old = before.get(name, {})
        moved = {k: v - old.get(k, 0) for k, v in counts.items() if v != old.get(k, 0)}
        if moved:
            delta[name] = moved
    return delta


def add_launches(delta: Dict[str, Dict[str, int]], times: int = 1) -> None:
    """Add ``delta`` (from :func:`launch_delta`) ``times`` times; ``times=-1``
    takes it back."""
    for name, moved in delta.items():
        counts = COUNTERS[name]
        for k, v in moved.items():
            counts[k] = counts.get(k, 0) + v * times


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def _sources(name: str) -> list:
    return [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh"))


def library_path(name: str) -> Path:
    digest = hashlib.sha1()
    for src in _sources(name):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _start(name: str):
    """Start ``nvcc`` for one kernel; returns (process, tmp path, final path)
    or None when the library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def finish(name: str, job) -> str:
    """Wait for a build :func:`_start` began and move the library into
    place; returns the compiler's output (for no job, the one kept beside
    the built library, or "(cached)"); raises if it failed."""
    if job is None:
        log = library_path(name).with_suffix(".log")
        return log.read_text() if log.exists() else "(cached)"
    proc, tmp, out = job
    text, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{text}")
    os.replace(tmp, out)
    out.with_suffix(".log").write_text(text)
    return text


def build(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile the named kernels, one ``nvcc`` each, all started together.
    Returns name -> the compiler's output (``-Xptxas -v``: registers,
    shared memory and spills per kernel); raises if any build fails."""
    started = {name: _start(name) for name in names}
    logs = {}
    failed = []
    for name, job in started.items():
        try:
            logs[name] = finish(name, job)
        except RuntimeError as err:
            failed.append(str(err))
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built if needed. Each wrapper module
    loads its library once and keeps it."""
    build([name])
    lib = ctypes.CDLL(str(library_path(name)))
    lib.passt_error_string.argtypes = [ctypes.c_int]
    lib.passt_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        msg = lib.passt_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_of(tensor: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(tensor.device).cuda_stream)


@functools.cache
def sm_count(device: torch.device) -> int:
    """The card's multiprocessor count (the persistent and the rotated
    kernels size their grids and orders by it)."""
    return torch.cuda.get_device_properties(device).multi_processor_count
