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
kernels its main path went through.
"""

from __future__ import annotations

import ctypes
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
KERNELS = ("mel_kernel", "attention_fwd", "attention_bwd", "layernorm_bwd", "ln_qkv", "int8_dense", "fused_mlp")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

#: wrapper name -> kernel launches since the last :func:`reset_launches`
LAUNCHES: Dict[str, int] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


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


def build(names: Iterable[str] = KERNELS) -> Dict[str, str]:
    """Compile the named kernels, one ``nvcc`` each, all started together.
    Returns name -> the compiler's output (``-Xptxas -v``: registers,
    shared memory and spills per kernel); raises if any build fails."""
    started = {name: _start(name) for name in names}
    logs = {}
    failed = []
    for name, job in started.items():
        if job is None:
            logs[name] = "(cached)"
            continue
        proc, tmp, out = job
        text, _ = proc.communicate()
        logs[name] = text
        if proc.returncode != 0:
            failed.append(f"{name}:\n{text}")
            continue
        os.replace(tmp, out)
        out.with_suffix(".log").write_text(text)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
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
