"""The port's own ctypes binding to the native host data plane
(native/hostplane.cpp; port of passt_tpu/data/native.py, same ABI).

Optional fast path: when ``libhostplane.so`` is available — ``make -C
native`` in a source checkout, overridable via the ``PASST_TPU_HOSTPLANE``
env var — batch assembly (int16 decode + pad/crop + gain + roll),
wave-mixup and packbits-target unpacking run in multithreaded C++; the
pure-numpy implementations in ``passt_tpu_torch.data.datasets`` remain the
fallback and the behavioral reference. The library is host code: it is
optional, as in the JAX package, and a missing one is reported
(:func:`available` is False), never replaced by another file.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

_LIB: Optional[ctypes.CDLL] = None
_SEARCHED = False


def _lib_candidates():
    """Search order: the explicit override, then the source checkout's
    Makefile output (native/libhostplane.so at the repo root)."""
    env = os.environ.get("PASST_TPU_HOSTPLANE")
    if env:
        if not os.path.exists(env):
            # An explicit override must not silently fall back to another
            # .so — a typo'd path would make every "native plane"
            # measurement exercise the wrong library.
            raise FileNotFoundError(
                f"PASST_TPU_HOSTPLANE={env!r} does not exist"
            )
        yield env
        return
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    yield os.path.join(root, "native", "libhostplane.so")


def _lib_path() -> Optional[str]:
    for p in _lib_candidates():
        if os.path.exists(p):
            return p
    return None


_ABI_VERSION = 2  # must match hostplane_version() — bump on ABI change
_LOAD_ERROR: Optional[RuntimeError] = None  # persistent stale-ABI failure


def load(n_threads: Optional[int] = None) -> Optional[ctypes.CDLL]:
    """Load (and memoize) the native library; None if not built.

    An explicit ``n_threads`` resizes the global worker pool, including on
    an already-loaded library (hostplane_init quiesces in-flight work
    first); ``None`` leaves a loaded pool untouched."""
    global _LIB, _SEARCHED, _LOAD_ERROR
    if _LIB is not None or _SEARCHED:
        if _LOAD_ERROR is not None:
            # a stale/broken library is a PERSISTENT loud failure: the
            # first caller must not consume the one RuntimeError and leave
            # every later probe silently returning None with a false
            # "not built" diagnosis
            raise _LOAD_ERROR
        if _LIB is not None and n_threads is not None:
            _LIB.hostplane_init(n_threads)
        return _LIB
    _SEARCHED = True
    path = _lib_path()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    lib.hostplane_init.argtypes = [ctypes.c_int]
    lib.hostplane_version.restype = ctypes.c_int
    got = lib.hostplane_version()
    if got != _ABI_VERSION:
        _LOAD_ERROR = RuntimeError(
            f"stale libhostplane.so at {path} (ABI v{got}, bindings need "
            f"v{_ABI_VERSION}) — rebuild: make -C native, or pip install -e ."
        )
        raise _LOAD_ERROR
    lib.hostplane_assemble_batch.argtypes = [
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int,
        ctypes.c_int64,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_uint64,
    ]
    lib.hostplane_wavmix.argtypes = [
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
        ctypes.c_int64,
    ]
    lib.hostplane_unpack_targets.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int64,
    ]
    lib.hostplane_mp3_available.restype = ctypes.c_int
    lib.hostplane_decode_mp3.restype = ctypes.c_int64
    lib.hostplane_decode_mp3.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.hostplane_assemble_mp3_batch.argtypes = [
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int,
        ctypes.c_int64,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64),
    ]
    if n_threads is None:
        n_threads = max(0, (os.cpu_count() or 1) - 1)
    lib.hostplane_init(n_threads)
    _LIB = lib
    return lib


def available() -> bool:
    return load() is not None


def _index_array(indices, b: int) -> np.ndarray:
    """Per-item DATASET indices for RNG seeding (slot i draws from
    fold(seed, indices[i])); defaults to 0..B-1 for standalone batches.
    Seeding by dataset index keeps every item's augmentation stream
    independent across an epoch — batch-position seeding would repeat the
    same B draws every batch."""
    if indices is None:
        return np.arange(b, dtype=np.int64)
    idx = np.ascontiguousarray(indices, dtype=np.int64)
    assert idx.shape == (b,), f"indices shape {idx.shape} != ({b},)"
    return idx


def assemble_batch(
    pcm_items,
    clip_samples: int,
    gain_db: int = 0,
    roll_range: int = 0,
    random_crop: bool = False,
    seed: int = 0,
    indices=None,
) -> np.ndarray:
    """pcm_items: list of int16 arrays -> [B, clip_samples] float32 with
    fused decode/pad-or-crop/gain/roll (deterministic in
    (seed, indices[i]); see _index_array)."""
    lib = load()
    assert lib is not None, "libhostplane.so not built (make -C native)"
    b = len(pcm_items)
    items = [np.ascontiguousarray(x, dtype=np.int16) for x in pcm_items]
    ptrs = (ctypes.c_void_p * b)(
        *[x.ctypes.data_as(ctypes.c_void_p).value for x in items]
    )
    lens = (ctypes.c_int64 * b)(*[len(x) for x in items])
    idx = _index_array(indices, b)
    out = np.empty((b, clip_samples), dtype=np.float32)
    lib.hostplane_assemble_batch(
        ctypes.cast(ptrs, ctypes.POINTER(ctypes.c_void_p)),
        ctypes.cast(lens, ctypes.POINTER(ctypes.c_int64)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        b,
        clip_samples,
        gain_db,
        roll_range,
        1 if random_crop else 0,
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        seed,
    )
    return out


def wavmix(out: np.ndarray, other: np.ndarray, lam: np.ndarray, apply: np.ndarray) -> None:
    """In-place wave mixup on a [B, T] batch (see hostplane_wavmix).

    ``out`` is written IN PLACE through its raw pointer, so it must
    already be contiguous float32 — a float64 or strided view would be
    silently reinterpreted as float32 rows by the C++ side; the other
    operands are coerced (copies are fine for
    read-only args) but must cover [B(,T)]."""
    lib = load()
    assert lib is not None
    b, t = out.shape
    if out.dtype != np.float32 or not out.flags["C_CONTIGUOUS"]:
        raise ValueError(
            f"wavmix out must be contiguous float32 [B, T]; got "
            f"dtype={out.dtype}, contiguous={out.flags['C_CONTIGUOUS']}"
        )
    if other.shape != (b, t):
        raise ValueError(f"wavmix other shape {other.shape} != {(b, t)}")
    if len(lam) < b or len(apply) < b:
        raise ValueError(
            f"wavmix lam/apply must cover the batch: {len(lam)}/{len(apply)} < {b}"
        )
    lib.hostplane_wavmix(
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        np.ascontiguousarray(other, np.float32).ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        np.ascontiguousarray(lam, np.float32).ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        np.ascontiguousarray(apply, np.uint8).ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        b,
        t,
    )


#: Capacity heuristic for decoded-mp3 output buffers, samples per input
#: byte (true Layer-III bound is <=48 at 8 kbps/48 kHz; 64 adds margin).
#: MUST stay in sync with kCapSamplesPerByte in native/hostplane.cpp.
_MP3_CAP_SAMPLES_PER_BYTE = 64
_MP3_CAP_SLACK = 65536


def _as_u8_buffer(data) -> np.ndarray:
    """bytes / buffer / ndarray -> contiguous uint8 array (shared by the
    single-clip and batch decode paths)."""
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data, dtype=np.uint8)
    return np.frombuffer(bytes(data), dtype=np.uint8)


def mp3_available() -> bool:
    """True when libhostplane.so is built AND it found the system libmpg123
    (the decode backend; dlopen'd lazily, see native/hostplane.cpp)."""
    lib = load()
    return lib is not None and bool(lib.hostplane_mp3_available())


def decode_mp3(data) -> tuple:
    """Decode one in-memory mp3 (bytes / uint8 array) -> (float32 mono
    waveform at the native rate, sample_rate). The float32-at-native-rate
    contract matches the reference's decode_mp3 (audioset/dataset.py:55-70,
    PyAV); backend is the system libmpg123 via the C++ host plane."""
    lib = load()
    if lib is None or not lib.hostplane_mp3_available():
        raise RuntimeError(
            "mp3 decode needs the native host plane with libmpg123: "
            "build it with `make -C native` (libmpg123.so.0 must be on the "
            "loader path; it ships with this image and with pygame wheels)"
        )
    buf = _as_u8_buffer(data)
    # re-call with the exact size if the decoder reports more than the
    # heuristic capacity (free-format streams)
    cap = int(buf.size) * _MP3_CAP_SAMPLES_PER_BYTE + _MP3_CAP_SLACK
    out = np.empty(cap, dtype=np.float32)
    rate = ctypes.c_int32(0)
    n = lib.hostplane_decode_mp3(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        buf.size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        cap,
        ctypes.byref(rate),
    )
    if n > cap:
        out = np.empty(int(n), dtype=np.float32)
        n = lib.hostplane_decode_mp3(
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            buf.size,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            int(n),
            ctypes.byref(rate),
        )
    if n < 0:
        reason = {
            -1: "bitstream/decoder error",
            -2: "libmpg123 not found",
            -3: "no audio frames in buffer",
            -4: "mid-stream format change (mixed-format concatenated mp3)",
        }.get(int(n), f"error {int(n)}")
        raise ValueError(f"mp3 decode failed: {reason}")
    return out[:n].copy(), int(rate.value)


def assemble_mp3_batch(
    mp3_items,
    clip_samples: int,
    gain_db: int = 0,
    roll_range: int = 0,
    random_crop: bool = False,
    seed: int = 0,
    indices=None,
):
    """mp3_items: list of uint8 buffers -> ([B, clip_samples] float32,
    native rates [B] int32, decoded lengths [B] int64) with fused
    decode/pad-or-crop/gain/roll (deterministic in (seed, indices[i]);
    same RNG streams as assemble_batch). lens[b] < 0 marks a decode error
    (row is zeroed)."""
    lib = load()
    assert lib is not None and lib.hostplane_mp3_available(), (
        "mp3 decode needs libhostplane.so + libmpg123 (make -C native)"
    )
    b = len(mp3_items)
    items = [_as_u8_buffer(x) for x in mp3_items]
    ptrs = (ctypes.c_void_p * b)(
        *[x.ctypes.data_as(ctypes.c_void_p).value for x in items]
    )
    sizes = (ctypes.c_int64 * b)(*[x.size for x in items])
    idx = _index_array(indices, b)
    out = np.empty((b, clip_samples), dtype=np.float32)
    rates = np.empty(b, dtype=np.int32)
    lens = np.empty(b, dtype=np.int64)
    lib.hostplane_assemble_mp3_batch(
        ctypes.cast(ptrs, ctypes.POINTER(ctypes.c_void_p)),
        ctypes.cast(sizes, ctypes.POINTER(ctypes.c_int64)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        b,
        clip_samples,
        gain_db,
        roll_range,
        1 if random_crop else 0,
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        seed,
        rates.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        lens.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return out, rates, lens


def unpack_targets(packed: np.ndarray, classes: int) -> np.ndarray:
    lib = load()
    assert lib is not None
    packed = np.ascontiguousarray(packed, np.uint8)
    b, w = packed.shape
    out = np.empty((b, classes), dtype=np.float32)
    lib.hostplane_unpack_targets(
        packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        b,
        w,
        classes,
    )
    return out
