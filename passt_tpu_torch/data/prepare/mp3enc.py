"""In-process mp3 encoding via the system libmp3lame (ctypes; port of
passt_tpu/data/prepare/mp3enc.py).

The reference prepares AudioSet-family containers by shelling out to
ffmpeg per file (reference: audioset/prepare_scripts/convert_to_mp3.py —
mirrored by ``python -m passt_tpu_torch.tools.transcode_to_mp3``). This
module removes the external dependency for the packing path: float
waveforms encode straight to mp3 bytes ready for
:mod:`passt_tpu_torch.data.prepare.pack_hdf5` containers, and the decode
side (:func:`passt_tpu_torch.data.native.decode_mp3`: native/hostplane.cpp
+ libmpg123) round-trips them.

Only mono CBR is exposed — the published containers are mono 32 kHz.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Optional

import numpy as np

_lame = None


def _load() -> Optional[ctypes.CDLL]:
    global _lame
    if _lame is not None:
        return _lame
    name = ctypes.util.find_library("mp3lame") or "libmp3lame.so.0"
    try:
        lib = ctypes.CDLL(name)
    except OSError:
        return None
    lib.lame_init.restype = ctypes.c_void_p
    for f in (
        "lame_set_in_samplerate",
        "lame_set_out_samplerate",
        "lame_set_num_channels",
        "lame_set_brate",
        "lame_set_mode",
        "lame_set_quality",
        "lame_init_params",
    ):
        getattr(lib, f).argtypes = [ctypes.c_void_p] + (
            [ctypes.c_int] if f != "lame_init_params" else []
        )
        getattr(lib, f).restype = ctypes.c_int
    lib.lame_encode_buffer.argtypes = [
        ctypes.c_void_p,
        ctypes.c_void_p,  # left int16
        ctypes.c_void_p,  # right int16 (NULL for mono)
        ctypes.c_int,
        ctypes.c_void_p,
        ctypes.c_int,
    ]
    lib.lame_encode_buffer.restype = ctypes.c_int
    lib.lame_encode_flush.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    lib.lame_encode_flush.restype = ctypes.c_int
    lib.lame_get_lametag_frame.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t
    ]
    lib.lame_get_lametag_frame.restype = ctypes.c_size_t
    lib.lame_close.argtypes = [ctypes.c_void_p]
    _lame = lib
    return lib


def available() -> bool:
    """True when libmp3lame is loadable on this host."""
    return _load() is not None


def encode_mp3(
    wave: np.ndarray, sample_rate: int = 32000, bitrate_kbps: int = 128
) -> bytes:
    """float32/-1..1 (or int16) mono waveform -> CBR mp3 bytes.

    Mirrors the reference container format: mono, constant bitrate, the
    file's native rate == ``sample_rate`` (no resampling here — resample
    before encoding if needed)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("libmp3lame not found on this host")
    if wave.dtype != np.int16:
        pcm = np.clip(np.asarray(wave, np.float32), -1.0, 1.0)
        pcm = (pcm * 32767.0).astype(np.int16)
    else:
        pcm = wave
    pcm = np.ascontiguousarray(pcm)

    gfp = lib.lame_init()
    if not gfp:
        raise RuntimeError("lame_init failed")
    try:
        lib.lame_set_in_samplerate(gfp, sample_rate)
        lib.lame_set_out_samplerate(gfp, sample_rate)
        lib.lame_set_num_channels(gfp, 1)
        lib.lame_set_mode(gfp, 3)  # MONO
        lib.lame_set_brate(gfp, bitrate_kbps)
        lib.lame_set_quality(gfp, 2)
        if lib.lame_init_params(gfp) < 0:
            raise RuntimeError("lame_init_params failed (rate/bitrate combo?)")
        out = ctypes.create_string_buffer(pcm.nbytes // 4 * 5 + 7200)
        n = lib.lame_encode_buffer(
            gfp, pcm.ctypes.data, None, len(pcm), out, len(out)
        )
        if n < 0:
            raise RuntimeError(f"lame_encode_buffer error {n}")
        tail = ctypes.create_string_buffer(7200)
        m = lib.lame_encode_flush(gfp, tail, len(tail))
        if m < 0:
            raise RuntimeError(f"lame_encode_flush error {m}")
        data = bytearray(out.raw[:n] + tail.raw[:m])
        # Finalize the Xing/Info (LAME) header frame: lame emits a
        # PLACEHOLDER first frame during encoding and expects the caller
        # to overwrite it with the finalized tag after flush — the tag
        # carries the encoder delay/padding that lets decoders (libmpg123,
        # ffmpeg) gapless-trim. Without this, decoded audio gains ~44 ms
        # of leading silence and ~2.8k trailing samples, so self-packed
        # containers would disagree with reference ffmpeg-made ones and
        # with their own length_samples column.
        tag = ctypes.create_string_buffer(2880)
        sz = lib.lame_get_lametag_frame(gfp, tag, len(tag))
        if 0 < sz <= len(data):
            data[:sz] = tag.raw[:sz]
        return bytes(data)
    finally:
        lib.lame_close(gfp)
