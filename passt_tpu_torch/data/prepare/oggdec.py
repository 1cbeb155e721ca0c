"""In-process Ogg/Vorbis decoding via the system libvorbisfile (ctypes; port
of passt_tpu/data/prepare/oggdec.py).

OpenMIC-2018 ships as .ogg files; the reference converts them to mp3 by
shelling out to ffmpeg per file (reference:
openmic/prepare_scripts/download_preprocess.py:50-54). Together with the
libmp3lame encoder (:mod:`passt_tpu_torch.data.prepare.mp3enc`) this makes the
whole OpenMIC prep chain run in-process with zero external binaries.

Only the stable public libvorbisfile ABI is used: ``ov_fopen`` /
``ov_info`` / ``ov_read`` / ``ov_clear``. ``vorbis_info``'s leading fields
(int version; int channels; long rate) are a frozen public struct prefix.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
from typing import Optional, Tuple

import numpy as np

_vf = None

# OggVorbis_File is ~944 bytes on LP64; over-allocate for safety.
_OV_FILE_BYTES = 4096


class _VorbisInfoPrefix(ctypes.Structure):
    _fields_ = [
        ("version", ctypes.c_int),
        ("channels", ctypes.c_int),
        ("rate", ctypes.c_long),
    ]


def _load() -> Optional[ctypes.CDLL]:
    global _vf
    if _vf is not None:
        return _vf
    name = ctypes.util.find_library("vorbisfile") or "libvorbisfile.so.3"
    try:
        lib = ctypes.CDLL(name)
    except OSError:
        return None
    lib.ov_fopen.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
    lib.ov_fopen.restype = ctypes.c_int
    lib.ov_info.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ov_info.restype = ctypes.POINTER(_VorbisInfoPrefix)
    lib.ov_read.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.ov_read.restype = ctypes.c_long
    lib.ov_clear.argtypes = [ctypes.c_void_p]
    _vf = lib
    return lib


def available() -> bool:
    """True when libvorbisfile is loadable on this host."""
    return _load() is not None


def decode_ogg(path: str) -> Tuple[np.ndarray, int]:
    """Decode an .ogg file -> (float32 mono waveform, native sample rate).

    Multi-channel files are averaged to mono (the ffmpeg default the
    reference relies on for mono mp3 output)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("libvorbisfile not found on this host")
    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    vf = ctypes.create_string_buffer(_OV_FILE_BYTES)
    rc = lib.ov_fopen(path.encode(), vf)
    if rc != 0:
        raise ValueError(f"ov_fopen failed ({rc}) on {path}")
    try:
        info = lib.ov_info(vf, -1)
        if not info:
            raise ValueError(f"ov_info failed on {path}")
        channels = int(info.contents.channels)
        rate = int(info.contents.rate)
        if channels <= 0 or rate <= 0:
            raise ValueError(f"bad ogg stream params ({channels} ch, {rate} Hz)")
        chunks = []
        buf = ctypes.create_string_buffer(1 << 16)
        bitstream = ctypes.c_int(0)
        OV_HOLE = -3  # data interruption: recoverable, ov_read advances
        errs = 0
        while True:
            n = lib.ov_read(
                vf, buf, len(buf), 0, 2, 1, ctypes.byref(bitstream)
            )  # little-endian signed 16-bit
            if n == 0:
                break
            if n < 0:
                # Only OV_HOLE is a skip (ffmpeg is tolerant of holes too);
                # persistent errors (OV_EBADLINK/OV_EINVAL) would otherwise
                # spin this loop forever on a corrupt file. The cap also
                # bounds a pathological hole-only stream.
                errs += 1
                if n != OV_HOLE or errs > 1000:
                    raise ValueError(f"ov_read failed ({n}) on {path}")
                continue
            errs = 0
            # one copy, not three: buf.raw materializes the whole 64 KB
            # buffer and [:n] copies again; frombuffer reads the ctypes
            # memory directly and .copy() detaches from the reused buffer
            chunks.append(np.frombuffer(buf, dtype="<i2", count=n // 2).copy())
        if not chunks:
            raise ValueError(f"no audio decoded from {path}")
        pcm = np.concatenate(chunks).astype(np.float32) / 32768.0
        if channels > 1:
            pcm = pcm[: len(pcm) - len(pcm) % channels]
            pcm = pcm.reshape(-1, channels).mean(axis=1)
        return pcm, rate
    finally:
        lib.ov_clear(vf)
