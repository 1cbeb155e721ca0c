"""In-process WAV decode + high-quality resample for the offline prep tools
(port of passt_tpu/data/prepare/wavdec.py).

The reference preps ESC-50/FSD50K by shelling out to ffmpeg/librosa
(fsd50k/prepare_scripts/convert_to_mp3.py:36 ``ffmpeg ... -ar 32000``;
esc50/dataset.py:182 ``librosa.load(path, sr=32000, mono=True)``). Both
datasets ship 44.1 kHz PCM WAVs; this module decodes them with a minimal
RIFF chunk walk (PCM 16/24/32-bit, IEEE float32/float64, and
WAVE_FORMAT_EXTENSIBLE carriers of either — the stdlib ``wave`` module
rejects float and, before Python 3.12, extensible containers;
multi-channel averaged to mono exactly as ``mono=True`` does) and
resamples with an anti-aliased
polyphase filter (scipy ``resample_poly``, the same windowed-sinc family
librosa/ffmpeg use) — zero external binaries, matching the repo's
in-process prep plane (mp3enc/oggdec). ``resample`` is the port's one
resampler: :mod:`passt_tpu_torch.data.datasets` imports it from here.
"""

from __future__ import annotations

import math
import warnings
from typing import Tuple

import numpy as np


def decode_wav(path: str) -> Tuple[np.ndarray, int]:
    """Decode a RIFF WAV file -> (float32 mono waveform in [-1, 1], rate).

    Supports PCM int16/int24/int32 and IEEE float32/float64 frames; stereo
    and multi-channel files are averaged to mono (librosa ``mono=True``
    semantics, esc50/dataset.py:182).
    """
    with open(path, "rb") as f:
        header = f.read(12)
    if len(header) < 12 or header[:4] != b"RIFF" or header[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")

    # One chunk walk covers every format: the stdlib wave module rejects
    # WAVE_FORMAT_IEEE_FLOAT outright and (before Python 3.12) also
    # WAVE_FORMAT_EXTENSIBLE containers whose subformat is plain PCM, and
    # re-reading frames it had already read doubles prep I/O — so decode
    # straight from the parsed data chunk for all of them.
    fmt_code, channels, rate, bits, data = _read_chunks(path)
    if channels < 1 or bits < 8:
        raise ValueError(f"{path}: missing or malformed fmt chunk")
    # guard a truncated final frame (size field larger than the bytes on
    # disk): clip to whole frames so frombuffer/reshape can't fail
    frame_bytes = channels * (bits // 8)
    if frame_bytes and len(data) % frame_bytes:
        data = data[: len(data) - (len(data) % frame_bytes)]
    # Integer widths require WAVE_FORMAT_PCM (code 1) — a 16/32-bit frame of
    # some exotic compressed codec (ADPCM, a-law, ...) must not be decoded as
    # little-endian PCM garbage; float widths require WAVE_FORMAT_IEEE_FLOAT
    # (code 3). Anything else falls through to the ValueError below.
    if bits == 16 and fmt_code == 1:
        x = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
    elif bits == 32 and fmt_code == 3:
        x = np.frombuffer(data, dtype="<f4").astype(np.float32)
    elif bits == 64 and fmt_code == 3:
        x = np.frombuffer(data, dtype="<f8").astype(np.float32)
    elif bits == 32 and fmt_code == 1:
        x = np.frombuffer(data, dtype="<i4").astype(np.float32) / 2147483648.0
    elif bits == 24 and fmt_code == 1:
        b = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
        i32 = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        i32 = (i32 << 8) >> 8  # sign-extend 24 -> 32
        x = i32.astype(np.float32) / 8388608.0
    else:
        raise ValueError(f"{path}: unsupported WAV format (code={fmt_code}, bits={bits})")
    if channels > 1:
        # len(x) is a whole number of frames already (the raw data bytes were
        # clipped to frame_bytes above), so this reshape cannot fail.
        x = x.reshape(-1, channels).mean(axis=1)
    return np.ascontiguousarray(x, dtype=np.float32), rate


def _read_chunks(path: str) -> Tuple[int, int, int, int, bytes]:
    """Minimal RIFF chunk walk: returns (fmt_code, channels, rate, bits, data)."""
    fmt_code = channels = rate = bits = 0
    data = b""
    with open(path, "rb") as f:
        f.seek(12)
        while True:
            head = f.read(8)
            if len(head) < 8:
                break
            cid, size = head[:4], int.from_bytes(head[4:8], "little")
            if cid == b"fmt ":
                fmt = f.read(size)
                fmt_code = int.from_bytes(fmt[0:2], "little")
                channels = int.from_bytes(fmt[2:4], "little")
                rate = int.from_bytes(fmt[4:8], "little")
                bits = int.from_bytes(fmt[14:16], "little")
                if fmt_code == 0xFFFE and size >= 26:  # WAVE_FORMAT_EXTENSIBLE
                    fmt_code = int.from_bytes(fmt[24:26], "little")
            elif cid == b"data":
                data = f.read(size)
            else:
                f.seek(size + (size & 1), 1)
                continue
            if size & 1:
                f.seek(1, 1)
    return fmt_code, channels, rate, bits, data


def resample(wave_f32: np.ndarray, src_rate: int, dst_rate: int) -> np.ndarray:
    """Anti-aliased polyphase resample (44.1 kHz -> 32 kHz: up=320/down=441).

    Uses scipy's ``resample_poly`` (windowed-sinc, the standard prep-quality
    resampler); integer-stride decimation when src is an exact multiple
    (the container contract stride_resample assumes, datasets.py); falls
    back to linear interpolation with a warning when scipy is absent.
    """
    if src_rate == dst_rate:
        return np.asarray(wave_f32, np.float32)
    if src_rate % dst_rate == 0:
        return np.asarray(wave_f32[:: src_rate // dst_rate], np.float32)
    try:
        from scipy.signal import resample_poly
    except ImportError:  # pragma: no cover - scipy is on both machines
        warnings.warn(
            "scipy unavailable: falling back to linear-interp resample "
            "(no anti-aliasing filter)"
        )
        n_out = int(round(len(wave_f32) * dst_rate / src_rate))
        t = np.arange(n_out) * (src_rate / dst_rate)
        return np.interp(t, np.arange(len(wave_f32)), wave_f32).astype(np.float32)
    g = math.gcd(src_rate, dst_rate)
    return resample_poly(wave_f32, dst_rate // g, src_rate // g).astype(np.float32)
