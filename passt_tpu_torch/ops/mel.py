"""Kaldi-compatible triangular mel filterbanks (port of passt_tpu/ops/mel.py).

The reference builds its bank with ``torchaudio.compliance.kaldi.get_mel_banks``
at a VTLN warp factor of 1.0, which reduces to plain triangles on the Kaldi
mel scale ``m(f) = 1127 * ln(1 + f/700)``. The bank covers FFT bins
``0 .. n_fft//2 - 1``: the Nyquist bin is left out.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def hz_to_mel(freq):
    """Kaldi mel scale (natural log, 1127 factor), on tensors or numpy/floats
    (numpy in float64)."""
    if isinstance(freq, torch.Tensor):
        return 1127.0 * torch.log1p(freq / 700.0)
    return 1127.0 * np.log(1.0 + np.asarray(freq, dtype=np.float64) / 700.0)


def mel_to_hz(mel):
    if isinstance(mel, torch.Tensor):
        return 700.0 * (torch.exp(mel / 1127.0) - 1.0)
    return 700.0 * (np.exp(np.asarray(mel, dtype=np.float64) / 1127.0) - 1.0)


def kaldi_mel_banks(
    n_mels: int,
    n_fft: int,
    sample_rate: float,
    fmin,
    fmax,
    *,
    device=None,
    dtype=torch.float32,
) -> torch.Tensor:
    """Triangular Kaldi mel bank ``(n_mels, n_fft // 2)`` in fp32 on ``device``.

    ``fmin`` / ``fmax`` are floats or scalar tensors and go through fp32
    arithmetic; the FFT-bin mel values are baked in from float64, as the
    JAX package does. ``fmax <= 0`` counts from Nyquist, as in Kaldi.
    """
    nyquist = 0.5 * sample_rate

    fmin, fmax = (_scalar(f, device) for f in (fmin, fmax))
    fmax = torch.where(fmax <= 0.0, fmax + nyquist, fmax)

    mel_low = hz_to_mel(fmin)
    mel_high = hz_to_mel(fmax)
    mel_delta = (mel_high - mel_low) / (n_mels + 1)

    bins = torch.arange(n_mels, dtype=torch.float32, device=fmin.device)[:, None]
    left_mel = mel_low + bins * mel_delta
    center_mel = mel_low + (bins + 1.0) * mel_delta
    right_mel = mel_low + (bins + 2.0) * mel_delta

    mel = _fft_bin_mels(n_fft, float(sample_rate), fmin.device)[None, :]

    up_slope = (mel - left_mel) / (center_mel - left_mel)
    down_slope = (right_mel - mel) / (right_mel - center_mel)
    weights = torch.clamp(torch.minimum(up_slope, down_slope), min=0.0)
    return weights.to(dtype)


def _scalar(value, device) -> torch.Tensor:
    """An fp32 scalar tensor on ``device``; a float is filled in place, so no
    host-to-device copy waits on the stream."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=torch.float32)
    return torch.full((), float(value), dtype=torch.float32, device=device)


def _fft_bin_mels(n_fft: int, sample_rate: float, device: torch.device) -> torch.Tensor:
    """The mel value of each FFT bin ``0 .. n_fft//2 - 1``, from float64,
    kept on ``device`` once (the training frontend builds a bank per step).
    A traced call (``torch.export``) makes its own: the tensor it would keep
    is the tracer's fake one."""
    if torch.compiler.is_compiling():
        return _fft_bin_mels_host(n_fft, sample_rate).to(device)
    return _fft_bin_mels_on(n_fft, sample_rate, device)


@functools.lru_cache(maxsize=16)
def _fft_bin_mels_on(n_fft: int, sample_rate: float, device: torch.device) -> torch.Tensor:
    return _fft_bin_mels_host(n_fft, sample_rate).to(device)


def _fft_bin_mels_host(n_fft: int, sample_rate: float) -> torch.Tensor:
    freqs = (sample_rate / n_fft) * np.arange(n_fft // 2, dtype=np.float64)
    return torch.from_numpy(hz_to_mel(freqs).astype(np.float32))


def kaldi_mel_banks_np(
    n_mels: int,
    n_fft: int,
    sample_rate: float,
    fmin: float,
    fmax: float,
) -> np.ndarray:
    """NumPy float64 twin of :func:`kaldi_mel_banks`, for host precomputation
    and as an independent cross-check."""
    num_fft_bins = n_fft // 2
    nyquist = 0.5 * sample_rate
    if fmax <= 0.0:
        fmax = fmax + nyquist

    mel_low = hz_to_mel(float(fmin))
    mel_high = hz_to_mel(float(fmax))
    mel_delta = (mel_high - mel_low) / (n_mels + 1)

    bins = np.arange(n_mels, dtype=np.float64)[:, None]
    left_mel = mel_low + bins * mel_delta
    center_mel = mel_low + (bins + 1.0) * mel_delta
    right_mel = mel_low + (bins + 2.0) * mel_delta

    freqs = (sample_rate / n_fft) * np.arange(num_fft_bins, dtype=np.float64)
    mel = hz_to_mel(freqs)[None, :]

    up_slope = (mel - left_mel) / (center_mel - left_mel)
    down_slope = (right_mel - mel) / (right_mel - center_mel)
    return np.maximum(0.0, np.minimum(up_slope, down_slope))
