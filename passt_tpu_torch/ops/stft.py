"""Power-spectrogram STFT pieces, in PyTorch (port of passt_tpu/ops/stft.py).

Semantics match ``torch.stft(x, n_fft, hop, win_length, center=True,
window=hann(win_length, periodic=False))`` followed by ``re^2 + im^2``, as
the reference frontend uses it: reflect padding by ``n_fft // 2`` on both
sides, the Hann window zero-padded centred inside the ``n_fft`` frame, and
``1 + (T_padded - n_fft) // hop`` frames.

:func:`stft_power` is the matmul formulation (frames as a strided view
times the windowed-DFT basis, in fp32): the plain version beside the mel
kernel, and the path a CPU tensor takes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

PREEMPHASIS_COEFF = 0.97  # reference preprocess.py:46


def hann_window(win_length: int, dtype=np.float64) -> np.ndarray:
    """Symmetric (``periodic=False``) Hann window, as ``torch.hann_window``."""
    n = np.arange(win_length, dtype=dtype)
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * n / (win_length - 1)))


def num_stft_frames(num_samples: int, n_fft: int, hop: int, center: bool = True) -> int:
    """Frame count produced for a signal of ``num_samples`` samples."""
    if center:
        num_samples = num_samples + 2 * (n_fft // 2)
    return 1 + (num_samples - n_fft) // hop


@functools.lru_cache(maxsize=8)
def make_stft_filters(n_fft: int, win_length: int) -> np.ndarray:
    """Windowed real-DFT basis, shape ``(2*(n_fft//2+1), n_fft)``, built in
    float64 and stored as float32.

    Row ``f`` is ``w[t] * cos(2*pi*f*t/n_fft)`` and row ``n_bins + f`` is
    ``-w[t] * sin(2*pi*f*t/n_fft)``, where ``w`` is the Hann window
    zero-padded centred into the ``n_fft`` frame. The cached array is shared:
    callers must not write to it.
    """
    n_bins = n_fft // 2 + 1
    window = np.zeros(n_fft, dtype=np.float64)
    left = (n_fft - win_length) // 2
    window[left : left + win_length] = hann_window(win_length)

    t = np.arange(n_fft, dtype=np.float64)
    f = np.arange(n_bins, dtype=np.float64)[:, None]
    phase = 2.0 * np.pi * f * t[None, :] / n_fft
    cos_f = np.cos(phase) * window[None, :]
    sin_f = -np.sin(phase) * window[None, :]
    filters = np.concatenate([cos_f, sin_f], axis=0).astype(np.float32)
    filters.flags.writeable = False
    return filters


def preemphasis(x: torch.Tensor, coeff: float = PREEMPHASIS_COEFF) -> torch.Tensor:
    """``y[t] = x[t+1] - coeff*x[t]`` in fp32; one sample shorter than ``x``."""
    x = x.float()
    return x[:, 1:] - coeff * x[:, :-1]


def reflect_pad_center(x: torch.Tensor, n_fft: int) -> torch.Tensor:
    """torch.stft ``center=True`` reflect padding (``n_fft // 2`` both sides)."""
    pad = n_fft // 2
    return F.pad(x[:, None, :], (pad, pad), mode="reflect")[:, 0, :]


def stft_power(
    x: torch.Tensor,
    n_fft: int = 1024,
    hop: int = 320,
    win_length: int = 800,
    center: bool = True,
) -> torch.Tensor:
    """Power spectrogram ``[B, n_fft//2 + 1, frames]`` (fp32): frames as a
    strided view of the padded signal, times the windowed-DFT basis."""
    if x.ndim != 2:
        raise ValueError(f"expected a [B, T] waveform, got {tuple(x.shape)}")
    x = x.float()
    if center:
        x = reflect_pad_center(x, n_fft)
    framed = x.unfold(1, n_fft, hop)  # [B, frames, n_fft], a view
    basis = torch.from_numpy(make_stft_filters(n_fft, win_length).copy()).to(x.device)
    out = torch.matmul(framed, basis.T).transpose(1, 2)  # [B, 2*bins, frames]
    n_bins = n_fft // 2 + 1
    re, im = out[:, :n_bins], out[:, n_bins:]
    return re * re + im * im
