"""Power-spectrogram STFT pieces, in PyTorch (port of passt_tpu/ops/stft.py).

Semantics match ``torch.stft(x, n_fft, hop, win_length, center=True,
window=hann(win_length, periodic=False))`` followed by ``re^2 + im^2``, as
the reference frontend uses it: reflect padding by ``n_fft // 2`` on both
sides, the Hann window zero-padded centred inside the ``n_fft`` frame, and
``1 + (T_padded - n_fft) // hop`` frames.

:func:`stft_power` takes the JAX package's three formulations, all in full
fp32: "matmul" (frames as a strided view times the windowed-DFT basis: the
plain version beside the mel kernel), "conv" (one strided convolution with
the basis as filters) and "fft" (framing, window, real FFT). They differ
only in summation order.
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


def _prepare(x: torch.Tensor, n_fft: int, center: bool) -> torch.Tensor:
    if x.ndim != 2:
        raise ValueError(f"expected a [B, T] waveform, got {tuple(x.shape)}")
    x = x.float()
    return reflect_pad_center(x, n_fft) if center else x


def _basis(n_fft: int, win_length: int, device) -> torch.Tensor:
    return torch.from_numpy(make_stft_filters(n_fft, win_length).copy()).to(device)


def _power(out: torch.Tensor, n_fft: int) -> torch.Tensor:
    """``re^2 + im^2`` of a ``[B, 2*bins, frames]`` DFT output."""
    n_bins = n_fft // 2 + 1
    re, im = out[:, :n_bins], out[:, n_bins:]
    return re * re + im * im


def stft_power_matmul(x: torch.Tensor, n_fft: int = 1024, hop: int = 320, win_length: int = 800,
                      center: bool = True) -> torch.Tensor:
    """Frames as a strided view of the padded signal, times the
    windowed-DFT basis (fp32 matmul)."""
    x = _prepare(x, n_fft, center)
    framed = x.unfold(1, n_fft, hop)  # [B, frames, n_fft], a view
    return _power(torch.matmul(framed, _basis(n_fft, win_length, x.device).T).transpose(1, 2), n_fft)


def stft_power_conv(x: torch.Tensor, n_fft: int = 1024, hop: int = 320, win_length: int = 800,
                    center: bool = True) -> torch.Tensor:
    """One strided convolution whose filters are the windowed-DFT basis (the
    JAX package's TPU formulation), in full fp32: cuDNN's TF32 is off
    inside the call."""
    x = _prepare(x, n_fft, center)
    filters = _basis(n_fft, win_length, x.device)[:, None, :]  # [2*bins, 1, n_fft]
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark, deterministic=cudnn.deterministic,
                     allow_tf32=False):
        out = F.conv1d(x[:, None, :], filters, stride=hop)  # [B, 2*bins, frames]
    return _power(out, n_fft)


def stft_power_fft(x: torch.Tensor, n_fft: int = 1024, hop: int = 320, win_length: int = 800,
                   center: bool = True) -> torch.Tensor:
    """Framing, the centred window, and ``torch.fft.rfft`` (the reference's
    cross-check path)."""
    x = _prepare(x, n_fft, center)
    window = np.zeros(n_fft, dtype=np.float32)
    left = (n_fft - win_length) // 2
    window[left : left + win_length] = hann_window(win_length).astype(np.float32)
    framed = x.unfold(1, n_fft, hop) * torch.from_numpy(window).to(x.device)
    spec = torch.fft.rfft(framed, dim=-1)  # [B, frames, bins]
    return (spec.real**2 + spec.imag**2).transpose(1, 2)


_METHODS = {"matmul": stft_power_matmul, "conv": stft_power_conv, "fft": stft_power_fft}


def stft_power(
    x: torch.Tensor,
    n_fft: int = 1024,
    hop: int = 320,
    win_length: int = 800,
    center: bool = True,
    method: str = "matmul",
) -> torch.Tensor:
    """Power spectrogram ``[B, n_fft//2 + 1, frames]`` (fp32) by the JAX
    package's ``method``: "matmul" (the plain version beside the mel
    kernel), "conv" or "fft"."""
    if method not in _METHODS:
        raise ValueError(f"unknown stft method {method!r}")
    return _METHODS[method](x, n_fft, hop, win_length, center)
