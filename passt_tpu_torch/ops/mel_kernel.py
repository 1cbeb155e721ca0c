"""Fused log-mel: waveform -> normalised log-mel spectrogram, as one Hopper
kernel (``csrc/mel_kernel.cu``), with its plain PyTorch version beside it.

Port of passt_tpu/ops/pallas/mel_kernel.py (``fused_log_mel`` and its
``_mel_kernel``). Pre-emphasis and reflect padding happen in PyTorch, as they
happen in XLA on the TPU; framing, DFT, power, mel bank, log and the affine
normalisation run in the kernel. Both products stay in full fp32.

Dispatch: a CPU tensor goes to :func:`fused_log_mel_plain`; a CUDA tensor
launches the kernel or raises. Unlike the TPU kernel there is no hop gate:
the hop-100 and hop-160 archs run on the kernel too.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from passt_tpu_torch.ops import _build
from passt_tpu_torch.ops.stft import make_stft_filters, preemphasis, reflect_pad_center, stft_power

_LAUNCHES_KEY = "fused_log_mel"
_build.LAUNCHES.setdefault(_LAUNCHES_KEY, 0)

#: the kernel's limits (csrc/mel_kernel.cu): bins per chunk and mels per block
_FREQ_CHUNK = 128
_MAX_MELS = 128


def fused_log_mel_plain(
    wave: torch.Tensor,
    mel_bank: torch.Tensor,
    *,
    n_fft: int = 1024,
    hop: int = 320,
    win_length: int = 800,
    log_offset: float = 1e-5,
    norm_shift: float = 4.5,
    norm_scale: float = 5.0,
) -> torch.Tensor:
    """The kernel's function in plain PyTorch: [B, T] -> [B, n_mels, frames]."""
    power = stft_power(preemphasis(wave), n_fft, hop, win_length, center=True)
    n_freq = mel_bank.shape[1]
    mel = torch.matmul(mel_bank.float(), power[:, :n_freq, :])
    mel = torch.log(mel + log_offset)
    return (mel + norm_shift) / norm_scale


@functools.lru_cache(maxsize=8)
def _window_basis(n_fft: int, win_length: int, n_freq: int, device: torch.device):
    """The DFT basis rows under the window's non-zero span, laid out for the
    kernel: ``[win_length, 2 * n_freq]`` fp32 (re columns, then im), plus the
    span's first sample."""
    filters = make_stft_filters(n_fft, win_length)  # [2 * n_bins, n_fft]
    n_bins = n_fft // 2 + 1
    left = (n_fft - win_length) // 2
    rows = slice(left, left + win_length)
    basis = torch.cat(
        [
            torch.from_numpy(filters[:n_freq, rows].T.copy()),
            torch.from_numpy(filters[n_bins : n_bins + n_freq, rows].T.copy()),
        ],
        dim=1,
    )
    return basis.contiguous().to(device), left


@functools.cache
def _lib():
    """The kernel library, built and bound on first use."""
    lib = _build.load("mel_kernel")
    vp, i64, i32, f32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    lib.passt_log_mel.argtypes = [
        vp, i64, i64, i32, i32, i32, vp, i32, i32, vp, i32, vp, f32, f32, f32, vp,
    ]
    lib.passt_log_mel.restype = ctypes.c_int
    return lib


def fused_log_mel(
    wave: torch.Tensor,
    mel_bank: torch.Tensor,
    *,
    n_fft: int = 1024,
    hop: int = 320,
    win_length: int = 800,
    log_offset: float = 1e-5,
    norm_shift: float = 4.5,
    norm_scale: float = 5.0,
) -> torch.Tensor:
    """[B, T] waveform + [n_mels, n_freq] mel bank -> [B, n_mels, frames] fp32.

    ``n_freq`` is ``n_fft // 2`` for the frontend's bank (the Nyquist bin is
    dropped). A CPU tensor takes :func:`fused_log_mel_plain`.
    """
    if wave.ndim != 2:
        raise ValueError(f"expected a [B, T] waveform, got {tuple(wave.shape)}")
    kwargs = dict(
        n_fft=n_fft, hop=hop, win_length=win_length,
        log_offset=log_offset, norm_shift=norm_shift, norm_scale=norm_scale,
    )
    if wave.device.type == "cpu":
        return fused_log_mel_plain(wave, mel_bank, **kwargs)
    if wave.device.type != "cuda":
        raise ValueError(f"fused_log_mel runs on CPU or CUDA tensors, got {wave.device}")

    n_mels, n_freq = mel_bank.shape
    if n_freq > n_fft // 2 + 1 or n_freq % _FREQ_CHUNK or n_mels > _MAX_MELS:
        raise ValueError(
            f"mel kernel needs n_freq <= n_fft//2+1 in multiples of {_FREQ_CHUNK} and "
            f"n_mels <= {_MAX_MELS}; got bank {tuple(mel_bank.shape)} at n_fft {n_fft}"
        )
    if mel_bank.device != wave.device:
        raise ValueError(f"mel bank on {mel_bank.device}, wave on {wave.device}")
    lib = _lib()
    x = reflect_pad_center(preemphasis(wave), n_fft).contiguous()
    b, t_padded = x.shape
    frames = 1 + (t_padded - n_fft) // hop
    basis, left = _window_basis(n_fft, win_length, n_freq, wave.device)
    bank_t = mel_bank.float().T.contiguous()  # [n_freq, n_mels]
    out = torch.empty((b, n_mels, frames), dtype=torch.float32, device=wave.device)
    code = lib.passt_log_mel(
        ctypes.c_void_p(x.data_ptr() + 4 * left), t_padded, t_padded - left,
        b, frames, hop,
        ctypes.c_void_p(basis.data_ptr()), win_length, n_freq,
        ctypes.c_void_p(bank_t.data_ptr()), n_mels,
        ctypes.c_void_p(out.data_ptr()),
        log_offset, norm_shift, norm_scale,
        _build.stream_of(wave),
    )
    _build.check(lib, code, "mel kernel launch")
    _build.LAUNCHES[_LAUNCHES_KEY] += 1
    return out
