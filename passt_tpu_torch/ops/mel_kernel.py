"""Fused log-mel: waveform -> normalised log-mel spectrogram, as one Hopper
kernel (``csrc/mel_kernel.cu``), with its plain PyTorch version beside it.

Port of passt_tpu/ops/pallas/mel_kernel.py (``fused_log_mel`` and its
``_mel_kernel``). The kernel takes the raw wave: pre-emphasis, reflect
padding, the window, one real FFT of ``n_fft`` points per frame (fp32 on
the FMA units), the power, the mel bank over each row's non-zero span, the
log and the affine normalisation all run on the card, in two launches (a
prologue finds each mel row's span and compacts its taps, then the main
kernel, launched behind it with programmatic dependent launch).

Dispatch: a CPU tensor goes to :func:`fused_log_mel_plain`; a CUDA tensor
launches the kernel or raises. The geometry gate (:func:`kernel_supports`:
``n_fft`` a power of two from 64 to 2048, at most 256 mels) holds on both,
as the JAX kernel's gate does; the frontend's ``stft_method="auto"`` takes
the plain "matmul" formulation where it fails, as the JAX frontend's does.
Unlike the TPU kernel there is no hop gate: the hop-100 and hop-160 archs
run on the kernel too.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from passt_tpu_torch.ops import _build
from passt_tpu_torch.ops.stft import hann_window, preemphasis, stft_power

_LAUNCHES_KEY = "fused_log_mel"
_build.LAUNCHES.setdefault(_LAUNCHES_KEY, 0)

#: the kernel's limits (csrc/mel_kernel.cu): n_fft a power of two in this
#: range; mels per call
N_FFT_RANGE = (64, 2048)
_MAX_MELS = 256


def kernel_supports(n_fft: int, n_mels: int = 1) -> bool:
    """True where the kernel takes this geometry: ``n_fft`` a power of two
    from 64 to 2048 (every arch of the registry uses 1024) and at most 256
    mels."""
    return N_FFT_RANGE[0] <= n_fft <= N_FFT_RANGE[1] and n_fft & (n_fft - 1) == 0 and n_mels <= _MAX_MELS


def fft_radices(n_fft: int) -> tuple:
    """The radices of the kernel's Stockham passes over ``n_fft // 2``
    complex points: a 2 or a 4 first where log2(n_fft / 2) is not a
    multiple of 3, then 8s (512 = 8 * 8 * 8)."""
    log_m = (n_fft // 2).bit_length() - 1
    first = (8, 2, 4)[log_m % 3]
    return (first,) + (8,) * ((log_m - {8: 3, 2: 1, 4: 2}[first]) // 3)


def twiddles(n_fft: int) -> np.ndarray:
    """``e^{-2 pi i u / n_fft}`` for u < n_fft as fp32 (cos, -sin) pairs
    ``[n_fft, 2]``, computed in float64 and rounded once."""
    phase = 2.0 * np.pi * np.arange(n_fft, dtype=np.float64) / n_fft
    return np.stack([np.cos(phase), -np.sin(phase)], axis=1).astype(np.float32)


def fft_tables(n_fft: int, win_length: int) -> np.ndarray:
    """The kernel's fp32 table, ``4 n_fft`` values: :func:`twiddles`; then
    the Stockham passes after the first, each ``7 ns`` pairs with entry
    ``(r - 1) ns + k`` the twiddle of k r in that pass (so that neighbouring
    lanes read neighbouring entries), padded to ``n_fft / 2`` pairs; then
    the Hann window zero-padded centred into the frame. Every value is a
    float64 one rounded once."""
    tw = twiddles(n_fft)
    radices = fft_radices(n_fft)
    passes, ns = [], radices[0]
    for radix in radices[1:]:
        k = np.arange(ns)
        passes += [tw[k * r * (n_fft // (ns * radix))] for r in range(1, radix)]
        ns *= radix
    pass_tab = np.zeros((n_fft // 2, 2), dtype=np.float32)
    if passes:
        flat = np.concatenate(passes)
        pass_tab[: len(flat)] = flat
    window = np.zeros(n_fft, dtype=np.float64)
    left = (n_fft - win_length) // 2
    window[left : left + win_length] = hann_window(win_length)
    return np.concatenate([tw.reshape(-1), pass_tab.reshape(-1), window.astype(np.float32)])


def mel_spans_plain(mel_bank: torch.Tensor) -> torch.Tensor:
    """Each mel row's non-zero span ``[lo, hi)`` as int32 ``[n_mels, 2]``
    (``[0, 0]`` for an all-zero row): what the kernel's prologue finds."""
    nz = mel_bank != 0
    n_freq = mel_bank.shape[1]
    k = torch.arange(n_freq, device=mel_bank.device)
    lo = torch.where(nz, k, n_freq).amin(dim=1)
    hi = torch.where(nz, k + 1, 0).amax(dim=1)
    empty = hi == 0
    return torch.stack([torch.where(empty, 0, lo), hi], dim=1).to(torch.int32)


def check_geometry(wave: torch.Tensor, mel_bank: torch.Tensor, n_fft: int, hop: int, win_length: int) -> None:
    """Raise ``ValueError`` for a call the kernel cannot take."""
    if wave.ndim != 2:
        raise ValueError(f"expected a [B, T] waveform, got {tuple(wave.shape)}")
    if not kernel_supports(n_fft):
        raise ValueError(
            f"mel kernel needs n_fft a power of two in [{N_FFT_RANGE[0]}, {N_FFT_RANGE[1]}], got n_fft={n_fft}; "
            "use stft_method='matmul'"
        )
    if hop <= 0 or not 0 < win_length <= n_fft:
        raise ValueError(f"mel kernel needs hop > 0 and 0 < win_length <= n_fft, got {hop}, {win_length}")
    n_mels, n_freq = mel_bank.shape
    if n_freq > n_fft // 2 + 1 or n_mels > _MAX_MELS:
        raise ValueError(
            f"mel kernel needs n_freq <= n_fft//2+1 and n_mels <= {_MAX_MELS}; got bank "
            f"{tuple(mel_bank.shape)} at n_fft {n_fft}"
        )


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
def _tables(n_fft: int, win_length: int, device: torch.device) -> torch.Tensor:
    """:func:`fft_tables` on ``device``, kept once per device."""
    return torch.from_numpy(fft_tables(n_fft, win_length)).to(device)


@functools.cache
def _lib():
    """The kernel library, built and bound on first use."""
    lib = _build.load("mel_kernel")
    vp, i64, i32, f32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
    lib.passt_log_mel.argtypes = [
        vp, i64, i64, i32, i32, i32, i32, i32, vp, vp, i32, i32, vp, vp, vp, f32, f32, f32, vp,
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
    dropped). A CPU tensor takes :func:`fused_log_mel_plain`. The call goes
    through the custom op ``passt::log_mel`` (``ops/library.py``), so that
    ``torch.export`` keeps the kernel in an exported program.
    """
    check_geometry(wave, mel_bank, n_fft, hop, win_length)
    return torch.ops.passt.log_mel(wave, mel_bank, n_fft, hop, win_length, log_offset, norm_shift, norm_scale)


def log_mel_on_device(
    wave: torch.Tensor, mel_bank: torch.Tensor, n_fft: int, hop: int, win_length: int,
    log_offset: float, norm_shift: float, norm_scale: float,
) -> torch.Tensor:
    """The body of ``passt::log_mel``: the plain version on a CPU tensor,
    the kernel on a CUDA tensor (raises on another device)."""
    kwargs = dict(
        n_fft=n_fft, hop=hop, win_length=win_length,
        log_offset=log_offset, norm_shift=norm_shift, norm_scale=norm_scale,
    )
    if wave.device.type == "cpu":
        return fused_log_mel_plain(wave, mel_bank, **kwargs)
    if wave.device.type != "cuda":
        raise ValueError(f"fused_log_mel runs on CPU or CUDA tensors, got {wave.device}")
    if mel_bank.device != wave.device:
        raise ValueError(f"mel bank on {mel_bank.device}, wave on {wave.device}")
    b, t = wave.shape
    if t - 1 <= n_fft // 2:
        # what F.pad(mode="reflect") refuses in the plain version
        raise ValueError(f"a wave of {t} samples is too short for the reflect padding of n_fft {n_fft}")
    lib = _lib()
    x = wave.float().contiguous()
    bank = mel_bank.float().contiguous()
    n_mels, n_freq = bank.shape
    frames = num_frames(t, hop)
    spans = torch.empty((n_mels + 1, 4), dtype=torch.int32, device=wave.device)
    taps = torch.empty(n_mels * n_freq, dtype=torch.float32, device=wave.device)
    out = torch.empty((b, n_mels, frames), dtype=torch.float32, device=wave.device)
    code = lib.passt_log_mel(
        ctypes.c_void_p(x.data_ptr()), x.stride(0), t, b, frames, n_fft, hop, win_length,
        ctypes.c_void_p(_tables(n_fft, win_length, wave.device).data_ptr()),
        ctypes.c_void_p(bank.data_ptr()), n_mels, n_freq,
        ctypes.c_void_p(spans.data_ptr()), ctypes.c_void_p(taps.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        log_offset, norm_shift, norm_scale,
        _build.stream_of(wave),
    )
    _build.check(lib, code, "mel kernel launch")
    _build.LAUNCHES[_LAUNCHES_KEY] += 1
    return out


def num_frames(num_samples: int, hop: int) -> int:
    """Frames of a ``num_samples`` wave: the centred STFT of its pre-emphasis
    (one sample shorter), on the kernel and the plain version alike."""
    return 1 + (num_samples - 1) // hop
