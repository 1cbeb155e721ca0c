"""The augmented log-mel frontend: waveform -> normalised log-mel
spectrogram (port of passt_tpu/ops/frontend.py).

waveform [B, T]
  -> pre-emphasis ``y[t] = x[t+1] - 0.97 * x[t]``
  -> power STFT, n_fft 1024 / hop 320 / win 800 Hann
  -> random mel-range jitter of (fmin, fmax)          (train only)
  -> Kaldi triangular mel bank (fp32), ``log(mel + 1e-5)``
  -> SpecAugment frequency + time masking             (train only)
  -> fixed affine normalisation ``(x + 4.5) / 5``

Under ``stft_method`` "pallas" (and "auto" where the kernel takes the
geometry: a power-of-two ``n_fft``, at most 256 mels; "matmul" otherwise)
the middle runs, on a CUDA tensor, as the Hopper mel kernel
(:func:`passt_tpu_torch.ops.mel_kernel.fused_log_mel`, un-normalised) with
the bank built on the card from the jittered (fmin, fmax); the masks and the
normalisation follow it, as on the TPU.

Randomness comes from an explicit ``torch.Generator`` on the wave's device,
drawn in a fixed order (fmin, fmax, frequency mask, time mask), so nothing
waits on the host. SpecAugment masks are shared across the batch by default
(``iid_masks=False``), with the start and width truncated to integers, as
the reference's 3-D masking call behaves (see :func:`_axis_mask`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from passt_tpu_torch.ops.mel import kaldi_mel_banks
from passt_tpu_torch.ops.mel_kernel import fused_log_mel, kernel_supports
from passt_tpu_torch.ops.stft import num_stft_frames, preemphasis, stft_power

LOG_OFFSET = 1e-5  # preprocess.py:78
NORM_SHIFT = 4.5  # preprocess.py:84
NORM_SCALE = 5.0
#: MelConfig.stft_method names; "pallas" selects the mel kernel, "auto" too
#: where the kernel takes the geometry
STFT_METHODS = ("auto", "pallas", "matmul", "conv", "fft")


@dataclasses.dataclass(frozen=True)
class MelConfig:
    """Frontend hyperparameters (defaults = reference AugmentMelSTFT defaults;
    the AudioSet recipe overrides fmin_aug_range=10, fmax_aug_range=2000)."""

    n_mels: int = 128
    sr: int = 32000
    win_length: int = 800
    hopsize: int = 320
    n_fft: int = 1024
    freqm: int = 48
    timem: int = 192
    fmin: float = 0.0
    fmax: Optional[float] = None  # None -> sr//2 - fmax_aug_range//2
    fmin_aug_range: int = 1
    fmax_aug_range: int = 1000
    iid_masks: bool = False
    stft_method: str = "auto"  # the JAX package's names: "pallas": the
    # mel kernel (its plain version for a CPU tensor); "auto": the same where
    # the kernel takes the geometry, else "matmul"; "matmul", "conv" or "fft":
    # that STFT formulation in plain PyTorch, on any device

    def __post_init__(self):
        if self.fmin_aug_range < 1 or self.fmax_aug_range < 1:
            raise ValueError("fmin_aug_range and fmax_aug_range must be >= 1 (1 = no augmentation)")
        if self.stft_method not in STFT_METHODS:
            raise ValueError(f"stft_method must be one of {STFT_METHODS}, got {self.stft_method!r}")

    @property
    def effective_fmax(self) -> float:
        if self.fmax is None:
            return self.sr // 2 - self.fmax_aug_range // 2
        return self.fmax

    def frames(self, num_samples: int) -> int:
        """Output frame count for a waveform of ``num_samples`` samples
        (pre-emphasis shortens the signal by one sample)."""
        return num_stft_frames(num_samples - 1, self.n_fft, self.hopsize)


def _axis_mask(
    generator: torch.Generator, batch: int, size: int, mask_param: int, iid: bool
) -> torch.Tensor:
    """SpecAugment mask along one axis -> boolean [batch, size] (True = masked),
    on the generator's device.

    width ~ U[0, mask_param), start ~ U[0, size - width). The shared mode
    (``iid=False``) truncates start and width to integers, as torchaudio's
    ``mask_along_axis`` does on the reference's 3-D input (a full-width mask
    is unreachable); ``iid=True`` keeps the float interval per sample.
    """
    n = batch if iid else 1
    device = generator.device
    width = torch.rand((n, 1), generator=generator, device=device) * mask_param
    start = torch.rand((n, 1), generator=generator, device=device) * (size - width)
    if not iid:
        width = torch.floor(width)
        start = torch.floor(start)
    idx = torch.arange(size, dtype=torch.float32, device=device)[None, :]
    mask = (idx >= start) & (idx < start + width)
    return mask if iid else mask.expand(batch, size)


def log_mel_spectrogram(
    wave: torch.Tensor,
    cfg: MelConfig = MelConfig(),
    *,
    generator: Optional[torch.Generator] = None,
    train: bool = False,
) -> torch.Tensor:
    """[B, T] float waveform -> [B, n_mels, frames] normalised log-mel (fp32).

    ``train=True`` needs ``generator`` (on the wave's device) and adds the
    mel-range jitter and SpecAugment."""
    if wave.ndim != 2:
        raise ValueError(f"expected [B, T], got {tuple(wave.shape)}")
    if train and generator is None:
        raise ValueError("train=True needs a generator")
    fmin, fmax = cfg.fmin, cfg.effective_fmax
    if train:
        dev = wave.device
        fmin = fmin + torch.randint(
            0, cfg.fmin_aug_range, (), generator=generator, device=dev
        ).float()
        fmax = (
            fmax + cfg.fmax_aug_range // 2
            - torch.randint(0, cfg.fmax_aug_range, (), generator=generator, device=dev).float()
        )
    bank = kaldi_mel_banks(cfg.n_mels, cfg.n_fft, cfg.sr, fmin, fmax, device=wave.device)
    method = cfg.stft_method
    if method == "auto":
        # the kernel where it takes the geometry, else the plain "matmul"
        # formulation, as the JAX frontend's "auto"
        method = "pallas" if kernel_supports(cfg.n_fft, cfg.n_mels) else "matmul"
    if method == "pallas":
        mel = fused_log_mel(
            wave.float(), bank, n_fft=cfg.n_fft, hop=cfg.hopsize, win_length=cfg.win_length,
            log_offset=LOG_OFFSET, norm_shift=0.0, norm_scale=1.0,
        )
    else:
        # the plain version's math (fused_log_mel_plain for "matmul") with
        # the named STFT formulation
        power = stft_power(preemphasis(wave), cfg.n_fft, cfg.hopsize, cfg.win_length, center=True,
                           method=method)
        mel = torch.log(torch.matmul(bank.float(), power[:, : bank.shape[1], :]) + LOG_OFFSET)
    if train:
        b, n_mels, frames = mel.shape
        if cfg.freqm > 0:
            fm = _axis_mask(generator, b, n_mels, cfg.freqm, cfg.iid_masks)
            mel = torch.where(fm[:, :, None], 0.0, mel)
        if cfg.timem > 0:
            tm = _axis_mask(generator, b, frames, cfg.timem, cfg.iid_masks)
            mel = torch.where(tm[:, None, :], 0.0, mel)
    return (mel + NORM_SHIFT) / NORM_SCALE


def mel_frontend(
    wave: torch.Tensor,
    cfg: MelConfig = MelConfig(),
    *,
    generator: Optional[torch.Generator] = None,
    train: bool = False,
) -> torch.Tensor:
    """[B, C, T] -> [B, C, n_mels, frames]; the model-facing wrapper."""
    b, c, t = wave.shape
    mel = log_mel_spectrogram(wave.reshape(b * c, t), cfg, generator=generator, train=train)
    return mel.reshape(b, c, *mel.shape[1:])
