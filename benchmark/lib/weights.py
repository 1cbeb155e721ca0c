"""Weights and clips made on the card from the run's seed, in a few large
calls: the same seed gives the same weights and inputs, and both the
program and the reference are handed the same ones."""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from benchmark.lib import reference
from benchmark.lib.harness import sub_seed

#: leaves near 1 (LayerNorm scales); every other leaf is drawn near 0
_UNIT = ("norm1.weight", "norm2.weight", "norm.weight", "head.0.weight")


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """Every leaf of the published checkpoint: 0.02 N(0, 1), and the
    LayerNorm scales 1 + 0.1 N(0, 1), from one draw, each value rounded to
    bf16 (the configurations' precision) and held in fp32, so that the
    program's bf16 casts and stores of them are exact."""
    shapes = reference.param_shapes(cfg)
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, "weights"))
    flat = torch.randn(sum(math.prod(s) for s in shapes.values()), generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        z = flat[at: at + n].view(shape)
        at += n
        value = 1.0 + 0.1 * z if name.endswith(_UNIT) else 0.02 * z
        out[name] = value.to(torch.bfloat16).float()
    return out


def make_clips(seed: int, batches: int, clips: int, samples: int, classes: int, target_rate: float,
               device, sr: int = 32000, tones: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
    """``batches`` distinct batches of ``clips`` waveforms [batches, clips,
    samples] (fp32) and multilabel targets [batches, clips, classes] with
    each label on at ``target_rate``. A clip is white noise at a level
    drawn between 0 and -30 dB plus ``tones`` sines of log-uniform
    frequency (50 Hz to 15 kHz), amplitude and phase, so that clips differ
    in level and spectrum and their answers differ."""
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, "clips"))
    waves = torch.randn((batches, clips, samples), generator=gen, device=device)
    waves *= 10.0 ** (-1.5 * torch.rand((batches, clips, 1), generator=gen, device=device))
    t = torch.arange(samples, device=device, dtype=torch.float32) / sr
    for _ in range(tones):
        f = 50.0 * 300.0 ** torch.rand((batches, clips, 1), generator=gen, device=device)
        a = torch.rand((batches, clips, 1), generator=gen, device=device)
        phase = 2.0 * math.pi * torch.rand((batches, clips, 1), generator=gen, device=device)
        waves += a * torch.sin(2.0 * math.pi * f * t + phase)
    targets = (torch.rand((batches, clips, classes), generator=gen, device=device) < target_rate).float()
    return waves, targets


def mel_frames(mel: dict, samples: int) -> int:
    """The frontend's frames for ``samples`` samples (pre-emphasis drops
    one; reflect padding by n_fft // 2 on both sides)."""
    return 1 + (samples - 1) // mel["hopsize"]
