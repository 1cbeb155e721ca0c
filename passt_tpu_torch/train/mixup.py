"""Batch mixup on the device (port of passt_tpu/train/mixup.py).

A batch permutation and per-sample ``lambda = max(Beta(a, a), 1 - Beta(a, a))``
blend the spectrograms and the targets. Both draws come from an explicit
``torch.Generator`` on the batch's device, so the step never waits on the
host.
"""

from __future__ import annotations

from typing import Tuple

import torch


def sample_mixup(
    generator: torch.Generator, batch_size: int, alpha: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (permutation [B] int64, lambda [B] float32) with lambda >= 0.5,
    on the generator's device."""
    device = generator.device
    perm = torch.randperm(batch_size, generator=generator, device=device)
    # Beta(a, a) as X / (X + Y) of two Gamma(a) draws; torch's Gamma
    # sampler takes no generator, so _gamma draws them from the generator's
    # normals and uniforms
    lam = _beta(generator, alpha, batch_size, device)
    lam = torch.maximum(lam, 1.0 - lam)
    return perm, lam.float()


def _beta(generator: torch.Generator, alpha: float, n: int, device) -> torch.Tensor:
    x = _gamma(generator, alpha, n, device)
    y = _gamma(generator, alpha, n, device)
    return x / (x + y)


def _gamma(generator: torch.Generator, alpha: float, n: int, device) -> torch.Tensor:
    """Gamma(alpha, 1) by Marsaglia-Tsang with a fixed number of proposals
    (no data-dependent loop, so nothing waits on the host); alpha < 1 uses
    Gamma(alpha + 1) * U**(1/alpha)."""
    boost = alpha < 1.0
    a = alpha + 1.0 if boost else alpha
    d = a - 1.0 / 3.0
    c = 1.0 / (9.0 * d) ** 0.5
    rounds = 16  # the acceptance rate is > 95% per proposal for a >= 1
    z = torch.randn((rounds, n), generator=generator, device=device)
    u = torch.rand((rounds, n), generator=generator, device=device)
    v = (1.0 + c * z) ** 3
    ok = (v > 0) & (torch.log(u) < 0.5 * z * z + d - d * v + d * torch.log(v.clamp(min=1e-30)))
    first = torch.argmax(ok.int(), dim=0)  # the first accepted proposal per sample
    g = d * v.gather(0, first[None])[0]
    if boost:
        g = g * torch.rand(n, generator=generator, device=device) ** (1.0 / alpha)
    return g


def apply_mixup(x: torch.Tensor, perm: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Blend ``x`` with its permuted batch: ``lam * x + (1 - lam) * x[perm]``;
    ``lam`` broadcasts over the non-batch axes."""
    lam = lam.reshape((x.shape[0],) + (1,) * (x.ndim - 1))
    return x * lam + x[perm] * (1.0 - lam)
