"""The train step's random draws, made again from the seed the step is given.

The program documents its draws: one ``torch.Generator`` per stream,
seeded from ``("step", seed, step, stream)`` by a blake2b hash of the
tuple's ``repr`` (the 63-bit ``fold_seed``), and drawn in a fixed order.
This file is a frozen copy of that scheme and order, with nothing of the
program imported, so the reference sees the jitter, SpecAugment masks,
mixup and patchout that the step saw, without reading them out of the
step's state. The stochastic rounding of the bf16 stores draws from other
streams; the fp32 reference has no such rounding and draws none of them.
"""

from __future__ import annotations

import hashlib

import torch


def fold_seed(*parts) -> int:
    digest = hashlib.blake2b(repr(parts).encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") & ((1 << 63) - 1)


def stream(seed: int, step: int, name: str, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(fold_seed("step", seed, step, name))
    return gen


def _axis_mask(gen: torch.Generator, size: int, mask_param: int) -> torch.Tensor:
    """A SpecAugment mask shared by the batch: [size] bool, True = masked;
    width ~ U[0, mask_param) and start ~ U[0, size - width), both floored."""
    dev = gen.device
    width = torch.rand((1, 1), generator=gen, device=dev) * mask_param
    start = torch.rand((1, 1), generator=gen, device=dev) * (size - width)
    width, start = torch.floor(width), torch.floor(start)
    idx = torch.arange(size, dtype=torch.float32, device=dev)[None, :]
    return ((idx >= start) & (idx < start + width))[0]


def _gamma(gen: torch.Generator, alpha: float, n: int) -> torch.Tensor:
    """Gamma(alpha) by Marsaglia-Tsang over 16 proposals; alpha < 1 as
    Gamma(alpha + 1) U^(1/alpha)."""
    dev = gen.device
    boost = alpha < 1.0
    a = alpha + 1.0 if boost else alpha
    d = a - 1.0 / 3.0
    c = 1.0 / (9.0 * d) ** 0.5
    z = torch.randn((16, n), generator=gen, device=dev)
    u = torch.rand((16, n), generator=gen, device=dev)
    v = (1.0 + c * z) ** 3
    ok = (v > 0) & (torch.log(u) < 0.5 * z * z + d - d * v + d * torch.log(v.clamp(min=1e-30)))
    first = torch.argmax(ok.int(), dim=0)
    g = d * v.gather(0, first[None])[0]
    if boost:
        g = g * torch.rand(n, generator=gen, device=dev) ** (1.0 / alpha)
    return g


def _keep(gen: torch.Generator, size: int, keep: int) -> torch.Tensor:
    perm = torch.randperm(size, generator=gen, device=gen.device)
    return torch.sort(perm[:keep]).values


def step_draws(seed: int, step: int, total: int, frames: int, mel: dict, model: dict, grid: tuple,
               device) -> dict:
    """The draws of the train step that has taken ``step`` steps before it,
    over a global batch of ``total`` clips of ``frames`` mel frames:
    ``fmin``, ``fmax`` (fp32 0-d tensors), ``freq_mask`` [n_mels] and
    ``time_mask`` [frames] (bool), mixup's ``perm`` [total] and ``lam``
    [total], and patchout's sorted ``keep_t`` and ``keep_f``."""
    out = {}
    g = stream(seed, step, "mel", device)
    out["fmin"] = mel["fmin"] + torch.randint(0, mel["fmin_aug_range"], (), generator=g, device=device).float()
    fmax = mel["sr"] // 2 - mel["fmax_aug_range"] // 2
    out["fmax"] = fmax + mel["fmax_aug_range"] // 2 - torch.randint(
        0, mel["fmax_aug_range"], (), generator=g, device=device).float()
    out["freq_mask"] = _axis_mask(g, mel["n_mels"], mel["freqm"])
    out["time_mask"] = _axis_mask(g, frames, mel["timem"])
    g = stream(seed, step, "mix", device)
    out["perm"] = torch.randperm(total, generator=g, device=device)
    x = _gamma(g, model["mixup_alpha"], total)
    y = _gamma(g, model["mixup_alpha"], total)
    lam = x / (x + y)
    out["lam"] = torch.maximum(lam, 1.0 - lam).float()
    g = stream(seed, step, "patchout", device)
    f, t = grid
    out["keep_t"] = _keep(g, t, t - model["s_patchout_t"])
    out["keep_f"] = _keep(g, f, f - model["s_patchout_f"])
    return out
