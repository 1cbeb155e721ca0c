"""The yardstick's arithmetic: the card's published peaks, the model's FLOPs
and each attention kernel's least time (its bound).

Frozen here so that no later change to the program can move it. The rules
are those the port's kernel table uses: a kernel's bound is the larger of
its operations over the peak rate of their type and its bytes, each input
read once and each output written once, over the memory's rate.
"""

from __future__ import annotations

#: NVIDIA H100 SXM, dense, at its 700 W limit (NVIDIA's data sheet)
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def tokens(cfg: dict, frames: int, train: bool) -> int:
    """The transformer's sequence length for a spectrogram of ``frames``
    frames: the patch grid (after structured patchout in training) plus
    the class and distillation tokens."""
    f, t = grid(cfg, frames)
    if train:
        f -= cfg.get("s_patchout_f", 0)
        t -= cfg.get("s_patchout_t", 0)
    return f * t + (2 if cfg["distilled"] else 1)


def grid(cfg: dict, frames: int) -> tuple:
    """(frequency, time) patches of the embedding for ``frames`` frames,
    the time axis cropped to the model's own grid."""
    (pf, pt), (sf, st) = cfg["patch_size"], cfg["stride"]
    f = (cfg["input_fdim"] - pf) // sf + 1
    t = (min(frames, cfg["input_tdim"]) - pt) // st + 1
    return f, t


def forward_flops(cfg: dict, n: int, patches: int) -> float:
    """Model FLOPs of one clip's forward at ``n`` tokens: the patch
    embedding over all ``patches`` patches (it runs before patchout), per
    block the four dense products (24 C^2 a token at an MLP ratio of 4)
    and the two attention products (4 N^2 C), and the head. Softmax,
    norms and the frontend are not counted."""
    c = cfg["embed_dim"]
    hidden = int(c * cfg["mlp_ratio"])
    pf, pt = cfg["patch_size"]
    dense = 2 * n * (3 * c * c + c * c + 2 * c * hidden)
    attn = 4 * n * n * c
    embed = 2 * patches * pf * pt * cfg.get("in_chans", 1) * c
    head = 2 * c * cfg["num_classes"]
    return float(cfg["depth"] * (dense + attn) + embed + head)


def attention_fwd_cost(b: int, n: int, h: int, d: int, itemsize: int = 2) -> tuple:
    """(operations, bytes) of one attention forward: 4 N^2 D B H; q, k, v
    read and o written once."""
    return 4.0 * n * n * d * b * h, 4.0 * b * n * h * d * itemsize


def attention_bwd_cost(b: int, n: int, h: int, d: int, itemsize: int = 2) -> tuple:
    """(operations, bytes) of one attention backward: 10 N^2 D B H (the
    recomputed scores, dP, dV, dQ, dK); q, k, v, o, dO and the fp32 row
    statistics read once, dq, dk, dv written once."""
    return 10.0 * n * n * d * b * h, 8.0 * b * n * h * d * itemsize + 4.0 * b * h * n


def bound_s(ops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS) -> float:
    """The least time a kernel of ``ops`` operations moving ``nbytes`` can
    take on the card."""
    return max(ops / peak_flops, nbytes / PEAK_BYTES_PER_S)
