"""The plain reference: PaSST as published (Koutini et al., "Efficient
Training of Audio Transformers with Patchout", Interspeech 2022), its
log-mel frontend, the multilabel loss with mixup and AdamW, in plain
PyTorch at fp32 with TF32 off.

It imports torch alone: nothing of the program under test and nothing of
the JAX package. Parameters are a dict keyed by the published checkpoint's
names (``blocks.3.attn.qkv.weight``, ...), made by the benchmark from the
seed and handed to both sides.

``low=True`` is the control: every product takes its operands rounded to
float8 e4m3 (one scale per tensor, its largest magnitude at 448), the
nearest precision below the configurations' bf16. In the backward the
rounding passes gradients straight through, and the products reuse the
rounded operands the forward saved.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


@contextlib.contextmanager
def exact_fp32():
    """fp32 products without TF32 inside, the caller's settings after."""
    cuda, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    old = cuda.allow_tf32, cudnn.allow_tf32
    cuda.allow_tf32 = cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cuda.allow_tf32, cudnn.allow_tf32 = old


def param_shapes(cfg: dict) -> Dict[str, tuple]:
    """The published checkpoint's leaves and shapes."""
    c, h = cfg["embed_dim"], int(cfg["embed_dim"] * cfg["mlp_ratio"])
    (pf, pt), (sf, st) = cfg["patch_size"], cfg["stride"]
    fg = (cfg["input_fdim"] - pf) // sf + 1
    tg = (cfg["input_tdim"] - pt) // st + 1
    k = cfg["num_classes"]
    shapes = {
        "cls_token": (1, 1, c), "dist_token": (1, 1, c), "new_pos_embed": (1, 2, c),
        "freq_new_pos_embed": (1, c, fg, 1), "time_new_pos_embed": (1, c, 1, tg),
        "patch_embed.proj.weight": (c, cfg.get("in_chans", 1), pf, pt), "patch_embed.proj.bias": (c,),
    }
    for i in range(cfg["depth"]):
        p = f"blocks.{i}."
        shapes.update({
            p + "norm1.weight": (c,), p + "norm1.bias": (c,),
            p + "attn.qkv.weight": (3 * c, c), p + "attn.qkv.bias": (3 * c,),
            p + "attn.proj.weight": (c, c), p + "attn.proj.bias": (c,),
            p + "norm2.weight": (c,), p + "norm2.bias": (c,),
            p + "mlp.fc1.weight": (h, c), p + "mlp.fc1.bias": (h,),
            p + "mlp.fc2.weight": (c, h), p + "mlp.fc2.bias": (c,),
        })
    shapes.update({
        "norm.weight": (c,), "norm.bias": (c,), "head.0.weight": (c,), "head.0.bias": (c,),
        "head.1.weight": (k, c), "head.1.bias": (k,), "head_dist.weight": (k, c), "head_dist.bias": (k,),
    })
    return shapes


# -- the control's rounding ------------------------------------------------

def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.detach().abs().amax().clamp(min=1e-30) / 448.0
    q = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q - t).detach()


def _mm(a: torch.Tensor, b: torch.Tensor, low: bool) -> torch.Tensor:
    if low:
        a, b = _fp8(a), _fp8(b)
    return torch.matmul(a, b)


def _linear(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor], low: bool) -> torch.Tensor:
    y = _mm(x, w.t(), low)
    return y if b is None else y + b


# -- the frontend -----------------------------------------------------------

def _hz_to_mel(f):
    return 1127.0 * torch.log1p(f / 700.0)


def mel_bank(mel: dict, fmin, fmax, device) -> torch.Tensor:
    """Kaldi's triangular mel bank [n_mels, n_fft // 2] (the Nyquist bin
    left out), in float64 from the (possibly jittered) band edges."""
    n_mels, n_fft, sr = mel["n_mels"], mel["n_fft"], mel["sr"]
    fmin = torch.as_tensor(fmin, dtype=torch.float64, device=device)
    fmax = torch.as_tensor(fmax, dtype=torch.float64, device=device)
    lo, hi = _hz_to_mel(fmin), _hz_to_mel(fmax)
    delta = (hi - lo) / (n_mels + 1)
    bins = torch.arange(n_mels, dtype=torch.float64, device=device)[:, None]
    left, center, right = lo + bins * delta, lo + (bins + 1) * delta, lo + (bins + 2) * delta
    freqs = (sr / n_fft) * torch.arange(n_fft // 2, dtype=torch.float64, device=device)
    m = _hz_to_mel(freqs)[None, :]
    return torch.clamp(torch.minimum((m - left) / (center - left), (right - m) / (right - center)), min=0.0)


def log_mel(wave: torch.Tensor, mel: dict, fmin, fmax, freq_mask=None, time_mask=None) -> torch.Tensor:
    """[B, T] -> [B, n_mels, frames]: pre-emphasis 0.97, the power STFT
    (reflect padding by n_fft // 2, a symmetric Hann window of win_length
    centred in the frame), the mel bank, ``log(x + 1e-5)``, the SpecAugment
    masks where given, then ``(x + 4.5) / 5``."""
    n_fft, hop, win = mel["n_fft"], mel["hopsize"], mel["win_length"]
    x = wave.float()
    x = x[:, 1:] - 0.97 * x[:, :-1]
    x = F.pad(x[:, None], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    n = torch.arange(win, dtype=torch.float64, device=x.device)
    window = torch.zeros(n_fft, dtype=torch.float64, device=x.device)
    left = (n_fft - win) // 2
    window[left:left + win] = 0.5 * (1.0 - torch.cos(2.0 * math.pi * n / (win - 1)))
    out = []
    for part in x.split(8):  # a few clips at a time: the frames are n_fft / hop times the wave
        spec = torch.fft.rfft(part.unfold(1, n_fft, hop) * window.float(), dim=-1)
        power = spec.real ** 2 + spec.imag ** 2
        bank = mel_bank(mel, fmin, fmax, x.device).float()
        out.append(torch.log(torch.matmul(power[..., : n_fft // 2], bank.t()) + 1e-5).transpose(1, 2))
    m = torch.cat(out)
    if freq_mask is not None:
        m = torch.where(freq_mask[None, :, None], 0.0, m)
    if time_mask is not None:
        m = torch.where(time_mask[None, None, :], 0.0, m)
    return (m + 4.5) / 5.0


# -- the model ---------------------------------------------------------------

def _layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def _gelu(x: torch.Tensor, cfg: dict) -> torch.Tensor:
    return F.gelu(x, approximate="tanh" if cfg["gelu"] == "tanh" else "none")


def _block(P: Params, i: int, x: torch.Tensor, cfg: dict, low: bool) -> torch.Tensor:
    p = f"blocks.{i}."
    b, n, c = x.shape
    h = cfg["num_heads"]
    d = c // h
    y = _layer_norm(x, P[p + "norm1.weight"], P[p + "norm1.bias"], cfg["norm_eps"])
    qkv = _linear(y, P[p + "attn.qkv.weight"], P[p + "attn.qkv.bias"], low)
    q, k, v = qkv.reshape(b, n, 3, h, d).permute(2, 0, 3, 1, 4)
    s = _mm(q, k.transpose(-1, -2), low) * d ** -0.5
    o = _mm(torch.softmax(s, dim=-1), v, low).transpose(1, 2).reshape(b, n, c)
    x = x + _linear(o, P[p + "attn.proj.weight"], P[p + "attn.proj.bias"], low)
    y = _layer_norm(x, P[p + "norm2.weight"], P[p + "norm2.bias"], cfg["norm_eps"])
    y = _gelu(_linear(y, P[p + "mlp.fc1.weight"], P[p + "mlp.fc1.bias"], low), cfg)
    return x + _linear(y, P[p + "mlp.fc2.weight"], P[p + "mlp.fc2.bias"], low)


def forward(P: Params, x: torch.Tensor, cfg: dict, keep_t=None, keep_f=None, low: bool = False) -> torch.Tensor:
    """[B, 1, F, T] spectrogram -> [B, num_classes] logits. ``keep_t`` and
    ``keep_f`` (sorted indices) are structured patchout's kept time columns
    and frequency rows; without them every patch is kept."""
    b = x.shape[0]
    (pf, pt), stride = cfg["patch_size"], cfg["stride"]
    c = cfg["embed_dim"]
    tg = P["time_new_pos_embed"].shape[-1]
    cols = F.unfold(x.float(), (pf, pt), stride=tuple(stride))
    e = _mm(P["patch_embed.proj.weight"].reshape(c, -1), cols, low) + P["patch_embed.proj.bias"][:, None]
    fg_now = (x.shape[2] - pf) // stride[0] + 1
    tg_now = (x.shape[3] - pt) // stride[1] + 1
    e = e.reshape(b, c, fg_now, tg_now)[..., :tg]
    e = e + P["time_new_pos_embed"][..., : e.shape[-1]] + P["freq_new_pos_embed"]
    if keep_t is not None:
        e = e.index_select(3, keep_t)
    if keep_f is not None:
        e = e.index_select(2, keep_f)
    e = e.flatten(2).transpose(1, 2)
    cls = (P["cls_token"] + P["new_pos_embed"][:, :1]).expand(b, -1, -1)
    dist = (P["dist_token"] + P["new_pos_embed"][:, 1:]).expand(b, -1, -1)
    z = torch.cat([cls, dist, e], dim=1)
    for i in range(cfg["depth"]):
        z = _block(P, i, z, cfg, low)
    z = _layer_norm(z, P["norm.weight"], P["norm.bias"], cfg["norm_eps"])
    feats = (z[:, 0] + z[:, 1]) / 2.0
    feats = _layer_norm(feats, P["head.0.weight"], P["head.0.bias"], cfg["head_norm_eps"])
    return _linear(feats, P["head.1.weight"], P["head.1.bias"], low)


#: the most audio samples a serving pass of the reference takes (four 10-s
#: clips at 32 kHz), so that its fp32 scores fit beside the program's state
SAMPLES_PER_PASS = 1_280_000


def eval_logits(P: Params, wave: torch.Tensor, cfg: dict, mel: dict, low: bool = False) -> torch.Tensor:
    """Serving: [B, T] waveform -> [B, num_classes] logits, the eval
    frontend (no jitter, no masks) cropped to the model's frames, as many
    clips a pass as :data:`SAMPLES_PER_PASS` holds (at least one)."""
    fmax = mel["sr"] // 2 - mel["fmax_aug_range"] // 2
    out = []
    with torch.no_grad(), exact_fp32():
        for part in wave.split(max(1, SAMPLES_PER_PASS // wave.shape[1])):
            spec = log_mel(part, mel, float(mel["fmin"]), float(fmax))[:, None, :, : cfg["input_tdim"]]
            out.append(forward(P, spec, cfg, low=low))
    return torch.cat(out)


# -- training -----------------------------------------------------------------

def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return torch.clamp(logits, min=0.0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def train_loss_and_grads(P: Params, wave: torch.Tensor, target: torch.Tensor, draws: dict, cfg: dict,
                         mel: dict, low: bool = False, clips_per_pass: int = 12, loss_rows: Optional[int] = None):
    """One training step's loss and gradients (mean over the whole batch)
    with the step's draws: the train frontend (jittered band, the masks),
    mixup of spectrograms and targets, structured patchout, BCE.
    ``loss_rows`` plants a fault for the checks' own tests: the loss is the
    mean over the first ``loss_rows`` rows alone."""
    with torch.no_grad():
        spec = log_mel(wave, mel, draws["fmin"], draws["fmax"], draws["freq_mask"], draws["time_mask"])
        x = spec[:, None, :, : cfg["input_tdim"]]
        lam, perm = draws["lam"], draws["perm"]
        x = x * lam[:, None, None, None] + x[perm] * (1.0 - lam[:, None, None, None])
        y = target * lam[:, None] + target[perm] * (1.0 - lam[:, None])
    leaves = {k: v.detach().requires_grad_() for k, v in P.items()}
    grads = {k: torch.zeros_like(v) for k, v in P.items()}
    if loss_rows is not None:
        x, y = x[:loss_rows], y[:loss_rows]
    total = x.shape[0] * y.shape[1]
    loss = torch.zeros((), dtype=torch.float64, device=x.device)
    with exact_fp32():
        for rows in torch.arange(x.shape[0], device=x.device).split(clips_per_pass):
            logits = forward(leaves, x[rows], cfg, draws["keep_t"], draws["keep_f"], low)
            part = bce_with_logits(logits, y[rows]).sum() / total
            gs = torch.autograd.grad(part, list(leaves.values()), allow_unused=True)
            for k, g in zip(leaves, gs):
                if g is not None:
                    grads[k] += g
            loss += part.detach().double()
    return float(loss), grads


def lr_at(step: int, opt: dict) -> float:
    """The recipe's rate at ``step`` (steps taken before it): the base rate
    times exp(-5 (1 - e / warmup)^2) for e = max(epoch, 0.5) below the
    warmup and the linear ramp down, constant within an epoch."""
    epoch = step // opt["steps_per_epoch"]
    up = 1.0
    if epoch < opt["warm_up_len"]:
        e = min(max(epoch, 0.5), opt["warm_up_len"])
        up = math.exp(-5.0 * (1.0 - e / opt["warm_up_len"]) ** 2)
    start, length, last = opt["ramp_down_start"], opt["ramp_down_len"], opt["last_lr_value"]
    down = 1.0 if epoch <= start else (
        last + (1.0 - last) * (length - epoch + start) / length if epoch - start < length else last)
    return float(torch.tensor(opt["lr"] * up * down, dtype=torch.float32))


def adamw(P: Params, grads: Params, m: Params, v: Params, step: int, opt: dict):
    """One AdamW update in fp32 (decoupled weight decay on every leaf, the
    rate at the pre-update count); returns (params, m, v, updates)."""
    t = step + 1
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    lr = lr_at(step, opt)
    out_p, out_m, out_v, upd = {}, {}, {}, {}
    for k in P:
        g = grads[k]
        out_m[k] = b1 * m[k] + (1.0 - b1) * g
        out_v[k] = b2 * v[k] + (1.0 - b2) * g * g
        u = -lr * ((out_m[k] / (1.0 - b1 ** t)) / (torch.sqrt(out_v[k] / (1.0 - b2 ** t)) + eps) + wd * P[k])
        upd[k] = u
        out_p[k] = P[k] + u
    return out_p, out_m, out_v, upd


def bf16_spacing(p: torch.Tensor) -> torch.Tensor:
    """The gap between a bf16 value and the next one away from zero (0 at
    zero)."""
    _, e = torch.frexp(p)
    return torch.where(p == 0, torch.zeros_like(p), torch.ldexp(torch.ones_like(p), e - 8))


def expected_sr_norm(p0: torch.Tensor, updates) -> float:
    """The root of the expected squared norm of a bf16 leaf's change when
    each update is added in fp32 and stored with unbiased stochastic
    rounding: sum (sum_s u_s)^2 + sum_s q^2 r_s (1 - r_s), with q the
    spacing at the start value and r_s the fractional part of |u_s| / q
    (rounding is unbiased, so the cross terms are the means' products)."""
    q = bf16_spacing(p0.double())
    total = torch.zeros_like(q)
    var = torch.zeros_like(q)
    for u in updates:
        u = u.double()
        total += u
        r = torch.where(q > 0, torch.remainder(u.abs() / torch.where(q > 0, q, 1.0), 1.0), torch.zeros_like(q))
        var += q * q * r * (1.0 - r)
    return float(torch.sqrt((total * total + var).sum()))
