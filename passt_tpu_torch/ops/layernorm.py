"""LayerNorm whose backward is a Hopper kernel (``csrc/layernorm_bwd.cu``),
with its plain PyTorch version beside it.

Port of passt_tpu/ops/pallas/layernorm.py. The forward is plain PyTorch in
the JAX package's order: fp32 statistics with the fast variance
``var = max(E[x^2] - mu^2, 0)``, then ``((xf - mu) * rstd) * scale + bias``,
returned in fp32 (``nn.LayerNorm(dtype=float32)`` semantics; callers cast
after). It saves x, mu and rstd. The backward is one pass over (x, dy):

  x_hat = (x - mu) * rstd,  g = dy * scale
  dx    = rstd * (g - mean(g) - x_hat * mean(g * x_hat))   in x.dtype
  dscale = sum_rows(dy * x_hat),  dbias = sum_rows(dy)

The kernel writes dscale/dbias as per-block partials [G, C] in fp32 (no
atomics, so every run gives the same bits) and the wrapper sums them, as
the JAX package sums its per-tile partials outside its kernel. dscale and
dbias come back in the weight's dtype.

Dispatch: a CPU tensor goes to the plain version; a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from passt_tpu_torch.ops import _build
from passt_tpu_torch.ops.attention import _DTYPE_CODE

_KEY = "layer_norm_bwd"
_build.LAUNCHES.setdefault(_KEY, 0)

#: the kernel keeps a row in registers, one warp per row
MAX_DIM = 1024


def ln_forward(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float):
    """The forward in plain PyTorch: returns (y fp32, mu [..., 1], rstd
    [..., 1])."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    rstd = torch.rsqrt(var + eps)
    return (xf - mu) * rstd * weight.float() + bias.float(), mu, rstd


def layer_norm_bwd_plain(x, dy, mu, rstd, scale):
    """The backward kernel's function in plain PyTorch on ``[M, C]`` rows
    (mu, rstd ``[M, 1]``): returns dx in x.dtype and fp32 dscale, dbias
    ``[C]``."""
    xf, dyf = x.float(), dy.float()
    x_hat = (xf - mu) * rstd
    g = dyf * scale.float()
    inv_d = 1.0 / x.shape[-1]
    m1 = g.sum(dim=-1, keepdim=True) * inv_d
    m2 = (g * x_hat).sum(dim=-1, keepdim=True) * inv_d
    dx = (rstd * (g - m1 - x_hat * m2)).to(x.dtype)
    return dx, (dyf * x_hat).sum(dim=0), dyf.sum(dim=0)


@functools.cache
def _lib():
    """The kernel library, built and bound on first use."""
    lib = _build.load("layernorm_bwd")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.passt_layernorm_bwd.argtypes = [vp] * 8 + [i32] * 3 + [vp]
    lib.passt_layernorm_bwd.restype = ctypes.c_int
    lib.passt_layernorm_bwd_rows.restype = ctypes.c_int
    return lib


def layer_norm_bwd(x, dy, mu, rstd, scale):
    """dx, dscale, dbias of :func:`layer_norm` on ``[M, C]`` rows: the kernel
    on a CUDA tensor, its plain version on a CPU tensor. dx in x.dtype,
    dscale and dbias fp32 ``[C]``."""
    if x.device.type == "cpu":
        return layer_norm_bwd_plain(x, dy, mu, rstd, scale)
    m, c = x.shape
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"layernorm kernel takes float32/bfloat16/float16 x, got {x.dtype}")
    if c % 8 or c > MAX_DIM:
        raise ValueError(f"layernorm kernel needs C a multiple of 8 and <= {MAX_DIM}, got {c}")
    operands = dict(x=x, dy=dy, mu=mu, rstd=rstd, scale=scale)
    for name, t in operands.items():
        if t.device != x.device:
            raise ValueError(f"{name} must be on {x.device}, got {t.device}")
    x = x.contiguous()
    dy = dy.float().contiguous()
    mu = mu.float().reshape(m).contiguous()
    rstd = rstd.float().reshape(m).contiguous()
    scale = scale.float().reshape(c).contiguous()
    if dy.shape != x.shape:
        raise ValueError(f"dy shape {tuple(dy.shape)} != x shape {tuple(x.shape)}")
    if x.data_ptr() % 16 or dy.data_ptr() % 16 or scale.data_ptr() % 16:
        raise ValueError("layernorm kernel needs 16-byte aligned x, dy and scale")
    lib = _lib()
    groups = -(-m // lib.passt_layernorm_bwd_rows())
    dx = torch.empty_like(x)
    parts = torch.empty((2, groups, c), dtype=torch.float32, device=x.device)
    code = lib.passt_layernorm_bwd(
        *(ctypes.c_void_p(t.data_ptr()) for t in (x, dy, mu, rstd, scale, dx, parts[0], parts[1])),
        _DTYPE_CODE[x.dtype], m, c, _build.stream_of(x),
    )
    _build.check(lib, code, "layernorm backward kernel launch")
    _build.LAUNCHES[_KEY] += 1
    sums = parts.sum(dim=1)
    return dx, sums[0], sums[1]


class _LayerNorm(torch.autograd.Function):
    """Plain forward saving (x, mu, rstd); the kernel's backward."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps: float):
        y, mu, rstd = ln_forward(x, weight, bias, eps)
        ctx.save_for_backward(x, mu, rstd, weight)
        ctx.bias_dtype = bias.dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        x, mu, rstd, weight = ctx.saved_tensors
        c = x.shape[-1]
        dx, dscale, dbias = layer_norm_bwd(x.reshape(-1, c), dy.reshape(-1, c), mu.reshape(-1, 1),
                                           rstd.reshape(-1, 1), weight)
        return dx.reshape(x.shape), dscale.to(weight.dtype), dbias.to(ctx.bias_dtype), None


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last dim, fp32 output; the backward is the Hopper
    kernel on CUDA tensors (see module docstring)."""
    return _LayerNorm.apply(x, weight, bias, float(eps))
