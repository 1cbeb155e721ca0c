"""The fused MLP, fc1 -> tanh-GELU -> fc2 with the hidden activation kept on
chip, and its dx / dh backward, as Hopper kernels (``csrc/fused_mlp.cu``),
with their plain PyTorch versions beside them.

Port of scripts/proto_mlp_fused.py (``_fwd_kernel``, ``_bwd_kernel`` and
``make_fused_mlp``). x ``[M, C]``, w1 ``[C, H]``, b1 ``[H]``, w2 ``[H, C]``, b2
``[C]``, all float32 or all bfloat16. The rounding points are the
prototype's, which are neither the port's ``Linear`` (round the product, then
add the bias) nor the prototype's own ``xla_mlp`` (which rounds h before the
GELU):

  forward   h = x w1 (fp32 sum) + fp32(b1); g, d = gelu(h), gelu'(h) in fp32;
            y = round(g) w2 (fp32 sum) + fp32(b2), rounded once; with
            ``residuals`` also round(g) and round(d)
  backward  dg = dy w2^T (fp32); dh = round(dg * fp32(d)); dx = dh w1^T (fp32
            sum), rounded once

Limits (the kernel's tiles): C a multiple of 64 up to 768, H a multiple of
64, any M; checked on every device.

Dispatch: a CPU tensor goes to the plain versions; a CUDA tensor launches the
kernel or raises. ``_build.LAUNCHES`` counts ``fused_mlp_fwd`` and
``fused_mlp_bwd``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from passt_tpu_torch.ops import _build
from passt_tpu_torch.ops.activations import gelu_parts

_KEY_FWD = "fused_mlp_fwd"
_KEY_BWD = "fused_mlp_bwd"
for _key in (_KEY_FWD, _KEY_BWD):
    _build.LAUNCHES.setdefault(_key, 0)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: C and H must be multiples of this; C at most MAX_C
ALIGN, MAX_C = 64, 768


def fused_mlp_fwd_plain(x, w1, b1, w2, b2, *, residuals: bool):
    """The forward kernel's function in plain PyTorch: y, or ``(y, g, d)``
    under ``residuals``, in x's dtype."""
    h = torch.matmul(x.float(), w1.float()) + b1.float()
    g, d = gelu_parts(h)
    gc = g.to(x.dtype)
    y = (torch.matmul(gc.float(), w2.float()) + b2.float()).to(x.dtype)
    return (y, gc, d.to(x.dtype)) if residuals else y


def fused_mlp_bwd_plain(dy, d, w1, w2):
    """The backward kernel's function in plain PyTorch: ``(dx, dh)`` in dy's
    dtype."""
    dg = torch.matmul(dy.float(), w2.float().t())
    dh = (dg * d.float()).to(dy.dtype)
    dx = torch.matmul(dh.float(), w1.float().t()).to(dy.dtype)
    return dx, dh


@functools.cache
def _lib():
    """The kernel library, built and bound on first use."""
    lib = _build.load("fused_mlp")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.passt_fused_mlp_fwd.argtypes = [vp] * 8 + [i32] * 5 + [vp]
    lib.passt_fused_mlp_fwd.restype = ctypes.c_int
    lib.passt_fused_mlp_bwd.argtypes = [vp] * 6 + [i32] * 4 + [vp]
    lib.passt_fused_mlp_bwd.restype = ctypes.c_int
    lib.passt_fused_mlp_row_block.argtypes = [i32]
    lib.passt_fused_mlp_row_block.restype = ctypes.c_int
    return lib


def row_block(m: int) -> int:
    """The rows a bfloat16 kernel block takes at M = m on the current card:
    32, 48 or 64, whichever needs the fewest waves over its SMs (see
    ``csrc/fused_mlp.cu`` ``row_warps``)."""
    return _lib().passt_fused_mlp_row_block(m)


def _check(named: dict, shapes: dict) -> torch.device:
    """One dtype (float32 or bfloat16) and one device for all, the given
    shapes, and the kernel's limits on C and H; returns the device."""
    first = next(iter(named.values()))
    for name, t in named.items():
        if t.dtype != first.dtype or t.device != first.device:
            raise ValueError(f"{name}: {t.dtype} on {t.device}, want {first.dtype} on {first.device}")
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, want {shapes[name]}")
    if first.dtype not in _DTYPE_CODE:
        raise ValueError(f"the fused MLP takes float32 or bfloat16, not {first.dtype}")
    c, h = shapes["w1"]
    if c % ALIGN or c > MAX_C or h % ALIGN:
        raise ValueError(f"the fused MLP needs C a multiple of {ALIGN} up to {MAX_C} and H a multiple of "
                         f"{ALIGN}; got C = {c}, H = {h}")
    if first.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the fused MLP runs on CPU or CUDA tensors, got {first.device}")
    return first.device


def _ptrs(*ts):
    return [ctypes.c_void_p(t.data_ptr() if t is not None else 0) for t in ts]


def fused_mlp_fwd(x, w1, b1, w2, b2, *, residuals: bool):
    """``tanh_gelu(x w1 + b1) w2 + b2`` with the hidden activation on chip:
    y ``[M, C]``, or ``(y, g, d)`` with g and d ``[M, H]`` under
    ``residuals``; all in x's dtype."""
    if x.ndim != 2 or w1.ndim != 2:
        raise ValueError(f"x {tuple(x.shape)}, w1 {tuple(w1.shape)}: want [M, C] and [C, H]")
    (m, c), h = x.shape, w1.shape[1]
    dev = _check(dict(x=x, w1=w1, b1=b1, w2=w2, b2=b2),
                 dict(x=(m, c), w1=(c, h), b1=(h,), w2=(h, c), b2=(c,)))
    if dev.type == "cpu":
        return fused_mlp_fwd_plain(x, w1, b1, w2, b2, residuals=residuals)
    x, w1, b1, w2, b2 = (t.contiguous() for t in (x, w1, b1, w2, b2))
    y = torch.empty((m, c), dtype=x.dtype, device=dev)
    g = torch.empty((m, h), dtype=x.dtype, device=dev) if residuals else None
    d = torch.empty_like(g) if residuals else None
    if m:
        lib = _lib()
        code = lib.passt_fused_mlp_fwd(*_ptrs(x, w1, b1, w2, b2, y, g, d), int(residuals), _DTYPE_CODE[x.dtype],
                                       m, c, h, _build.stream_of(x))
        _build.check(lib, code, "fused MLP forward kernel launch")
        _build.LAUNCHES[_KEY_FWD] += 1
    return (y, g, d) if residuals else y


def fused_mlp_bwd(dy, d, w1, w2):
    """dx ``[M, C]`` and dh ``[M, H]`` of the fused MLP from dy ``[M, C]``
    and the saved derivative d ``[M, H]``; dg stays on chip."""
    if dy.ndim != 2 or w1.ndim != 2:
        raise ValueError(f"dy {tuple(dy.shape)}, w1 {tuple(w1.shape)}: want [M, C] and [C, H]")
    (m, c), h = dy.shape, w1.shape[1]
    dev = _check(dict(dy=dy, d=d, w1=w1, w2=w2), dict(dy=(m, c), d=(m, h), w1=(c, h), w2=(h, c)))
    if dev.type == "cpu":
        return fused_mlp_bwd_plain(dy, d, w1, w2)
    dy, d, w1, w2 = (t.contiguous() for t in (dy, d, w1, w2))
    dx = torch.empty((m, c), dtype=dy.dtype, device=dev)
    dh = torch.empty((m, h), dtype=dy.dtype, device=dev)
    if m:
        lib = _lib()
        code = lib.passt_fused_mlp_bwd(*_ptrs(dy, d, w1, w2, dx, dh), _DTYPE_CODE[dy.dtype], m, c, h,
                                       _build.stream_of(dy))
        _build.check(lib, code, "fused MLP backward kernel launch")
        _build.LAUNCHES[_KEY_BWD] += 1
    return dx, dh


class _FusedMlp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2, fused_bwd):
        y, g, d = fused_mlp_fwd(x, w1, b1, w2, b2, residuals=True)
        ctx.save_for_backward(x, g, d, w1, w2)
        ctx.fused_bwd = fused_bwd
        return y

    @staticmethod
    def backward(ctx, dy):
        x, g, d, w1, w2 = ctx.saved_tensors
        dy = dy.contiguous()
        bwd = fused_mlp_bwd if ctx.fused_bwd else fused_mlp_bwd_plain
        dx, dh = bwd(dy, d, w1, w2)
        dw1 = torch.matmul(x.t(), dh).to(w1.dtype)
        dw2 = torch.matmul(g.t(), dy).to(w2.dtype)
        db1 = dh.float().sum(dim=0).to(dy.dtype)
        db2 = dy.float().sum(dim=0).to(dy.dtype)
        return dx, dw1, db1, dw2, db2, None


def fused_mlp(x, w1, b1, w2, b2, fused_bwd: bool):
    """The fused MLP with its custom gradient (``make_fused_mlp``'s
    counterpart): without grad the forward writes y only; with grad it also
    writes g and d, and the backward takes dx and dh from the backward kernel
    (``fused_bwd``) or from the plain fp32 products, then dW1 = x^T dh and
    dW2 = g^T dy (torch products, fp32 sums) and the bias gradients as fp32
    sums in dy's dtype."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w1, b1, w2, b2)):
        return _FusedMlp.apply(x, w1, b1, w2, b2, fused_bwd)
    return fused_mlp_fwd(x, w1, b1, w2, b2, residuals=False)
