"""Attention forward as one Hopper kernel (``csrc/attention_fwd.cu``), with
its plain PyTorch version beside it.

Port of passt_tpu/ops/pallas/attention.py, forward only: the backward
kernels belong to the training slice. Two entry points, as in the JAX
package, launch the same kernel:

- :func:`fused_attention` on q, k, v ``[B, N, H, D]`` (any strides with a
  contiguous last dim, e.g. views into the qkv Dense output);
- :func:`fused_attention_qkv` on the raw qkv Dense output ``[B, N, 3C]``,
  columns ordered (qkv, head, dim).

The kernel reads both layouts in place through (batch, token, head) strides.

The math is the reference's: fp32 scores, one max over the whole row
(clamped at 0 under ``plus1``, which also adds ``exp(-m)`` to the
denominator), P rounded to the input dtype for PV with an fp32 accumulator,
division by the denominator after PV, output in the input dtype.

Dispatch: a CPU tensor goes to the plain version; a CUDA tensor launches the
kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from passt_tpu_torch.ops import _build

_KEY_BNHD = "fused_attention"
_KEY_QKV = "fused_attention_qkv"
_build.LAUNCHES.setdefault(_KEY_BNHD, 0)
_build.LAUNCHES.setdefault(_KEY_QKV, 0)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: the qkv entry's bounds from passt_tpu/ops/pallas/attention.py:74-95,
#: kept so that the port takes the same entry as the JAX package at each
#: geometry (on Hopper both entries launch the same kernel, which has no
#: N cap)
_FLAT_VMEM_BUDGET = {
    (False, 2): int(10.5 * 1024 * 1024),
    (True, 2): 14 * 1024 * 1024,
    (False, 4): 14 * 1024 * 1024,
    (True, 4): 14 * 1024 * 1024,
}
_FLAT_FWD_OUT_BUDGET = 14 * 1024 * 1024


def flat_kernel_supports(
    n: int,
    heads: int,
    head_dim: int,
    *,
    backward: bool,
    itemsize: int = 2,
    batch: Optional[int] = None,
) -> bool:
    """True where the JAX package takes the qkv entry
    (passt_tpu/ops/pallas/attention.py:flat_kernel_supports, same rule)."""
    if head_dim > 128 or head_dim % 8 != 0:
        return False
    budget = _FLAT_VMEM_BUDGET.get((backward, itemsize))
    if budget is None:
        return False
    c = heads * head_dim
    if not backward and batch is not None:
        n_pad = -(-n // 8) * 8
        if batch * n_pad * c * itemsize > _FLAT_FWD_OUT_BUDGET:
            return False
    if backward:
        blocks = 2 * n * (3 * c + c + 3 * c) * itemsize
        scores = 3 * n * n * 4
    else:
        blocks = 2 * n * (3 * c + c) * itemsize
        scores = 2 * n * n * 4
    return blocks + scores <= budget


def attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float, plus1: bool = False
) -> torch.Tensor:
    """The kernel's function in plain PyTorch, on ``[B, N, H, D]``."""
    qf, kf, vf = q.float(), k.float(), v.float()
    s = torch.einsum("bnhd,bmhd->bhnm", qf, kf) * scale
    m = s.amax(dim=-1, keepdim=True)
    if plus1:
        m = torch.clamp(m, min=0.0)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if plus1:
        l = l + torch.exp(-m)
    o = torch.einsum("bhnm,bmhd->bhnd", p.to(v.dtype).float(), vf) / l
    return o.transpose(1, 2).to(q.dtype)


@functools.cache
def _lib():
    """The kernel library, built and bound on first use."""
    lib = _build.load("attention_fwd")
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.passt_attention_fwd.argtypes = (
        [vp, vp, vp, vp, i32, i32, i32, i32, i32] + [i64] * 12 + [ctypes.c_float, i32, vp]
    )
    lib.passt_attention_fwd.restype = ctypes.c_int
    return lib


def _launch(q, k, v, out, scale: float, plus1: bool) -> None:
    """Launch the kernel on ``[B, N, H, D]``-shaped views (any strides with
    a contiguous last dim)."""
    b, n, h, d = q.shape
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}, got {t.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
        if tuple(t.shape) != (b, n, h, d):
            raise ValueError(f"{name} shape {tuple(t.shape)} != {(b, n, h, d)}")
        if t.stride(3) != 1:
            raise ValueError(f"{name} needs a contiguous head dim, strides {t.stride()}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"attention kernel takes float32/bfloat16/float16, got {q.dtype}")
    if d > 128 or d % 8:
        raise ValueError(f"attention kernel needs head_dim <= 128 and a multiple of 8, got {d}")
    if b > 65535 or h > 65535:
        raise ValueError(f"attention kernel grid limit: batch {b}, heads {h} must be <= 65535")
    lib = _lib()
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    code = lib.passt_attention_fwd(
        ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
        ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        _DTYPE_CODE[q.dtype], b, n, h, d, *strides, float(scale), int(bool(plus1)),
        _build.stream_of(q),
    )
    _build.check(lib, code, "attention kernel launch")


def fused_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float, plus1: bool = False
) -> torch.Tensor:
    """softmax(q k^T * scale) v on ``[B, N, H, D]``; returns ``[B, N, H, D]``
    contiguous, in the input dtype."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale=scale, plus1=plus1)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(q, k, v, out, scale, plus1)
    _build.LAUNCHES[_KEY_BNHD] += 1
    return out


def fused_attention_qkv(
    qkv: torch.Tensor, *, heads: int, head_dim: int, scale: float, plus1: bool = False
) -> torch.Tensor:
    """Attention over the raw qkv Dense output ``[B, N, 3*heads*head_dim]``;
    returns ``[B, N, heads*head_dim]`` in the input dtype (the proj input)."""
    if qkv.ndim != 3 or qkv.shape[-1] != 3 * heads * head_dim:
        raise ValueError(f"qkv shape {tuple(qkv.shape)} != [B, N, 3*{heads}*{head_dim}]")
    b, n, _ = qkv.shape
    if qkv.device.type == "cpu":
        q, k, v = qkv.reshape(b, n, 3, heads, head_dim).unbind(2)
        return attention_plain(q, k, v, scale=scale, plus1=plus1).reshape(b, n, heads * head_dim)
    if qkv.stride(2) != 1:
        raise ValueError(f"qkv needs a contiguous last dim, strides {qkv.stride()}")
    q, k, v = (
        qkv.as_strided((b, n, heads, head_dim), (qkv.stride(0), qkv.stride(1), head_dim, 1),
                       qkv.storage_offset() + i * heads * head_dim)
        for i in range(3)
    )
    out = torch.empty((b, n, heads * head_dim), dtype=qkv.dtype, device=qkv.device)
    _launch(q, k, v, out.view(b, n, heads, head_dim), scale, plus1)
    _build.LAUNCHES[_KEY_QKV] += 1
    return out
