"""Fused norm1 -> qkv projection -> attention, with its two Hopper kernels
(``csrc/ln_qkv.cu``: F1 and B2) and their plain PyTorch versions beside
them.

Port of passt_tpu/ops/pallas/ln_qkv.py. One autograd function,
:func:`fused_ln_qkv_attention`, takes the block's input x ``[B, N, C]``
before norm1 and returns the attention output (the proj input):

  forward:  F1  x -> LayerNorm -> xn (rounded to the dtype) -> xn W^T, the
                fp32 sum rounded to the dtype, + the qkv bias in the dtype;
                the row statistics from a prologue kernel into an ``[M, 2]``
                scratch; in bf16/fp16 on wgmma, a persistent grid of
                192 x 192 or 128 x 256 output tiles (:func:`f1_tile`), xn
                built in registers as the product's A operand; in fp32 on
                FMA, 64 x 64 tiles, K split over a cluster of 2 or 4 where
                the tiles do not fill the card (:func:`f1_fp32_split`)
            the attention forward kernel on the raw qkv (``ops/attention.py``,
                counted under ``fused_attention_qkv``)
  backward: the attention backward kernel -> dqkv (``fused_attention_qkv_bwd``)
            B2  dxn = dqkv W in fp32, fused with the LayerNorm backward:
                dx, the recomputed xn, and dscale/dbias (per-row-tile
                partials the wrapper sums); in bf16/fp16 on wgmma, one
                cluster per 192 rows (``B2_ROWS``) with C split across its
                CTAs (:func:`b2_split`), each loading its own tiles by TMA;
                in fp32 on FMA, one cluster of 8 CTAs per 16 rows
                (``B2_ROWS_FP32``), K = 3C split across them
            dW = dqkv^T xn (cuBLAS, fp32 accumulation) and db = sum(dqkv) in
                fp32, both in W's dtype: outside any kernel, as the JAX
                package leaves them to XLA.

The weight is the torch Linear layout ``[3C, C]`` (the JAX kernel's
``[C, 3C]`` transposed) and the gradient comes back in it. The LayerNorm is
the JAX one: fp32 statistics with the fast variance clamped at 0, then
``((xf - mu) * rstd) * s + b`` in that order.

:func:`ln_qkv_supports` is the JAX package's gate, to the byte, so both
packages take the fused path at the same geometries. Its B2 budget is a
TPU VMEM limit that Hopper does not have: on a CUDA tensor B2 runs whenever
the forward ran F1 (the JAX package's plain fallback past that budget is
kept only as :func:`ln_qkv_b2_plain`, which CPU tensors take).

Dispatch: a CPU tensor goes to the plain versions; a CUDA tensor launches
the kernels or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from passt_tpu_torch.ops import _build
from passt_tpu_torch.ops.attention import (
    _DTYPE_CODE,
    _KEY_QKV,
    _head_views,
    _launch,
    attention_plain,
    flat_kernel_supports,
    fused_attention_qkv_bwd,
)

_KEY_F1 = "ln_qkv_f1"
_KEY_B2 = "ln_qkv_b2"
for _key in (_KEY_F1, _KEY_B2):
    _build.LAUNCHES.setdefault(_key, 0)

#: the JAX package's budgets for F1 and B2 (passt_tpu/ops/pallas/ln_qkv.py)
_F1_BUDGET = 14 * 1024 * 1024
_B2_BUDGET = 16 * 1024 * 1024


#: rows of a dscale/dbias partial of the bf16/fp16 B2 kernel (a cluster's
#: row tile, ``B2_BM`` in csrc/ln_qkv.cu)
B2_ROWS = 192
#: the fp32 B2 kernel's: a cluster's row tile (``B2F_ROWS``), and its CTAs,
#: each summing one of ``B2_FP32_CTAS`` equal K ranges of 3C (``B2F_CK``)
B2_ROWS_FP32 = 16
B2_FP32_CTAS = 8
#: the bf16/fp16 F1 kernel's output tiles (rows, columns), by index
#: (``F1_TILES`` in csrc/ln_qkv.cu)
F1_TILES = ((192, 192), (128, 256))
#: the fp32 F1 kernel's output tile (``F1F_BM``, ``F1F_BN``)
F1_FP32_TILE = (64, 64)


def b2_split(c: int):
    """The bf16/fp16 B2 kernel's split of C = 64 q across a cluster
    (csrc/ln_qkv.cu ``b2_split``): ``(ctas, blocks)``, ceil(q / 3) CTAs of
    ``blocks`` 64-column blocks each; the last CTA's blocks past C are
    empty."""
    q = c // 64
    ctas = -(-q // 3)
    return ctas, -(-q // ctas)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def f1_tile(m: int, c: int, sms: int) -> int:
    """The bf16/fp16 F1 kernel's tile for an ``[m, 3c]`` output over
    ``sms`` SMs (csrc/ln_qkv.cu ``f1_pick``): the index into
    :data:`F1_TILES` of the least wave cost, the rounds of tiles times the
    tile's area; a tie goes to the first."""
    def cost(i):
        bm, bn = F1_TILES[i]
        return _cdiv(_cdiv(m, bm) * _cdiv(3 * c, bn), sms) * bm * bn
    return min(range(len(F1_TILES)), key=cost)


def f1_fp32_split(m: int, c: int, sms: int) -> int:
    """CTAs of the fp32 F1 kernel's cluster (csrc/ln_qkv.cu ``f1f_split``),
    each summing an equal K range of C: the fewest of 1, 2 and 4 that give
    four CTAs an SM with the 64 x 64 output tiles."""
    bm, bn = F1_FP32_TILE
    tiles = _cdiv(m, bm) * (3 * c // bn)
    return 1 if tiles >= 4 * sms else 2 if tiles >= 2 * sms else 4


def f1_plan(dtype: torch.dtype, m: int, c: int, sms: int) -> tuple:
    """What the F1 entry launches (csrc/ln_qkv.cu ``passt_ln_qkv_f1_plan``):
    ``(tile rows, tile columns, CTAs a cluster, output tiles, CTAs of the
    main grid)``."""
    if dtype == torch.float32:
        bm, bn = F1_FP32_TILE
        tiles, ck = _cdiv(m, bm) * (3 * c // bn), f1_fp32_split(m, c, sms)
        return bm, bn, ck, tiles, tiles * ck
    bm, bn = F1_TILES[f1_tile(m, c, sms)]
    tiles = _cdiv(m, bm) * _cdiv(3 * c, bn)
    return bm, bn, 1, tiles, min(tiles, sms)


def b2_fp32_ranges(c: int) -> list:
    """The fp32 B2 kernel's K ranges of 3C, one per CTA of a cluster in
    rank order: ``B2_FP32_CTAS`` equal slices."""
    kr = 3 * c // B2_FP32_CTAS
    return [slice(q * kr, (q + 1) * kr) for q in range(B2_FP32_CTAS)]


def _f1_bytes(n: int, c: int, itemsize: int) -> int:
    blocks = 2 * n * (c + 3 * c) * itemsize  # x in + qkv out, double-buffered
    w = c * 3 * c * itemsize
    temps = 2 * n * c * 4 + n * c * 4  # xf, xn fp32 + one [N, C] f32 accum
    return blocks + w + temps


def _b2_bytes(n: int, c: int, itemsize: int) -> int:
    blocks = 2 * n * (c + 3 * c + c + c) * itemsize  # x, dqkv in; dx, xn out
    w = c * 3 * c * itemsize
    temps = 3 * n * c * 4  # xhat, dxn accum, dxhat
    return blocks + w + temps


def ln_qkv_supports(
    n: int, heads: int, head_dim: int, *, backward: bool, itemsize: int = 2,
    batch: Optional[int] = None,
) -> bool:
    """True where the JAX package takes the fused norm1 + qkv + attention
    path (passt_tpu/ops/pallas/ln_qkv.py:ln_qkv_supports, same rule)."""
    if not flat_kernel_supports(n, heads, head_dim, backward=backward, itemsize=itemsize, batch=batch):
        return False
    c = heads * head_dim
    if _f1_bytes(n, c, itemsize) > _F1_BUDGET:
        return False
    if backward and _b2_bytes(n, c, itemsize) > _B2_BUDGET:
        return False
    return True


def ln_stats(xf: torch.Tensor, eps: float):
    """fp32 LayerNorm statistics with the fast variance clamped at 0:
    ``(mu, rstd)``, each ``[..., 1]``. The clamp matters: on a near-constant
    large-magnitude row (x = 120 + N(0, 1e-3) at C = 768) fp32 cancellation
    makes the unclamped variance negative and rsqrt NaN."""
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    return mu, torch.rsqrt(var + eps)


def _ln_rows(x: torch.Tensor, s: torch.Tensor, b: torch.Tensor, eps: float):
    """x_hat (fp32), xn rounded to x's dtype, and rstd, in the JAX order."""
    xf = x.float()
    mu, rstd = ln_stats(xf, eps)
    xhat = (xf - mu) * rstd
    return xhat, (xhat * s.float() + b.float()).to(x.dtype), rstd


def ln_qkv_f1_plain(x, s, b, w, wb, eps: float = 1e-6) -> torch.Tensor:
    """F1 in plain PyTorch: x ``[B, N, C]``, s and b ``[C]``, w ``[3C, C]``
    and wb ``[3C]`` in x's dtype; returns qkv ``[B, N, 3C]`` in x's dtype."""
    _, xn, _ = _ln_rows(x, s, b, eps)
    acc = torch.matmul(xn.float(), w.float().t())
    return acc.to(x.dtype) + wb.to(x.dtype)


def ln_qkv_b2_plain(x, dqkv, w, s, b, eps: float = 1e-6):
    """B2 in plain PyTorch: returns dx and xn ``[B, N, C]`` in x's dtype and
    fp32 dscale, dbias ``[C]``."""
    xhat, xn, rstd = _ln_rows(x, s, b, eps)
    dxn = torch.matmul(dqkv.float(), w.float())
    c = x.shape[-1]
    dscale = (dxn * xhat).reshape(-1, c).sum(dim=0)
    dbias = dxn.reshape(-1, c).sum(dim=0)
    dxhat = dxn * s.float()
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    return (rstd * (dxhat - m1 - xhat * m2)).to(x.dtype), xn, dscale, dbias


@functools.cache
def _lib():
    """The kernel library, built and bound on first use."""
    lib = _build.load("ln_qkv")
    vp, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.passt_ln_qkv_f1.argtypes = [vp] * 7 + [i32, i32, i32, f32, i32, vp]
    lib.passt_ln_qkv_f1.restype = ctypes.c_int
    lib.passt_ln_qkv_b2.argtypes = [vp] * 9 + [i32, i32, i32, f32, vp]
    lib.passt_ln_qkv_b2.restype = ctypes.c_int
    lib.passt_ln_qkv_b2_rows.argtypes = [i32]
    lib.passt_ln_qkv_b2_rows.restype = ctypes.c_int
    lib.passt_ln_qkv_b2_clusters.argtypes = [i32, i32, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.passt_ln_qkv_b2_clusters.restype = ctypes.c_int
    lib.passt_ln_qkv_f1_plan.argtypes = [i32, i32, i32, i32, ctypes.POINTER(ctypes.c_int)]
    lib.passt_ln_qkv_f1_plan.restype = ctypes.c_int
    return lib


def b2_clusters(c: int, dtype: torch.dtype):
    """The B2 kernel's cluster for ``dtype`` at width ``c`` on the current
    card: ``(CTAs a cluster, clusters resident at once)`` (the card's
    occupancy query; it needs the card)."""
    lib = _lib()
    ctas, active = ctypes.c_int(), ctypes.c_int()
    code = lib.passt_ln_qkv_b2_clusters(_DTYPE_CODE[dtype], c, ctypes.byref(ctas), ctypes.byref(active))
    _build.check(lib, code, "B2 clusters")
    return ctas.value, active.value


def f1_plan_kernel(dtype: torch.dtype, m: int, c: int, sms: int) -> tuple:
    """:func:`f1_plan` as the kernel library computes it, and a sixth
    entry: the main kernel's CTAs the card holds at once (the card's
    occupancy query; it needs the card)."""
    lib = _lib()
    plan = (ctypes.c_int * 6)()
    _build.check(lib, lib.passt_ln_qkv_f1_plan(_DTYPE_CODE[dtype], m, c, sms, plan), "F1 plan")
    return tuple(plan)


def _operands(named: dict, dtype: torch.dtype, device: torch.device, c: int) -> dict:
    """The kernels' operands, contiguous and checked: x-dtype tensors
    (everything but s and b) and fp32 s, b; raise on what the kernels do not
    take."""
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"ln_qkv kernels take float32/bfloat16/float16, got {dtype}")
    if c % 64 or not 64 <= c <= 1024:
        raise ValueError(f"ln_qkv kernels need C a multiple of 64 in [64, 1024], got {c}")
    out = {}
    for name, t in named.items():
        if t.device != device:
            raise ValueError(f"{name} must be on {device}, got {t.device}")
        want = torch.float32 if name in ("s", "b") else dtype
        if name not in ("s", "b") and t.dtype != dtype:
            raise ValueError(f"{name} dtype {t.dtype} != x dtype {dtype}")
        t = t.to(want).contiguous()
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
        out[name] = t
    return out


def _check_weight(w, c):
    if tuple(w.shape) != (3 * c, c):
        raise ValueError(f"qkv weight shape {tuple(w.shape)} != {(3 * c, c)}")


def ln_qkv_f1(x, s, b, w, wb, eps: float = 1e-6) -> torch.Tensor:
    """F1: qkv ``[B, N, 3C]`` of x ``[B, N, C]`` by the kernel on a CUDA
    tensor, by its plain version on a CPU tensor."""
    c = x.shape[-1]
    _check_weight(w, c)
    if tuple(wb.shape) != (3 * c,):
        raise ValueError(f"qkv bias shape {tuple(wb.shape)} != {(3 * c,)}")
    if x.device.type == "cpu":
        return ln_qkv_f1_plain(x, s, b, w, wb, eps)
    ops = _operands(dict(x=x, s=s, b=b, w=w, wb=wb), x.dtype, x.device, c)
    m = x.numel() // c
    out = torch.empty(x.shape[:-1] + (3 * c,), dtype=x.dtype, device=x.device)
    stats = torch.empty((m, 2), dtype=torch.float32, device=x.device)  # (mu, rstd) of each row
    lib = _lib()
    code = lib.passt_ln_qkv_f1(
        *(ctypes.c_void_p(t.data_ptr()) for t in (ops["x"], ops["s"], ops["b"], ops["w"], ops["wb"], out, stats)),
        _DTYPE_CODE[x.dtype], m, c, float(eps), _build.sm_count(x.device), _build.stream_of(x),
    )
    _build.check(lib, code, "ln_qkv F1 kernel launch")
    _build.LAUNCHES[_KEY_F1] += 1
    return out


def ln_qkv_b2(x, dqkv, w, s, b, eps: float = 1e-6):
    """B2: dx and xn ``[B, N, C]`` in x's dtype and fp32 dscale, dbias
    ``[C]``, by the kernel on a CUDA tensor (its per-block partials summed
    here), by its plain version on a CPU tensor."""
    c = x.shape[-1]
    _check_weight(w, c)
    if dqkv.shape != x.shape[:-1] + (3 * c,):
        raise ValueError(f"dqkv shape {tuple(dqkv.shape)} != {tuple(x.shape[:-1]) + (3 * c,)}")
    if x.device.type == "cpu":
        return ln_qkv_b2_plain(x, dqkv, w, s, b, eps)
    ops = _operands(dict(x=x, dqkv=dqkv, w=w, s=s, b=b), x.dtype, x.device, c)
    m = x.numel() // c
    lib = _lib()
    code = _DTYPE_CODE[x.dtype]
    groups = -(-m // lib.passt_ln_qkv_b2_rows(code))
    dx = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    xn = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    parts = torch.empty((2, groups, c), dtype=torch.float32, device=x.device)
    status = lib.passt_ln_qkv_b2(
        *(ctypes.c_void_p(ops[k].data_ptr()) for k in ("x", "dqkv", "w", "s", "b")),
        *(ctypes.c_void_p(t.data_ptr()) for t in (dx, xn, parts[0], parts[1])),
        code, m, c, float(eps), _build.stream_of(x),
    )
    _build.check(lib, status, "ln_qkv B2 kernel launch")
    _build.LAUNCHES[_KEY_B2] += 1
    sums = parts.sum(dim=1)
    return dx, xn, sums[0], sums[1]


class _LnQkvAttention(torch.autograd.Function):
    """F1 then the attention forward; the attention backward, B2, then dW
    and db (see module docstring)."""

    @staticmethod
    def forward(ctx, x, s, b, w, wb, heads: int, head_dim: int, scale: float, plus1: bool, eps: float):
        qkv = ln_qkv_f1(x, s, b, w, wb, eps)
        ctx.save_for_backward(x, s, b, w, qkv)
        ctx.args = (heads, head_dim, scale, plus1, eps)
        bsz, n, _ = qkv.shape
        if qkv.device.type == "cpu":
            q, k, v = qkv.reshape(bsz, n, 3, heads, head_dim).unbind(2)
            return attention_plain(q, k, v, scale=scale, plus1=plus1).reshape(bsz, n, heads * head_dim)
        out = torch.empty((bsz, n, heads * head_dim), dtype=qkv.dtype, device=qkv.device)
        _launch(*_head_views(qkv, heads, head_dim), out.view(bsz, n, heads, head_dim), scale, plus1)
        _build.LAUNCHES[_KEY_QKV] += 1
        return out

    @staticmethod
    def backward(ctx, do):
        x, s, b, w, qkv = ctx.saved_tensors
        heads, head_dim, scale, plus1, eps = ctx.args
        dqkv = fused_attention_qkv_bwd(qkv, do, heads=heads, head_dim=head_dim, scale=scale, plus1=plus1)
        dx, xn, dscale, dbias = ln_qkv_b2(x, dqkv, w, s, b, eps)
        c3 = dqkv.shape[-1]
        d2 = dqkv.reshape(-1, c3)
        dw = torch.matmul(d2.t(), xn.reshape(-1, x.shape[-1])).to(w.dtype)
        db = d2.float().sum(dim=0).to(w.dtype)
        return dx, dscale.to(s.dtype), dbias.to(b.dtype), dw, db, None, None, None, None, None


def fused_ln_qkv_attention(
    x: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    qkv_weight: torch.Tensor,
    qkv_bias: torch.Tensor,
    *,
    heads: int,
    head_dim: int,
    scale: float,
    plus1: bool = False,
    eps: float = 1e-6,
) -> torch.Tensor:
    """norm1 -> qkv Linear -> attention, fused (see module docstring).

    x: ``[B, N, C]`` before norm1, in the compute dtype; ln_scale, ln_bias:
    ``[C]`` (fp32 parameters); qkv_weight: ``[3*heads*head_dim, C]`` (torch
    Linear layout, columns of the output ordered (qkv, head, dim)) and
    qkv_bias ``[3*heads*head_dim]``, cast to x's dtype here. Returns the
    ``[B, N, C]`` attention output in x's dtype.
    """
    if qkv_weight.shape[0] != 3 * heads * head_dim:
        raise ValueError(f"qkv weight out dim {qkv_weight.shape[0]} != 3*{heads}*{head_dim}")
    dt = x.dtype
    return _LnQkvAttention.apply(x, ln_scale, ln_bias, qkv_weight.to(dt), qkv_bias.to(dt), int(heads),
                                 int(head_dim), float(scale), bool(plus1), float(eps))
