"""Attention as Hopper kernels (``csrc/attention_fwd.cu``,
``csrc/attention_fwd_fp32.cu``, ``csrc/attention_bwd.cu`` and
``csrc/attention_bwd_fp32.cu``), with their plain PyTorch versions beside
them.

Port of passt_tpu/ops/pallas/attention.py. Two differentiable entry points,
as in the JAX package, launch the same kernels:

- :func:`fused_attention` on q, k, v ``[B, N, H, D]`` (any strides with a
  contiguous last dim, e.g. views into the qkv Dense output); it saves q, k,
  v and its backward returns dq, dk, dv ``[B, N, H, D]``;
- :func:`fused_attention_qkv` on the raw qkv Dense output ``[B, N, 3C]``,
  columns ordered (qkv, head, dim); it saves qkv and its backward writes
  d(qkv) ``[B, N, 3C]`` in the Dense layout.

The kernels read and write both layouts in place through (batch, token,
head) strides.

The math is the reference's: fp32 scores, one max over the whole row
(clamped at 0 under ``plus1``, which also adds ``exp(-m)`` to the
denominator), P rounded to the input dtype for PV with an fp32 accumulator,
division by the denominator after PV, output in the input dtype. The
forward's "wgmma" and "simt" paths take the max in one pass over the keys:
P is rounded against the running max (in fp32 the rounding is the
identity) and the fp32 accumulator is rescaled when the max rises (see
``csrc/attention_fwd.cu``, ``csrc/attention_fwd_fp32.cu``). The backward recomputes P
from q and k (nothing but the inputs is saved) and follows the reference
backward kernel (see ``csrc/attention_bwd.cu``); its "wgmma" path takes
the row statistics in one pass with a running max, as the forward does, and
its "resident" path (the whole head in one block) takes them exactly, as
the reference does.

Dispatch: a CPU tensor goes to the plain version; a CUDA tensor launches the
kernel or raises. On the card :func:`forward_path` alone picks the forward
kernel's path from the call's shape, dtype and alignment: ``"wgmma"``
(bf16/fp16, aligned, at a D that is a multiple of 16 but D = 64 with
N <= 64: one pass over K, wgmma fed by TMA, a template on the head dim
padded to DP = 32, 64 or 128, :func:`wgmma_head_dim`), ``"short"`` (D = 64,
N <= 64: one key tile, four heads a block at N <= 16) and ``"simt"`` (every
other call: every fp32 call, and bf16/fp16 at a D that is 8 mod 16 or on
unaligned views; one pass over K in fp32 FMA with register micro-tiles,
``csrc/attention_fwd_fp32.cu``, a template on the input dtype and on the
head dim padded to 32, 64, 96 or 128). The C entry launches exactly that
path or returns an error, on which the wrapper raises;
``FWD_PATH_LAUNCHES`` counts the launches of each. The backward's path,
which :func:`backward_path` picks in the same way: ``"wgmma"`` (bf16/fp16,
aligned, at a D that is a multiple of 16 but D = 32 with N <= 128: a
statistics kernel, then one pass per 64-key block on wgmma fed by TMA, dQ
summed across key blocks in a fixed order; templates on DP = 32, 64, 128),
``"resident"`` (D = 32, N <= 128: one launch, one block per (batch, head)
holding the whole head, exact row statistics, no scratch) and ``"simt"``
(every other call: the "wgmma" order in fp32 FMA,
``csrc/attention_bwd_fp32.cu``, templates on the dtype and the padded head
dim); ``BWD_PATH_LAUNCHES`` counts them. No call dispatches to the old
``"mma"`` and ``"fma"`` kernels (``csrc/attention_fwd.cu``,
``csrc/attention_bwd.cu``); the private ``path=`` override still reaches
them, so that they can be timed on the same call. A failed build or launch
raises, and nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from passt_tpu_torch.ops import _build

_KEY_BNHD = "fused_attention"
_KEY_QKV = "fused_attention_qkv"
_KEY_BNHD_BWD = "fused_attention_bwd"
_KEY_QKV_BWD = "fused_attention_qkv_bwd"
for _key in (_KEY_BNHD, _KEY_QKV, _KEY_BNHD_BWD, _KEY_QKV_BWD):
    _build.LAUNCHES.setdefault(_key, 0)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: the forward kernel's paths, by the code its C entry takes ("simt" is the
#: kernel of ``csrc/attention_fwd_fp32.cu``, a C entry of its own; "fma" and
#: "mma" are reached only by the private override)
FWD_PATHS = {"fma": 0, "mma": 1, "short": 2, "wgmma": 3, "simt": 4}
#: forward launches per path since the last :func:`reset_path_launches`
#: (beside ``_build.LAUNCHES``, which counts per entry point)
FWD_PATH_LAUNCHES = dict.fromkeys(FWD_PATHS, 0)


#: the padded head dims the "simt" kernels are built for (templates on DP in
#: ``csrc/attention_fwd_fp32.cu`` and ``csrc/attention_bwd_fp32.cu``; a call
#: at head dim d runs on the smallest DP >= d, ``simt_dp`` in
#: ``csrc/attention_common.cuh``)
SIMT_HEAD_DIMS = (32, 64, 96, 128)


def simt_head_dim(d: int) -> int:
    """The padded head dim of the "simt" instance that takes head dim ``d``
    (a multiple of 8 up to 128)."""
    return next(dp for dp in SIMT_HEAD_DIMS if d <= dp)


#: the padded head dims the "wgmma" kernels are built for (templates on DP
#: in ``csrc/attention_fwd.cu`` and ``csrc/attention_bwd.cu``; a call at
#: head dim d, a multiple of 16, runs on the smallest DP >= d, ``wgmma_dp``
#: in ``csrc/attention_common.cuh``)
WGMMA_HEAD_DIMS = (32, 64, 128)


def wgmma_head_dim(d: int) -> int:
    """The padded head dim of the "wgmma" instance that takes head dim ``d``
    (a multiple of 16 up to 128)."""
    return next(dp for dp in WGMMA_HEAD_DIMS if d <= dp)


#: the backward kernel's paths, by the code its C entry takes ("simt" is
#: the kernel pair of ``csrc/attention_bwd_fp32.cu``, a C entry of its own;
#: "fma" and "mma" are reached only by the private override)
BWD_PATHS = {"fma": 0, "mma": 1, "wgmma": 2, "simt": 3, "resident": 4}
#: the most tokens the "resident" backward takes: a block holds every key
#: and query of its head (RS_N in ``csrc/attention_bwd.cu``)
RESIDENT_MAX_N = 128
#: backward launches per path since the last :func:`reset_path_launches`
BWD_PATH_LAUNCHES = dict.fromkeys(BWD_PATHS, 0)
_build.COUNTERS.update(attention_fwd_paths=FWD_PATH_LAUNCHES, attention_bwd_paths=BWD_PATH_LAUNCHES)


def reset_path_launches() -> None:
    for counts in (FWD_PATH_LAUNCHES, BWD_PATH_LAUNCHES):
        for name in counts:
            counts[name] = 0


def forward_path(n: int, d: int, dtype: torch.dtype, aligned: bool) -> str:
    """The forward kernel path for ``n`` tokens of head dim ``d`` (a
    multiple of 8 up to 128): for bf16 / fp16 with aligned operands
    (``aligned``: 16-byte aligned base pointers, strides in multiples of 8
    elements) at a ``d`` that is a multiple of 16, ``"short"`` at ``d = 64``
    and ``n <= 64``, ``"wgmma"`` otherwise; ``"simt"`` for every other call
    (every fp32 call, any ``n``)."""
    if dtype not in (torch.bfloat16, torch.float16) or not aligned or d % 16:
        return "simt"
    return "short" if d == 64 and n <= 64 else "wgmma"


def backward_path(n: int, d: int, dtype: torch.dtype, aligned: bool) -> str:
    """The backward kernel path for ``n`` tokens of head dim ``d`` (a
    multiple of 8 up to 128): for bf16 / fp16 with aligned operands at a
    ``d`` that is a multiple of 16, ``"resident"`` at ``d = 32`` and
    ``n <= 128``, ``"wgmma"`` otherwise; ``"simt"`` for every other call
    (every fp32 call, any ``n``)."""
    if dtype not in (torch.bfloat16, torch.float16) or not aligned or d % 16:
        return "simt"
    return "resident" if d == 32 and n <= RESIDENT_MAX_N else "wgmma"


def _aligned(*tensors: torch.Tensor) -> bool:
    """What the tensor-core paths need (``vectors_aligned`` in
    ``csrc/attention_common.cuh``): 16-byte aligned base pointers and
    (batch, token, head) strides in multiples of 8 elements."""
    return all(t.data_ptr() % 16 == 0 and all(s % 8 == 0 for s in t.stride()[:3]) for t in tensors)


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
        [vp, vp, vp, vp, i32, i32, i32, i32, i32, i32] + [i64] * 12 + [ctypes.c_float, i32, vp]
    )
    lib.passt_attention_fwd.restype = ctypes.c_int
    return lib


def _check_operands(named: dict) -> None:
    """Raise unless every operand is a CUDA ``[B, N, H, D]`` tensor of q's
    device, dtype and shape with a contiguous last dim, in a shape the
    kernels take."""
    q = named["q"]
    b, n, h, d = q.shape
    for name, t in named.items():
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} must be a CUDA tensor on {q.device}, got {t.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} dtype {t.dtype} != q dtype {q.dtype}")
        if tuple(t.shape) != (b, n, h, d):
            raise ValueError(f"{name} shape {tuple(t.shape)} != {(b, n, h, d)}")
        if t.stride(3) != 1:
            raise ValueError(f"{name} needs a contiguous head dim, strides {t.stride()}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"attention kernels take float32/bfloat16/float16, got {q.dtype}")
    if d > 128 or d % 8:
        raise ValueError(f"attention kernels need head_dim <= 128 and a multiple of 8, got {d}")
    if b > 65535 or h > 65535:
        raise ValueError(f"attention kernel grid limit: batch {b}, heads {h} must be <= 65535")


@functools.cache
def _fwd32_lib():
    """The "simt" forward kernel library, built and bound on first use."""
    lib = _build.load("attention_fwd_fp32")
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.passt_attention_fwd_fp32.argtypes = [vp] * 4 + [i32] * 5 + [i64] * 12 + [ctypes.c_float, i32, vp]
    lib.passt_attention_fwd_fp32.restype = ctypes.c_int
    lib.passt_attention_fwd_fp32_occupancy.argtypes = [i32, i32, i32, ctypes.POINTER(ctypes.c_int)]
    lib.passt_attention_fwd_fp32_occupancy.restype = ctypes.c_int
    return lib


def simt_forward_blocks_per_sm(d: int = 64, dtype: torch.dtype = torch.float32, aligned: bool = True) -> int:
    """The blocks of the "simt" forward kernel's instance for head dim ``d``,
    ``dtype`` and aligned or unaligned operands an SM of the current card
    holds at once (the occupancy query; builds the kernel)."""
    lib, blocks = _fwd32_lib(), ctypes.c_int(0)
    _build.check(lib, lib.passt_attention_fwd_fp32_occupancy(_DTYPE_CODE[dtype], d, int(aligned), ctypes.byref(blocks)),
                 "simt forward occupancy")
    return blocks.value


def _launch(q, k, v, out, scale: float, plus1: bool, path: Optional[str] = None) -> None:
    """Launch the kernel on ``[B, N, H, D]``-shaped views (any strides with
    a contiguous last dim), on the path :func:`forward_path` picks.
    ``path`` overrides the choice (private: chip_smoke and the variants
    tools time the old "fma" kernel beside "simt" and the old "mma" kernel
    beside "wgmma" on the same call); a path that cannot take the call
    raises."""
    _check_operands(dict(q=q, k=k, v=v, out=out))
    b, n, h, d = q.shape
    if path is None:
        path = forward_path(n, d, q.dtype, _aligned(q, k, v, out))
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    if path == "simt":
        lib = _fwd32_lib()
        code = lib.passt_attention_fwd_fp32(
            *(ctypes.c_void_p(t.data_ptr()) for t in (q, k, v, out)), _DTYPE_CODE[q.dtype], b, n, h, d, *strides,
            float(scale), int(bool(plus1)), _build.stream_of(q),
        )
        _build.check(lib, code, "attention kernel launch (simt path)")
        FWD_PATH_LAUNCHES[path] += 1
        return
    lib = _lib()
    code = lib.passt_attention_fwd(
        ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(k.data_ptr()),
        ctypes.c_void_p(v.data_ptr()), ctypes.c_void_p(out.data_ptr()),
        _DTYPE_CODE[q.dtype], FWD_PATHS[path], b, n, h, d, *strides, float(scale), int(bool(plus1)),
        _build.stream_of(q),
    )
    _build.check(lib, code, f"attention kernel launch ({path} path)")
    FWD_PATH_LAUNCHES[path] += 1


def attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, *,
    scale: float, plus1: bool = False,
):
    """The backward kernel's function in plain PyTorch, on ``[B, N, H, D]``:
    the JAX package's ``_xla_attn_bwd`` in fp32, in its kernels' order
    (``dO * (1/l)`` in fp32 for dV, ``di`` from the unrounded p, dS rounded
    to the input dtype before dQ and dK). Returns dq, dk, dv ``[B, N, H, D]``
    in the input dtype."""
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    s = torch.einsum("bnhd,bmhd->bhnm", qf, kf) * scale
    m = s.amax(dim=-1, keepdim=True)
    if plus1:
        m = torch.clamp(m, min=0.0)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if plus1:
        l = l + torch.exp(-m)
    inv_l = 1.0 / l  # [B, H, N, 1]
    do_n = dof * inv_l.permute(0, 2, 1, 3)
    dv = torch.einsum("bhnm,bnhd->bmhd", p, do_n)
    dp = torch.einsum("bnhd,bmhd->bhnm", dof, vf)
    di = (p * dp).sum(dim=-1, keepdim=True) * inv_l
    ds = ((p * inv_l) * (dp - di) * scale).to(q.dtype).float()
    dq = torch.einsum("bhnm,bmhd->bnhd", ds, kf)
    dk = torch.einsum("bhnm,bnhd->bmhd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@functools.cache
def _bwd_lib():
    """The backward kernel library, built and bound on first use."""
    lib = _build.load("attention_bwd")
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.passt_attention_bwd.argtypes = (
        [vp] * 8 + [i32] * 6 + [i64] * 21 + [ctypes.c_float, i32, i32, vp]
    )
    lib.passt_attention_bwd.restype = ctypes.c_int
    lib.passt_attention_bwd_scratch.argtypes = [i32] * 5
    lib.passt_attention_bwd_scratch.restype = ctypes.c_longlong
    return lib


@functools.cache
def _bwd32_lib():
    """The "simt" backward kernel library, built and bound on first use."""
    lib = _build.load("attention_bwd_fp32")
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.passt_attention_bwd_fp32.argtypes = [vp] * 8 + [i64] + [i32] * 5 + [i64] * 21 + [ctypes.c_float, i32, i32, vp]
    lib.passt_attention_bwd_fp32.restype = ctypes.c_int
    lib.passt_attention_bwd_fp32_scratch.argtypes = [i32] * 7
    lib.passt_attention_bwd_fp32_scratch.restype = ctypes.c_longlong
    lib.passt_attention_bwd_fp32_occupancy.argtypes = [i32, i32, i32, ctypes.POINTER(ctypes.c_int),
                                                       ctypes.POINTER(ctypes.c_int)]
    lib.passt_attention_bwd_fp32_occupancy.restype = ctypes.c_int
    return lib


def simt_backward_blocks_per_sm(d: int = 64, dtype: torch.dtype = torch.float32, aligned: bool = True) -> tuple:
    """The blocks of the "simt" backward's kernel S and kernel KV (their
    instances for head dim ``d``, ``dtype`` and aligned or unaligned
    operands) an SM of the current card holds at once (the occupancy query;
    builds the kernels)."""
    lib, stats, kv = _bwd32_lib(), ctypes.c_int(0), ctypes.c_int(0)
    _build.check(lib, lib.passt_attention_bwd_fp32_occupancy(_DTYPE_CODE[dtype], d, int(aligned), ctypes.byref(stats),
                                                             ctypes.byref(kv)),
                 "simt backward occupancy")
    return stats.value, kv.value


def _launch_bwd(q, k, v, do, dq, dk, dv, scale: float, plus1: bool, path: Optional[str] = None) -> None:
    """Launch the backward kernels on ``[B, N, H, D]``-shaped views (any
    strides with a contiguous last dim), on the path :func:`backward_path`
    picks; dq, dk, dv are written in place. ``path`` overrides the choice
    (private: chip_smoke and the variants tools time the old "mma" pair
    beside "wgmma" and "resident", and the old "fma" pair beside "simt", on
    the same call); a path that cannot take the call raises."""
    _check_operands(dict(q=q, k=k, v=v, do=do, dq=dq, dk=dk, dv=dv))
    b, n, h, d = q.shape
    if path is None:
        path = backward_path(n, d, q.dtype, _aligned(q, k, v, do, dq, dk, dv))
    strides = [s for t in (q, k, v, do, dq, dk, dv) for s in t.stride()[:3]]
    if path == "simt":
        lib = _bwd32_lib()
        floats = lib.passt_attention_bwd_fp32_scratch(_DTYPE_CODE[q.dtype], b, n, h, d,
                                                      int(_aligned(q, k, v, do, dq, dk, dv)), _build.sm_count(q.device))
        if floats < 0:
            raise RuntimeError(f"the simt backward's occupancy query failed ({q.dtype}, head_dim {d})")
        scratch = torch.empty(floats, dtype=torch.float32, device=q.device)
        code = lib.passt_attention_bwd_fp32(
            *(ctypes.c_void_p(t.data_ptr()) for t in (q, k, v, do, dq, dk, dv, scratch)), floats,
            _DTYPE_CODE[q.dtype], b, n, h, d, *strides, float(scale), int(bool(plus1)), _build.sm_count(q.device),
            _build.stream_of(q),
        )
        _build.check(lib, code, "attention backward kernel launch (simt path)")
        BWD_PATH_LAUNCHES[path] += 1
        return
    lib = _bwd_lib()
    floats = lib.passt_attention_bwd_scratch(BWD_PATHS[path], b, n, h, d)
    # "resident" takes none: no allocation on its calls
    scratch = torch.empty(floats, dtype=torch.float32, device=q.device) if floats else None
    code = lib.passt_attention_bwd(
        *(ctypes.c_void_p(t.data_ptr()) for t in (q, k, v, do, dq, dk, dv)),
        ctypes.c_void_p(scratch.data_ptr() if scratch is not None else 0),
        _DTYPE_CODE[q.dtype], BWD_PATHS[path], b, n, h, d, *strides, float(scale), int(bool(plus1)),
        _build.sm_count(q.device), _build.stream_of(q),
    )
    _build.check(lib, code, f"attention backward kernel launch ({path} path)")
    BWD_PATH_LAUNCHES[path] += 1


def _head_views(t: torch.Tensor, heads: int, head_dim: int):
    """The q, k, v (or dq, dk, dv) ``[B, N, H, D]`` views of a ``[B, N, 3C]``
    tensor with columns ordered (qkv, head, dim)."""
    b, n, _ = t.shape
    return tuple(
        t.as_strided((b, n, heads, head_dim), (t.stride(0), t.stride(1), head_dim, 1),
                     t.storage_offset() + i * heads * head_dim)
        for i in range(3)
    )


def _last_dim_contiguous(t: torch.Tensor) -> torch.Tensor:
    return t if t.stride(-1) == 1 else t.contiguous()


def fused_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor, *,
    scale: float, plus1: bool = False,
):
    """dq, dk, dv ``[B, N, H, D]`` of :func:`fused_attention` given its
    output gradient ``do``, by the backward kernel (its plain version for a
    CPU tensor)."""
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, do, scale=scale, plus1=plus1)
    dq, dk, dv = (torch.empty(q.shape, dtype=q.dtype, device=q.device) for _ in range(3))
    _launch_bwd(q, k, v, _last_dim_contiguous(do), dq, dk, dv, scale, plus1)
    _build.LAUNCHES[_KEY_BNHD_BWD] += 1
    return dq, dk, dv


def fused_attention_qkv_bwd(
    qkv: torch.Tensor, do: torch.Tensor, *, heads: int, head_dim: int, scale: float,
    plus1: bool = False,
) -> torch.Tensor:
    """d(qkv) ``[B, N, 3C]`` of :func:`fused_attention_qkv` given its output
    gradient ``do`` ``[B, N, C]``. The kernel writes dq, dk and dv straight
    into their columns of d(qkv), the Dense layout, with no concat."""
    b, n, c3 = qkv.shape
    do = _last_dim_contiguous(do).reshape(b, n, heads, head_dim)
    if qkv.device.type == "cpu":
        q, k, v = qkv.reshape(b, n, 3, heads, head_dim).unbind(2)
        grads = attention_bwd_plain(q, k, v, do, scale=scale, plus1=plus1)
        return torch.stack(grads, dim=2).reshape(b, n, c3)
    dqkv = torch.empty((b, n, c3), dtype=qkv.dtype, device=qkv.device)
    _launch_bwd(*_head_views(qkv, heads, head_dim), do, *_head_views(dqkv, heads, head_dim),
                scale, plus1)
    _build.LAUNCHES[_KEY_QKV_BWD] += 1
    return dqkv


def attention_on_device(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                        plus1: bool) -> torch.Tensor:
    """The body of ``passt::attention`` (``ops/library.py``): the plain
    version on a CPU tensor, the forward kernel on a CUDA tensor; ``[B, N,
    H, D]`` in, ``[B, N, H, D]`` contiguous out."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, scale=scale, plus1=plus1).contiguous()
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _launch(q, k, v, out, scale, plus1)
    _build.LAUNCHES[_KEY_BNHD] += 1
    return out


def attention_qkv_on_device(qkv: torch.Tensor, heads: int, head_dim: int, scale: float,
                            plus1: bool) -> torch.Tensor:
    """The body of ``passt::attention_qkv``: the forward kernel on the
    q, k, v views of the raw qkv ``[B, N, 3C]`` (its plain version on a CPU
    tensor); ``[B, N, C]`` out."""
    b, n, _ = qkv.shape
    if qkv.device.type == "cpu":
        q, k, v = qkv.reshape(b, n, 3, heads, head_dim).unbind(2)
        return attention_plain(q, k, v, scale=scale, plus1=plus1).reshape(b, n, heads * head_dim)
    if qkv.stride(2) != 1:
        raise ValueError(f"qkv needs a contiguous last dim, strides {qkv.stride()}")
    out = torch.empty((b, n, heads * head_dim), dtype=qkv.dtype, device=qkv.device)
    _launch(*_head_views(qkv, heads, head_dim), out.view(b, n, heads, head_dim), scale, plus1)
    _build.LAUNCHES[_KEY_QKV] += 1
    return out


class _FusedAttention(torch.autograd.Function):
    """Forward kernel (the custom op ``passt::attention``); backward kernel
    from the saved q, k, v."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, plus1: bool):
        ctx.save_for_backward(q, k, v)
        ctx.scale, ctx.plus1 = scale, plus1
        return torch.ops.passt.attention(q, k, v, scale, plus1)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        return (*fused_attention_bwd(q, k, v, do, scale=ctx.scale, plus1=ctx.plus1), None, None)


class _FusedAttentionQKV(torch.autograd.Function):
    """Forward kernel on raw qkv (the custom op ``passt::attention_qkv``);
    backward kernel writes d(qkv) from the saved qkv."""

    @staticmethod
    def forward(ctx, qkv, heads: int, head_dim: int, scale: float, plus1: bool):
        ctx.save_for_backward(qkv)
        ctx.args = dict(heads=heads, head_dim=head_dim, scale=scale, plus1=plus1)
        return torch.ops.passt.attention_qkv(qkv, heads, head_dim, scale, plus1)

    @staticmethod
    def backward(ctx, do):
        (qkv,) = ctx.saved_tensors
        return (fused_attention_qkv_bwd(qkv, do, **ctx.args), None, None, None, None)


def fused_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, scale: float, plus1: bool = False
) -> torch.Tensor:
    """softmax(q k^T * scale) v on ``[B, N, H, D]``; returns ``[B, N, H, D]``
    contiguous, in the input dtype. Differentiable: the backward returns
    dq, dk, dv ``[B, N, H, D]`` from the backward kernel."""
    return _FusedAttention.apply(q, k, v, float(scale), bool(plus1))


def fused_attention_qkv(
    qkv: torch.Tensor, *, heads: int, head_dim: int, scale: float, plus1: bool = False
) -> torch.Tensor:
    """Attention over the raw qkv Dense output ``[B, N, 3*heads*head_dim]``;
    returns ``[B, N, heads*head_dim]`` in the input dtype (the proj input).
    Differentiable: the backward returns d(qkv) in the Dense layout."""
    if qkv.ndim != 3 or qkv.shape[-1] != 3 * heads * head_dim:
        raise ValueError(f"qkv shape {tuple(qkv.shape)} != [B, N, 3*{heads}*{head_dim}]")
    return _FusedAttentionQKV.apply(qkv, int(heads), int(head_dim), float(scale), bool(plus1))
