"""The int8 Dense family as one Hopper GEMM with three epilogues
(``csrc/int8_gemm.cu``), with its plain PyTorch versions beside it.

Port of passt_tpu/ops/pallas/int8_dense.py (the quantized Dense, optionally
with the tanh-GELU fused into its epilogue) and of the tiled matmul of
scripts/int8_matmul_micro.py:

  y = dequant(Q8(x) @ Q8(w)) + b          :func:`int8_dense`
  h, d = tanh_gelu(y) and its derivative   :func:`int8_dense_gelu` (saves d)
  a @ b, int8 -> int32 or bf16, bf16 -> bf16   :func:`int8_matmul`

x is quantized per row and w per output column (symmetric, absmax / 127,
``round(x / scale)`` half to even, a zero row gets scale 1 and q = 0); the
int8 products are summed exactly in int32 and dequantized in fp32 as
``((acc * sx) * sw) + b``, rounded once to x's dtype. Quantization and the
straight-through backward stay plain PyTorch, as the JAX package leaves them
to XLA outside its kernel; the backward's products are ``torch.matmul`` with
``jnp.dot``'s type promotion.

The kernel takes both operands K-major: the weight is quantized as ``w^T``
(``quantize_rows(w.t())`` is ``quantize_cols(w)`` transposed, bit for bit) and
K is padded with zeros to a multiple of 16 bytes where it is not one.

Dispatch: a CPU tensor goes to the plain versions; a CUDA tensor launches the
kernel or raises. On the card every public call takes the ``"wgmma"`` main
loop (``csrc/int8_gemm.cu``: wgmma fed by TMA, a persistent grid, the output
tile a template parameter that :func:`pick_tile` chooses per call for the
least wave time); the first kernel's ``mma.sync`` loop (``csrc/int8_dense.cu``)
stays as the private path ``"mma"``. ``_build.LAUNCHES`` counts
``int8_dense``, ``int8_dense_gelu`` and ``int8_matmul``; ``PATH_LAUNCHES``
counts the launches of each main loop.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from passt_tpu_torch.ops import _build
from passt_tpu_torch.ops.activations import gelu_parts

_KEY_DENSE = "int8_dense"
_KEY_GELU = "int8_dense_gelu"
_KEY_MM = "int8_matmul"
for _key in (_KEY_DENSE, _KEY_GELU, _KEY_MM):
    _build.LAUNCHES.setdefault(_key, 0)

_IN_CODE = {torch.int8: 0, torch.bfloat16: 1}
_OUT_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
_EPI_DENSE, _EPI_GELU, _EPI_RAW = 0, 1, 2
#: output dtypes of each input dtype of :func:`int8_matmul`
_MATMUL_OUT = {torch.int8: (torch.int32, torch.bfloat16), torch.bfloat16: (torch.bfloat16,)}
#: the dense epilogues' output dtypes (x's dtype)
_DENSE_OUT = (torch.float32, torch.bfloat16)
#: the most K for which a sum of int8 products stays inside int32
MAX_K_INT8 = (2**31 - 1) // (128 * 128)
#: the main loops: the wgmma one every public call takes on the card, and the
#: first kernel's mma.sync one (private, timed beside it)
PATHS = ("wgmma", "mma")
#: launches of each main loop since the last :func:`reset_path_launches`
PATH_LAUNCHES = dict.fromkeys(PATHS, 0)
_build.COUNTERS["int8_paths"] = PATH_LAUNCHES
#: the wgmma loop's compiled output tiles (rows, columns), by the index its C
#: entry takes (``launch_tile`` in ``csrc/int8_gemm.cu``)
TILES = ((128, 128), (128, 192), (128, 256))
#: row tiles per group of the persistent tile order (``GROUP_M``)
GROUP_M = 8


def reset_path_launches() -> None:
    for name in PATH_LAUNCHES:
        PATH_LAUNCHES[name] = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def wave_cost(m: int, n: int, tile: int, sms: int) -> int:
    """The wave time of an ``[m, n]`` output on compiled tile ``tile`` over
    ``sms`` multiprocessors (one block each), in units of one column of a
    tile: the rounds of tiles (``ceil(tiles / sms)``) times the tile's
    width, which its time is proportional to."""
    bm, bn = TILES[tile]
    return _cdiv(_cdiv(m, bm) * _cdiv(n, bn), sms) * bn


def pick_tile(m: int, n: int, sms: int, *, gelu: bool) -> int:
    """The compiled tile with the least :func:`wave_cost` for an ``[m, n]``
    output. Of tiles that tie, under the GELU epilogue the narrowest: a
    block runs its epilogue after its main loop, and GELU's (two bf16
    outputs and a tanh an element) decides the time, so the narrower tile's
    shorter epilogue wins. Under DENSE and RAW the widest, whose main loop
    reads fewer bytes per product. chip_smoke [3d] times every tile at the
    MLP's shapes on an H100: fc1 + GELU 128 x 128 0.076 ms, 128 x 192 0.091;
    fc2 128 x 192 0.031 ms, 128 x 128 0.033."""
    width = (lambda i: TILES[i][1]) if gelu else (lambda i: -TILES[i][1])
    return min(range(len(TILES)), key=lambda i: (wave_cost(m, n, i, sms), width(i)))


def tile_order(m: int, n: int, tile: int) -> list:
    """The output tiles ``(row tile, column tile)`` in the persistent order
    of ``tile_coords`` in ``csrc/int8_gemm.cu``: groups of ``GROUP_M`` row
    tiles, each walked column by column. Block b of a grid of g takes
    entries b, b + g, ..."""
    bm, bn = TILES[tile]
    tiles_m, tiles_n = _cdiv(m, bm), _cdiv(n, bn)
    order = []
    for t in range(tiles_m * tiles_n):
        group, r = divmod(t, GROUP_M * tiles_n)
        first = group * GROUP_M
        size = min(tiles_m - first, GROUP_M)
        order.append((first + r % size, r // size))
    return order


def quantize_rows(x: torch.Tensor):
    """Symmetric per-row int8: ``(q [M, K] int8, scale [M, 1] fp32)`` with
    ``x ~= q * scale``. Zero rows quantize to zeros with scale 1."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(absmax > 0, absmax / 127.0, 1.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_cols(w: torch.Tensor):
    """Symmetric per-output-channel int8 for a ``[K, N]`` weight:
    ``(q [K, N] int8, scale [1, N] fp32)``."""
    q, scale = quantize_rows(w.t())
    return q.t(), scale.t()


def _exact_product(qa: torch.Tensor, qbt: torch.Tensor) -> torch.Tensor:
    """``qa [M, K] @ qbt [N, K]^T`` of int8 operands, exact, in int32. CUDA
    has no integer matmul: float64 holds every such sum exactly there."""
    if qa.device.type == "cpu":
        return qa.int() @ qbt.int().t()
    return (qa.double() @ qbt.double().t()).to(torch.int32)


def quantized_dense_plain(qx, sx, qwt, sw, b, *, out_dtype: torch.dtype, gelu: bool = False):
    """The kernel's dense epilogues in plain PyTorch on quantized operands:
    qx ``[M, K]`` and qwt ``[N, K]`` int8, sx ``[M, 1]``, sw and b ``[N]``.
    Returns y, or ``(h, d)`` under ``gelu``, in ``out_dtype``."""
    z = _exact_product(qx, qwt).float() * sx.float().reshape(-1, 1) * sw.float().reshape(1, -1) + b.float()
    if not gelu:
        return z.to(out_dtype)
    h, d = gelu_parts(z)
    return h.to(out_dtype), d.to(out_dtype)


def int8_dense_plain(x, w, b, gelu: bool = False):
    """``x [M, K] @ w [K, N] + b`` with int8 operands, in plain PyTorch: y,
    or ``(h, d)`` (tanh-GELU of y and its derivative) under ``gelu``, in x's
    dtype."""
    qx, sx = quantize_rows(x)
    qw, sw = quantize_cols(w)
    return quantized_dense_plain(qx, sx, qw.t(), sw, b, out_dtype=x.dtype, gelu=gelu)


def int8_matmul_plain(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """``a [M, K] @ b [K, N]`` in plain PyTorch: int8 summed exactly in int32,
    bf16 in fp32; cast to ``out_dtype``."""
    if a.dtype == torch.int8:
        return _exact_product(a, b.t()).to(out_dtype)
    return torch.matmul(a.float(), b.float()).to(out_dtype)


@functools.cache
def _lib(path: str):
    """The kernel library of a main loop, built and bound on first use."""
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    if path == "mma":
        lib = _build.load("int8_dense")
        lib.passt_int8_gemm.argtypes = [vp] * 7 + [i32] * 6 + [vp]
        lib.passt_int8_gemm.restype = ctypes.c_int
    else:
        lib = _build.load("int8_gemm")
        lib.passt_int8_gemm_wgmma.argtypes = [vp] * 7 + [i32] * 8 + [vp]
        lib.passt_int8_gemm_wgmma.restype = ctypes.c_int
    return lib



def _pad_k(t: torch.Tensor) -> torch.Tensor:
    """``t [R, K]`` contiguous, K zero-padded to a multiple of 16 bytes."""
    pad = -t.shape[1] % (16 // t.element_size())
    return (F.pad(t, (0, pad)) if pad else t).contiguous()


def _gemm(a, bt, out, out2, sx, sw, bias, epilogue: int, path: str = "wgmma", tile=None) -> None:
    """Launch the kernel: ``out = epilogue(a [M, K] @ bt [N, K]^T)``; the
    float operands (sx ``[M]``, sw and bias ``[N]``) may be None for RAW.
    ``path`` and ``tile`` (an index into :data:`TILES`; :func:`pick_tile`'s
    by default) are private overrides, for timing the main loops and tiles
    side by side."""
    if path not in PATHS:
        raise ValueError(f"int8 GEMM path {path!r} is not one of {PATHS}")
    m, n = a.shape[0], bt.shape[0]
    named = dict(a=a, bt=bt, out=out, out2=out2, sx=sx, sw=sw, bias=bias)
    for name, t in named.items():
        if t is None:
            continue
        if t.device != a.device:
            raise ValueError(f"{name} must be on {a.device}, got {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    a, bt = _pad_k(a), _pad_k(bt)
    lib = _lib(path)
    ptrs = [ctypes.c_void_p(t.data_ptr() if t is not None else 0) for t in (a, bt, out, out2, sx, sw, bias)]
    codes = (_IN_CODE[a.dtype], epilogue, _OUT_CODE[out.dtype], m, n, a.shape[1])
    if path == "mma":
        code = lib.passt_int8_gemm(*ptrs, *codes, _build.stream_of(a))
    else:
        sms = _build.sm_count(a.device)
        tile = pick_tile(m, n, sms, gelu=epilogue == _EPI_GELU) if tile is None else tile
        code = lib.passt_int8_gemm_wgmma(*ptrs, *codes, tile, sms, _build.stream_of(a))
    _build.check(lib, code, f"int8 GEMM kernel launch ({path} path)")
    PATH_LAUNCHES[path] += 1


def _check_k(k: int, dtype: torch.dtype) -> None:
    if dtype == torch.int8 and k > MAX_K_INT8:
        raise ValueError(f"int8 sums over K = {k} > {MAX_K_INT8} may overflow int32")


def quantized_dense(qx, sx, qwt, sw, b, *, out_dtype: torch.dtype, gelu: bool = False, _path: str = "wgmma",
                    _tile=None):
    """The dense epilogues on quantized operands (see
    :func:`quantized_dense_plain`): the kernel on CUDA tensors, the plain
    version on CPU tensors. ``_path`` and ``_tile`` are :func:`_gemm`'s
    private overrides."""
    m, k = qx.shape
    n = qwt.shape[0]
    if qx.dtype != torch.int8 or qwt.dtype != torch.int8:
        raise ValueError(f"quantized operands must be int8, got {qx.dtype} and {qwt.dtype}")
    if qwt.shape[1] != k or sx.numel() != m or sw.numel() != n or b.numel() != n:
        raise ValueError(f"shapes qx {tuple(qx.shape)}, sx {tuple(sx.shape)}, qwt {tuple(qwt.shape)}, "
                         f"sw {tuple(sw.shape)}, b {tuple(b.shape)} do not match")
    if out_dtype not in _DENSE_OUT:
        raise ValueError(f"the int8 dense kernel writes float32 or bfloat16, not {out_dtype}")
    _check_k(k, torch.int8)
    if qx.device.type == "cpu":
        return quantized_dense_plain(qx, sx, qwt, sw, b, out_dtype=out_dtype, gelu=gelu)
    floats = [t.float().reshape(-1).contiguous() for t in (sx, sw, b)]
    out = torch.empty((m, n), dtype=out_dtype, device=qx.device)
    out2 = torch.empty_like(out) if gelu else None
    _gemm(qx.contiguous(), qwt.contiguous(), out, out2, *floats, _EPI_GELU if gelu else _EPI_DENSE, _path, _tile)
    _build.LAUNCHES[_KEY_GELU if gelu else _KEY_DENSE] += 1
    return (out, out2) if gelu else out


def int8_dense_forward(x, w, b, gelu: bool = False):
    """The forward of :func:`int8_dense` (or, under ``gelu``, ``(h, d)`` of
    :func:`int8_dense_gelu`): quantize, then :func:`quantized_dense`. x
    ``[M, K]``, w ``[K, N]``, b ``[N]``; outputs in x's dtype."""
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"x {tuple(x.shape)} @ w {tuple(w.shape)}: want [M, K] @ [K, N]")
    qx, sx = quantize_rows(x)
    qwt, sw = quantize_rows(w.t())
    return quantized_dense(qx, sx, qwt, sw, b, out_dtype=x.dtype, gelu=gelu)


def int8_matmul(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype = torch.bfloat16, *,
                _path: str = "wgmma", _tile=None) -> torch.Tensor:
    """``a [M, K] @ b [K, N]``: int8 x int8 summed in int32, cast to int32 or
    bfloat16; bf16 x bf16 summed in fp32, cast to bfloat16. The kernel on
    CUDA tensors (b is read K-major: a b that is the transpose of a
    contiguous ``[N, K]`` tensor is not copied), the plain version on CPU
    tensors. ``_path`` and ``_tile`` are :func:`_gemm`'s private
    overrides."""
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"a {tuple(a.shape)} @ b {tuple(b.shape)}: want [M, K] @ [K, N]")
    if a.dtype != b.dtype or out_dtype not in _MATMUL_OUT.get(a.dtype, ()):
        raise ValueError(f"int8_matmul takes int8 -> int32/bfloat16 or bfloat16 -> bfloat16, got "
                         f"{a.dtype} x {b.dtype} -> {out_dtype}")
    _check_k(a.shape[1], a.dtype)
    if a.device.type == "cpu":
        return int8_matmul_plain(a, b, out_dtype)
    out = torch.empty((a.shape[0], b.shape[1]), dtype=out_dtype, device=a.device)
    _gemm(a.contiguous(), b.t().contiguous(), out, None, None, None, None, _EPI_RAW, _path, _tile)
    _build.LAUNCHES[_KEY_MM] += 1
    return out


def _dot(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """``jnp.dot``'s promotion: both operands in their common dtype."""
    dt = torch.promote_types(p.dtype, q.dtype)
    return torch.matmul(p.to(dt), q.to(dt))


def _ste_grads(x, w, b, gz):
    """The straight-through gradients of ``x @ w + b`` given dL/dz, in the
    dtypes of x, w and b."""
    dx = _dot(gz, w.t()).to(x.dtype)
    dw = _dot(x.t(), gz).to(w.dtype)
    db = gz.float().sum(dim=0).to(b.dtype)
    return dx, dw, db


class _Int8Dense(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w, b)
        return int8_dense_forward(x, w, b)

    @staticmethod
    def backward(ctx, g):
        return _ste_grads(*ctx.saved_tensors, g)


class _Int8DenseGelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b):
        h, d = int8_dense_forward(x, w, b, gelu=True)
        ctx.save_for_backward(x, w, b, d)
        return h

    @staticmethod
    def backward(ctx, g):
        x, w, b, d = ctx.saved_tensors
        gz = (g.float() * d.float()).to(g.dtype)
        return _ste_grads(x, w, b, gz)


def int8_dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x [M, K] @ w [K, N] + b`` with an int8 forward (the kernel on CUDA
    tensors) and the straight-through backward: exact gradients of the
    unquantized Dense in the dtypes of x, w and b."""
    return _Int8Dense.apply(x, w, b)


def int8_dense_gelu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``tanh_gelu(x @ w + b)`` with an int8 forward whose epilogue also
    writes the GELU derivative, and the saved-derivative straight-through
    backward (one multiply, no transcendentals)."""
    return _Int8DenseGelu.apply(x, w, b)


def int8_dense_nd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, gelu: bool = False) -> torch.Tensor:
    """:func:`int8_dense` (or :func:`int8_dense_gelu`) over all leading dims
    of x (the module-side tensors are ``[B, N, C]``)."""
    lead = x.shape[:-1]
    f = int8_dense_gelu if gelu else int8_dense
    return f(x.reshape(-1, x.shape[-1]), w, b).reshape(*lead, w.shape[1])
