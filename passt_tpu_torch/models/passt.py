"""PaSST — Patchout faSt Spectrogram Transformer, in PyTorch
(port of passt_tpu/models/passt.py).

Module and parameter names are the reference's torch names
(``patch_embed.proj``, ``blocks.{i}.norm1|attn.qkv|attn.proj|norm2|mlp.fc1|
mlp.fc2``, ``norm``, ``head.0``/``head.1``, ``head_dist``, ``cls_token``,
``dist_token``, ``new_pos_embed``, ``freq_new_pos_embed`` (1, D, F, 1) and
``time_new_pos_embed`` (1, D, 1, T)), so a published ``.pt`` state dict loads
with a plain ``load_state_dict``.

The numerics follow the JAX package rather than torch habit:

- parameters stay fp32 and every Dense casts them to the compute dtype; the
  product is rounded to that dtype first and the bias added after (flax
  ``nn.Dense`` order, see :class:`Linear`);
- LayerNorms compute in fp32 with the fast variance ``E[x^2] - mean^2``
  clamped at 0 and return fp32; block norms use eps 1e-6, the head's 1e-5;
- under bf16 the residual stream is bf16 from the patch embedding on, the
  features are the fp32 mean of tokens 0 and 1, and the head runs in fp32;
- ``gelu="auto"`` is erf under fp32 and tanh under bf16.

Training mode (``train=True``) adds, as the JAX package does: a random
offset into the time embedding for inputs shorter than its grid, structured
patchout (time, then frequency) and unstructured patchout, each a sorted
random subset of indices (:func:`_sorted_keep_indices`), dropout and
stochastic depth. The draws come from explicit ``torch.Generator``s, one per
stream of the JAX package (``generators={"patchout", "dropout",
"droppath"}``), on the input's device. Attention takes its entry with the
backward's rule (``backward=train``) and leaves the kernels when attention
dropout is on.

The two LayerNorm variants of the JAX package are here:

- ``ln_impl="fused"``: the block norms and the final norm are
  :class:`FusedLayerNorm`, whose backward is the Hopper LayerNorm-backward
  kernel (``ops/layernorm.py``);
- ``fuse_ln_qkv=True`` (with the fused attention): norm1 is absorbed into
  the attention boundary (``ops/ln_qkv.py``: the LN -> qkv kernel F1 and the
  dqkv W -> LN-backward kernel B2 around the attention kernels) wherever
  the JAX package's gate holds; elsewhere norm1 runs inline in the JAX
  rounding order and attention takes its usual entry. Under
  ``attn_impl="auto"`` without a card (the "xla" attention) the block runs
  unfused, as in the JAX package.

Both keep the parameters where the module path has them (``norm1.weight``,
``norm1.bias``, ...), so state dicts are unchanged.

The depth runs in one of three forms (``blocks_impl``), as in the JAX
package:

- "loop": ``blocks.{i}.*``, one :class:`Block` per layer;
- "scan": one set of ``[depth, ...]`` leaves at ``blocks.block.*`` (the JAX
  scan layout, leaf for leaf, in torch's orientation), the same
  :class:`Block` applied to each layer's slice, so logits and gradients
  equal the loop's bit for bit;
- "stacked": the same leaves, the depth unrolled by
  ``models/stacked_blocks.py`` with its hand-written backward (the weight
  gradients of every layer as four batched products).

``remat`` recomputes each block (or scan step) in the backward
(``torch.utils.checkpoint``); the draws made inside a block are recorded by
its forward and replayed by the recompute, so remat changes no bit.
``representation_size`` (no distillation) adds the pre-logits ``Linear`` +
tanh before the head.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from passt_tpu_torch.ops.activations import tanh_gelu
from passt_tpu_torch.ops.attention import (
    flat_kernel_supports,
    fused_attention,
    fused_attention_qkv,
)
from passt_tpu_torch.ops.layernorm import layer_norm
from passt_tpu_torch.ops.ln_qkv import fused_ln_qkv_attention, ln_qkv_supports, ln_stats

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class PaSSTConfig:
    """Model hyperparameters; the same fields and defaults as the JAX
    package's ``PaSSTConfig``."""

    input_fdim: int = 128
    input_tdim: int = 998
    patch_size: Tuple[int, int] = (16, 16)
    stride: Tuple[int, int] = (10, 10)
    in_chans: int = 1
    num_classes: int = 527
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    distilled: bool = True
    representation_size: Optional[int] = None
    u_patchout: int = 0
    s_patchout_t: int = 0
    s_patchout_f: int = 0
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.0
    dtype: str = "float32"  # compute dtype
    gelu: str = "auto"  # "erf", "tanh", or "auto": erf under fp32, tanh under bf16
    gelu_saved_deriv: bool = True  # tanh GELU: the backward multiplies by the saved derivative
    ln_impl: str = "auto"  # "auto"/"xla": flax-order LayerNorm; "fused": the
    # LayerNorm-backward kernel (FusedLayerNorm)
    remat: bool = False  # recompute each block in the backward
    softmax_fp32: bool = True  # "xla" attention: fp32 softmax
    patch_embed_impl: str = "unfold"  # "unfold" or "conv": the same function here
    attn_impl: str = "auto"  # "fused": the Hopper kernel (its plain version on
    # CPU tensors); "xla": the einsum composition; "auto": fused where CUDA is
    plus1_attn: bool = False
    verbose_shapes: bool = False
    fuse_ln_qkv: bool = False  # norm1 absorbed into the attention boundary
    # (ops/ln_qkv.py); needs the fused attention and ln_impl != "fused"
    blocks_impl: str = "loop"  # "loop" | "scan" | "stacked" (module docstring)

    @property
    def grid_size(self) -> Tuple[int, int]:
        """(F_grid, T_grid) of the patch-embedding output at the nominal size."""
        return (
            (self.input_fdim - self.patch_size[0]) // self.stride[0] + 1,
            (self.input_tdim - self.patch_size[1]) // self.stride[1] + 1,
        )

    @property
    def num_tokens(self) -> int:
        return 2 if self.distilled else 1

    @property
    def compute_dtype(self) -> torch.dtype:
        if self.dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, got {self.dtype!r}")
        return _DTYPES[self.dtype]

    @property
    def use_fused_attn(self) -> bool:
        """Resolve ``attn_impl``; "auto" is the kernel wherever CUDA is."""
        if self.attn_impl == "auto":
            return torch.cuda.is_available()
        if self.attn_impl not in ("fused", "xla"):
            raise ValueError(f"attn_impl must be 'auto'|'fused'|'xla', got {self.attn_impl!r}")
        return self.attn_impl == "fused"

    @property
    def use_fused_ln(self) -> bool:
        """Resolve ``ln_impl``; "auto" is the flax-order LayerNorm, as in
        the JAX package."""
        if self.ln_impl == "auto":
            return False
        if self.ln_impl not in ("fused", "xla"):
            raise ValueError(f"ln_impl must be 'auto'|'fused'|'xla', got {self.ln_impl!r}")
        return self.ln_impl == "fused"

    @property
    def gelu_approximate(self) -> bool:
        if self.gelu == "auto":
            return self.compute_dtype == torch.bfloat16
        if self.gelu not in ("erf", "tanh"):
            raise ValueError(f"gelu must be 'auto'|'erf'|'tanh', got {self.gelu!r}")
        return self.gelu == "tanh"

    @property
    def num_features(self) -> int:
        """Width of the features the head reads (the pre-logits width where
        that layer is on)."""
        if self.representation_size and not self.distilled:
            return self.representation_size
        return self.embed_dim

    @property
    def use_scan_blocks(self) -> bool:
        """Resolve ``blocks_impl`` and check its constraints, with the JAX
        package's messages: the stacked forms need one static config per
        block (no stochastic-depth decay), and "stacked" covers only what
        its hand-written backward honors. True for "scan"."""
        if self.blocks_impl not in ("loop", "scan", "stacked"):
            raise ValueError(f"blocks_impl must be 'loop'|'scan'|'stacked', got {self.blocks_impl!r}")
        if self.blocks_impl != "loop" and self.drop_path_rate > 0.0:
            raise NotImplementedError(
                f"blocks_impl={self.blocks_impl!r} requires drop_path_rate == 0 (per-block "
                "stochastic-depth rates need the unrolled 'loop' form)"
            )
        if self.blocks_impl == "stacked":
            if self.drop_rate > 0.0 or self.attn_drop_rate > 0.0:
                raise NotImplementedError(
                    "blocks_impl='stacked' requires drop_rate == attn_drop_rate == 0 (no dropout in "
                    "the hand-written stack backward; use 'loop')"
                )
            if not self.qkv_bias:
                raise NotImplementedError(
                    "blocks_impl='stacked' assumes qkv_bias=True (every published PaSST config; use 'loop' otherwise)"
                )
            if self.attn_impl == "xla":
                raise NotImplementedError(
                    "blocks_impl='stacked' always uses the flat Pallas attention (with its internal "
                    "fallback); attn_impl='xla' is not honored — use 'loop' to A/B attention"
                )
            if not self.softmax_fp32:
                raise NotImplementedError(
                    "blocks_impl='stacked' computes fp32 attention softmax unconditionally; "
                    "softmax_fp32=False is not honored — use 'loop'"
                )
            if self.remat:
                raise NotImplementedError(
                    "blocks_impl='stacked' has a hand-written backward; remat is not honored — use 'loop' or 'scan'"
                )
            if self.fuse_ln_qkv:
                raise NotImplementedError(
                    "blocks_impl='stacked' ignores fuse_ln_qkv (its own fused norms are hand-written); "
                    "A/B fuse_ln_qkv under 'loop'"
                )
            if self.use_fused_ln:
                raise NotImplementedError("blocks_impl='stacked' ignores ln_impl='fused' for block norms — use 'loop'")
        if self.fuse_ln_qkv:
            if self.use_fused_ln:
                raise NotImplementedError(
                    "fuse_ln_qkv absorbs norm1 into the attention boundary and cannot combine with ln_impl='fused'"
                )
            if self.attn_impl == "xla":
                raise NotImplementedError(
                    "fuse_ln_qkv requires the fused attention kernel; attn_impl='xla' contradicts it"
                )
        return self.blocks_impl == "scan"

    def seq_len(self, train: bool, f_grid: Optional[int] = None, t_grid: Optional[int] = None) -> int:
        """Transformer sequence length (incl. CLS/DIST tokens)."""
        f = self.grid_size[0] if f_grid is None else f_grid
        t = self.grid_size[1] if t_grid is None else t_grid
        if train:
            f = f - self.s_patchout_f
            t = t - self.s_patchout_t
            return f * t - self.u_patchout + self.num_tokens
        return f * t + self.num_tokens


def _check_supported(cfg: PaSSTConfig) -> None:
    cfg.use_scan_blocks  # blocks_impl and its constraints
    if cfg.patch_embed_impl not in ("unfold", "conv"):
        raise ValueError(f"patch_embed_impl must be 'unfold'|'conv', got {cfg.patch_embed_impl!r}")


class Linear(nn.Linear):
    """``nn.Linear`` with flax ``nn.Dense`` numerics: the fp32 weight is cast
    to the input's dtype, the product is rounded to that dtype, then the
    (cast) bias is added."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(x, self.weight.to(x.dtype))
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` with flax ``nn.LayerNorm(dtype=float32)`` numerics:
    fp32 compute and output, fast variance clamped at 0."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mean * mean, min=0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (xf - mean) * mul + self.bias


class FusedLayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` with the JAX ``FusedLayerNorm`` numerics: fp32
    compute and output, fast variance clamped at 0, ``((xf - mu) * rstd) *
    weight + bias``; its backward is the Hopper kernel
    (``ops/layernorm.py``). The same ``weight``/``bias`` as
    :class:`LayerNorm`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps)


def _ln(fused: bool, dim: int, eps: float = 1e-6) -> nn.LayerNorm:
    """The LayerNorm implementation (the same parameters either way)."""
    return (FusedLayerNorm if fused else LayerNorm)(dim, eps=eps)


def _inline_ln(x: torch.Tensor, ln: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """norm1 applied inside the attention where the fused path does not
    fit: the JAX order ``((xf - mu) * rstd) * s + b``, cast to x's dtype."""
    xf = x.float()
    mu, rstd = ln_stats(xf, 1e-6)
    return ((xf - mu) * rstd * ln[0] + ln[1]).to(x.dtype)


class PatchEmbed(nn.Module):
    """Strided patch embedding; ``proj`` is an ``nn.Conv2d`` (OIHW weight).

    The product runs as im2col plus one fp32 matmul of the inputs rounded to
    the compute dtype (the JAX package's fp32 accumulation), so it does not
    go through cuDNN's TF32 convolution. Output ``[B, D, F', T']``.
    """

    def __init__(self, embed_dim: int, patch_size, stride, in_chans: int):
        super().__init__()
        self.patch_size = tuple(patch_size)
        self.stride = tuple(stride)
        self.proj = nn.Conv2d(in_chans, embed_dim, kernel_size=self.patch_size, stride=self.stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype
        b, _, f, t = x.shape
        fg = (f - self.patch_size[0]) // self.stride[0] + 1
        tg = (t - self.patch_size[1]) // self.stride[1] + 1
        cols = F.unfold(x.float(), self.patch_size, stride=self.stride)  # [B, C*ph*pw, L]
        w = self.proj.weight.to(dtype).float().reshape(self.proj.out_channels, -1)
        out = torch.matmul(w, cols) + self.proj.bias[:, None]
        return out.reshape(b, -1, fg, tg).to(dtype)


Rows = Optional[Tuple[int, int]]  # (first row, global batch): data parallelism


class _DrawTape:
    """The draws of one recomputed block: its forward records them and its
    recompute in the backward replays them, so remat draws no new mask
    (``torch.utils.checkpoint`` restores only the default generators, and
    the blocks draw from named ones)."""

    def __init__(self):
        self.draws: List[torch.Tensor] = []
        self.replay_at: Optional[int] = None  # None while recording

    @contextlib.contextmanager
    def active(self, replay: bool):
        self.replay_at = 0 if replay else None
        _TAPES.append(self)
        try:
            yield
        finally:
            _TAPES.pop()


_TAPES: List[_DrawTape] = []  # the tapes of the blocks being run, innermost last


def batch_rand(shape, generator: torch.Generator, device, rows: Rows = None) -> torch.Tensor:
    """U[0, 1) of ``shape`` (batch first). ``rows=(start, total)``: the batch
    is rows ``start ..`` of a global batch of ``total``, so the draw is made
    at the global batch and these rows are kept (every rank draws alike).
    Inside a recomputed block the draw is recorded, and replayed by the
    recompute (:class:`_DrawTape`)."""
    tape = _TAPES[-1] if _TAPES else None
    if tape is not None and tape.replay_at is not None:
        tape.replay_at += 1
        return tape.draws[tape.replay_at - 1]
    if rows is None:
        out = torch.rand(shape, generator=generator, device=device)
    else:
        start, total = rows
        out = torch.rand((total,) + tuple(shape[1:]), generator=generator, device=device)[start: start + shape[0]]
    if tape is not None:
        tape.draws.append(out)
    return out


def remat(fn, *args):
    """``fn(*args)`` recomputed in the backward instead of saving its
    activations (the JAX package's ``nn.remat``): non-reentrant
    ``torch.utils.checkpoint`` with the block's draws taped. Without grad
    mode it is ``fn(*args)``."""
    if not torch.is_grad_enabled():
        return fn(*args)
    tape = _DrawTape()
    return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                      context_fn=lambda: (tape.active(replay=False), tape.active(replay=True)))


def drop_path(x: torch.Tensor, rate: float, generator: torch.Generator, rows: Rows = None) -> torch.Tensor:
    """Stochastic depth on the batch axis: a whole sample's branch is kept
    with probability ``1 - rate`` and scaled by its inverse."""
    keep = 1.0 - rate
    mask = batch_rand((x.shape[0],) + (1,) * (x.ndim - 1), generator, x.device, rows) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def dropout(x: torch.Tensor, rate: float, generator: Optional[torch.Generator], rows: Rows = None,
            split: Optional[Tuple[int, int, int]] = None) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability ``1 - rate``, scale by its
    inverse; the identity at rate 0 (no generator needed then).
    ``split=(axis, start, full)``: ``x`` is a tensor-parallel rank's share
    ``start ..`` of a tensor ``full`` long on ``axis``, so the mask is drawn
    for the full tensor and this share kept."""
    if rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training draws from the 'dropout' generator; pass one")
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    if split is None:
        mask = batch_rand(x.shape, generator, x.device, rows) < keep
    else:
        axis, start, full = split
        shape = x.shape[:axis] + (full,) + x.shape[axis + 1:]
        mask = batch_rand(shape, generator, x.device, rows).narrow(axis, start, x.shape[axis]) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def _sorted_keep_indices(generator: torch.Generator, size: int, keep: int) -> torch.Tensor:
    """A sorted random subset of ``keep`` indices out of ``size``, on the
    generator's device: the patchout selection (``randperm[:keep].sort()``)."""
    perm = torch.randperm(size, generator=generator, device=generator.device)
    return torch.sort(perm[:keep]).values


Generators = Dict[str, torch.Generator]


def _stream(generators: Generators, name: str) -> torch.Generator:
    """The named generator of a training forward; a missing one raises."""
    if name not in generators:
        raise ValueError(f"train=True draws from the {name!r} generator; pass generators={{{name!r}: ...}}")
    return generators[name]


class Attention(nn.Module):
    """Fused-qkv multi-head self-attention (JAX ``Attention``).

    ``fused``: the Hopper kernels through the same entry the JAX package
    takes at this geometry (the qkv entry where its gate holds, with the
    backward's rule in training, else ``[B, N, H, D]`` views of the qkv
    output), except in training with attention dropout; otherwise the
    einsum composition of the JAX package's "xla" path.
    """

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool, softmax_fp32: bool,
                 plus1: bool, fused: bool, attn_drop: float = 0.0, proj_drop: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.softmax_fp32 = softmax_fp32
        self.plus1 = plus1
        self.fused = fused
        self.attn_drop = attn_drop
        self.proj_drop = proj_drop
        self.qkv = Linear(dim, dim * 3, bias=qkv_bias)
        self.proj = Linear(dim, dim)

    def forward(self, x: torch.Tensor, train: bool = False, generators: Optional[Generators] = None,
                ln: Optional[Tuple[torch.Tensor, torch.Tensor]] = None, rows: Rows = None,
                tp=None) -> torch.Tensor:
        """``ln=(scale, bias)``: x arrives before norm1, which is fused into
        the qkv projection and attention (``fused_ln_qkv_attention``) where
        the JAX gate holds, else applied inline. ``tp`` (a
        :class:`~passt_tpu_torch.parallel.mesh.TensorParallel`): the qkv and
        proj weights are this rank's heads' share."""
        b, n, c = x.shape
        head_dim = c // self.num_heads
        heads = self.num_heads if tp is None else tp.local(self.num_heads, "num_heads")
        scale = head_dim ** -0.5
        drop_gen = (generators or {}).get("dropout")
        proj_drop = self.proj_drop if train else 0.0
        if tp is not None:
            # the fused entry takes the whole qkv weight; under tp norm1
            # runs inline before the copy, so its gradient is summed over
            # the model group with x's
            if ln is not None:
                x, ln = _inline_ln(x, ln), None
            x = tp.copy(x)
        fused_ok = self.fused and not (train and self.attn_drop > 0.0)
        # the gates' batch bound is a TPU VMEM limit; a symbolic batch
        # (torch.export) skips it rather than tie the program to one side of
        # it (on the card both entries launch the same kernel, to the bit)
        gate_batch = b if isinstance(b, int) else None
        if ln is not None:
            if fused_ok and ln_qkv_supports(n, heads, head_dim, backward=train,
                                            itemsize=x.element_size(), batch=gate_batch):
                qkv_bias = self.qkv.bias if self.qkv.bias is not None else x.new_zeros(3 * heads * head_dim)
                out = fused_ln_qkv_attention(x, ln[0], ln[1], self.qkv.weight, qkv_bias, heads=heads,
                                             head_dim=head_dim, scale=scale, plus1=self.plus1)
                return dropout(self._proj(out, tp), proj_drop, drop_gen, rows)
            x = _inline_ln(x, ln)
        qkv = self.qkv(x)
        if fused_ok:
            if flat_kernel_supports(n, heads, head_dim, backward=train,
                                    itemsize=x.element_size(), batch=gate_batch):
                out = fused_attention_qkv(qkv, heads=heads, head_dim=head_dim,
                                          scale=scale, plus1=self.plus1)
            else:
                q, k, v = qkv.reshape(b, n, 3, heads, head_dim).unbind(2)
                out = fused_attention(q, k, v, scale=scale, plus1=self.plus1).reshape(b, n, heads * head_dim)
            return dropout(self._proj(out, tp), proj_drop, drop_gen, rows)

        q, k, v = qkv.reshape(b, n, 3, heads, head_dim).unbind(2)
        attn = torch.einsum("bnhd,bmhd->bhnm", q, k) * scale
        if self.plus1:
            attn = torch.cat([attn, attn.new_zeros(attn.shape[:-1] + (1,))], dim=-1)
        if self.softmax_fp32:
            attn = torch.softmax(attn.float(), dim=-1).to(x.dtype)
        else:
            attn = torch.softmax(attn, dim=-1)
        if self.plus1:
            attn = attn[..., :-1]
        split = None if tp is None else (1, tp.rank * heads, self.num_heads)
        attn = dropout(attn, self.attn_drop if train else 0.0, drop_gen, rows, split)
        out = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(b, n, heads * head_dim)
        return dropout(self._proj(out, tp), proj_drop, drop_gen, rows)

    def _proj(self, out: torch.Tensor, tp) -> torch.Tensor:
        """The output projection; under ``tp`` the share's partial product,
        all-reduced, then the bias once."""
        if tp is None:
            return self.proj(out)
        y = tp.reduce(F.linear(out, self.proj.weight.to(out.dtype)))
        return y + self.proj.bias.to(y.dtype)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int, gelu_approximate: bool, gelu_saved_deriv: bool = True,
                 drop: float = 0.0):
        super().__init__()
        self.gelu_approximate = gelu_approximate
        self.gelu_saved_deriv = gelu_saved_deriv
        self.drop = drop
        self.fc1 = Linear(dim, hidden)
        self.fc2 = Linear(hidden, dim)

    def forward(self, x: torch.Tensor, train: bool = False, generators: Optional[Generators] = None,
                rows: Rows = None, tp=None) -> torch.Tensor:
        """``tp``: fc1 and fc2 hold this rank's share of the hidden units."""
        drop = self.drop if train else 0.0
        gen = (generators or {}).get("dropout")
        if tp is not None:
            x = tp.copy(x)
        h = self.fc1(x)
        if self.gelu_approximate and self.gelu_saved_deriv:
            h = tanh_gelu(h)
        else:
            approximate = "tanh" if self.gelu_approximate else "none"
            h = F.gelu(h.float(), approximate=approximate).to(h.dtype)
        if tp is None:
            h = dropout(h, drop, gen, rows)
            return dropout(self.fc2(h), drop, gen, rows)
        hidden = h.shape[-1]
        h = dropout(h, drop, gen, rows, (h.ndim - 1, tp.rank * hidden, hidden * tp.size))
        y = tp.reduce(F.linear(h, self.fc2.weight.to(h.dtype)))
        return dropout(y + self.fc2.bias.to(y.dtype), drop, gen, rows)


class Block(nn.Module):
    """Pre-norm transformer block; the residual stream stays in the compute
    dtype, the norms output fp32 and are cast before attn/MLP."""

    def __init__(self, cfg: PaSSTConfig, drop_path_rate: float = 0.0):
        super().__init__()
        d = cfg.embed_dim
        self.drop_path_rate = drop_path_rate
        # norm1 inside the attention boundary, as the JAX package decides it
        self.ln_in_attn = cfg.fuse_ln_qkv and cfg.use_fused_attn and not cfg.use_fused_ln
        self.norm1 = _ln(cfg.use_fused_ln, d)
        self.attn = Attention(d, cfg.num_heads, cfg.qkv_bias, cfg.softmax_fp32,
                              cfg.plus1_attn, cfg.use_fused_attn,
                              attn_drop=cfg.attn_drop_rate, proj_drop=cfg.drop_rate)
        self.norm2 = _ln(cfg.use_fused_ln, d)
        self.mlp = Mlp(d, int(d * cfg.mlp_ratio), cfg.gelu_approximate, cfg.gelu_saved_deriv,
                       drop=cfg.drop_rate)

    def forward(self, x: torch.Tensor, train: bool = False, generators: Optional[Generators] = None,
                rows: Rows = None, tp=None) -> torch.Tensor:
        def branch(h):
            if train and self.drop_path_rate > 0.0:
                return drop_path(h, self.drop_path_rate, _stream(generators or {}, "droppath"), rows)
            return h

        if self.ln_in_attn:
            h = self.attn(x, train, generators, ln=(self.norm1.weight, self.norm1.bias), rows=rows, tp=tp)
        else:
            h = self.attn(self.norm1(x).to(x.dtype), train, generators, rows=rows, tp=tp)
        x = x + branch(h)
        return x + branch(self.mlp(self.norm2(x).to(x.dtype), train, generators, rows, tp))


def _tensors_in_use(module: nn.Module) -> Dict[str, torch.Tensor]:
    """The module's parameter tensors as its forward reads them now (those a
    ``functional_call`` put in, where one is running)."""
    out = {}
    for name, _ in module.named_parameters():
        owner = module
        *path, leaf = name.split(".")
        for part in path:
            owner = getattr(owner, part)
        out[name] = getattr(owner, leaf)
    return out


def remat_module(module: nn.Module, x: torch.Tensor, *args):
    """:func:`remat` of ``module(x, *args)``. The parameters in use go in
    as inputs, so the recompute, which runs in the backward after a
    ``functional_call`` has put the module's own tensors back, reads the
    forward's."""
    params = _tensors_in_use(module)

    def run(x, *tensors):
        return functional_call(module, dict(zip(params, tensors)), (x,) + args)

    return remat(run, x, *params.values())


class _Stacked(nn.Module):
    """``weight`` (and ``bias``) of one block layer, stacked ``[depth, ...]``."""

    def __init__(self, depth: int, weight_shape, bias_shape=None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(depth, *weight_shape))
        self.bias = nn.Parameter(torch.zeros(depth, *bias_shape)) if bias_shape else None


class StackedBlocks(nn.Module):
    """The depth over stacked ``[depth, ...]`` leaves at ``block.*`` (names
    as :class:`Block`'s, torch orientation: Linear weights ``[depth, out,
    in]``). "scan": the loop's :class:`Block` on each layer's slice (taken
    with ``unbind``, whose backward stacks the layer gradients once);
    "stacked": ``stacked_blocks_apply``."""

    def __init__(self, cfg: PaSSTConfig):
        super().__init__()
        self.cfg = cfg
        d, depth = cfg.embed_dim, cfg.depth
        hidden = int(d * cfg.mlp_ratio)
        self.block = nn.Module()
        blk = self.block
        blk.norm1 = _Stacked(depth, (d,), (d,))
        blk.attn = nn.Module()
        blk.attn.qkv = _Stacked(depth, (3 * d, d), (3 * d,) if cfg.qkv_bias else None)
        blk.attn.proj = _Stacked(depth, (d, d), (d,))
        blk.norm2 = _Stacked(depth, (d,), (d,))
        blk.mlp = nn.Module()
        blk.mlp.fc1 = _Stacked(depth, (hidden, d), (hidden,))
        blk.mlp.fc2 = _Stacked(depth, (d, hidden), (d,))
        if cfg.blocks_impl == "scan":
            # the one Block the scan applies; its own parameters are never
            # read (meta tensors, outside the module tree)
            with torch.device("meta"):
                object.__setattr__(self, "_step", Block(cfg))

    def forward(self, x: torch.Tensor, train: bool = False, generators: Optional[Generators] = None,
                rows: Rows = None, tp=None) -> torch.Tensor:
        cfg = self.cfg
        leaves = _tensors_in_use(self.block)  # by block parameter name
        if cfg.blocks_impl == "stacked":
            from passt_tpu_torch.models.stacked_blocks import stacked_blocks_apply

            return stacked_blocks_apply(leaves, x, cfg.num_heads, cfg.plus1_attn,
                                        (cfg.embed_dim // cfg.num_heads) ** -0.5, cfg.gelu_approximate, train, tp)
        names = list(leaves)
        slices = [t.unbind(0) for t in leaves.values()]

        def step(x, *layer):
            return functional_call(self._step, dict(zip(names, layer)), (x, train, generators, rows, tp))

        for layer in zip(*slices):
            x = remat(step, x, *layer) if cfg.remat else step(x, *layer)
        return x


class PaSST(nn.Module):
    """Input ``[B, C, F, T]`` spectrogram; returns ``(logits [B, num_classes],
    features [B, D])`` like the reference forward."""

    def __init__(self, cfg: PaSSTConfig):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        d = cfg.embed_dim
        f_grid, t_grid = cfg.grid_size
        self.patch_embed = PatchEmbed(d, cfg.patch_size, cfg.stride, cfg.in_chans)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, d))
        self.dist_token = nn.Parameter(torch.zeros(1, 1, d)) if cfg.distilled else None
        self.new_pos_embed = nn.Parameter(torch.zeros(1, cfg.num_tokens, d))
        self.freq_new_pos_embed = nn.Parameter(torch.zeros(1, d, f_grid, 1))
        self.time_new_pos_embed = nn.Parameter(torch.zeros(1, d, 1, t_grid))
        # the stochastic-depth decay rule: rates rise linearly over the blocks
        if cfg.blocks_impl == "loop":
            dpr = np.linspace(0.0, cfg.drop_path_rate, cfg.depth)
            self.blocks = nn.ModuleList(Block(cfg, float(dpr[i])) for i in range(cfg.depth))
        else:
            self.blocks = StackedBlocks(cfg)
        self.norm = _ln(cfg.use_fused_ln, d)
        if cfg.num_features != d:
            # the pre-logits layer (reference passt.py:452-458)
            self.pre_logits = nn.Module()
            self.pre_logits.fc = Linear(d, cfg.num_features)
        self.head = nn.Sequential(LayerNorm(cfg.num_features, eps=1e-5), Linear(cfg.num_features, cfg.num_classes))
        # in checkpoints, unused by the reference forward
        self.head_dist = Linear(d, cfg.num_classes) if cfg.distilled else None

    def forward(self, x: torch.Tensor, train: bool = False, generators: Optional[Generators] = None,
                rows: Rows = None, tp=None):
        """``generators``: the "patchout", "dropout" and "droppath" streams
        a training forward draws from (each only where it draws).
        ``rows=(start, total)``: ``x`` is rows ``start ..`` of a global batch
        of ``total`` (data parallelism): the per-example draws (dropout,
        drop-path) are made at the global batch and these rows kept.
        ``tp`` (a :class:`~passt_tpu_torch.parallel.mesh.TensorParallel`):
        the block parameters are this model rank's share."""
        cfg = self.cfg
        dtype = cfg.compute_dtype
        b = x.shape[0]
        f_grid, t_grid = cfg.grid_size
        generators = generators or {}

        if cfg.verbose_shapes:
            print(f" input: {tuple(x.shape)}")
        x = self.patch_embed(x.to(dtype))  # [B, D, F', T']
        _, _, f_cur, t_cur = x.shape
        # a window of the time embedding for shorter inputs (a prefix in
        # eval, a random offset in training); longer inputs are cropped
        if t_cur < t_grid:
            if train:
                g = _stream(generators, "patchout")
                offset = torch.randint(0, t_grid - t_cur + 1, (), generator=g, device=g.device)
                idx = offset.to(x.device) + torch.arange(t_cur, device=x.device)
                tpe = self.time_new_pos_embed.index_select(3, idx)
            else:
                tpe = self.time_new_pos_embed[:, :, :, :t_cur]
        else:
            x = x[:, :, :, :t_grid]
            t_cur = t_grid
            tpe = self.time_new_pos_embed
        x = x + tpe.to(dtype)
        if f_cur != f_grid:
            raise ValueError(f"input frequency grid {f_cur} != positional embedding grid {f_grid}")
        x = x + self.freq_new_pos_embed.to(dtype)

        # structured patchout: whole time columns, then whole frequency rows
        if train and cfg.s_patchout_t:
            keep = _sorted_keep_indices(_stream(generators, "patchout"), t_cur, t_cur - cfg.s_patchout_t)
            x = x.index_select(3, keep.to(x.device))
            t_cur -= cfg.s_patchout_t
        if train and cfg.s_patchout_f:
            keep = _sorted_keep_indices(_stream(generators, "patchout"), f_cur, f_cur - cfg.s_patchout_f)
            x = x.index_select(2, keep.to(x.device))
            f_cur -= cfg.s_patchout_f
        x = x.flatten(2).transpose(1, 2)  # [B, F'*T', D], frequency-major
        if train and cfg.u_patchout:
            seq = x.shape[1]
            keep = _sorted_keep_indices(_stream(generators, "patchout"), seq, seq - cfg.u_patchout)
            x = x.index_select(1, keep.to(x.device))

        tokens = [(self.cls_token + self.new_pos_embed[:, :1]).to(dtype).expand(b, -1, -1)]
        if cfg.distilled:
            tokens.append((self.dist_token + self.new_pos_embed[:, 1:]).to(dtype).expand(b, -1, -1))
        x = torch.cat(tokens + [x], dim=1)
        if cfg.verbose_shapes:
            print(f" final sequence: {tuple(x.shape)}")
        if train:
            x = dropout(x, cfg.drop_rate, generators.get("dropout"), rows)

        if cfg.blocks_impl != "loop":
            x = self.blocks(x, train, generators, rows, tp)
        else:
            for block in self.blocks:
                if cfg.remat:
                    x = remat_module(block, x, train, generators, rows, tp)
                else:
                    x = block(x, train, generators, rows, tp)
        x = self.norm(x)  # fp32

        features = (x[:, 0] + x[:, 1]) / 2.0 if cfg.distilled else x[:, 0]
        if cfg.num_features != cfg.embed_dim:
            features = torch.tanh(self.pre_logits.fc(features))
        logits = self.head(features)
        return logits, features


@torch.no_grad()
def init_weights(model: PaSST, generator: torch.Generator) -> PaSST:
    """Seeded random init with the JAX package's initialisers: N(0, 0.02)
    for tokens, position embeddings and Dense weights (the reference's
    truncation at +-2 is +-100 sigma), zero biases, unit LayerNorm scales,
    and PyTorch's Conv2d default for the patch embedding. Draws on the CPU
    from ``generator`` (a CPU generator), so the same seed gives the same
    weights on any device."""

    def normal_(p):
        p.copy_(torch.empty(p.shape).normal_(0.0, 0.02, generator=generator).clamp_(-2.0, 2.0))

    def uniform_(p, bound):
        p.copy_(torch.empty(p.shape).uniform_(-bound, bound, generator=generator))

    conv = model.patch_embed.proj.weight
    conv_bound = (conv.shape[1] * conv.shape[2] * conv.shape[3]) ** -0.5
    for name, p in model.named_parameters():
        if name.startswith("patch_embed.proj."):
            uniform_(p, conv_bound)
        elif name.endswith("norm1.weight") or name.endswith("norm2.weight") or name in (
            "norm.weight", "head.0.weight",
        ):
            p.fill_(1.0)
        elif name.endswith(".bias"):
            p.zero_()
        else:
            normal_(p)
    return model
