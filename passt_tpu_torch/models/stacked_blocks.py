"""The block stack over stacked ``[depth, ...]`` leaves with a hand-written
backward whose weight gradients are four batched products (port of
passt_tpu/models/stacked_blocks.py).

Autograd emits each block's weight-gradient products inside the sequential
dx chain. :class:`_StackedBlocks` writes the stack's backward itself:

- forward: the depth unrolled over ``w[l]`` slices of the stacked leaves,
  in the block's math (pre-norm, fp32 fast-variance LayerNorm, Dense
  products rounded before the bias, the attention kernels, GELU with its
  derivative saved), keeping the residuals of every block stacked
  ``[depth, ...]`` (``x, mu1, rstd1, xn1, qkv, a, x2, mu2, rstd2, xn2, g,
  gp``);
- backward, first pass: the dx chain alone, and each block's cotangents
  at the four Dense outputs (``dqkv, dh, du, dv``), the attention through
  the flat backward kernel (``fused_attention_qkv_bwd``);
- backward, second pass: the four weight-gradient families as batched
  products over the stacked activations and cotangents, each with an fp32
  result cast once to its weight's dtype; bias and LayerNorm gradients are
  fp32 sums.

Under tensor parallelism (``tp``) the leaves are a model rank's share
(``parallel/mesh.py``): the attention runs this rank's heads, and the
proj and fc2 partial products are all-reduced before their bias in the
forward, as are the norm inputs' partial cotangents (``dxn1``, ``dxn2``)
in the backward.

The stacked leaves then meet the optimizer as single leaves. Dropout,
drop-path and attention dropout are 0 here (the model's ``blocks_impl``
check). Without a gradient (eval, serving, ``torch.export``) the forward
runs unrolled outside the Function and saves nothing.

Leaves are keyed by the :class:`~passt_tpu_torch.models.passt.Block`
parameter names (``norm1.weight``, ``attn.qkv.weight`` ``[depth, 3C, C]``,
...), torch orientation: a Linear weight is ``[depth, out, in]``.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from passt_tpu_torch.ops.attention import (
    flat_kernel_supports,
    fused_attention,
    fused_attention_qkv,
    fused_attention_qkv_bwd,
)
from passt_tpu_torch.ops.ln_qkv import ln_stats

_C = math.sqrt(2.0 / math.pi)
_A = 0.044715

#: the Function's leaves, in the order it takes them
LEAVES = (
    "norm1.weight", "norm1.bias", "attn.qkv.weight", "attn.qkv.bias", "attn.proj.weight", "attn.proj.bias",
    "norm2.weight", "norm2.bias", "mlp.fc1.weight", "mlp.fc1.bias", "mlp.fc2.weight", "mlp.fc2.bias",
)
#: the residual families the forward saves, stacked
RESIDUALS = ("x", "mu1", "rstd1", "xn1", "qkv", "a", "x2", "mu2", "rstd2", "xn2", "g", "gp")


def stacked_param_shapes(depth: int, c: int, mlp_hidden: int) -> Dict[str, Tuple[int, ...]]:
    """The stacked leaves' shapes by name (torch orientation)."""
    return {
        "norm1.weight": (depth, c), "norm1.bias": (depth, c),
        "attn.qkv.weight": (depth, 3 * c, c), "attn.qkv.bias": (depth, 3 * c),
        "attn.proj.weight": (depth, c, c), "attn.proj.bias": (depth, c),
        "norm2.weight": (depth, c), "norm2.bias": (depth, c),
        "mlp.fc1.weight": (depth, mlp_hidden, c), "mlp.fc1.bias": (depth, mlp_hidden),
        "mlp.fc2.weight": (depth, c, mlp_hidden), "mlp.fc2.bias": (depth, c),
    }


def _ln_fwd(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6):
    """fp32 fast-variance LayerNorm in the JAX stack's order
    ``((xf - mu) * rstd) * scale + bias``; returns (xn fp32, mu, rstd)."""
    xf = x.float()
    mu, rstd = ln_stats(xf, eps)
    return (xf - mu) * rstd * scale.float() + bias.float(), mu, rstd


def _ln_bwd(x, mu, rstd, scale, dxn):
    """One block's LayerNorm backward from its input and statistics: fp32
    ``dxn`` -> (dx, dscale [C], dbias [C]), all fp32."""
    xhat = (x.float() - mu) * rstd
    dscale = (dxn * xhat).sum(dim=(0, 1))
    dbias = dxn.sum(dim=(0, 1))
    dxhat = dxn * scale.float()
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    return rstd * (dxhat - m1 - xhat * m2), dscale, dbias


def _gelu_fwd(u: torch.Tensor, approximate: bool, derivative: bool = True):
    """GELU and (with ``derivative``; else None) its derivative, each
    computed in fp32 and rounded once to ``u``'s dtype: the tanh form, or
    the erf form (derivative ``Phi(u) + u phi(u)``)."""
    uf = u.float()
    if approximate:
        t = torch.tanh(_C * (uf + _A * uf * uf * uf))
        g = (0.5 * uf * (1.0 + t)).to(u.dtype)
        if not derivative:
            return g, None
        gp = 0.5 * (1.0 + t) + 0.5 * uf * (1.0 - t * t) * _C * (1.0 + 3.0 * _A * uf * uf)
        return g, gp.to(u.dtype)
    cdf = 0.5 * (1.0 + torch.erf(uf * (1.0 / math.sqrt(2.0))))
    if not derivative:
        return (uf * cdf).to(u.dtype), None
    pdf = torch.exp(-0.5 * uf * uf) * (1.0 / math.sqrt(2.0 * math.pi))
    return (uf * cdf).to(u.dtype), (cdf + uf * pdf).to(u.dtype)


def _dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, tp=None) -> torch.Tensor:
    """flax ``nn.Dense`` at x's dtype: the product rounded, then the bias;
    with ``tp`` (a row-split weight) the partial products all-reduced
    before the bias."""
    y = F.linear(x, weight.to(x.dtype))
    if tp is not None:
        y = tp.all_reduce(y)
    return y + bias.to(x.dtype)


def _attn_fwd(qkv: torch.Tensor, heads: int, head_dim: int, scale: float, plus1: bool, train: bool) -> torch.Tensor:
    """The attention forward with the module path's choice: the qkv entry
    where its gate holds (``backward=train``, the batch bound in eval),
    else the ``[B, N, H, D]`` entry (both the kernel on the card, their
    plain versions on a CPU tensor)."""
    b, n, _ = qkv.shape
    gate_batch = b if isinstance(b, int) else None
    if flat_kernel_supports(n, heads, head_dim, backward=train, itemsize=qkv.element_size(), batch=gate_batch):
        return fused_attention_qkv(qkv, heads=heads, head_dim=head_dim, scale=scale, plus1=plus1)
    q, k, v = qkv.reshape(b, n, 3, heads, head_dim).unbind(2)
    return fused_attention(q, k, v, scale=scale, plus1=plus1).reshape(b, n, heads * head_dim)


def _block_fwd(p: Dict[str, torch.Tensor], x: torch.Tensor, heads: int, plus1: bool, scale: float,
               gelu_approximate: bool, train: bool, tp=None, save: bool = True):
    """One block (``heads``: this rank's); returns (out, its residuals by
    :data:`RESIDUALS` name; without ``save`` the GELU derivative is not
    computed)."""
    head_dim = p["attn.qkv.weight"].shape[0] // (3 * heads)
    xn1_f, mu1, rstd1 = _ln_fwd(x, p["norm1.weight"], p["norm1.bias"])
    xn1 = xn1_f.to(x.dtype)
    qkv = _dense(xn1, p["attn.qkv.weight"], p["attn.qkv.bias"])
    a = _attn_fwd(qkv, heads, head_dim, scale, plus1, train)
    x2 = x + _dense(a, p["attn.proj.weight"], p["attn.proj.bias"], tp)
    xn2_f, mu2, rstd2 = _ln_fwd(x2, p["norm2.weight"], p["norm2.bias"])
    xn2 = xn2_f.to(x.dtype)
    u = _dense(xn2, p["mlp.fc1.weight"], p["mlp.fc1.bias"])
    g, gp = _gelu_fwd(u, gelu_approximate, derivative=save)
    out = x2 + _dense(g, p["mlp.fc2.weight"], p["mlp.fc2.bias"], tp)
    return out, dict(x=x, mu1=mu1, rstd1=rstd1, xn1=xn1, qkv=qkv, a=a, x2=x2, mu2=mu2, rstd2=rstd2,
                     xn2=xn2, g=g, gp=gp)


def _forward(leaves: Dict[str, torch.Tensor], x: torch.Tensor, heads, plus1, scale, gelu_approximate, train,
             tp, save: bool):
    depth = leaves["norm1.weight"].shape[0]
    layers = [dict(zip(leaves, ws)) for ws in zip(*(t.unbind(0) for t in leaves.values()))]
    saved = []
    for l in range(depth):
        x, res = _block_fwd(layers[l], x, heads, plus1, scale, gelu_approximate, train, tp, save)
        if save:
            saved.append(res)
    if not save:
        return x, None
    return x, {k: torch.stack([r[k] for r in saved]) for k in RESIDUALS}


def _bdw(acts: torch.Tensor, cots: torch.Tensor) -> torch.Tensor:
    """The batched weight gradient ``[depth, out, in]`` of ``[depth, B, N,
    in]`` activations and ``[depth, B, N, out]`` cotangents, summed over
    (B, N) with an fp32 result (half-precision products are exact in fp32;
    a half-precision result would round them)."""
    d = acts.shape[0]
    a = acts.reshape(d, -1, acts.shape[-1])
    c = cots.reshape(d, -1, cots.shape[-1]).transpose(1, 2)
    if a.dtype == torch.float32:
        return torch.bmm(c, a)
    if a.device.type == "cuda":  # cuBLAS: half-precision operands, an fp32 result
        return torch.bmm(c, a, out_dtype=torch.float32)
    return torch.bmm(c.float(), a.float())  # the CPU has no such product: the same sums


class _StackedBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, heads, plus1, scale, gelu_approximate, train, tp, *weights):
        leaves = dict(zip(LEAVES, weights))
        y, res = _forward(leaves, x, heads, plus1, scale, gelu_approximate, train, tp, save=True)
        ctx.save_for_backward(*weights, *(res[k] for k in RESIDUALS))
        ctx.args = (heads, plus1, scale, tp)
        return y

    @staticmethod
    def backward(ctx, dy):
        heads, plus1, scale, tp = ctx.args
        saved = ctx.saved_tensors
        w = dict(zip(LEAVES, saved[: len(LEAVES)]))
        r = dict(zip(RESIDUALS, saved[len(LEAVES):]))
        depth = w["norm1.weight"].shape[0]
        head_dim = w["attn.qkv.weight"].shape[1] // (3 * heads)

        def reduce(t):  # a partial cotangent of a replicated input
            return t if tp is None else tp.all_reduce(t)

        dtype = dy.dtype
        wq, wp, w1, w2 = (w[k].to(dtype) for k in ("attn.qkv.weight", "attn.proj.weight",
                                                    "mlp.fc1.weight", "mlp.fc2.weight"))
        cot = {k: [None] * depth for k in ("dqkv", "dh", "du", "dv", "ds1", "db1", "ds2", "db2")}
        dx = dy
        for l in range(depth - 1, -1, -1):
            # the MLP branch: out = x2 + fc2(gelu(fc1(LN2(x2))))
            dv = dx
            dg = torch.matmul(dv, w2[l])
            du = (dg.float() * r["gp"][l].float()).to(dtype)
            dxn2 = reduce(torch.matmul(du, w1[l]))
            dx2_ln, ds2, db2 = _ln_bwd(r["x2"][l], r["mu2"][l], r["rstd2"][l], w["norm2.weight"][l], dxn2.float())
            dx2 = dx + dx2_ln.to(dtype)
            # the attention branch: x2 = x + proj(attn(qkv(LN1(x))))
            dh = dx2
            da = torch.matmul(dh, wp[l])
            dqkv = fused_attention_qkv_bwd(r["qkv"][l], da, heads=heads, head_dim=head_dim, scale=scale,
                                           plus1=plus1)
            dxn1 = reduce(torch.matmul(dqkv, wq[l]))
            dx_ln, ds1, db1 = _ln_bwd(r["x"][l], r["mu1"][l], r["rstd1"][l], w["norm1.weight"][l], dxn1.float())
            dx = dx2 + dx_ln.to(dtype)
            for k, v in zip(("dqkv", "dh", "du", "dv", "ds1", "db1", "ds2", "db2"),
                            (dqkv, dh, du, dv, ds1, db1, ds2, db2)):
                cot[k][l] = v
        st = {k: torch.stack(v) for k, v in cot.items()}

        def bias_grad(c):
            return c.float().sum(dim=(1, 2))

        grads = {
            "norm1.weight": st["ds1"], "norm1.bias": st["db1"],
            "attn.qkv.weight": _bdw(r["xn1"], st["dqkv"]), "attn.qkv.bias": bias_grad(st["dqkv"]),
            "attn.proj.weight": _bdw(r["a"], st["dh"]), "attn.proj.bias": bias_grad(st["dh"]),
            "norm2.weight": st["ds2"], "norm2.bias": st["db2"],
            "mlp.fc1.weight": _bdw(r["xn2"], st["du"]), "mlp.fc1.bias": bias_grad(st["du"]),
            "mlp.fc2.weight": _bdw(r["g"], st["dv"]), "mlp.fc2.bias": bias_grad(st["dv"]),
        }
        return (dx, None, None, None, None, None, None, *(grads[k].to(w[k].dtype) for k in LEAVES))


def stacked_blocks_apply(leaves: Dict[str, torch.Tensor], x: torch.Tensor, heads: int, plus1: bool, scale: float,
                         gelu_approximate: bool = True, train: bool = False, tp=None) -> torch.Tensor:
    """The pre-norm block stack over the stacked ``leaves`` (by
    :data:`LEAVES` name) on the residual stream ``x`` ``[B, N, C]`` in the
    compute dtype; ``heads`` is the model's, ``tp`` a model rank's share
    (module docstring). With a gradient to take, the hand-written backward;
    else the same forward unrolled, saving nothing."""
    weights = [leaves[k] for k in LEAVES]
    if tp is not None:
        heads = tp.local(heads, "num_heads")
    if torch.is_grad_enabled() and (x.requires_grad or any(t.requires_grad for t in weights)):
        return _StackedBlocks.apply(x, int(heads), bool(plus1), float(scale), bool(gelu_approximate),
                                    bool(train), tp, *weights)
    return _forward(leaves, x, heads, plus1, scale, gelu_approximate, train, tp, save=False)[0]
