"""The port's ``blocks_impl="stacked"`` (passt_tpu_torch.models.stacked_blocks)
against the JAX package's ``stacked_blocks_apply``, on the CPU.

The same stacked leaves (the JAX stacked init through the bridge) and the
same numpy inputs go through both stacks: the forward, and the backward of
one cotangent (the JAX ``custom_vjp`` with its Pallas flat attention
interpreted; the port's hand-written backward with the attention kernels'
plain versions). Bounds: fp32 1e-5 x max|ref| per leaf; bf16 the port's
bf16 bound, 2e-2 x max(1, max|ref|).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from passt_tpu.models.passt import PaSSTConfig as JaxConfig
from passt_tpu.models.passt import init_passt
from passt_tpu.models.stacked_blocks import stacked_blocks_apply as jax_stacked
from passt_tpu_torch.models import stacked_blocks
from passt_tpu_torch.models.passt import PaSST, PaSSTConfig
from passt_tpu_torch.models.pretrained import stack_block_params, state_dict_from_flax, unstack_block_params
from passt_tpu_torch.models.stacked_blocks import stacked_blocks_apply, stacked_param_shapes
from test_torch_train import _fp32_step_vs_jax, injected_draws  # noqa: F401  (a fixture)

SMALL = dict(input_fdim=64, input_tdim=50, embed_dim=192, depth=2, num_heads=3, num_classes=11)
HEADS, C, DEPTH = 3, 192, 2
BOUND = {"float32": 1e-5, "bfloat16": 2e-2}


@functools.lru_cache(maxsize=None)
def _jax_stacked(seed=0):
    """The JAX stacked tree (the scan model's, leaf for leaf: its init
    traces no Pallas kernel)."""
    _, params = init_passt(JaxConfig(**dict(SMALL, blocks_impl="scan", attn_impl="xla")),
                           jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, params)


def _close(got, ref, dtype, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = float(np.abs(ref).max())
    bound = BOUND[dtype] * (scale if dtype == "float32" else max(1.0, scale))
    err = float(np.abs(got - ref).max())
    assert err <= bound, f"{what}: {err} > {bound}"


def test_param_layout_is_the_jax_scan_layout():
    """The JAX stacked tree bridges to the port's stacked model leaf for
    leaf (``blocks.block.*``, Linear weights ``[depth, out, in]``), and
    unstacks to the loop model's names."""
    sd = state_dict_from_flax(_jax_stacked())
    model = PaSST(PaSSTConfig(**dict(SMALL, blocks_impl="stacked")))
    own = model.state_dict()
    assert set(sd) == set(own)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(own[k].shape), k
    shapes = stacked_param_shapes(DEPTH, C, 4 * C)
    for k, shape in shapes.items():
        assert tuple(own[f"blocks.block.{k}"].shape) == shape, k
    loop = PaSST(PaSSTConfig(**SMALL))
    assert set(unstack_block_params(sd)) == set(loop.state_dict())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_hand_backward_match_jax(dtype):
    """The stack's output and the gradients of every stacked leaf and of x
    for one cotangent, against JAX ``stacked_blocks_apply`` and its
    ``custom_vjp``, in training (the attention takes its qkv entry under
    the backward's gate); the leaves fp32 (as stored), x and the cotangent
    in the compute dtype."""
    train = True
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jp = _jax_stacked()["blocks"]["block"]
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 22, C)).astype(np.float32)
    dy = rng.standard_normal((2, 22, C)).astype(np.float32)
    scale = (C // HEADS) ** -0.5

    def f(p, xx):
        return jax_stacked(p, xx, HEADS, False, scale, True, dtype == "bfloat16", train)

    jy, vjp = jax.vjp(f, jax.tree.map(jnp.asarray, jp), jnp.asarray(x).astype(jdt))
    jgp, jgx = vjp(jnp.asarray(dy).astype(jdt))

    leaves = {k[len("blocks.block."):]: v.requires_grad_() for k, v in
              state_dict_from_flax({"blocks": {"block": jp}, **_stub()}).items() if k.startswith("blocks.block.")}
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    y = stacked_blocks_apply(leaves, tx, HEADS, False, scale, dtype == "bfloat16", train)
    assert y.dtype == tdt
    y.backward(torch.from_numpy(dy).to(tdt))
    _close(y.detach().float().numpy(), np.asarray(jy.astype(jnp.float32)), dtype, "y")
    _close(tx.grad.float().numpy(), np.asarray(jgx.astype(jnp.float32)), dtype, "dx")
    jg = state_dict_from_flax({"blocks": {"block": jax.tree.map(np.asarray, jgp)}, **_stub()})
    for k, t in leaves.items():
        assert t.grad.dtype == torch.float32, k
        _close(t.grad.numpy(), jg[f"blocks.block.{k}"].numpy(), dtype, k)


def _stub():
    """The non-block leaves the bridge expects, from the JAX init."""
    p = _jax_stacked()
    return {k: v for k, v in p.items() if k != "blocks"}


def test_no_grad_forward_is_the_functions_forward():
    """Without a gradient (eval, serving, export) the stack runs unrolled
    outside the Function: the same bits as the Function's forward."""
    sd = state_dict_from_flax(_jax_stacked())
    leaves = {k[len("blocks.block."):]: v for k, v in sd.items() if k.startswith("blocks.block.")}
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((2, 22, C)).astype(np.float32))
    with torch.no_grad():
        plain = stacked_blocks_apply(leaves, x, HEADS, False, 0.125, False, False)
    graded = stacked_blocks_apply(leaves, x.clone().requires_grad_(), HEADS, False, 0.125, False, False)
    assert graded.grad_fn is not None and torch.equal(plain, graded.detach())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stacked_model_matches_loop(dtype):
    """The stacked model against the loop model on the same weights: logits
    and every gradient, fp32 1e-5 x max|ref|, bf16 the bf16 bound (the
    stack's LayerNorm multiplies in the JAX stack's order, the loop's in
    flax's, and its weight gradients are fp32 products)."""
    kw = dict(SMALL, dtype=dtype, attn_impl="fused")
    sd = unstack_block_params(state_dict_from_flax(_jax_stacked()))
    loop, st = PaSST(PaSSTConfig(**kw)), PaSST(PaSSTConfig(**dict(kw, blocks_impl="stacked")))
    loop.load_state_dict(sd)
    st.load_state_dict(stack_block_params(sd))
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((2, 1, 64, 50)).astype(np.float32))
    out = []
    for m in (loop, st):
        logits, _ = m(x)
        logits.square().mean().backward()
        out.append((logits.detach(), stack_block_params({k: p.grad for k, p in m.named_parameters()
                                                         if p.grad is not None})))
    (lo_l, g_l), (lo_s, g_s) = out
    _close(lo_s.numpy(), lo_l.numpy(), dtype, "logits")
    for k in g_l:
        _close(g_s[k].numpy(), g_l[k].numpy(), dtype, k)


def test_fp32_stacked_train_step_matches_jax(injected_draws, monkeypatch):  # noqa: F811
    """One whole fp32 stacked step, every draw injected, against the JAX
    stacked step (its flat attention kernels interpreted): the bounds of
    tests/test_torch_train.py's step test."""
    _fp32_step_vs_jax(monkeypatch, dict(attn_impl="fused", blocks_impl="stacked"),
                      dict(attn_impl="fused", blocks_impl="stacked"))


def test_batched_weight_gradient_keeps_fp32():
    """The batched dW product of bf16 activations and cotangents returns
    fp32, exact products summed in fp32: closer to the float64 sum than a
    bf16-result product, which rounds each sum."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.standard_normal((3, 2, 40, 24)).astype(np.float32)).bfloat16()
    c = torch.from_numpy(rng.standard_normal((3, 2, 40, 16)).astype(np.float32)).bfloat16()
    got = stacked_blocks._bdw(a, c)
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 16, 24)
    ref = torch.einsum("dbno,dbni->doi", c.double(), a.double())
    assert float((got.double() - ref).abs().max()) < 1e-4
    rounded = torch.bmm(c.reshape(3, -1, 16).transpose(1, 2), a.reshape(3, -1, 24))
    assert float((rounded.double() - ref).abs().max()) > float((got.double() - ref).abs().max())
