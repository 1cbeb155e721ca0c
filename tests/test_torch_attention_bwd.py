"""Port attention backward and tanh-GELU VJP vs the JAX package, on the CPU.

The port's ``fused_attention`` / ``fused_attention_qkv`` are autograd
functions whose backward is the Hopper backward kernel on CUDA tensors and
its plain version (``attention_bwd_plain``) on CPU tensors. The JAX side
differentiates its Pallas kernels in interpret mode (``_bwd_kernel`` and
``_flat_bwd_kernel``). The same numpy inputs and output gradient go to both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from passt_tpu.ops.pallas import attention as jax_attention
from passt_tpu_torch.ops import _build
from passt_tpu_torch.ops.attention import (
    attention_bwd_plain,
    fused_attention,
    fused_attention_bwd,
    fused_attention_qkv,
    fused_attention_qkv_bwd,
)

HEADS, HEAD_DIM, BATCH = 2, 16, 2

# max error relative to max|ref| of each gradient.
# fp32: the same fp32 formula, another summation order (observed < 1e-6).
# bf16: dS is rounded to bf16 on both sides before dQ/dK, dV's product is
# fp32 on both sides, and the gradients are stored in bf16: a summation-order
# change can move a dS across a rounding boundary and an output rounds once,
# so one bf16 ulp (2**-8 relative) of the largest gradient plus the flips.
TOL = {"float32": 1e-5, "bfloat16": 2.0**-6}


def _inputs(seed, n):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((BATCH, n, 3 * HEADS * HEAD_DIM)).astype(np.float32)
    do = rng.standard_normal((BATCH, n, HEADS * HEAD_DIM)).astype(np.float32)
    return qkv, do


def _close(got, ref, dtype):
    got = got.float().numpy()
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=TOL[dtype] * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("plus1", [False, True])
@pytest.mark.parametrize("n", [14, 97])
@pytest.mark.parametrize("entry", ["bnhd", "qkv"])
def test_attention_grads_match_pallas_interpret(entry, n, plus1, dtype):
    qkv, do = _inputs(n + 100 * plus1, n)
    scale = HEAD_DIM ** -0.5
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jqkv, jdo = jnp.asarray(qkv, jdt), jnp.asarray(do, jdt)
    tqkv = torch.from_numpy(qkv).to(tdt).requires_grad_()
    tdo = torch.from_numpy(do).to(tdt)
    _build.reset_launches()
    if entry == "qkv":
        _, vjp = jax.vjp(
            lambda x: jax_attention.fused_attention_qkv(
                x, heads=HEADS, head_dim=HEAD_DIM, scale=scale, plus1=plus1, interpret=True),
            jqkv)
        (ref,) = vjp(jdo)
        out = fused_attention_qkv(tqkv, heads=HEADS, head_dim=HEAD_DIM, scale=scale, plus1=plus1)
        (got,) = torch.autograd.grad(out, tqkv, tdo)
        assert got.dtype == tdt and got.shape == tqkv.shape
        _close(got, ref, dtype)
    else:
        def f(q, k, v):
            return jax_attention.fused_attention(q, k, v, scale=scale, plus1=plus1, interpret=True)

        j5 = jqkv.reshape(BATCH, n, 3, HEADS, HEAD_DIM)
        _, vjp = jax.vjp(f, j5[:, :, 0], j5[:, :, 1], j5[:, :, 2])
        refs = vjp(jdo.reshape(BATCH, n, HEADS, HEAD_DIM))
        q, k, v = (t.detach().clone().requires_grad_()
                   for t in tqkv.detach().reshape(BATCH, n, 3, HEADS, HEAD_DIM).unbind(2))
        out = fused_attention(q, k, v, scale=scale, plus1=plus1)
        gots = torch.autograd.grad(out, (q, k, v), tdo.reshape(BATCH, n, HEADS, HEAD_DIM))
        for got, ref in zip(gots, refs):
            assert got.dtype == tdt and tuple(got.shape) == (BATCH, n, HEADS, HEAD_DIM)
            _close(got, ref, dtype)
    # a CPU tensor takes the plain versions and launches nothing
    assert not any(_build.LAUNCHES.values())


def test_grads_through_qkv_views_equal_the_qkv_entry():
    """The [B, N, H, D] entry on unbind views of qkv: autograd assembles
    d(qkv) from the three view gradients, and that equals the qkv entry's
    d(qkv), written in the Dense layout."""
    n = 37
    qkv, do = _inputs(5, n)
    scale = HEAD_DIM ** -0.5
    x1 = torch.from_numpy(qkv).requires_grad_()
    q, k, v = x1.reshape(BATCH, n, 3, HEADS, HEAD_DIM).unbind(2)
    out1 = fused_attention(q, k, v, scale=scale, plus1=True).reshape(BATCH, n, -1)
    (g1,) = torch.autograd.grad(out1, x1, torch.from_numpy(do))
    x2 = torch.from_numpy(qkv).requires_grad_()
    out2 = fused_attention_qkv(x2, heads=HEADS, head_dim=HEAD_DIM, scale=scale, plus1=True)
    (g2,) = torch.autograd.grad(out2, x2, torch.from_numpy(do))
    torch.testing.assert_close(out1, out2, rtol=0, atol=0)
    torch.testing.assert_close(g1, g2, rtol=0, atol=0)
    direct = fused_attention_qkv_bwd(x2.detach(), torch.from_numpy(do), heads=HEADS,
                                     head_dim=HEAD_DIM, scale=scale, plus1=True)
    torch.testing.assert_close(direct, g2, rtol=0, atol=0)


def test_plain_backward_is_the_autograd_of_the_forward():
    """At fp32 the kernel's backward function (unrounded dS) is the exact
    derivative of the forward: it matches PyTorch autograd of the plain
    forward to fp32 summation order; the plus1 column changes only m and l."""
    n = 29
    qkv, do = _inputs(7, n)
    scale = HEAD_DIM ** -0.5
    for plus1 in (False, True):
        q, k, v = (t.clone().requires_grad_() for t in
                   torch.from_numpy(qkv).reshape(BATCH, n, 3, HEADS, HEAD_DIM).unbind(2))
        s = torch.einsum("bnhd,bmhd->bhnm", q, k) * scale
        if plus1:
            s = torch.cat([s, s.new_zeros(s.shape[:-1] + (1,))], dim=-1)
        p = torch.softmax(s, dim=-1)[..., :n]
        out = torch.einsum("bhnm,bmhd->bnhd", p, v)
        dout = torch.from_numpy(do).reshape(BATCH, n, HEADS, HEAD_DIM)
        want = torch.autograd.grad(out, (q, k, v), dout)
        got = fused_attention_bwd(q.detach(), k.detach(), v.detach(), dout, scale=scale, plus1=plus1)
        plain = attention_bwd_plain(q.detach(), k.detach(), v.detach(), dout, scale=scale, plus1=plus1)
        for g, p_, w in zip(got, plain, want):
            torch.testing.assert_close(g, p_, rtol=0, atol=0)
            torch.testing.assert_close(g, w, rtol=0, atol=2e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tanh_gelu_grad_matches_jax_custom_vjp(dtype):
    """The backward multiplies by the saved derivative: the derivative is
    computed in fp32 and rounded once to the input dtype, then g * d in fp32
    and rounded once, as the JAX custom VJP does. fp32 to a few ulps of the
    fp32 formula; bf16: the fp32 derivatives may straddle a rounding
    boundary of d, and then the product's, so up to two bf16 ulps (2**-6
    relative); where |x| > 3 the derivative's O(1) terms cancel to ~1e-3 and
    the two fp32 formulas (PyTorch's gelu_backward, JAX's) differ by a few
    1e-6 absolute, hence atol 1e-5."""
    from passt_tpu.ops.activations import tanh_gelu as jax_gelu
    from passt_tpu_torch.ops.activations import tanh_gelu

    rng = np.random.default_rng(11)
    x = (rng.standard_normal(4096) * 3).astype(np.float32)
    g = rng.standard_normal(4096).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    _, vjp = jax.vjp(jax_gelu, jnp.asarray(x, jdt))
    (ref,) = vjp(jnp.asarray(g, jdt))
    ref = np.asarray(ref.astype(jnp.float32))
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    (got,) = torch.autograd.grad(tanh_gelu(tx), tx, torch.from_numpy(g).to(tdt))
    assert got.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(got.float().numpy(), ref, atol=1e-5, rtol=2.0**-6)
