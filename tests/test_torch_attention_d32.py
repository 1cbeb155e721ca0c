"""The port's attention at D = 32 (the convergence demo's PaSST 4 x 192 with
6 heads) against the JAX package's Pallas kernels in interpret mode, on the
CPU.

On the card a bf16 / fp16 call at D = 32 takes the one-pass "wgmma" forward
and, up to N = 128, the "resident" backward (``csrc/attention_fwd.cu``,
``csrc/attention_bwd.cu``); on CPU tensors the wrappers run the plain
versions of those kernels' function, which these tests hold against
``passt_tpu.ops.pallas.attention`` (``_fwd_kernel``, ``_flat_fwd_kernel``
and their backward kernels, interpret mode) on the same numpy inputs: both
entries, fp32 and bf16, plus1 on and off, N from 1 to 200 (one and two
128-key tiles, ragged edges at 64, 65, 79, 110, 128 and 129). The kernels'
own orders are emulated in ``tests/test_torch_attention_online.py`` and
``tests/test_torch_attention_bwd_online.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from passt_tpu.ops.pallas import attention as jax_attention
from passt_tpu_torch.ops import _build
from passt_tpu_torch.ops.attention import fused_attention, fused_attention_qkv

HEADS, HEAD_DIM, BATCH = 6, 32, 2
NS = (1, 16, 64, 65, 79, 110, 128, 129, 200)

# the forward: fp32 is the same math in another summation order (observed
# < 1e-6); in bf16 a p may round the other way and the output rounds once:
# one bf16 ulp of an output below 2 (tests/test_torch_attention.py)
TOL_FWD = {"float32": 1e-5, "bfloat16": 2.0**-7}
# the gradients, of max|ref| of each: fp32 summation order; in bf16 dS
# rounds before dQ and dK on both sides and each gradient rounds once, so
# one ulp at the largest plus the flips (tests/test_torch_attention_bwd.py)
TOL_BWD = {"float32": 1e-5, "bfloat16": 2.0**-6}

CASES = [(entry, n, plus1, dtype) for entry in ("bnhd", "qkv") for n in NS for plus1 in (False, True)
         for dtype in ("float32", "bfloat16")]


def _inputs(n, plus1, dtype):
    rng = np.random.default_rng(n + 1000 * plus1 + 7 * (dtype == "bfloat16"))
    qkv = rng.standard_normal((BATCH, n, 3 * HEADS * HEAD_DIM)).astype(np.float32)
    do = rng.standard_normal((BATCH, n, HEADS * HEAD_DIM)).astype(np.float32)
    return qkv, do


def _jax_fn(entry, plus1):
    """The JAX package's kernel as a function of the raw qkv [B, N, 3C],
    returning [B, N, C]."""
    scale = HEAD_DIM ** -0.5
    if entry == "qkv":
        return lambda x: jax_attention.fused_attention_qkv(
            x, heads=HEADS, head_dim=HEAD_DIM, scale=scale, plus1=plus1, interpret=True)

    def bnhd(x):
        b, n, _ = x.shape
        j5 = x.reshape(b, n, 3, HEADS, HEAD_DIM)
        o = jax_attention.fused_attention(j5[:, :, 0], j5[:, :, 1], j5[:, :, 2], scale=scale, plus1=plus1,
                                          interpret=True)
        return o.reshape(b, n, HEADS * HEAD_DIM)
    return bnhd


def _torch_fn(entry, plus1):
    """The port's entry as a function of the raw qkv, returning [B, N, C]."""
    scale = HEAD_DIM ** -0.5
    if entry == "qkv":
        return lambda x: fused_attention_qkv(x, heads=HEADS, head_dim=HEAD_DIM, scale=scale, plus1=plus1)

    def bnhd(x):
        b, n, _ = x.shape
        q, k, v = x.reshape(b, n, 3, HEADS, HEAD_DIM).unbind(2)
        return fused_attention(q, k, v, scale=scale, plus1=plus1).reshape(b, n, HEADS * HEAD_DIM)
    return bnhd


def _as_np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("entry, n, plus1, dtype", CASES)
def test_forward_matches_pallas_interpret(entry, n, plus1, dtype):
    qkv, _ = _inputs(n, plus1, dtype)
    ref = _jax_fn(entry, plus1)(jnp.asarray(qkv, jnp.dtype(dtype)))
    _build.reset_launches()
    got = _torch_fn(entry, plus1)(torch.from_numpy(qkv).to(getattr(torch, dtype)))
    assert _build.LAUNCHES["fused_attention"] == _build.LAUNCHES["fused_attention_qkv"] == 0
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == tuple(ref.shape)
    np.testing.assert_allclose(got.float().numpy(), _as_np(ref), atol=TOL_FWD[dtype], rtol=0)


@pytest.mark.parametrize("entry, n, plus1, dtype", CASES)
def test_gradients_match_pallas_interpret(entry, n, plus1, dtype):
    qkv, do = _inputs(n, plus1, dtype)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    _, vjp = jax.vjp(_jax_fn(entry, plus1), jnp.asarray(qkv, jdt))
    (ref,) = vjp(jnp.asarray(do, jdt))
    x = torch.from_numpy(qkv).to(tdt).requires_grad_()
    _build.reset_launches()
    (got,) = torch.autograd.grad(_torch_fn(entry, plus1)(x), x, torch.from_numpy(do).to(tdt))
    assert _build.LAUNCHES["fused_attention_bwd"] == _build.LAUNCHES["fused_attention_qkv_bwd"] == 0
    assert got.dtype == tdt and got.shape == x.shape
    got = got.float().numpy().reshape(BATCH, n, 3, HEADS, HEAD_DIM)
    ref = _as_np(ref).reshape(BATCH, n, 3, HEADS, HEAD_DIM)
    for i, name in enumerate(("dq", "dk", "dv")):
        r = ref[:, :, i]
        np.testing.assert_allclose(got[:, :, i], r, atol=TOL_BWD[dtype] * np.abs(r).max(), rtol=0, err_msg=name)
