"""Port attention (passt_tpu_torch.ops.attention) vs the JAX package's
Pallas attention kernels in interpret mode, on the CPU.

On CPU tensors the port's wrappers run the plain version of the Hopper
kernel's function. The same numpy inputs go to both sides, in fp32 and
bf16, with and without the plus1 term, at ragged lengths.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from passt_tpu.ops.pallas import attention as jax_attention
from passt_tpu_torch.ops import _build
from passt_tpu_torch.ops.attention import (
    flat_kernel_supports,
    fused_attention,
    fused_attention_qkv,
)

HEADS, HEAD_DIM, BATCH = 2, 16, 2

# fp32: same math, another summation order (observed < 1e-6).
# bf16: P is rounded to bf16 on both sides, but a summation-order change can
# move a p across a rounding boundary, and the output is bf16 (8 bits):
# one bf16 ulp of an output of magnitude < 2 is <= 2**-7.
TOL = {"float32": 1e-5, "bfloat16": 2.0**-7}


def _qkv(seed, n):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((BATCH, n, 3 * HEADS * HEAD_DIM)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("plus1", [False, True])
@pytest.mark.parametrize("n", [14, 97, 200])
@pytest.mark.parametrize("entry", ["bnhd", "qkv"])
def test_attention_matches_pallas_interpret(entry, n, plus1, dtype):
    qkv = _qkv(n + 1000 * plus1, n)
    scale = HEAD_DIM ** -0.5
    jq = jnp.asarray(qkv, dtype=jnp.dtype(dtype))
    tq = torch.from_numpy(qkv).to(getattr(torch, dtype))
    _build.reset_launches()
    if entry == "qkv":
        ref = jax_attention.fused_attention_qkv(
            jq, heads=HEADS, head_dim=HEAD_DIM, scale=scale, plus1=plus1, interpret=True
        )
        got = fused_attention_qkv(tq, heads=HEADS, head_dim=HEAD_DIM, scale=scale, plus1=plus1)
    else:
        j5 = jq.reshape(BATCH, n, 3, HEADS, HEAD_DIM)
        ref = jax_attention.fused_attention(
            j5[:, :, 0], j5[:, :, 1], j5[:, :, 2], scale=scale, plus1=plus1, interpret=True
        )
        q, k, v = tq.reshape(BATCH, n, 3, HEADS, HEAD_DIM).unbind(2)
        got = fused_attention(q, k, v, scale=scale, plus1=plus1)
    assert _build.LAUNCHES["fused_attention"] == _build.LAUNCHES["fused_attention_qkv"] == 0
    assert got.dtype == tq.dtype and tuple(got.shape) == tuple(ref.shape)
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(ref.astype(jnp.float32)), atol=TOL[dtype], rtol=0
    )


def test_plus1_rows_can_sum_below_one():
    """With all-negative scores the plus1 row weights sum to < 1, so the
    output shrinks toward 0 (v = 1 makes the output the row sum)."""
    n = 14
    q = torch.full((1, n, 1, 8), 1.0)
    k = torch.full((1, n, 1, 8), -1.0)
    v = torch.ones((1, n, 1, 8))
    plain = fused_attention(q, k, v, scale=1.0, plus1=False)
    quiet = fused_attention(q, k, v, scale=1.0, plus1=True)
    np.testing.assert_allclose(plain.numpy(), 1.0, rtol=1e-6)
    assert (quiet < 0.01).all()


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("batch", [None, 1, 12, 20, 256])
def test_entry_choice_matches_jax(batch, itemsize):
    """The model takes the qkv entry exactly where the JAX package does."""
    for n in (14, 110, 474, 600, 1190, 2390):
        for backward in (False, True):
            args = dict(backward=backward, itemsize=itemsize, batch=batch)
            assert flat_kernel_supports(n, 12, 64, **args) == jax_attention.flat_kernel_supports(
                n, 12, 64, **args
            )
