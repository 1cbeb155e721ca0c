"""The flat-qkv attention prototype's two Pallas kernels
(scripts/proto_attn_qkv.py: ``_fwd_kernel_flat`` and ``_bwd_kernel_flat``)
against their counterparts in the port, on the CPU.

The prototype's kernels are the flat attention kernels with plus1 off (the
same formulas, rounding points and dqkv layout as
passt_tpu/ops/pallas/attention.py's); the port's counterparts are the qkv
entries of ``csrc/attention_fwd.cu`` and ``csrc/attention_bwd.cu``, reached
through ``fused_attention_qkv(..., plus1=False)``. The JAX side runs
interpreted; the port takes the kernels' plain versions on CPU tensors.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from passt_tpu_torch.ops import _build
from passt_tpu_torch.ops.attention import fused_attention_qkv

SCRIPTS = os.path.join(os.path.dirname(__file__), "..", "scripts")
if SCRIPTS not in sys.path:
    sys.path.insert(0, SCRIPTS)

B, N, H, D = 2, 23, 4, 16
# max error relative to max|ref|, as tests/test_torch_ln_qkv.py: fp32 differs
# in summation order only; bf16 rounds P and dS at the same places on both
# sides, so a summation-order change may move a value across a rounding
# boundary (one or two bf16 ulps of the largest value)
TOL = {"float32": 1e-5, "bfloat16": 2.0**-6}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_proto_attn_qkv_matches_port(dtype):
    """The forward and the d(qkv) of an upstream gradient."""
    from proto_attn_qkv import attn_qkv

    rng = np.random.default_rng(7)

    def arr(shape):
        return np.array(jnp.asarray(rng.standard_normal(shape).astype(np.float32), dtype).astype(jnp.float32))

    qkv, do = arr((B, N, 3 * H * D)), arr((B, N, H * D))
    scale = D ** -0.5
    ref, vjp = jax.vjp(lambda t: attn_qkv(t, H, D, scale, True), jnp.asarray(qkv, dtype))
    (dref,) = vjp(jnp.asarray(do, dtype))

    tdt = getattr(torch, dtype)
    x = torch.from_numpy(qkv).to(tdt).requires_grad_()
    _build.reset_launches()
    out = fused_attention_qkv(x, heads=H, head_dim=D, scale=scale, plus1=False)
    (dx,) = torch.autograd.grad(out, x, torch.from_numpy(do).to(tdt))
    assert not any(_build.LAUNCHES.values())
    assert out.dtype == dx.dtype == tdt
    for name, got, r in (("out", out, ref), ("dqkv", dx, dref)):
        r = np.asarray(r.astype(jnp.float32))
        assert tuple(got.shape) == r.shape, name
        np.testing.assert_allclose(got.detach().float().numpy(), r, atol=TOL[dtype] * np.abs(r).max(), rtol=0,
                                   err_msg=name)
