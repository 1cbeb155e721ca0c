"""Port LayerNorm with the kernel backward (passt_tpu_torch.ops.layernorm)
vs the JAX package's Pallas LayerNorm, on the CPU.

The JAX side runs its Pallas backward kernel in interpret mode
(``layer_norm(interpret=True)``), as tests/test_pallas_layernorm.py does; the
port's autograd function takes the kernel's plain version on CPU tensors.
The same numpy inputs and output gradient go to both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from passt_tpu.ops.pallas.layernorm import layer_norm as jax_layer_norm
from passt_tpu_torch.ops import _build
from passt_tpu_torch.ops.layernorm import layer_norm, layer_norm_bwd, layer_norm_bwd_plain, ln_forward

# fp32: the same formulas on both sides, another summation order: the
# output and dx to 1e-6 of their max (observed ~1e-7); dscale/dbias sum M
# rows (the JAX package per 512-row tile, the port in one reduction): 1e-5
# of their max.
# bf16 x: the statistics and the output are fp32 on both sides (same
# bound); dx is rounded to bf16 once, so a summation-order change may move
# it across a rounding boundary: one bf16 ulp (2**-8) of the largest dx.
TOL = {"float32": {"y": 1e-6, "dx": 1e-6, "sums": 1e-5},
       "bfloat16": {"y": 1e-6, "dx": 2.0**-8, "sums": 1e-5}}


def _inputs(seed, shape, dtype):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if dtype == "bfloat16":  # the same bf16 values on both sides
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    scale = (1.0 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    bias = (0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    return x, scale, bias, dy


def _close(got, ref, tol, name):
    got = got.detach().float().numpy()
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    assert got.shape == ref.shape, name
    np.testing.assert_allclose(got, ref, atol=tol * np.abs(ref).max(), rtol=0, err_msg=name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(3, 37, 256), (2, 600, 128), (111, 64)])
def test_layer_norm_and_grads_match_pallas_interpret(shape, dtype):
    """Values and dx/dscale/dbias, including M not a multiple of 512 (the
    JAX kernel's row tile) and of 32 (the port's)."""
    x, scale, bias, dy = _inputs(sum(shape), shape, dtype)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    y_ref, vjp = jax.vjp(lambda a, s, b: jax_layer_norm(a, s, b, interpret=True),
                         jnp.asarray(x, jdt), jnp.asarray(scale), jnp.asarray(bias))
    refs = vjp(jnp.asarray(dy))
    tx = torch.from_numpy(x).to(tdt).requires_grad_()
    ts, tb = torch.from_numpy(scale).requires_grad_(), torch.from_numpy(bias).requires_grad_()
    _build.reset_launches()
    y = layer_norm(tx, ts, tb)
    grads = torch.autograd.grad(y, (tx, ts, tb), torch.from_numpy(dy))
    assert y.dtype == torch.float32 and grads[0].dtype == tdt
    assert grads[1].dtype == grads[2].dtype == torch.float32
    assert _build.LAUNCHES["layer_norm_bwd"] == 0  # CPU tensors take the plain version
    tol = TOL[dtype]
    _close(y, y_ref, tol["y"], "y")
    for name, g, r in zip(("dx", "dscale", "dbias"), grads, refs):
        _close(g, r, tol["dx" if name == "dx" else "sums"], name)


def test_backward_wrapper_is_the_plain_version_on_cpu():
    """The wrapper on CPU tensors returns the plain version's values bit for
    bit; the plain version's dx equals autograd through the forward's
    formula (1e-6 of its max, fp32)."""
    x, scale, bias, dy = _inputs(5, (70, 96), "float32")
    tx, ts, tdy = torch.from_numpy(x), torch.from_numpy(scale), torch.from_numpy(dy)
    _, mu, rstd = ln_forward(tx, ts, torch.from_numpy(bias), 1e-6)
    got, plain = layer_norm_bwd(tx, tdy, mu, rstd, ts), layer_norm_bwd_plain(tx, tdy, mu, rstd, ts)
    for a, b in zip(got, plain):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    xa = tx.clone().requires_grad_()
    (auto,) = torch.autograd.grad(ln_forward(xa, ts, torch.from_numpy(bias), 1e-6)[0], xa, tdy)
    torch.testing.assert_close(got[0], auto, rtol=0, atol=1e-6 * float(auto.abs().max()))


def test_bf16_parameters_get_bf16_gradients():
    """dscale and dbias come back in the parameters' dtype."""
    x, scale, bias, dy = _inputs(6, (4, 9, 64), "float32")
    ts = torch.from_numpy(scale).to(torch.bfloat16).requires_grad_()
    tb = torch.from_numpy(bias).to(torch.bfloat16).requires_grad_()
    y = layer_norm(torch.from_numpy(x), ts, tb)
    gs, gb = torch.autograd.grad(y, (ts, tb), torch.from_numpy(dy))
    assert gs.dtype == gb.dtype == torch.bfloat16
