"""The fused-MLP prototype's two Pallas kernels (scripts/proto_mlp_fused.py:
``_fwd_kernel`` and ``_bwd_kernel``, through ``fused_mlp_fwd_call`` and
``make_fused_mlp``) against their counterparts in the port
(passt_tpu_torch/ops/fused_mlp.py), on the CPU.

The JAX side runs its kernels in interpret mode; the port takes the kernels'
plain versions on CPU tensors, which repeat the kernels' rounding points.
Inputs are numpy arrays drawn from a seed; in bf16 they are bf16-exact, so
both sides start from the same numbers.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from passt_tpu_torch.ops import _build
from passt_tpu_torch.ops.fused_mlp import fused_mlp, fused_mlp_bwd, fused_mlp_fwd
from passt_tpu_torch.tools import proto_mlp_fused as tool

SCRIPTS = os.path.join(os.path.dirname(__file__), "..", "scripts")
if SCRIPTS not in sys.path:
    sys.path.insert(0, SCRIPTS)

C, HID, BM = 64, 256, 16
KEYS = ("fused_mlp_fwd", "fused_mlp_bwd")
# max error relative to max|ref|: fp32 differs in summation order only; in
# bf16 an fp32 ulp of tanh (or of a sum in another order) can flip the
# rounding of g, d, dh or y: one bf16 ulp at the largest value, 2**-7; a
# gradient that passes through two roundings (dh, then dx or dW1), 2**-6
TOL = {"float32": 1e-5, "bfloat16": 2.0**-7}
TOL_GRAD = {"float32": 1e-5, "bfloat16": 2.0**-6}


def _arr(rng, shape, dtype, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return np.array(jnp.asarray(a, dtype).astype(jnp.float32))


def _inputs(seed, m, dtype):
    """x [m, C] with a zero row, w1, b1, w2, b2 (small non-zero biases)."""
    rng = np.random.default_rng(seed)
    x = _arr(rng, (m, C), dtype)
    x[3] = 0.0
    return (x, _arr(rng, (C, HID), dtype, 0.05), _arr(rng, (HID,), dtype, 0.1), _arr(rng, (HID, C), dtype, 0.05),
            _arr(rng, (C,), dtype, 0.1))


def _close(got, ref, tol, name):
    got = got.detach().float().numpy()
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    assert got.shape == ref.shape, name
    np.testing.assert_allclose(got, ref, atol=tol * np.abs(ref).max(), rtol=0, err_msg=name)


def _no_launches():
    return all(_build.LAUNCHES[k] == 0 for k in KEYS)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [40, 37])
def test_forward_and_residuals_match_pallas(m, dtype):
    """y, g and d of the forward with residuals, and y without them, against
    ``fused_mlp_fwd_call`` run interpreted (M = 37 is ragged in bm = 16)."""
    from proto_mlp_fused import fused_mlp_fwd_call

    arrs = _inputs(1, m, dtype)
    ref = fused_mlp_fwd_call(*(jnp.asarray(a, dtype) for a in arrs), bm=BM, residuals=True, interpret=True)
    tdt = getattr(torch, dtype)
    ts = [torch.from_numpy(a).to(tdt) for a in arrs]
    _build.reset_launches()
    got = fused_mlp_fwd(*ts, residuals=True)
    y_only = fused_mlp_fwd(*ts, residuals=False)
    assert _no_launches()
    for name, gt, r in zip(("y", "g", "d"), got, ref):
        assert gt.dtype == tdt, name
        _close(gt, r, TOL[dtype], name)
    torch.testing.assert_close(y_only, got[0], rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_kernel_matches_pallas(dtype):
    """dx and dh of the backward kernel against ``fused_mlp_bwd_call``."""
    from proto_mlp_fused import fused_mlp_bwd_call

    x, w1, _, w2, _ = _inputs(2, 37, dtype)
    rng = np.random.default_rng(3)
    dy, d = _arr(rng, (37, C), dtype), _arr(rng, (37, HID), dtype)
    rdx, rdh = fused_mlp_bwd_call(*(jnp.asarray(a, dtype) for a in (dy, d, w1, w2)), bm=BM, interpret=True)
    tdt = getattr(torch, dtype)
    _build.reset_launches()
    dx, dh = fused_mlp_bwd(*(torch.from_numpy(a).to(tdt) for a in (dy, d, w1, w2)))
    assert _no_launches() and dx.dtype == dh.dtype == tdt
    _close(dh, rdh, TOL[dtype], "dh")
    _close(dx, rdx, TOL_GRAD[dtype], "dx")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fused_bwd", [False, True])
def test_fused_mlp_gradients_match_make_fused_mlp(fused_bwd, dtype):
    """The five gradients of an upstream cotangent through ``fused_mlp``
    against ``make_fused_mlp``'s custom VJP, dtypes included."""
    from proto_mlp_fused import make_fused_mlp

    arrs = _inputs(4, 37, dtype)
    cot = _arr(np.random.default_rng(5), (37, C), dtype)
    jfn = make_fused_mlp(BM, True, fused_bwd=fused_bwd)
    out, vjp = jax.vjp(jfn, *(jnp.asarray(a, dtype) for a in arrs))
    refs = vjp(jnp.asarray(cot, dtype))
    tdt = getattr(torch, dtype)
    leaves = [torch.from_numpy(a).to(tdt).requires_grad_() for a in arrs]
    _build.reset_launches()
    y = fused_mlp(*leaves, fused_bwd=fused_bwd)
    grads = torch.autograd.grad(y, leaves, torch.from_numpy(cot).to(tdt))
    assert _no_launches()
    _close(y, out, TOL[dtype], "y")
    for name, g, r in zip(("dx", "dw1", "db1", "dw2", "db2"), grads, refs):
        assert str(g.dtype)[6:] == str(r.dtype), name
        _close(g, r, TOL_GRAD[dtype], name)
    with torch.no_grad():
        torch.testing.assert_close(fused_mlp(*leaves, fused_bwd=fused_bwd), y.detach(), rtol=0, atol=0)


def test_xla_variant_matches_prototype():
    """The tool's ``xla`` composition against the prototype's ``xla_mlp``,
    forward and the five gradients of mean(y^2), in bf16 (as the A/B runs
    it): the same rounding points (h rounded before the GELU, each Dense
    rounded once after the fp32 bias), so one bf16 ulp (2**-7) forward and
    two (2**-6) in the gradients."""
    from proto_mlp_fused import loss_of, xla_mlp

    arrs = _inputs(6, 37, "bfloat16")
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in arrs]
    leaves = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_() for a in arrs]
    y = tool.xla_mlp(*leaves)
    _close(y, xla_mlp(*jargs), 2.0**-7, "y")
    refs = jax.grad(loss_of(xla_mlp), argnums=(0, 1, 2, 3, 4))(*jargs)
    grads = torch.autograd.grad((y.float() ** 2).mean(), leaves)
    for name, g, r in zip(("dx", "dw1", "db1", "dw2", "db2"), grads, refs):
        _close(g, r, 2.0**-6, name)


def test_tool_on_cpu(capsys):
    """The A/B at PaSST-S width and a few tokens: the fields, the call
    counts, errors of bf16 size; the times and the memory are not measured
    on the CPU."""
    res = tool.run(device="cpu", sizes=(37,))
    out = capsys.readouterr().out
    assert "M=37 (kernel config none (the plain version))" in out and "fwd: xla not measured" in out
    (r,) = res
    assert r["fwd_calls"] == 4 and r["bwd_calls"] == 1
    assert r["fwd_err_fuse_f"] == r["fwd_err_fuse"] <= 2.0**-6 * r["y_max"]
    assert r["grad_rel_fuse"] < 2.0**-5 and r["grad_rel_fuse2"] < 2.0**-5
    assert r["fwd_ms_fuse_f"] == r["fuse_f_peak_growth"] == "not measured"
    assert r["hidden_bytes"] == 37 * 3072 * 2


def test_wrappers_check_arguments_and_need_a_card():
    x = torch.zeros(4, 64)
    w1, b1, w2, b2 = torch.zeros(64, 128), torch.zeros(128), torch.zeros(128, 64), torch.zeros(64)
    with pytest.raises(ValueError, match="multiple of 64"):
        fused_mlp_fwd(torch.zeros(4, 32), torch.zeros(32, 128), b1, torch.zeros(128, 32), torch.zeros(32),
                      residuals=False)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fused_mlp_fwd(x.half(), w1.half(), b1.half(), w2.half(), b2.half(), residuals=False)
    with pytest.raises(ValueError, match="b2"):
        fused_mlp_fwd(x, w1, b1, w2, b2.bfloat16(), residuals=False)
    with pytest.raises(ValueError, match="shape"):
        fused_mlp_bwd(x, torch.zeros(4, 64), w1, w2)
    # a tensor on neither the CPU nor a card is refused, not computed plainly
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fused_mlp_fwd(*(t.to("meta") for t in (x, w1, b1, w2, b2)), residuals=False)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fused_mlp_bwd(*(t.to("meta") for t in (x, torch.zeros(4, 128), w1, w2)))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            tool.run()
