"""Port int8 Dense family (passt_tpu_torch.ops.int8) vs the JAX
package's, on the CPU.

The JAX side runs its Pallas kernels in interpret mode: the quantized Dense
of passt_tpu/ops/pallas/int8_dense.py by itself off a TPU, and the tiled
matmul of scripts/int8_matmul_micro.py under ``force_tpu_interpret_mode``.
The port takes the kernels' plain versions on CPU tensors. Inputs are numpy
arrays drawn from a seed; in bf16 they are bf16-exact, so both sides start
from the same numbers.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from passt_tpu.ops.pallas import int8_dense as jax_int8
from passt_tpu_torch.ops import _build
from passt_tpu_torch.ops.int8 import (
    int8_dense,
    int8_dense_gelu,
    int8_dense_nd,
    int8_dense_plain,
    int8_matmul,
    quantize_cols,
    quantize_rows,
)
from passt_tpu_torch.tools import ab_int8_mlp, int8_matmul_micro

SCRIPTS = os.path.join(os.path.dirname(__file__), "..", "scripts")
if SCRIPTS not in sys.path:
    sys.path.insert(0, SCRIPTS)

# forward outputs, max error relative to max|ref|: the int32 sums are exact
# on both sides and the fp32 dequantization is the same sequence of roundings,
# so fp32 differs only where tanh does (by an ulp: 1e-6; XLA's CPU tanh is its
# own approximation, and torch's CPU tanh takes a vectorized or a scalar path
# by chunk); in bf16 such an ulp can flip the rounding of h or d: one bf16 ulp
# of the largest value, 2**-7 of max|ref|
TOL_FWD = {"float32": 1e-6, "bfloat16": 2.0**-7}
# gradients, relative to max|ref|: the straight-through products are the same
# math in another summation order (fp32: 1e-5); in bf16 they round once, and a
# summation-order change can move a value across a rounding boundary (two bf16
# ulps, as tests/test_torch_ln_qkv.py)
TOL_GRAD = {"float32": 1e-5, "bfloat16": 2.0**-6}
KEYS = ("int8_dense", "int8_dense_gelu", "int8_matmul")


def _arr(rng, shape, dtype, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    if dtype == "bfloat16":
        a = np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
    return a


def _inputs(seed, m, k, n, dtype):
    """x [m, k] with a zero row, w [k, n] with a zero column (both in dtype),
    fp32 b [n]."""
    rng = np.random.default_rng(seed)
    x, w = _arr(rng, (m, k), dtype), _arr(rng, (k, n), dtype, 0.05)
    x[3] = 0.0
    w[:, 5] = 0.0
    return x, w, rng.standard_normal(n).astype(np.float32) * 0.01


def _close(got, ref, tol, name):
    got = got.detach().float().numpy()
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    assert got.shape == ref.shape, name
    np.testing.assert_allclose(got, ref, atol=tol * np.abs(ref).max(), rtol=0, err_msg=name)


def _no_launches():
    return all(_build.LAUNCHES[k] == 0 for k in KEYS)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantizers_bit_equal(dtype):
    """q and scale of both quantizers equal the JAX ones bit for bit, a zero
    row (rows) and a zero column (cols) included."""
    x, w, _ = _inputs(0, 24, 40, 32, dtype)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    for port, ref, a in ((quantize_rows, jax_int8.quantize_rows, x), (quantize_cols, jax_int8.quantize_cols, w)):
        q, s = port(torch.from_numpy(a).to(tdt))
        jq, js = ref(jnp.asarray(a, jdt))
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    q, s = quantize_rows(torch.zeros(2, 8))
    assert not q.any() and bool((s == 1.0).all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,k,n", [(48, 64, 96), (130, 64, 128), (48, 40, 96)])
def test_dense_forward_matches_pallas(m, k, n, dtype):
    """y of int8_dense and (h, d) of the fused-GELU epilogue against the
    Pallas kernels run interpreted: ragged M (130) and K (40) included."""
    x, w, b = _inputs(1, m, k, n, dtype)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jx, jw, jb = jnp.asarray(x, jdt), jnp.asarray(w, jdt), jnp.asarray(b)
    tx, tw, tb = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt), torch.from_numpy(b)
    _build.reset_launches()
    y = int8_dense(tx, tw, tb)
    assert y.dtype == tdt
    _close(y, jax_int8.int8_dense(jx, jw, jb), TOL_FWD[dtype], "y")
    h, d = int8_dense_plain(tx, tw, tb, gelu=True)
    jh, jd = jax_int8._call_quantized(jx, jw, jb, gelu=True, out_dtype=jdt, interpret=True)
    _close(h, jh, TOL_FWD[dtype], "h")
    _close(d, jd, TOL_FWD[dtype], "d")
    torch.testing.assert_close(int8_dense_gelu(tx, tw, tb), h, rtol=0, atol=0)
    assert _no_launches()


@pytest.mark.parametrize("x_dtype,w_dtype", [("float32", "float32"), ("bfloat16", "bfloat16"),
                                             ("float32", "bfloat16")])
@pytest.mark.parametrize("gelu", [False, True])
def test_ste_gradients_match_jax(gelu, x_dtype, w_dtype):
    """dx, dw, db of the straight-through backward against JAX's custom_vjp,
    dtypes included (fp32 b beside bf16 x and w, as the int8 MLP has; a bf16
    w beside an fp32 x takes jnp.dot's promotion)."""
    x, w, b = _inputs(2, 40, 48, 64, "bfloat16")
    rng = np.random.default_rng(3)
    g = _arr(rng, (40, 64), x_dtype)
    jfn = jax_int8.int8_dense_gelu if gelu else jax_int8.int8_dense
    tfn = int8_dense_gelu if gelu else int8_dense
    jargs = (jnp.asarray(x, x_dtype), jnp.asarray(w, w_dtype), jnp.asarray(b))
    out, vjp = jax.vjp(jfn, *jargs)
    refs = vjp(jnp.asarray(g, x_dtype))
    leaves = [torch.from_numpy(x).to(getattr(torch, x_dtype)), torch.from_numpy(w).to(getattr(torch, w_dtype)),
              torch.from_numpy(b)]
    leaves = [t.requires_grad_() for t in leaves]
    y = tfn(*leaves)
    _close(y, out, TOL_FWD[x_dtype], "y")
    grads = torch.autograd.grad(y, leaves, torch.from_numpy(g).to(y.dtype))
    for name, gt, leaf, r in zip(("dx", "dw", "db"), grads, leaves, refs):
        assert gt.dtype == leaf.dtype and str(gt.dtype)[6:] == str(r.dtype), name
        _close(gt, r, TOL_GRAD["bfloat16" if "bfloat16" in (x_dtype, w_dtype) else "float32"], name)


@pytest.mark.parametrize("gelu", [False, True])
def test_dense_nd_leading_dims(gelu):
    x, w, b = _inputs(4, 10, 32, 16, "float32")
    x = x.reshape(2, 5, 32)
    y = int8_dense_nd(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), gelu=gelu)
    ref = jax_int8.int8_dense_nd(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), gelu=gelu)
    assert tuple(y.shape) == (2, 5, 16)
    _close(y, ref, TOL_FWD["float32"], "y")


@pytest.mark.parametrize("case", ["int8->int32", "int8->bfloat16", "bfloat16->bfloat16"])
def test_int8_matmul_matches_pallas_micro(case):
    """int8_matmul against scripts/int8_matmul_micro.pallas_matmul run
    interpreted: int32 out bit-equal; int32 -> bf16 bit-equal too (both
    convert through fp32; the rows and columns of 127s push the sums past
    2**24, where that rounds twice); bf16 -> bf16 within one bf16 ulp."""
    from int8_matmul_micro import pallas_matmul

    src, out = case.split("->")
    m, k, n = 64, 2048, 96
    rng = np.random.default_rng(5)
    if src == "int8":
        a = rng.integers(-127, 128, (m, k), dtype=np.int8)
        b = rng.integers(-127, 128, (k, n), dtype=np.int8)
        a[0], b[:, 0] = 127, 127
    else:
        a, b = _arr(rng, (m, k), "bfloat16"), _arr(rng, (k, n), "bfloat16")
    with pltpu.force_tpu_interpret_mode():
        ref = pallas_matmul(jnp.asarray(a, src), jnp.asarray(b, src), 32, 32, 512, out_dtype=jnp.dtype(out))
    tdt = torch.int8 if src == "int8" else torch.bfloat16
    _build.reset_launches()
    got = int8_matmul(torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt), getattr(torch, out))
    assert got.dtype == getattr(torch, out) and _no_launches()
    if case == "bfloat16->bfloat16":
        _close(got, ref, 2.0**-7, case)
    else:
        if out == "bfloat16":
            assert float(np.abs(np.asarray(ref, np.float32)).max()) > 2**24
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(ref.astype(jnp.float32)))


def test_wrappers_check_arguments():
    a = torch.zeros(4, 32, dtype=torch.int8)
    with pytest.raises(ValueError, match="int8_matmul takes"):
        int8_matmul(a, torch.zeros(32, 8, dtype=torch.int8), torch.float16)
    with pytest.raises(ValueError, match="int8_matmul takes"):
        int8_matmul(a, torch.zeros(32, 8, dtype=torch.bfloat16), torch.bfloat16)
    with pytest.raises(ValueError, match=r"\[M, K\] @ \[K, N\]"):
        int8_matmul(a, torch.zeros(16, 8, dtype=torch.int8), torch.int32)
    with pytest.raises(ValueError, match="overflow"):
        int8_matmul(torch.zeros(1, 140_000, dtype=torch.int8), torch.zeros(140_000, 1, dtype=torch.int8),
                    torch.int32)


def test_ab_int8_mlp_tool_on_cpu(capsys):
    """The tool's fields at PaSST-S width and a few tokens; without a device
    argument and without a card it raises."""
    res = ab_int8_mlp.run(device="cpu", sizes=(37,))
    out = capsys.readouterr().out
    assert "M=37: mean |int8-bf16| / mean|y|" in out and "fwd: bf16 not measured" in out
    (r,) = res
    assert r["fc1_err"] < r["fc1_limit"] and r["fc2_err"] < r["fc2_limit"]
    assert r["rel_err"] < 0.05 and r["corr"] > 0.99 and r["int8_forwards"] == 2
    assert r["fwd_ms_int8"] == "not measured"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            ab_int8_mlp.run()


def test_int8_matmul_micro_tool_on_cpu(capsys):
    res = int8_matmul_micro.run(device="cpu", shapes={"tiny": (40, 64, 48)})
    out = capsys.readouterr().out
    for key in ("tiny_kernel_int8_tops", "tiny_kernel_bf16_tops", "tiny_torch_int8_tops", "tiny_torch_bf16_tops",
                "tiny_int8_vs_best_bf16"):
        assert key in res and f'"{key}"' in out
    assert res["tiny_kernel_int8_tops"] == "not measured"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            int8_matmul_micro.run()
