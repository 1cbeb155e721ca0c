"""Port fused norm1 -> qkv -> attention (passt_tpu_torch.ops.ln_qkv) vs the
JAX package's, on the CPU.

The JAX side runs its Pallas kernels (F1, B2 and the flat attention
kernels) in interpret mode, as tests/test_ln_qkv.py does; the port takes
the kernels' plain versions on CPU tensors. The port's qkv weight is the
torch Linear layout [3C, C], the JAX kernel's [C, 3C] transposed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from passt_tpu.ops.pallas import ln_qkv as jax_ln_qkv
from passt_tpu_torch.ops import _build
from passt_tpu_torch.ops import ln_qkv

B, N, H, D = 2, 23, 4, 16
C = H * D

# max error relative to max|ref|.
# fp32: the same fp32 formulas, another summation order (the products over
# C and 3C, the row statistics, the dscale/dbias sums over the rows, which
# the JAX package takes per batch element): 1e-5 (observed ~1e-7).
# bf16: xn, qkv, dx and the attention's P and dS are rounded to bf16 on both
# sides at the same places; a summation-order change can move a value
# across a rounding boundary and an output rounds once (qkv twice: the
# product, then the bias add), so one or two bf16 ulps (2**-8 each) of the
# largest value; dscale/dbias and dW are fp32 sums of those rounded inputs.
TOL = {"float32": 1e-5, "bfloat16": 2.0**-6}


def _inputs(seed, dtype, n=N, batch=B):
    """x [B, N, C], LN scale/bias [C], W [C, 3C] (JAX layout), wb [3C], an
    upstream gradient of shape [B, N, C] and one of [B, N, 3C]; in bf16 the
    values are bf16-exact so both sides start from the same numbers."""
    rng = np.random.default_rng(seed)

    def arr(shape, scale=1.0, offset=0.0, exact=True):
        a = (rng.standard_normal(shape) * scale + offset).astype(np.float32)
        if dtype == "bfloat16" and exact:
            a = np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
        return a

    return dict(x=arr((batch, n, C)), s=arr((C,), 0.1, 1.0, exact=False), b=arr((C,), 0.1, exact=False),
                w=arr((C, 3 * C), 0.1), wb=arr((3 * C,), 0.1), do=arr((batch, n, C)),
                dqkv=arr((batch, n, 3 * C)))


def _close(got, ref, dtype, name):
    got = got.detach().float().numpy()
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    assert got.shape == ref.shape, name
    np.testing.assert_allclose(got, ref, atol=TOL[dtype] * np.abs(ref).max(), rtol=0, err_msg=name)


def test_ln_stats_matches_jax_and_clamps():
    """The statistics equal the JAX ones (fp32, 1e-6 relative). On the
    near-constant large rows x = 120 + N(0, 1e-3) at C = 768 the fp32 fast
    variance is cancellation noise of either sign (the two frameworks sum
    in other orders, so their rstd differ); the clamp keeps it >= 0, so rstd
    is finite and at most 1/sqrt(eps), on both sides."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((5, 768)).astype(np.float32)
    mu, rstd = ln_qkv.ln_stats(torch.from_numpy(x), 1e-6)
    jmu, jrstd = jax_ln_qkv.ln_stats(jnp.asarray(x), 1e-6)
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(jrstd), rtol=1e-6)
    x = (120.0 + rng.standard_normal((64, 768)) * 1e-3).astype(np.float32)
    xt = torch.from_numpy(x)
    mu, rstd = ln_qkv.ln_stats(xt, 1e-6)
    jmu, jrstd = jax_ln_qkv.ln_stats(jnp.asarray(x), 1e-6)
    unclamped = (xt * xt).mean(-1, keepdim=True) - mu * mu
    assert bool((unclamped < 0).any())  # the case the clamp exists for
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), rtol=1e-6)
    for r in (rstd.numpy(), np.asarray(jrstd)):
        assert np.isfinite(r).all() and (r <= np.float32(1e3) * (1 + 1e-6)).all()


def test_supports_equals_the_jax_gate():
    """The same geometry decisions as the JAX package, including the tight
    bf16 training geometry (B2 at 16,644,096 of 16,777,216 bytes), eval
    N = 1190, and fp32 at N = 474 (no) and N = 154 (yes)."""
    named = [
        (474, 12, 64, True, 2, 12, True), (1190, 12, 64, False, 2, 20, False),
        (474, 12, 64, True, 4, 12, False), (154, 12, 64, True, 4, 2, True),
        (14, 12, 64, False, 2, 256, True), (14, 12, 64, False, 4, 256, True),
    ]
    for n, h, d, bwd, item, batch, want in named:
        assert ln_qkv.ln_qkv_supports(n, h, d, backward=bwd, itemsize=item, batch=batch) is want
    assert ln_qkv._b2_bytes(474, 768, 2) == 16_644_096 and ln_qkv._f1_bytes(474, 768, 2) == 13_731_840
    for n in (1, 14, 47, 100, 154, 155, 300, 474, 475, 600, 1190):
        for h, d in ((12, 64), (4, 16), (2, 24), (6, 128)):
            for bwd in (False, True):
                for item in (2, 4):
                    for batch in (None, 1, 12, 256):
                        kw = dict(backward=bwd, itemsize=item, batch=batch)
                        assert ln_qkv.ln_qkv_supports(n, h, d, **kw) == jax_ln_qkv.ln_qkv_supports(n, h, d, **kw), \
                            (n, h, d, kw)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_f1_and_b2_plain_match_pallas_interpret(dtype):
    """F1's qkv and B2's dx, xn, dscale, dbias (the JAX per-batch partials
    summed) from the same inputs."""
    a = _inputs(1, dtype)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jx, jw, jwb = jnp.asarray(a["x"], jdt), jnp.asarray(a["w"], jdt), jnp.asarray(a["wb"], jdt)
    js, jb = jnp.asarray(a["s"]), jnp.asarray(a["b"])
    tx = torch.from_numpy(a["x"]).to(tdt)
    tw, twb = torch.from_numpy(a["w"].T.copy()).to(tdt), torch.from_numpy(a["wb"]).to(tdt)
    ts, tb = torch.from_numpy(a["s"]), torch.from_numpy(a["b"])
    ref = jax_ln_qkv._f1_call(jx, js, jb, jw, jwb, 1e-6, True)
    got = ln_qkv.ln_qkv_f1_plain(tx, ts, tb, tw, twb)
    assert got.dtype == tdt
    _close(got, ref, dtype, "qkv")

    jdq = jnp.asarray(a["dqkv"], jdt)
    dx, xn, dsc, dbi = jax_ln_qkv._b2_call(jx, jdq, jw, js, jb, 1e-6, True)
    got = ln_qkv.ln_qkv_b2_plain(tx, torch.from_numpy(a["dqkv"]).to(tdt), tw, ts, tb)
    assert got[0].dtype == got[1].dtype == tdt and got[2].dtype == got[3].dtype == torch.float32
    for name, g, r in zip(("dx", "xn", "dscale", "dbias"), got,
                          (dx, xn, jnp.sum(dsc, axis=(0, 1)), jnp.sum(dbi, axis=(0, 1)))):
        _close(g, r, dtype, name)
    # the wrappers take the plain versions on CPU tensors
    torch.testing.assert_close(ln_qkv.ln_qkv_f1(tx, ts, tb, tw, twb), ln_qkv.ln_qkv_f1_plain(tx, ts, tb, tw, twb),
                               rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("plus1", [False, True])
def test_fused_ln_qkv_attention_and_grads_match_jax(plus1, dtype):
    """The output and all five gradients (dx, dscale, dbias, dW, db) of the
    fused boundary against the JAX one; the launch counters stay 0."""
    a = _inputs(2 + plus1, dtype)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    scale = D ** -0.5

    def jf(x, s, b, w, wb):
        return jax_ln_qkv.fused_ln_qkv_attention(x, s, b, w, wb, heads=H, head_dim=D, scale=scale, plus1=plus1)

    jargs = (jnp.asarray(a["x"], jdt), jnp.asarray(a["s"]), jnp.asarray(a["b"]), jnp.asarray(a["w"]),
             jnp.asarray(a["wb"]))
    ref, vjp = jax.vjp(jf, *jargs)
    refs = vjp(jnp.asarray(a["do"], jdt))

    leaves = [torch.from_numpy(a["x"]).to(tdt), torch.from_numpy(a["s"]), torch.from_numpy(a["b"]),
              torch.from_numpy(a["w"].T.copy()), torch.from_numpy(a["wb"])]
    leaves = [t.requires_grad_() for t in leaves]
    _build.reset_launches()
    out = ln_qkv.fused_ln_qkv_attention(*leaves, heads=H, head_dim=D, scale=scale, plus1=plus1)
    grads = torch.autograd.grad(out, leaves, torch.from_numpy(a["do"]).to(tdt))
    assert not any(_build.LAUNCHES.values())
    assert out.dtype == tdt and grads[0].dtype == tdt
    assert all(g.dtype == torch.float32 for g in grads[1:])
    _close(out, ref, dtype, "out")
    for name, g, r in zip(("dx", "dscale", "dbias", "dW", "db"), grads, refs):
        _close(g.t() if name == "dW" else g, r, dtype, name)


def test_wrappers_check_shapes():
    a = _inputs(4, "float32")
    tx = torch.from_numpy(a["x"])
    ts, tb = torch.from_numpy(a["s"]), torch.from_numpy(a["b"])
    w = torch.from_numpy(a["w"])  # [C, 3C]: the JAX layout, not the port's
    with pytest.raises(ValueError, match="weight shape"):
        ln_qkv.ln_qkv_f1(tx, ts, tb, w, torch.from_numpy(a["wb"]))
    with pytest.raises(ValueError, match="dqkv shape"):
        ln_qkv.ln_qkv_b2(tx, tx, w.t(), ts, tb)
