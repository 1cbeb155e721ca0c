"""The port's bf16 / fp16 attention at the head dims the "wgmma" kernels take
padded (D = 16, 48, 96, 128, and D = 32 above the "resident" path's N)
against the JAX package's Pallas kernels in interpret mode, on the CPU.

On the card every aligned bf16 / fp16 call at a D that is a multiple of 16
takes the one-pass "wgmma" forward and backward (``csrc/attention_fwd.cu``,
``csrc/attention_bwd.cu``), templates on the head dim padded to DP = 32, 64
or 128 with zero columns (``wgmma_head_dim``); none takes the old "mma"
kernels. On CPU tensors the wrappers run the plain versions of those
kernels' function, which these tests hold against
``passt_tpu.ops.pallas.attention`` (interpret mode) on the same numpy inputs:
both entries, bf16 and fp16, plus1 on and off, N at one and two query tiles
and at the edges of the 64- and 128-key tiles; and a reduced PaSST in bf16
at 2 heads of D = 96 and of D = 128 against the JAX model. The kernels'
own orders are emulated in ``tests/test_torch_attention_online.py`` and
``tests/test_torch_attention_bwd_online.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from passt_tpu.models.passt import PaSSTConfig as JaxConfig
from passt_tpu.models.passt import init_passt
from passt_tpu.ops.pallas import attention as jax_attention
from passt_tpu_torch.models.passt import PaSST, PaSSTConfig
from passt_tpu_torch.models.pretrained import state_dict_from_flax
from passt_tpu_torch.ops import _build
from passt_tpu_torch.ops.attention import (
    WGMMA_HEAD_DIMS,
    backward_path,
    forward_path,
    fused_attention,
    fused_attention_qkv,
    wgmma_head_dim,
)
from passt_tpu_torch.tools.convergence_demo import OVERRIDES, REDUCED

HEADS, BATCH = 2, 2

# the forward: the same math in another summation order; a p may round the
# other way and the output rounds once: one output ulp at the element's
# magnitude, 2^-7 (bf16) or 2^-10 (fp16) below |o| = 2, doubled with each
# binade above (chip_smoke's attn_err)
ULP = {"bfloat16": 2.0**-7, "float16": 2.0**-10}
# the gradients, of max|ref| of each: dS rounds before dQ and dK on both
# sides and each gradient rounds once, so one ulp at the largest plus the
# flips (tests/test_torch_attention_bwd.py, chip_smoke's TOL_BWD)
TOL_BWD = {"bfloat16": 2.0**-6, "float16": 2.0**-9}

# (D, N): each padded instance at a ragged N inside one query tile and past
# two key tiles (of 64 keys at DP = 128, of 128 below), and D = 32 above 128
SHAPES = [(16, 65), (16, 129), (48, 65), (48, 129), (96, 65), (96, 129), (128, 65), (128, 129), (32, 129),
          (32, 200)]
CASES = [(entry, d, n, plus1, dtype) for d, n in SHAPES for entry in ("bnhd", "qkv") for plus1 in (False, True)
         for dtype in ("bfloat16", "float16")]


def _inputs(d, n, plus1, dtype):
    rng = np.random.default_rng(d + 1000 * n + 7 * plus1 + 3 * (dtype == "float16"))
    qkv = rng.standard_normal((BATCH, n, 3 * HEADS * d)).astype(np.float32)
    do = rng.standard_normal((BATCH, n, HEADS * d)).astype(np.float32)
    return qkv, do


def _jax_fn(entry, d, plus1):
    """The JAX package's kernel as a function of the raw qkv [B, N, 3C],
    returning [B, N, C]."""
    scale = d ** -0.5
    if entry == "qkv":
        return lambda x: jax_attention.fused_attention_qkv(x, heads=HEADS, head_dim=d, scale=scale, plus1=plus1,
                                                           interpret=True)

    def bnhd(x):
        b, n, _ = x.shape
        j5 = x.reshape(b, n, 3, HEADS, d)
        o = jax_attention.fused_attention(j5[:, :, 0], j5[:, :, 1], j5[:, :, 2], scale=scale, plus1=plus1,
                                          interpret=True)
        return o.reshape(b, n, HEADS * d)
    return bnhd


def _torch_fn(entry, d, plus1):
    """The port's entry as a function of the raw qkv, returning [B, N, C]."""
    scale = d ** -0.5
    if entry == "qkv":
        return lambda x: fused_attention_qkv(x, heads=HEADS, head_dim=d, scale=scale, plus1=plus1)

    def bnhd(x):
        b, n, _ = x.shape
        q, k, v = x.reshape(b, n, 3, HEADS, d).unbind(2)
        return fused_attention(q, k, v, scale=scale, plus1=plus1).reshape(b, n, HEADS * d)
    return bnhd


def _as_np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


@pytest.mark.parametrize("entry, d, n, plus1, dtype", CASES)
def test_forward_matches_pallas_interpret(entry, d, n, plus1, dtype):
    assert forward_path(n, d, getattr(torch, dtype), True) == "wgmma"
    qkv, _ = _inputs(d, n, plus1, dtype)
    ref = _as_np(_jax_fn(entry, d, plus1)(jnp.asarray(qkv, jnp.dtype(dtype))))
    _build.reset_launches()
    got = _torch_fn(entry, d, plus1)(torch.from_numpy(qkv).to(getattr(torch, dtype)))
    assert _build.LAUNCHES["fused_attention"] == _build.LAUNCHES["fused_attention_qkv"] == 0
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == ref.shape
    tol = ULP[dtype] * np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 1.0))))
    err = np.abs(got.float().numpy() - ref)
    assert (err <= tol).all(), f"max err {err.max():.3g}, {(err / tol).max():.3g} of its tolerance"


@pytest.mark.parametrize("entry, d, n, plus1, dtype", CASES)
def test_gradients_match_pallas_interpret(entry, d, n, plus1, dtype):
    assert backward_path(n, d, getattr(torch, dtype), True) == "wgmma"
    qkv, do = _inputs(d, n, plus1, dtype)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    _, vjp = jax.vjp(_jax_fn(entry, d, plus1), jnp.asarray(qkv, jdt))
    (ref,) = vjp(jnp.asarray(do, jdt))
    x = torch.from_numpy(qkv).to(tdt).requires_grad_()
    _build.reset_launches()
    (got,) = torch.autograd.grad(_torch_fn(entry, d, plus1)(x), x, torch.from_numpy(do).to(tdt))
    assert _build.LAUNCHES["fused_attention_bwd"] == _build.LAUNCHES["fused_attention_qkv_bwd"] == 0
    assert got.dtype == tdt and got.shape == x.shape
    got = got.float().numpy().reshape(BATCH, n, 3, HEADS, d)
    ref = _as_np(ref).reshape(BATCH, n, 3, HEADS, d)
    for i, name in enumerate(("dq", "dk", "dv")):
        r = ref[:, :, i]
        np.testing.assert_allclose(got[:, :, i], r, atol=TOL_BWD[dtype] * np.abs(r).max(), rtol=0, err_msg=name)


def test_wgmma_head_dims_pad_up():
    """Each head dim the "wgmma" kernels take (a multiple of 16 up to 128)
    runs on the smallest padded instance that holds it."""
    assert WGMMA_HEAD_DIMS == (32, 64, 128)
    want = {16: 32, 32: 32, 48: 64, 64: 64, 80: 128, 96: 128, 112: 128, 128: 128}
    assert {d: wgmma_head_dim(d) for d in range(16, 129, 16)} == want
    for d in range(8, 129, 8):
        dp = wgmma_head_dim(d)
        assert d <= dp and all(p < d for p in WGMMA_HEAD_DIMS if p < dp)


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", range(8, 129, 8))
def test_no_call_takes_mma(d, dtype, aligned):
    """No dtype, D (8 to 128 by 8), alignment or N dispatches to the old
    "mma" kernels, forward or backward: the aligned bf16 / fp16 calls at a
    multiple of 16 take "wgmma" (but "short" at D = 64, N <= 64 forward and
    "resident" at D = 32, N <= 128 backward), every other call "simt"."""
    for n in (1, 14, 64, 65, 79, 97, 110, 128, 129, 200, 474, 1190):
        fwd, bwd = forward_path(n, d, dtype, aligned), backward_path(n, d, dtype, aligned)
        assert "mma" not in (fwd, bwd)
        if dtype == torch.float32 or not aligned or d % 16:
            assert fwd == bwd == "simt"
        else:
            assert fwd == ("short" if d == 64 and n <= 64 else "wgmma")
            assert bwd == ("resident" if d == 32 and n <= 128 else "wgmma")


#: the convergence demo's reduced PaSST (tools/convergence_demo REDUCED, its
#: input length and the ESC-50 recipe's 50 classes) at depth 2, bf16, the
#: attention kernels' entry points
DEMO = dict(REDUCED, depth=2, input_tdim=int(OVERRIDES["model.input_tdim"]), num_classes=50,
            dtype="bfloat16", attn_impl="fused")
# bf16 in two frameworks: the port rounds where flax rounds, so the logits to
# test_torch_model.py's bf16 bound, 2e-2 (two bf16 ulps of logits below 1;
# observed 2e-3 to 5e-3). The gradients differ by more: a bias's gradient
# sums B x N bf16 values whose roundings in the residual stream differ
# between the two frameworks, and the same comparison with the attention in
# plain XLA on both sides (attn_impl="xla") reads a relative L2 error of
# 1.6e-2 to 2.3e-2 per leaf (max error up to 4.7e-2 of max|g|), the fused
# attention the same; so each leaf's relative L2 error to 5e-2, over twice
# that floor and far below the O(1) of a wrong gradient
TOL_LOGITS, TOL_GRAD_L2 = 2e-2, 5e-2


@pytest.mark.parametrize("heads, head_dim", [(2, 96), (2, 128)])
def test_reduced_passt_bf16_matches_jax(heads, head_dim):
    """The demo's arch in bf16 over 2 heads: at width 192 D = 96 (the demo
    at 2 heads, chip_smoke [20i]) and at width 256 D = 128, each on the
    "wgmma" DP = 128 instances both ways on the card at the demo's token
    counts (N = 79 in training, 110 in eval); logits and every parameter's
    gradient of sum(logits * w) against the JAX model, its Pallas attention
    interpreted, the weights carried by ``state_dict_from_flax``."""
    cfg = dict(DEMO, num_heads=heads, embed_dim=heads * head_dim)
    for n in (79, 110):
        assert forward_path(n, head_dim, torch.bfloat16, True) == backward_path(n, head_dim, torch.bfloat16,
                                                                                True) == "wgmma"
    assert wgmma_head_dim(head_dim) == 128
    jmodel, params = init_passt(JaxConfig(**cfg), jax.random.PRNGKey(5))
    params = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(24)
    x = rng.standard_normal((2, 1, 128, cfg["input_tdim"])).astype(np.float32)
    w = rng.standard_normal((2, cfg["num_classes"])).astype(np.float32)

    def loss(p):
        logits, _ = jmodel.apply({"params": p}, jnp.asarray(x), train=False)
        return jnp.sum(logits.astype(jnp.float32) * w), logits

    (_, jlogits), jgrads = jax.value_and_grad(loss, has_aux=True)(params)
    want = state_dict_from_flax(jax.tree.map(np.asarray, jgrads))

    model = PaSST(PaSSTConfig(**cfg))
    model.load_state_dict(state_dict_from_flax(params))
    model.eval()
    logits, _ = model(torch.from_numpy(x))
    (logits.float() * torch.from_numpy(w)).sum().backward()

    np.testing.assert_allclose(logits.detach().float().numpy(), np.asarray(jlogits, np.float32), atol=TOL_LOGITS,
                               rtol=0)
    got = {name: p.grad for name, p in model.named_parameters()}
    assert set(got) == set(want)
    held = 0
    for name, g in got.items():
        ref = torch.as_tensor(np.asarray(want[name], np.float32))
        if g is None:  # outside the eval forward (the distillation head): zero in JAX too
            assert not bool(ref.any()), f"{name}: no port gradient, JAX's is not zero"
            continue
        assert g.shape == ref.shape, name
        err = float(torch.linalg.vector_norm(g.float() - ref) / torch.linalg.vector_norm(ref))
        assert err <= TOL_GRAD_L2, f"{name}: relative L2 error {err:.3g}"
        held += 1
    # every leaf of the two blocks (their attention's qkv and proj among them) is held
    assert held >= 2 * 12
