"""The attention forward kernel's one-pass order, emulated on the CPU, and
the choice of its path.

``csrc/attention_fwd.cu``'s "wgmma" path (D = 64, and D = 32 at any N)
walks the keys in tiles of 128 with a running row max (starting at 0 under plus1), rounds p = exp(s - m)
to the input dtype against that running max for the PV product, and
rescales its fp32 accumulator and row sum by exp(m_old - m_new) whenever
the max rises. ``csrc/attention_fwd_fp32.cu``'s "simt" path (every fp32
call, and bf16 / fp16 at a D that is 8 mod 16 or on unaligned views) takes
the same order over tiles of 64 keys, at the head dim padded to 32, 64, 96
or 128 with zero columns (at fp32 rounding p is the identity). The
emulation below does the same in fp32 PyTorch and is held,
on the same numpy inputs, against the JAX package's Pallas kernel in
interpret mode (fp32 at Precision.HIGHEST) and against the port's plain
version (exact max), within chip_smoke.py's TOL_ATTN for bf16 / fp16, the
tolerance the card holds the kernel to, and within 1e-5 for fp32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from passt_tpu.ops.pallas import attention as jax_attention
from passt_tpu_torch.ops.attention import (
    SIMT_HEAD_DIMS,
    _aligned,
    _head_views,
    attention_plain,
    forward_path,
    simt_head_dim,
)

HEADS, HEAD_DIM = 2, 64
KEY_TILE = 128  # WG_BK in csrc/attention_fwd.cu
KEY_TILE_FP32 = 64  # the "simt" kernel's key tile, csrc/attention_fwd_fp32.cu
# chip_smoke.py TOL_ATTN: a p may round the other way and the output may
# round the other way: one output ulp at |o| < 2. fp32 rounds nothing to the
# input dtype: the running max's rescale and the summation order move only
# fp32 ulps of o (|o| < 4 here), held as tests/test_torch_attention.py holds
# fp32
TOL_ATTN = {torch.bfloat16: 2.0**-7, torch.float16: 2.0**-10, torch.float32: 1e-5}


def online_attention(q, k, v, *, scale, plus1, tile=KEY_TILE):
    """The wgmma path's order on ``[B, N, H, D]``: fp32 scores and softmax,
    a running max over key tiles, p rounded to the input dtype against the
    running max, acc and l rescaled in fp32; o = acc / l rounded once."""
    dtype = q.dtype
    qf, kf, vf = q.float(), k.float(), v.float()
    b, n, h, d = q.shape
    m = torch.full((b, h, n, 1), 0.0 if plus1 else -torch.inf)
    l = torch.zeros((b, h, n, 1))
    acc = torch.zeros((b, h, n, d))
    for k0 in range(0, n, tile):
        s = torch.einsum("bnhd,bmhd->bhnm", qf, kf[:, k0:k0 + tile]) * scale
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhnm,bmhd->bhnd", p.to(dtype).float(), vf[:, k0:k0 + tile])
        m = m_new
    if plus1:
        l = l + torch.exp(-m)
    return (acc / l).transpose(1, 2).to(dtype)


@pytest.mark.parametrize("n", [97, 474, 1190])
@pytest.mark.parametrize("plus1", [False, True])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_online_order_matches_pallas_and_plain(dtype, plus1, n):
    rng = np.random.default_rng(n + 7 * plus1)
    qkv = rng.standard_normal((1, n, 3 * HEADS * HEAD_DIM)).astype(np.float32)
    tdt = getattr(torch, dtype)
    q, k, v = torch.from_numpy(qkv).to(tdt).reshape(1, n, 3, HEADS, HEAD_DIM).unbind(2)
    scale = HEAD_DIM ** -0.5
    tile = KEY_TILE_FP32 if tdt == torch.float32 else KEY_TILE
    got = online_attention(q, k, v, scale=scale, plus1=plus1, tile=tile)
    assert got.dtype == tdt and bool(torch.isfinite(got).all())

    plain = attention_plain(q, k, v, scale=scale, plus1=plus1)
    j5 = jnp.asarray(qkv, dtype=jnp.dtype(dtype)).reshape(1, n, 3, HEADS, HEAD_DIM)
    ref = jax_attention.fused_attention(
        j5[:, :, 0], j5[:, :, 1], j5[:, :, 2], scale=scale, plus1=plus1, interpret=True
    )
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32)))
    for other in (plain.float(), ref):
        assert float((got.float() - other).abs().max()) <= TOL_ATTN[tdt]


@pytest.mark.parametrize("n", [79, 110, 200])
@pytest.mark.parametrize("plus1", [False, True])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_online_order_at_d32_matches_pallas_and_plain(dtype, plus1, n):
    """The D = 32 instances of the "wgmma" path (bf16 / fp16) and of the
    "simt" path (fp32) at the convergence demo's 6 heads of D = 32: in
    bf16 / fp16 one 128-key tile at N = 79 and 110, where the running max is
    the exact max, two at N = 200; in fp32 two 64-key tiles at N = 79 and
    110, four at N = 200."""
    heads, d = 6, 32
    rng = np.random.default_rng(3 * n + plus1)
    qkv = rng.standard_normal((2, n, 3 * heads * d)).astype(np.float32)
    tdt = getattr(torch, dtype)
    q, k, v = torch.from_numpy(qkv).to(tdt).reshape(2, n, 3, heads, d).unbind(2)
    scale = d ** -0.5
    tile = KEY_TILE_FP32 if tdt == torch.float32 else KEY_TILE
    got = online_attention(q, k, v, scale=scale, plus1=plus1, tile=tile)
    assert got.dtype == tdt and bool(torch.isfinite(got).all())
    if n <= tile:
        # one tile: the same order as the plain version's exact max
        assert torch.equal(got, attention_plain(q, k, v, scale=scale, plus1=plus1))
    ref = jax_attention.fused_attention_qkv(jnp.asarray(qkv, dtype=jnp.dtype(dtype)), heads=heads, head_dim=d,
                                            scale=scale, plus1=plus1, interpret=True)
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32))).reshape(2, n, heads, d)
    for other in (attention_plain(q, k, v, scale=scale, plus1=plus1).float(), ref):
        assert float((got.float() - other).abs().max()) <= TOL_ATTN[tdt]


def _padded(x, dp):
    """``x`` [B, N, H, d] with zero columns up to ``dp``, as the "simt"
    kernels hold it in shared memory."""
    return torch.nn.functional.pad(x, (0, dp - x.shape[-1]))


# (D, dtype): the "simt" instances' padded head dims from below (D = 8, 24
# on DP = 32; 48 on 64; 96 on 96 itself; 128) in fp32, and the half-precision
# instances at D = 24, 8 mod 16
PADDED_CASES = [(d, "float32") for d in (8, 24, 48, 96, 128)] + [(24, "bfloat16"), (24, "float16")]


@pytest.mark.parametrize("plus1", [False, True])
@pytest.mark.parametrize("d, dtype", PADDED_CASES)
def test_online_order_padded_matches_pallas_and_plain(d, dtype, plus1):
    """The "simt" order at a head dim padded with zero columns (the padded
    emulation sliced back to D), at N = 97 (two 64-key tiles, the second
    ragged), through the qkv entry of the Pallas kernel interpreted."""
    n, heads = 97, 2
    dp = simt_head_dim(d)
    rng = np.random.default_rng(5 * d + plus1)
    qkv = rng.standard_normal((2, n, 3 * heads * d)).astype(np.float32)
    tdt = getattr(torch, dtype)
    q, k, v = torch.from_numpy(qkv).to(tdt).reshape(2, n, 3, heads, d).unbind(2)
    scale = d ** -0.5
    got = online_attention(*(_padded(x, dp) for x in (q, k, v)), scale=scale, plus1=plus1,
                           tile=KEY_TILE_FP32)[..., :d]
    assert got.dtype == tdt and bool(torch.isfinite(got).all())
    ref = jax_attention.fused_attention_qkv(jnp.asarray(qkv, dtype=jnp.dtype(dtype)), heads=heads, head_dim=d,
                                            scale=scale, plus1=plus1, interpret=True)
    ref = torch.from_numpy(np.array(ref.astype(jnp.float32))).reshape(2, n, heads, d)
    for other in (attention_plain(q, k, v, scale=scale, plus1=plus1).float(), ref):
        assert float((got.float() - other).abs().max()) <= TOL_ATTN[tdt]


def test_simt_head_dims_pad_up():
    """Each head dim the kernels take (a multiple of 8 up to 128) runs on the
    smallest padded instance at least as wide."""
    assert SIMT_HEAD_DIMS == (32, 64, 96, 128)
    for d in range(8, 129, 8):
        dp = simt_head_dim(d)
        assert dp >= d and dp - d < 32 and dp in SIMT_HEAD_DIMS


def test_online_order_rescales_when_the_max_rises():
    """A key tile after the first with far larger scores: the first tile's
    contribution is rescaled to (almost) nothing, as with the exact max."""
    n, d = 2 * KEY_TILE, HEAD_DIM
    q = torch.ones((1, n, 1, d), dtype=torch.bfloat16)
    k = torch.zeros((1, n, 1, d), dtype=torch.bfloat16)
    k[:, KEY_TILE:] = 1.0
    v = torch.zeros((1, n, 1, d), dtype=torch.bfloat16)
    v[:, KEY_TILE:] = 1.0
    got = online_attention(q, k, v, scale=1.0, plus1=False)
    plain = attention_plain(q, k, v, scale=1.0, plus1=False)
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(), atol=2.0**-7, rtol=0)
    assert float(got.float().min()) > 0.99


@pytest.mark.parametrize(
    "n, d, dtype, aligned, path",
    [
        (1190, 64, torch.bfloat16, True, "wgmma"),  # serving
        (474, 64, torch.bfloat16, True, "wgmma"),  # training, the qkv entry
        (154, 64, torch.float16, True, "wgmma"),
        (14, 64, torch.bfloat16, True, "short"),  # timestamp windows
        (64, 64, torch.bfloat16, True, "short"),
        (65, 64, torch.bfloat16, True, "wgmma"),
        (474, 64, torch.float32, True, "simt"),  # the fp32 steps
        (1190, 64, torch.float32, True, "simt"),  # fp32 serving and the exported program
        (1, 64, torch.float32, True, "simt"),
        (474, 64, torch.float32, False, "simt"),  # unaligned views (was "fma")
        (97, 32, torch.float32, True, "simt"),  # fp32 D = 32: the simt template (was "fma")
        (97, 16, torch.bfloat16, True, "wgmma"),  # padded to DP = 32 (was "mma")
        (97, 128, torch.float16, True, "wgmma"),  # DP = 128 (was "mma")
        (97, 24, torch.bfloat16, True, "simt"),  # 8 mod 16: the simt template on bf16 (was "fma")
        (1190, 64, torch.bfloat16, False, "simt"),  # unaligned strides (was "fma")
        (79, 32, torch.bfloat16, True, "wgmma"),  # the convergence demo's training step
        (110, 32, torch.float16, True, "wgmma"),  # and its eval
        (129, 32, torch.bfloat16, True, "wgmma"),  # D = 32 at any N
        (1, 32, torch.bfloat16, True, "wgmma"),
        (79, 32, torch.float32, True, "simt"),  # the demo at model.dtype=float32: fp32 D = 32 (was "fma")
        (79, 32, torch.bfloat16, False, "simt"),
        (110, 32, torch.float32, True, "simt"),  # the fp32 demo's eval
        (129, 32, torch.float32, True, "simt"),  # fp32 D = 32 at any N
        (1, 32, torch.float32, True, "simt"),
        (1190, 32, torch.float32, True, "simt"),
        (79, 32, torch.float32, False, "simt"),  # unaligned views (was "fma")
        (97, 24, torch.float32, True, "simt"),  # fp32 at another D: padded to 32 (was "fma")
        (97, 16, torch.float32, True, "simt"),
        (97, 128, torch.float32, True, "simt"),
    ],
)
def test_forward_path(n, d, dtype, aligned, path):
    assert forward_path(n, d, dtype, aligned) == path


def _tensor_core_forward(n, d):
    """The bf16 / fp16 forward paths at an aligned D that is a multiple of
    16, as they stand (none of them "simt")."""
    return "short" if d == 64 and n <= 64 else "wgmma"


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", range(8, 129, 8))
def test_no_forward_call_takes_fma(d, dtype, aligned):
    """No dtype, D (8 to 128 by 8), alignment or N dispatches to the old
    "fma" kernel: fp32 always, and bf16 / fp16 at a D that is 8 mod 16 or
    unaligned, take "simt"; the aligned bf16 / fp16 calls at a multiple of
    16 keep their tensor-core paths."""
    for n in (1, 14, 64, 65, 97, 129, 474, 1190):
        path = forward_path(n, d, dtype, aligned)
        if dtype == torch.float32 or not aligned or d % 16:
            assert path == "simt"
        else:
            assert path == _tensor_core_forward(n, d)


def test_aligned_views():
    """The qkv entry's head views of a contiguous [B, N, 3C] tensor meet the
    tensor-core paths' alignment; a view one element off does not."""
    qkv = torch.zeros((2, 97, 3 * HEADS * HEAD_DIM), dtype=torch.bfloat16)
    assert _aligned(*_head_views(qkv, HEADS, HEAD_DIM))
    assert _aligned(*qkv.reshape(2, 97, 3, HEADS, HEAD_DIM).unbind(2))
    shifted = torch.zeros(qkv.numel() + 1, dtype=torch.bfloat16)[1:].view(qkv.shape)
    assert not _aligned(*_head_views(shifted, HEADS, HEAD_DIM))
