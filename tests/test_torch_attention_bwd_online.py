"""The attention backward's "wgmma" order, emulated on the CPU, and the
choice of its path.

``csrc/attention_bwd.cu``'s "wgmma" path runs two kernels. Kernel S walks
the keys once in tiles of 128 with a running row max (starting at 0 under
plus1), rescaling l = sum p and r = sum p dP by exp(m_old - m_new) when the
max rises, and saves m, il = 1 / l and di = r il. Kernel KV takes 64 keys a
block and walks the 64-query tiles (each block from its own starting tile,
a rotation); per tile it rounds P_norm^T = exp(s^T - m) il and
dS^T = P_norm^T (dP^T - di) scale to the input dtype for dV and dK, and
adds its fp32 share of dQ = dS K to the tile's sum in a fixed order of the
blocks; the last rounds once. The emulation below does the same in fp32
PyTorch and is held, on the same numpy inputs, against the JAX package's
Pallas kernels (``_bwd_kernel`` and ``_flat_bwd_kernel``, interpret mode)
and the port's plain version, within chip_smoke.py's TOL_BWD, the tolerance
the card holds the kernel to.

The "resident" path (D = 32, N <= 128: the convergence demo's backward)
holds a whole head in one block and takes the plain version's order with
exact statistics; it rounds P_norm to the input dtype for dV (the plain
version keeps dO / l in fp32 there) and dS for dQ and dK.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from passt_tpu.ops.pallas import attention as jax_attention
from passt_tpu_torch.ops.attention import attention_bwd_plain, backward_path

HEADS, HEAD_DIM = 2, 64
STATS_TILE = 128  # ST_BK in csrc/attention_bwd.cu
BLOCK = 64  # keys a block of kernel KV, and queries a tile
# chip_smoke.py TOL_BWD, of max|ref| of each gradient: one output ulp at the
# largest gradient plus the P_norm rounding
TOL_BWD = {torch.bfloat16: 2.0**-6, torch.float16: 2.0**-9}


def query_tile(blk, step, tiles, rotate):
    """kv_query_tile: the query tile block ``blk`` takes at ``step``."""
    return (step - blk + tiles) % tiles if rotate else step


def position(blk, tile, tiles, rotate):
    """kv_position: block ``blk``'s place in ``tile``'s dQ order (as many
    blocks as tiles)."""
    return (blk + tile) % tiles if rotate else blk


def stats_pass(qf, kf, vf, dof, *, scale, plus1, tile=STATS_TILE):
    """Kernel S on fp32 ``[B, N, H, D]``: m, il, di ``[B, H, N, 1]``."""
    b, n, h, _ = qf.shape
    m = torch.full((b, h, n, 1), 0.0 if plus1 else -torch.inf)
    l = torch.zeros((b, h, n, 1))
    r = torch.zeros((b, h, n, 1))
    for k0 in range(0, n, tile):
        s = torch.einsum("bnhd,bmhd->bhnm", qf, kf[:, k0:k0 + tile]) * scale
        dp = torch.einsum("bnhd,bmhd->bhnm", dof, vf[:, k0:k0 + tile])
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        r = r * alpha + (p * dp).sum(dim=-1, keepdim=True)
        m = m_new
    if plus1:
        l = l + torch.exp(-m)
    il = 1.0 / l
    return m, il, r * il


def wgmma_backward(q, k, v, do, *, scale, plus1, rotate=True):
    """The "wgmma" path's order on ``[B, N, H, D]``; dq, dk, dv in the input
    dtype."""
    dtype = q.dtype
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    b, n, h, d = q.shape
    m, il, di = stats_pass(qf, kf, vf, dof, scale=scale, plus1=plus1)
    tiles = -(-n // BLOCK)
    blocks = tiles
    dk = torch.zeros((b, h, n, d))
    dv = torch.zeros((b, h, n, d))
    parts = {}  # (tile, block) -> the block's fp32 share of that tile's dQ
    for blk in range(blocks):
        ks = slice(blk * BLOCK, (blk + 1) * BLOCK)
        for step in range(tiles):
            i = query_tile(blk, step, tiles, rotate)
            qs = slice(i * BLOCK, (i + 1) * BLOCK)
            s_t = torch.einsum("bmhd,bnhd->bhmn", kf[:, ks], qf[:, qs]) * scale
            dp_t = torch.einsum("bmhd,bnhd->bhmn", vf[:, ks], dof[:, qs])
            pn = torch.exp(s_t - m[:, :, qs].transpose(-1, -2)) * il[:, :, qs].transpose(-1, -2)
            ds = pn * (dp_t - di[:, :, qs].transpose(-1, -2)) * scale
            pn, ds = pn.to(dtype).float(), ds.to(dtype).float()
            dv[:, :, ks] += torch.einsum("bhmn,bnhd->bhmd", pn, dof[:, qs])
            dk[:, :, ks] += torch.einsum("bhmn,bnhd->bhmd", ds, qf[:, qs])
            parts[i, blk] = torch.einsum("bhmn,bmhd->bhnd", ds, kf[:, ks])
    dq = torch.zeros((b, h, n, d))
    for i in range(tiles):
        order = sorted(range(blocks), key=lambda blk: position(blk, i, tiles, rotate))
        acc = parts[i, order[0]]
        for blk in order[1:]:
            acc = acc + parts[i, blk]
        dq[:, :, i * BLOCK:(i + 1) * BLOCK] = acc
    return tuple(x.transpose(1, 2).to(dtype) for x in (dq, dk, dv))


def resident_backward(q, k, v, do, *, scale, plus1):
    """The "resident" path's order on ``[B, N, H, D]``: the exact row
    statistics over all keys (m clamped at 0 under plus1, l, il, and di from
    the unrounded p), P_norm = p il and dS = P_norm (dP - di) scale each
    rounded to the input dtype in one step; dV = P_norm^T dO, dQ = dS K,
    dK = dS^T Q, each one fp32 sum over all tokens, rounded once."""
    dtype = q.dtype
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    s = torch.einsum("bnhd,bmhd->bhnm", qf, kf) * scale
    m = s.amax(dim=-1, keepdim=True)
    if plus1:
        m = torch.clamp(m, min=0.0)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    if plus1:
        l = l + torch.exp(-m)
    il = 1.0 / l
    dp = torch.einsum("bnhd,bmhd->bhnm", dof, vf)
    di = (p * dp).sum(dim=-1, keepdim=True) * il
    pn = p * il
    ds = (pn * (dp - di) * scale).to(dtype).float()
    pn = pn.to(dtype).float()
    dv = torch.einsum("bhnm,bnhd->bmhd", pn, dof)
    dq = torch.einsum("bhnm,bmhd->bnhd", ds, kf)
    dk = torch.einsum("bhnm,bnhd->bmhd", ds, qf)
    return dq.to(dtype), dk.to(dtype), dv.to(dtype)


def _jax_grads(qkv, do, dtype, scale, plus1, heads=HEADS, head_dim=HEAD_DIM):
    """The JAX package's two backward kernels (interpret mode) on the same
    inputs: dq, dk, dv of the [B, N, H, D] entry and of the qkv entry."""
    b, n, _ = qkv.shape
    jdt = jnp.dtype(dtype)
    jqkv, jdo = jnp.asarray(qkv, jdt), jnp.asarray(do, jdt)
    j5 = jqkv.reshape(b, n, 3, heads, head_dim)
    _, vjp = jax.vjp(
        lambda q, k, v: jax_attention.fused_attention(q, k, v, scale=scale, plus1=plus1, interpret=True),
        j5[:, :, 0], j5[:, :, 1], j5[:, :, 2])
    bnhd = vjp(jdo.reshape(b, n, heads, head_dim))
    _, vjp = jax.vjp(
        lambda x: jax_attention.fused_attention_qkv(
            x, heads=heads, head_dim=head_dim, scale=scale, plus1=plus1, interpret=True),
        jqkv)
    (flat,) = vjp(jdo)
    flat = flat.reshape(b, n, 3, heads, head_dim)
    as_torch = lambda x: torch.from_numpy(np.array(x.astype(jnp.float32)))
    return [as_torch(x) for x in bnhd], [as_torch(flat[:, :, j]) for j in range(3)]


def _hold(got, refs, dtype):
    for name, g, r in zip(("dq", "dk", "dv"), got, refs):
        r = r.float()
        err = float((g.float() - r).abs().max())
        assert err <= TOL_BWD[dtype] * float(r.abs().max()), f"{name}: {err:.3g} of max|ref| {float(r.abs().max()):.3g}"


@pytest.mark.parametrize(
    "n, plus1, dtype",
    [(n, plus1, "bfloat16") for n in (1, 16, 65, 79, 110, 128) for plus1 in (False, True)]
    + [(n, plus1, "float16") for n in (79, 128) for plus1 in (False, True)],
)
def test_resident_order_matches_pallas_and_plain(n, plus1, dtype):
    heads, d = 6, 32
    rng = np.random.default_rng(11 * n + plus1)
    qkv = rng.standard_normal((2, n, 3 * heads * d)).astype(np.float32)
    do = rng.standard_normal((2, n, heads * d)).astype(np.float32)
    tdt = getattr(torch, dtype)
    scale = d ** -0.5
    q, k, v = torch.from_numpy(qkv).to(tdt).reshape(2, n, 3, heads, d).unbind(2)
    do4 = torch.from_numpy(do).to(tdt).reshape(2, n, heads, d)
    got = resident_backward(q, k, v, do4, scale=scale, plus1=plus1)
    assert all(g.dtype == tdt and bool(torch.isfinite(g).all()) for g in got)
    assert backward_path(n, d, tdt, True) == "resident"

    plain = attention_bwd_plain(q, k, v, do4, scale=scale, plus1=plus1)
    # dQ and dK: the same order as the plain version's, term for term
    assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])
    _hold(got, plain, tdt)
    bnhd, flat = _jax_grads(qkv, do, dtype, scale, plus1, heads, d)
    _hold(got, bnhd, tdt)
    _hold(got, flat, tdt)


@pytest.mark.parametrize(
    "n, plus1, dtype",
    [(n, plus1, "bfloat16") for n in (14, 65, 128, 129, 474) for plus1 in (False, True)]
    + [(n, True, "float16") for n in (14, 129, 474)],
)
def test_wgmma_order_matches_pallas_and_plain(n, plus1, dtype):
    rng = np.random.default_rng(n + 5 * plus1)
    qkv = rng.standard_normal((1, n, 3 * HEADS * HEAD_DIM)).astype(np.float32)
    do = rng.standard_normal((1, n, HEADS * HEAD_DIM)).astype(np.float32)
    tdt = getattr(torch, dtype)
    scale = HEAD_DIM ** -0.5
    q, k, v = torch.from_numpy(qkv).to(tdt).reshape(1, n, 3, HEADS, HEAD_DIM).unbind(2)
    do4 = torch.from_numpy(do).to(tdt).reshape(1, n, HEADS, HEAD_DIM)
    got = wgmma_backward(q, k, v, do4, scale=scale, plus1=plus1)
    assert all(g.dtype == tdt and bool(torch.isfinite(g).all()) for g in got)

    _hold(got, attention_bwd_plain(q, k, v, do4, scale=scale, plus1=plus1), tdt)
    bnhd, flat = _jax_grads(qkv, do, dtype, scale, plus1)
    _hold(got, bnhd, tdt)
    _hold(got, flat, tdt)


def test_wgmma_order_when_a_later_tile_raises_the_max():
    """Scores in the second 128-key tile far above the first's: kernel S's
    l and sum p dP are rescaled to (almost) nothing from the first tile, and
    the gradients match the exact-max plain version as they do elsewhere."""
    n = 3 * STATS_TILE
    rng = np.random.default_rng(17)
    q = torch.from_numpy(rng.standard_normal((1, n, 1, HEAD_DIM)).astype(np.float32) * 0.2)
    k = torch.from_numpy(rng.standard_normal((1, n, 1, HEAD_DIM)).astype(np.float32) * 0.2)
    k[:, STATS_TILE:2 * STATS_TILE] += 1.0  # every query's max lies in the second tile
    q = q + 1.0
    v = torch.from_numpy(rng.standard_normal((1, n, 1, HEAD_DIM)).astype(np.float32))
    do = torch.from_numpy(rng.standard_normal((1, n, 1, HEAD_DIM)).astype(np.float32))
    q, k, v, do = (x.to(torch.bfloat16) for x in (q, k, v, do))
    scale = HEAD_DIM ** -0.5
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    s = torch.einsum("bnhd,bmhd->bhnm", qf, kf) * scale
    first, second = s[..., :STATS_TILE].amax(-1), s[..., STATS_TILE:2 * STATS_TILE].amax(-1)
    assert bool((s.argmax(dim=-1) // STATS_TILE == 1).all()) and float((second - first).min()) > 3
    m, il, di = stats_pass(qf, kf, vf, dof, scale=scale, plus1=False)
    torch.testing.assert_close(m, s.amax(dim=-1, keepdim=True), rtol=0, atol=0)
    p = torch.exp(s - m)
    torch.testing.assert_close(il, 1.0 / p.sum(-1, keepdim=True), rtol=1e-6, atol=0)
    _hold(wgmma_backward(q, k, v, do, scale=scale, plus1=False),
          attention_bwd_plain(q, k, v, do, scale=scale, plus1=False), torch.bfloat16)


@pytest.mark.parametrize("rotate", [True, False])
def test_dq_order_is_fixed_and_waits_only_backwards(rotate):
    """The dQ order the kernel follows, for every tile count up to 40: each
    block walks every query tile once; each tile's order is a permutation
    of the blocks; with the rotation every block's predecessor took the
    tile at an earlier step (so in lockstep no block waits) and a block's
    place in a tile's order is the step at which it takes the tile, without
    it every predecessor has a lower index (dispatched first)."""
    for tiles in range(1, 41):
        blocks = tiles
        seen = {}
        for blk in range(blocks):
            walk = [query_tile(blk, s, tiles, rotate) for s in range(tiles)]
            assert sorted(walk) == list(range(tiles))
            for s, i in enumerate(walk):
                seen[i, blk] = s
        for i in range(tiles):
            order = sorted(range(blocks), key=lambda blk: position(blk, i, tiles, rotate))
            assert [position(blk, i, tiles, rotate) for blk in order] == list(range(blocks))
            if rotate:
                assert all(position(blk, i, tiles, rotate) == seen[i, blk] for blk in range(blocks))
            for prev, blk in zip(order, order[1:]):
                assert seen[i, prev] < seen[i, blk] if rotate else prev < blk


def test_rotated_and_plain_orders_agree():
    """The two orders sum the same fp32 terms in another order (dQ's
    partials across blocks, dK's and dV's across query tiles): each
    gradient differs by at most one rounding of the input dtype."""
    n = 474
    rng = np.random.default_rng(23)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((1, n, HEADS, HEAD_DIM)).astype(np.float32)).to(torch.bfloat16)
                   for _ in range(4))
    a = wgmma_backward(q, k, v, do, scale=HEAD_DIM ** -0.5, plus1=True, rotate=True)
    b = wgmma_backward(q, k, v, do, scale=HEAD_DIM ** -0.5, plus1=True, rotate=False)
    for x, y in zip(a, b):
        assert float((x.float() - y.float()).abs().max()) <= 2.0**-8 * float(x.float().abs().max())


@pytest.mark.parametrize(
    "n, d, dtype, aligned, path",
    [
        (474, 64, torch.bfloat16, True, "wgmma"),  # the bf16 training step
        (14, 64, torch.bfloat16, True, "wgmma"),  # one query tile
        (1190, 64, torch.float16, True, "wgmma"),
        (474, 64, torch.float32, True, "simt"),  # the fp32 steps (csrc/attention_bwd_fp32.cu)
        (474, 64, torch.bfloat16, False, "simt"),  # unaligned strides (was "fma")
        (97, 16, torch.bfloat16, True, "wgmma"),  # padded to DP = 32 (was "mma")
        (97, 48, torch.float16, True, "wgmma"),  # DP = 64 (was "mma")
        (97, 128, torch.float16, True, "wgmma"),  # DP = 128 (was "mma")
        (97, 24, torch.bfloat16, True, "simt"),  # 8 mod 16 (was "fma")
        (97, 56, torch.float16, True, "simt"),
        (79, 32, torch.bfloat16, True, "resident"),  # the convergence demo's training step
        (128, 32, torch.float16, True, "resident"),
        (1, 32, torch.bfloat16, True, "resident"),
        (129, 32, torch.bfloat16, True, "wgmma"),  # past one block's 128 tokens (was "mma")
        (79, 32, torch.float32, True, "simt"),  # fp32 D = 32: the simt template (was "fma")
        (79, 32, torch.bfloat16, False, "simt"),  # unaligned strides (was "fma")
    ],
)
def test_backward_path(n, d, dtype, aligned, path):
    assert backward_path(n, d, dtype, aligned) == path
