"""The attention backward's fp32 "simt" order, emulated on the CPU, and the
choice of its path.

``csrc/attention_bwd_fp32.cu`` runs two kernels in fp32 FMA, templates on
the input dtype and on the head dim padded with zero columns to DP = 32,
64, 96 or 128: D = 64 (the fp32 training step's 12 heads), D = 32 (the
convergence demo's 6 heads at ``model.dtype=float32``), and every other
fp32 D, and bf16 / fp16 at a D that is 8 mod 16 or on unaligned views; the
tiles are 64 keys and 64 queries at every D.
Kernel S walks the keys once in tiles of 64 with a running row max
(starting at 0 under plus1), rescaling l = sum p and r = sum p dP by
exp(m_old - m_new) when the max rises, and saves m, il = 1 / l and di = r il.
Kernel KV takes 64 keys a block and walks the 64-query tiles, each block
from its own starting tile (a rotation; where it saves a round of blocks,
two blocks a key block each walk half of them); per tile it forms
P_norm = exp(s - m) il and dS = P_norm (dP - di) scale, both rounded to the
input dtype (at fp32 no rounding), adds P_norm^T dO to dV and dS^T Q to dK,
and adds its fp32 share dS K to the tile's dQ sum in a fixed order of the
blocks. The emulation below does the same in fp32 PyTorch and is held, on
the same numpy inputs, against the JAX package's Pallas kernels
(``_bwd_kernel`` and ``_flat_bwd_kernel`` in interpret mode, fp32 at
``Precision.HIGHEST``) and the port's plain version, within chip_smoke.py's
TOL_BWD, the tolerance the card holds the kernel to.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from passt_tpu.ops.pallas import attention as jax_attention
from passt_tpu_torch.ops.attention import attention_bwd_plain, backward_path, simt_head_dim

HEADS, HEAD_DIM = 2, 64
#: the D = 32 instance's case: the convergence demo's 6 heads of D = 32
DEMO_HEADS, DEMO_HEAD_DIM = 6, 32
TILE = 64  # keys a stats tile and a block of kernel KV; queries a tile, at either D
# chip_smoke.py TOL_BWD[fp32], of max|ref| of each gradient: fp32 in another
# summation order (and exp2 of a fused product for exp)
TOL = 5e-5
# chip_smoke.py TOL_BWD in bf16 / fp16: the kernel rounds P_norm for dV's
# product (the plain version and the Pallas kernel keep fp32 there), a dS
# may round the other way, and the output rounds once
TOL_HALF = {torch.bfloat16: 2.0**-6, torch.float16: 2.0**-9}


def query_tile(blk, step, tiles, rotate):
    """kv_query_tile: the query tile block ``blk`` takes at ``step``."""
    return (step - blk + tiles) % tiles if rotate else step


def position(blk, tile, tiles, rotate):
    """kv_position: block ``blk``'s place in ``tile``'s dQ order."""
    return (blk + tile) % tiles if rotate else blk


def place(blk, step, tiles, rotate, halves):
    """kv_place: the place in its tile's dQ order of block ``blk``'s
    contribution at ``step``; with the query walk split in two halves
    (half 0 the first ceil(tiles / 2) steps), 2 l + h for local step l of
    half h."""
    if halves == 1:
        return position(blk, query_tile(blk, step, tiles, rotate), tiles, rotate)
    h0 = (tiles + 1) // 2
    half = int(step >= h0)
    return 2 * (step - half * h0) + half


def kv_halves(batch, n, heads, slots):
    """kv_halves: 2 where splitting each key block's query walk in two
    halves takes fewer rounds of blocks over the card's ``slots`` (its SMs
    times the blocks of kernel KV an SM holds: one at D = 64, two at
    D = 32), and both halves of a head's key blocks fit at once."""
    tiles = -(-n // TILE)
    blocks = batch * heads * tiles
    if tiles < 2 or 2 * tiles > slots:
        return 1
    rounds, half_rounds = -(-blocks // slots), -(-2 * blocks // slots)
    return 2 if half_rounds < 2 * rounds else 1


def stats_pass(qf, kf, vf, dof, *, scale, plus1):
    """Kernel S on fp32 ``[B, N, H, D]``: m, il, di ``[B, H, N, 1]``."""
    b, n, h, _ = qf.shape
    m = torch.full((b, h, n, 1), 0.0 if plus1 else -torch.inf)
    l = torch.zeros((b, h, n, 1))
    r = torch.zeros((b, h, n, 1))
    for k0 in range(0, n, TILE):
        s = torch.einsum("bnhd,bmhd->bhnm", qf, kf[:, k0:k0 + TILE]) * scale
        dp = torch.einsum("bnhd,bmhd->bhnm", dof, vf[:, k0:k0 + TILE])
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


def simt_backward(q, k, v, do, *, scale, plus1, rotate=True, halves=1, dp=None):
    """The "simt" path's order on ``[B, N, H, D]``: dq, dk, dv in the input
    dtype. With two halves, kernel KV's query walk is split in two (two
    blocks a key block): dK and dV summed half 0 first, dQ in ``place``
    order. With ``dp``, the head dim padded with zero columns to ``dp`` as
    the kernels hold it, sliced back at the end. P_norm and dS are rounded
    to the input dtype as the products' operands (at fp32 the identity)."""
    dtype, d = q.dtype, q.shape[-1]
    q, k, v, do = (torch.nn.functional.pad(x.float(), (0, (dp or d) - d)) for x in (q, k, v, do))
    b, n, h, dpad = q.shape
    m, il, di = stats_pass(q, k, v, do, scale=scale, plus1=plus1)
    tiles = -(-n // TILE)
    h0 = (tiles + 1) // 2 if halves == 2 else tiles
    dk = torch.zeros((b, h, n, dpad))
    dv = torch.zeros((b, h, n, dpad))
    parts = {}  # (tile, block) -> the block's fp32 share of that tile's dQ and its place
    for blk in range(tiles):
        ks = slice(blk * TILE, (blk + 1) * TILE)
        halves_kv = []
        for steps in ((range(h0), range(h0, tiles)) if halves == 2 else (range(tiles),)):
            dk_h = torch.zeros((b, h, min(n, (blk + 1) * TILE) - blk * TILE, dpad))
            dv_h = torch.zeros_like(dk_h)
            for step in steps:
                i = query_tile(blk, step, tiles, rotate)
                qs = slice(i * TILE, (i + 1) * TILE)
                s_t = torch.einsum("bmhd,bnhd->bhmn", k[:, ks], q[:, qs]) * scale
                dp_t = torch.einsum("bmhd,bnhd->bhmn", v[:, ks], do[:, qs])
                pn = torch.exp(s_t - m[:, :, qs].transpose(-1, -2)) * il[:, :, qs].transpose(-1, -2)
                ds = (pn * (dp_t - di[:, :, qs].transpose(-1, -2)) * scale).to(dtype).float()
                dv_h += torch.einsum("bhmn,bnhd->bhmd", pn.to(dtype).float(), do[:, qs])
                dk_h += torch.einsum("bhmn,bnhd->bhmd", ds, q[:, qs])
                parts[i, blk] = (torch.einsum("bhmn,bmhd->bhnd", ds, k[:, ks]),
                                 place(blk, step, tiles, rotate, halves))
            halves_kv.append((dk_h, dv_h))
        dk[:, :, ks] = halves_kv[0][0] + halves_kv[1][0] if halves == 2 else halves_kv[0][0]
        dv[:, :, ks] = halves_kv[0][1] + halves_kv[1][1] if halves == 2 else halves_kv[0][1]
    dq = torch.zeros((b, h, n, dpad))
    for i in range(tiles):
        order = sorted((parts[i, blk] for blk in range(tiles)), key=lambda part: part[1])
        assert [pl for _, pl in order] == list(range(tiles))
        acc = order[0][0]
        for share, _ in order[1:]:
            acc = acc + share
        dq[:, :, i * TILE:(i + 1) * TILE] = acc
    return tuple(x.transpose(1, 2)[..., :d].to(dtype) for x in (dq, dk, dv))


def _jax_grads(qkv, do, scale, plus1, heads=HEADS, head_dim=HEAD_DIM, dtype="float32"):
    """The JAX package's two backward kernels (interpret mode, in ``dtype``)
    on the same inputs: dq, dk, dv of the [B, N, H, D] entry and of the qkv
    entry, as fp32."""
    b, n, _ = qkv.shape
    jqkv, jdo = jnp.asarray(qkv, dtype=jnp.dtype(dtype)), jnp.asarray(do, dtype=jnp.dtype(dtype))
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


def _hold(got, refs, tol=TOL):
    for name, g, r in zip(("dq", "dk", "dv"), got, refs):
        g, r = g.float(), r.float()
        err = float((g - r).abs().max())
        assert err <= tol * float(r.abs().max()), f"{name}: {err:.3g} of max|ref| {float(r.abs().max()):.3g}"


# (n, plus1, D): D = 64 at 2 heads, D = 32 at the demo's 6 (also at its
# training N = 79: two query tiles, the walk split in halves there); the
# D = 64 cases keep their ids
SIMT_CASES = [(n, plus1, 64) for n in (14, 65, 129, 200) for plus1 in (False, True)]
SIMT_CASES += [(n, plus1, 32) for n in (14, 65, 79, 129, 200) for plus1 in (False, True)]


@pytest.mark.parametrize("n, plus1, d", SIMT_CASES,
                         ids=[f"{n}-{plus1}" + ("" if d == 64 else f"-d{d}") for n, plus1, d in SIMT_CASES])
def test_simt_order_matches_pallas_and_plain(n, plus1, d):
    heads = HEADS if d == HEAD_DIM else DEMO_HEADS
    rng = np.random.default_rng(3 * n + plus1 + (d != HEAD_DIM))
    qkv = rng.standard_normal((1, n, 3 * heads * d)).astype(np.float32)
    do = rng.standard_normal((1, n, heads * d)).astype(np.float32)
    scale = d ** -0.5
    q, k, v = torch.from_numpy(qkv).reshape(1, n, 3, heads, d).unbind(2)
    do4 = torch.from_numpy(do).reshape(1, n, heads, d)
    plain = attention_bwd_plain(q, k, v, do4, scale=scale, plus1=plus1)
    bnhd, flat = _jax_grads(qkv, do, scale, plus1, heads, d)
    for halves in (1, 2):  # the walks whole, and split where that saves a round of blocks
        got = simt_backward(q, k, v, do4, scale=scale, plus1=plus1, halves=halves)
        assert all(g.dtype == torch.float32 and bool(torch.isfinite(g).all()) for g in got)
        _hold(got, plain)
        _hold(got, bnhd)
        _hold(got, flat)


# (D, dtype): the padded instances from below (D = 8, 24 on DP = 32; 48 on
# 64; 96 on 96; 128) in fp32, and the half-precision instances at D = 24
PADDED_CASES = [(d, "float32") for d in (8, 24, 48, 96, 128)] + [(24, "bfloat16"), (24, "float16")]


@pytest.mark.parametrize("plus1", [False, True])
@pytest.mark.parametrize("d, dtype", PADDED_CASES)
def test_simt_order_padded_matches_pallas_and_plain(d, dtype, plus1):
    """The "simt" order at a head dim padded with zero columns, sliced back
    (N = 79: two query tiles, the walk whole and split in halves), in fp32
    and, at D = 24, in bf16 / fp16 with P_norm and dS rounded to the dtype."""
    n, heads = 79, 2
    tdt = getattr(torch, dtype)
    rng = np.random.default_rng(7 * d + plus1 + (dtype != "float32"))
    qkv = rng.standard_normal((1, n, 3 * heads * d)).astype(np.float32)
    do = rng.standard_normal((1, n, heads * d)).astype(np.float32)
    scale = d ** -0.5
    q, k, v = torch.from_numpy(qkv).to(tdt).reshape(1, n, 3, heads, d).unbind(2)
    do4 = torch.from_numpy(do).to(tdt).reshape(1, n, heads, d)
    plain = attention_bwd_plain(q, k, v, do4, scale=scale, plus1=plus1)
    bnhd, flat = _jax_grads(qkv, do, scale, plus1, heads, d, dtype)
    tol = TOL if tdt == torch.float32 else TOL_HALF[tdt]
    for halves in (1, 2):
        got = simt_backward(q, k, v, do4, scale=scale, plus1=plus1, halves=halves, dp=simt_head_dim(d))
        assert all(g.dtype == tdt and g.shape == q.shape and bool(torch.isfinite(g).all()) for g in got)
        _hold(got, plain, tol)
        _hold(got, bnhd, tol)
        _hold(got, flat, tol)


def _later_tile_raises_the_max(d):
    """Scores in the third 64-key tile far above the first two's (head dim
    ``d``): kernel S's l and sum p dP are rescaled to (almost) nothing from
    the earlier tiles, and the gradients match the exact-max plain version."""
    n = 4 * TILE
    rng = np.random.default_rng(29)
    q = torch.from_numpy(rng.standard_normal((1, n, 1, d)).astype(np.float32) * 0.2) + 1.0
    k = torch.from_numpy(rng.standard_normal((1, n, 1, d)).astype(np.float32) * 0.2)
    k[:, 2 * TILE:3 * TILE] += 1.0  # every query's max lies in the third tile
    v = torch.from_numpy(rng.standard_normal((1, n, 1, d)).astype(np.float32))
    do = torch.from_numpy(rng.standard_normal((1, n, 1, d)).astype(np.float32))
    scale = d ** -0.5
    s = torch.einsum("bnhd,bmhd->bhnm", q, k) * scale
    assert bool((s.argmax(dim=-1) // TILE == 2).all())
    m, il, _ = stats_pass(q, k, v, do, scale=scale, plus1=False)
    torch.testing.assert_close(m, s.amax(dim=-1, keepdim=True), rtol=0, atol=0)
    torch.testing.assert_close(il, 1.0 / torch.exp(s - m).sum(-1, keepdim=True), rtol=1e-6, atol=0)
    _hold(simt_backward(q, k, v, do, scale=scale, plus1=False), attention_bwd_plain(q, k, v, do, scale=scale))


def test_simt_order_when_a_later_tile_raises_the_max():
    _later_tile_raises_the_max(HEAD_DIM)


def test_simt_order_at_d32_when_a_later_tile_raises_the_max():
    """The same at the D = 32 instance's head dim."""
    _later_tile_raises_the_max(DEMO_HEAD_DIM)


@pytest.mark.parametrize(
    "batch, n, heads, slots, halves",
    [
        (2, 474, 12, 132, 2),  # the fp32 step at D = 64: 192 blocks, one an SM: 2 rounds; 384 halves 3
        (25, 79, 6, 264, 2),  # the fp32 demo at D = 32: 300 blocks, two an SM: 2 rounds; 600 halves 3
        (25, 79, 6, 132, 2),  # the same at one block an SM: 3 rounds; halves 5
        (50, 110, 6, 264, 2),  # 600 blocks: 3 rounds; 1200 halves 5
        (1, 474, 12, 132, 1),  # 96 blocks, one round; 192 halves two of half the work: no round saved
        (2, 40, 12, 132, 1),  # one query tile: no walk to split
        (1, 64 * 70, 1, 132, 1),  # 70 key blocks: both halves of a head do not fit on 132 slots
    ],
)
def test_split_walk_only_where_it_saves_a_round(batch, n, heads, slots, halves):
    assert kv_halves(batch, n, heads, slots) == halves


def test_rotated_and_plain_orders_agree():
    """The two block orders sum the same fp32 terms in another order: each
    gradient differs by fp32 rounding only."""
    n = 300
    rng = np.random.default_rng(31)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((1, n, HEADS, HEAD_DIM)).astype(np.float32))
                   for _ in range(4))
    a = simt_backward(q, k, v, do, scale=HEAD_DIM ** -0.5, plus1=True, rotate=True)
    b = simt_backward(q, k, v, do, scale=HEAD_DIM ** -0.5, plus1=True, rotate=False)
    for x, y in zip(a, b):
        assert float((x - y).abs().max()) <= 1e-6 * float(x.abs().max())


def test_split_dq_order_waits_only_on_the_same_or_the_last_step():
    """With the query walk split in two halves running side by side, each
    tile's places are a permutation of the key blocks, and each
    contribution's predecessor was made at the same local step (by half 0)
    or the one before (by half 1): the halves advance in lockstep."""
    for tiles in range(2, 70):
        h0 = (tiles + 1) // 2
        for i in range(tiles):
            at = {}
            for blk in range(tiles):
                step = (i + blk) % tiles  # the step at which blk takes tile i
                assert query_tile(blk, step, tiles, True) == i
                half = int(step >= h0)
                at[place(blk, step, tiles, True, 2)] = (step - half * h0, half)
            assert sorted(at) == list(range(tiles))
            for p in range(1, tiles):
                (l, half), (lp, hp) = at[p], at[p - 1]
                assert (lp, hp) < (l, half) and l - lp in (0, 1)


@pytest.mark.parametrize(
    "n, d, aligned, path",
    [
        (474, 64, True, "simt"),  # the fp32 training steps
        (14, 64, True, "simt"),  # one query tile
        (154, 64, True, "simt"),  # the fuse_ln_qkv fp32 step
        (97, 24, True, "simt"),  # padded to 32 (was "fma")
        (97, 128, True, "simt"),  # (was "fma")
        (97, 16, True, "simt"),  # (was "fma")
        (474, 64, False, "simt"),  # unaligned views (was "fma")
        (79, 32, True, "simt"),  # the convergence demo's training step at model.dtype=float32
        (110, 32, True, "simt"),
        (129, 32, True, "simt"),  # D = 32 at any N
        (474, 32, True, "simt"),
        (79, 32, False, "simt"),  # unaligned views (was "fma")
    ],
)
def test_fp32_backward_path(n, d, aligned, path):
    assert backward_path(n, d, torch.float32, aligned) == path


def _tensor_core_backward(n, d):
    """The bf16 / fp16 backward paths at an aligned D that is a multiple of
    16, as they stand (none of them "simt")."""
    return "resident" if d == 32 and n <= 128 else "wgmma"


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("d", range(8, 129, 8))
def test_no_backward_call_takes_fma(d, dtype, aligned):
    """No dtype, D (8 to 128 by 8), alignment or N dispatches to the old
    "fma" pair: fp32 always, and bf16 / fp16 at a D that is 8 mod 16 or
    unaligned, take "simt"; the aligned bf16 / fp16 calls at a multiple of
    16 keep their tensor-core paths."""
    for n in (1, 14, 64, 65, 97, 128, 129, 474, 1190):
        path = backward_path(n, d, dtype, aligned)
        if dtype == torch.float32 or not aligned or d % 16:
            assert path == "simt"
        else:
            assert path == _tensor_core_backward(n, d)
