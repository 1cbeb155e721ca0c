"""The F1 kernels' orders (csrc/ln_qkv.cu: the statistics prologue, the
bf16/fp16 F1 on wgmma and the fp32 F1 on the shared FMA loop), emulated in
PyTorch on the CPU, against the JAX package's F1 kernel in interpret mode and
the port's plain version.

The emulation follows the kernels: each row's statistics summed as one warp
sums them (lane l adds its 16-byte chunks l, l + 32, ... in order, x and the
rounded x * x, then a butterfly over the lanes), the fast variance clamped
at 0; xn = ((x - mu) * rstd) * s + b in fp32, rounded to the dtype before the
product; in bf16 the output tiles of ``f1_tile`` (each an fp32 product over
the whole K), the sum rounded to the dtype and the bias added in the dtype;
in fp32 the K split of ``f1_fp32_split``, the ranges' partials added in rank
order, then the bias. Tolerances are chip_smoke's: ``TOL_QKV`` of max|ref|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from passt_tpu.ops.pallas import ln_qkv as jax_ln_qkv
from passt_tpu_torch.ops import ln_qkv

TOL_QKV = {"float32": 1e-4, "bfloat16": 2.0**-7}
SMS = 132  # an H100's multiprocessors: the tile and split choices depend on them


def row_stats_in_order(x: torch.Tensor, eps: float = 1e-6):
    """``(mu, rstd)`` ``[M, 1]`` of x ``[M, C]`` in the kernels' warp order
    (csrc/ln_qkv.cu ``row_stats``), for x's dtype: 16-byte chunks of
    16 / itemsize values."""
    m, c = x.shape
    v = 16 // x.element_size()
    chunks = c // v
    rounds = -(-chunks // 32)
    xf = torch.zeros(m, rounds * 32 * v)
    xf[:, :c] = x.float()
    xf = xf.reshape(m, rounds, 32, v)  # [row, round, lane, value]: chunk lane + 32 round
    s = torch.zeros(m, 32)
    s2 = torch.zeros(m, 32)
    for i in range(rounds):
        for e in range(v):
            val = xf[:, i, :, e]
            s = s + val
            s2 = s2 + val * val
    lanes = torch.arange(32)
    for off in (16, 8, 4, 2, 1):  # lane l adds lane l ^ off: every lane ends with the same sums
        s = s + s[:, lanes ^ off]
        s2 = s2 + s2[:, lanes ^ off]
    mu = s[:, :1] / c
    var = torch.clamp(s2[:, :1] / c - mu * mu, min=0.0)
    return mu, 1.0 / torch.sqrt(var + eps)


def emulate_f1(x, s, b, w, wb, eps=1e-6, sms=SMS):
    """F1 in the kernels' order: x ``[M, C]``, w ``[3C, C]``, wb ``[3C]`` in
    one dtype, s and b fp32 ``[C]`` -> qkv ``[M, 3C]`` in x's dtype."""
    m, c = x.shape
    mu, rstd = row_stats_in_order(x, eps)
    xn = (((x.float() - mu) * rstd) * s + b).to(x.dtype)
    if x.dtype == torch.float32:
        ck = ln_qkv.f1_fp32_split(m, c, sms)
        kr = c // ck
        acc = torch.zeros(m, 3 * c)
        for q in range(ck):  # the cluster's K ranges, added in rank order
            acc = acc + torch.matmul(xn[:, q * kr:(q + 1) * kr], w[:, q * kr:(q + 1) * kr].t())
        return acc + wb
    bm, bn = ln_qkv.F1_TILES[ln_qkv.f1_tile(m, c, sms)]
    out = torch.empty(m, 3 * c, dtype=x.dtype)
    for r0 in range(0, m, bm):
        for c0 in range(0, 3 * c, bn):
            acc = torch.matmul(xn[r0:r0 + bm].float(), w[c0:c0 + bn].float().t())
            out[r0:r0 + bm, c0:c0 + bn] = acc.to(x.dtype) + wb[c0:c0 + bn]
    return out


def _inputs(seed, m, c, dtype, near_constant=False):
    """bf16-exact values in bf16, so both packages start from the same numbers."""
    rng = np.random.default_rng(seed)

    def arr(shape, scale=1.0, offset=0.0, exact=True):
        a = (rng.standard_normal(shape) * scale + offset).astype(np.float32)
        if dtype == "bfloat16" and exact:
            a = torch.from_numpy(a).bfloat16().float().numpy()
        return a

    x = arr((m, c), 1e-3, 120.0) if near_constant else arr((m, c))
    return dict(x=x, w=arr((3 * c, c), 0.05), wb=arr((3 * c,), 0.05), s=arr((c,), 0.1, 1.0, exact=False),
                b=arr((c,), 0.1, exact=False))


def _torch(a, dtype):
    tdt = getattr(torch, dtype)
    return {k: torch.from_numpy(v).to(tdt if k in ("x", "w", "wb") else torch.float32) for k, v in a.items()}


def _pallas_f1(a, batch, n, c, dtype):
    jdt = getattr(jnp, dtype)
    out = jax_ln_qkv._f1_call(jnp.asarray(a["x"].reshape(batch, n, c), jdt), jnp.asarray(a["s"]),
                              jnp.asarray(a["b"]), jnp.asarray(a["w"].T, jdt), jnp.asarray(a["wb"], jdt), 1e-6, True)
    return np.asarray(jnp.asarray(out).astype(jnp.float32)).reshape(batch * n, 3 * c)


def _hold(got, ref, dtype, what):
    got, ref = got.float().numpy(), np.asarray(ref, dtype=np.float32)
    assert got.shape == ref.shape and np.isfinite(got).all(), what
    err = np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= TOL_QKV[dtype], f"{what}: {err:.3g} of max|ref| > {TOL_QKV[dtype]:.3g}"


def test_row_stats_order_matches_jax():
    """The warp order's statistics against the JAX ln_stats: the same fp32
    formulas summed in another order, so within a few fp32 ulps."""
    rng = np.random.default_rng(3)
    for c in (64, 320, 768, 1024):
        x = rng.standard_normal((9, c)).astype(np.float32)
        mu, rstd = row_stats_in_order(torch.from_numpy(x))
        jmu, jrstd = jax_ln_qkv.ln_stats(jnp.asarray(x), 1e-6)
        np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(rstd.numpy(), np.asarray(jrstd), rtol=1e-5)
        xb = torch.from_numpy(x).bfloat16()  # 8 values a chunk
        mu_b, _ = row_stats_in_order(xb)
        np.testing.assert_allclose(mu_b.numpy(), xb.float().mean(-1, keepdim=True).numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("batch, n, c", [(2, 21, 64), (1, 37, 192), (3, 13, 320), (2, 110, 768), (1, 45, 1024)])
def test_emulation_matches_pallas_f1_and_plain(dtype, batch, n, c):
    """Every M here is ragged against the tiles (42, 37, 39, 220, 45 rows)."""
    a = _inputs(batch * n + c, batch * n, c, dtype)
    t = _torch(a, dtype)
    got = emulate_f1(t["x"], t["s"], t["b"], t["w"], t["wb"])
    _hold(got, _pallas_f1(a, batch, n, c, dtype), dtype, f"vs pallas {dtype} M={batch * n} C={c}")
    plain = ln_qkv.ln_qkv_f1_plain(t["x"], t["s"], t["b"], t["w"], t["wb"])
    _hold(got, plain.float().numpy(), dtype, f"vs plain {dtype} M={batch * n} C={c}")
    # a CPU tensor takes the plain version through the wrapper
    assert torch.equal(ln_qkv.ln_qkv_f1(t["x"], t["s"], t["b"], t["w"], t["wb"]), plain)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_emulation_on_near_constant_rows(dtype):
    """x = 120 + N(0, 1e-3) at C = 768. In bf16 every x rounds to 120, so the
    fast variance is exactly 0 in any order, rstd = 1/sqrt(eps) and xn = b:
    the warp order agrees with the JAX kernel and the plain version within
    the usual tolerance. In fp32 the fast variance is cancellation noise of
    either sign, which each summation order draws differently (so no two
    orders agree on xn); the clamp keeps rstd at most 1/sqrt(eps), so qkv
    stays finite and bounded on every side."""
    m, c = 40, 768
    a = _inputs(17, m, c, dtype, near_constant=True)
    t = _torch(a, dtype)
    mu, rstd = row_stats_in_order(t["x"])
    assert bool(torch.isfinite(rstd).all()) and float(rstd.max()) <= 1e3 * (1 + 1e-6)
    got = emulate_f1(t["x"], t["s"], t["b"], t["w"], t["wb"])
    ref = _pallas_f1(a, 1, m, c, dtype)
    plain = ln_qkv.ln_qkv_f1_plain(t["x"], t["s"], t["b"], t["w"], t["wb"]).float().numpy()
    if dtype == "bfloat16":
        assert float(rstd.min()) == float(np.float32(1.0) / np.sqrt(np.float32(1e-6)))
        _hold(got, ref, dtype, f"near-constant vs pallas {dtype}")
        _hold(got, plain, dtype, f"near-constant vs plain {dtype}")
    else:
        # |x - mu| <= ~0.005 here and rstd <= 1e3, so |xn| <= ~5 |s| + |b| and
        # |qkv| <= C max|xn| max|w| + max|wb| on every side
        xmax = float(np.abs(a["x"] - a["x"].mean(-1, keepdims=True)).max())
        xn_max = xmax * 1e3 * float(np.abs(a["s"]).max()) + float(np.abs(a["b"]).max())
        bound = c * xn_max * float(np.abs(a["w"]).max()) + float(np.abs(a["wb"]).max())
        for out in (got.numpy(), ref, plain):
            assert np.isfinite(out).all() and float(np.abs(out).max()) <= bound


def test_emulation_at_the_timestamp_shape_takes_the_other_tile():
    """At M = 3584 (B = 256 windows of N = 14) the bf16 kernel takes
    128 x 256 tiles; the emulation through them still agrees with the plain
    version (a narrow C keeps the CPU product small)."""
    m, c = 3584, 64
    assert ln_qkv.F1_TILES[ln_qkv.f1_tile(m, 768, SMS)] == (128, 256)
    a = _inputs(5, m, c, "bfloat16")
    t = _torch(a, "bfloat16")
    got = emulate_f1(t["x"], t["s"], t["b"], t["w"], t["wb"])
    _hold(got, ln_qkv.ln_qkv_f1_plain(t["x"], t["s"], t["b"], t["w"], t["wb"]).float().numpy(), "bfloat16",
          "M=3584 vs plain")


def test_tile_and_split_choices_at_the_main_shapes():
    """What the kernels launch on an H100 at the shapes the main paths give
    them: the bf16 step's M = 5688 (192 x 192 tiles, three rounds over 132
    CTAs), the timestamp windows' M = 3584 (128 x 256, two rounds), a short
    call (M = 37: 128 x 256, the smaller area of one round), the fp32
    step's M = 308 (64 x 64 tiles, K split in four: 720 CTAs) and the fp32
    windows' M = 3584 (no split)."""
    assert ln_qkv.f1_plan(torch.bfloat16, 5688, 768, SMS) == (192, 192, 1, 360, 132)
    assert ln_qkv.f1_plan(torch.bfloat16, 3584, 768, SMS) == (128, 256, 1, 252, 132)
    assert ln_qkv.f1_plan(torch.float16, 37, 768, SMS) == (128, 256, 1, 9, 9)
    assert ln_qkv.f1_plan(torch.float32, 308, 768, SMS) == (64, 64, 4, 180, 720)
    assert ln_qkv.f1_plan(torch.float32, 700, 768, SMS) == (64, 64, 2, 396, 792)
    assert ln_qkv.f1_plan(torch.float32, 3584, 768, SMS) == (64, 64, 1, 2016, 2016)


@pytest.mark.parametrize("m", [1, 37, 308, 3584, 5688, 5725])
def test_tiles_and_splits_cover_every_width(m):
    """Every C the entries take (multiples of 64 up to 1024) at the main
    shapes' M and ragged ones: the wgmma F1's K-tiles of 64 are whole and
    its column tiles cover 3C; the fp32 F1's 64-column tiles are whole and
    each K range is whole 16-wide K-tiles; the fp32 B2's eight K ranges
    cover 3C in whole 8-wide K-tiles, its threads (C / 8 column groups for
    two 8-row halves, whole warps, at least two) stay within 256 and its shared memory
    within a block's 227 KB; its dscale/dbias columns split evenly over the
    cluster's eight CTAs."""
    for c in range(64, 1025, 64):
        bm, bn, ck, tiles, grid = ln_qkv.f1_plan(torch.bfloat16, m, c, SMS)
        assert (bm, bn) in ln_qkv.F1_TILES and ck == 1 and c % 64 == 0
        assert -(-m // bm) * -(-3 * c // bn) == tiles and grid == min(tiles, SMS)
        assert (-(-3 * c // bn) - 1) * bn < 3 * c <= -(-3 * c // bn) * bn
        bm, bn, ck, tiles, grid = ln_qkv.f1_plan(torch.float32, m, c, SMS)
        assert (bm, bn) == ln_qkv.F1_FP32_TILE and (3 * c) % bn == 0 and ck in (1, 2, 4)
        assert (c // ck) % 16 == 0 and grid == tiles * ck and -(-m // bm) * (3 * c // bn) == tiles
        ranges = ln_qkv.b2_fp32_ranges(c)
        assert len(ranges) == ln_qkv.B2_FP32_CTAS
        assert [r.start for r in ranges] == [q * (3 * c // 8) for q in range(8)] and ranges[-1].stop == 3 * c
        assert all((r.stop - r.start) % 8 == 0 for r in ranges)
        threads = 64 if c // 4 <= 64 else -(-(c // 4) // 32) * 32
        assert 2 * (c // 8) <= threads <= 256 and threads >= 64 and (c // 2) % 4 == 0 and c % ln_qkv.B2_FP32_CTAS == 0
        assert 4 * (3 * (8 * c + 16 * 12) + 6 * c) <= 227 * 1024
