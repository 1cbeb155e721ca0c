"""The B2 kernels' orders (csrc/ln_qkv.cu, dqkv W -> LayerNorm backward in
thread-block clusters: bf16/fp16 on wgmma, fp32 on the FMA loop), emulated
in PyTorch on the CPU, against the JAX package's B2 kernel in interpret mode
and the port's plain version.

The bf16 emulation follows its kernel: 192-row tiles (one cluster each); C
split into the cluster's column slices (``b2_split``); each slice's share of
every row's sums (x and x^2 for the statistics, then g and g x_hat) added in
rank order; the dscale and dbias partials of each row tile, summed over the
tiles as the wrapper sums them. The fp32 emulation follows its own: 16-row
tiles (one cluster of 8 CTAs each); dxn as the eight K ranges' partial
products (``b2_fp32_ranges``) added in rank order; each row's statistics in
the warp order (``row_stats_in_order``); the tile's dscale and dbias
partials summed over its 16 rows in order. Tolerances are chip_smoke's:
``TOL_QKV`` of max|ref| for dx and xn, ``TOL_LN_SUMS`` for dscale and dbias.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from passt_tpu.ops.pallas import ln_qkv as jax_ln_qkv
from passt_tpu_torch.ops import ln_qkv
from test_torch_ln_qkv_f1 import row_stats_in_order

TOL_QKV = {"float32": 1e-4, "bfloat16": 2.0**-7}
TOL_LN_SUMS = 1e-4


def emulate_b2(x, dqkv, w, s, b, eps=1e-6):
    """B2 in the kernel's order: x ``[M, C]``, dqkv ``[M, 3C]``, w
    ``[3C, C]`` in one dtype, s and b fp32 ``[C]`` -> dx, xn (x's dtype),
    dscale, dbias (fp32)."""
    m, c = x.shape
    ctas, blocks = ln_qkv.b2_split(c)
    rows = ln_qkv.B2_ROWS
    slices = [slice(q * 64 * blocks, min(c, (q + 1) * 64 * blocks)) for q in range(ctas)]
    xf, dxn = x.float(), torch.matmul(dqkv.float(), w.float())
    dx, xn = torch.empty_like(x), torch.empty_like(x)
    tiles = -(-m // rows)
    parts = torch.zeros(2, tiles, c)
    for t in range(tiles):
        r = slice(t * rows, min(m, (t + 1) * rows))
        xt, dt = xf[r], dxn[r]
        sx = sx2 = torch.zeros(xt.shape[0])
        for sl in slices:  # each CTA's share, in rank order
            sx = sx + xt[:, sl].sum(1)
            sx2 = sx2 + (xt[:, sl] * xt[:, sl]).sum(1)
        mu = sx / c
        rstd = 1.0 / torch.sqrt(torch.clamp(sx2 / c - mu * mu, min=0.0) + eps)
        xh = (xt - mu[:, None]) * rstd[:, None]
        xn[r] = (xh * s + b).to(x.dtype)
        g = dt * s
        s1 = s2 = torch.zeros(xt.shape[0])
        for sl in slices:
            s1 = s1 + g[:, sl].sum(1)
            s2 = s2 + (g[:, sl] * xh[:, sl]).sum(1)
        m1, m2 = s1 * (1.0 / c), s2 * (1.0 / c)
        dx[r] = (rstd[:, None] * (g - m1[:, None] - xh * m2[:, None])).to(x.dtype)
        parts[0, t], parts[1, t] = (dt * xh).sum(0), dt.sum(0)
    sums = parts.sum(dim=1)
    return dx, xn, sums[0], sums[1]


def emulate_b2_fp32(x, dqkv, w, s, b, eps=1e-6):
    """The fp32 B2 in its kernel's order: x ``[M, C]``, dqkv ``[M, 3C]``, w
    ``[3C, C]``, s and b ``[C]``, all fp32 -> dx, xn, dscale, dbias."""
    m, c = x.shape
    rows = ln_qkv.B2_ROWS_FP32
    dxn = torch.zeros(m, c)
    for k in ln_qkv.b2_fp32_ranges(c):  # the cluster's CTAs, in rank order
        dxn = dxn + torch.matmul(dqkv[:, k], w[k])
    mu, rstd = row_stats_in_order(x, eps)
    xh = (x - mu) * rstd
    xn = xh * s + b
    g = dxn * s
    m1, m2 = g.sum(1, keepdim=True) * (1.0 / c), (g * xh).sum(1, keepdim=True) * (1.0 / c)
    dx = rstd * (g - m1 - xh * m2)
    tiles = -(-m // rows)
    parts = torch.zeros(2, tiles, c)
    for t in range(tiles):
        for r in range(t * rows, min(m, (t + 1) * rows)):  # the tile's rows in order
            parts[0, t] = parts[0, t] + dxn[r] * xh[r]
            parts[1, t] = parts[1, t] + dxn[r]
    sums = parts.sum(dim=1)
    return dx, xn, sums[0], sums[1]


def _inputs(seed, m, c, dtype):
    """bf16-exact values in bf16, so both packages start from the same numbers."""
    rng = np.random.default_rng(seed)

    def arr(shape, scale=1.0, offset=0.0, exact=True):
        a = (rng.standard_normal(shape) * scale + offset).astype(np.float32)
        if dtype == "bfloat16" and exact:
            a = torch.from_numpy(a).bfloat16().float().numpy()
        return a

    return dict(x=arr((m, c)), dqkv=arr((m, 3 * c)), w=arr((3 * c, c), 0.05), s=arr((c,), 0.1, 1.0, exact=False),
                b=arr((c,), 0.1, exact=False))


def _hold(got, ref, dtype, what):
    for name, g, r in zip(("dx", "xn", "dscale", "dbias"), got, ref):
        g, r = g.float().numpy(), np.asarray(r, dtype=np.float32)
        assert g.shape == r.shape, (what, name)
        tol = TOL_QKV[dtype] if name in ("dx", "xn") else TOL_LN_SUMS
        err = np.abs(g - r).max() / max(np.abs(r).max(), 1e-30)
        assert err <= tol, f"{what} {name}: {err:.3g} of max|ref| > {tol:.3g}"


def test_split_covers_every_width():
    """Every C the entry takes (multiples of 64 up to 1024): at most 3
    blocks a CTA and 8 CTAs a cluster, no CTA without a column."""
    assert [ln_qkv.b2_split(c) for c in (64, 192, 320, 384, 768, 1024)] == [
        (1, 1), (1, 3), (2, 3), (2, 3), (4, 3), (6, 3)]
    for c in range(64, 1025, 64):
        ctas, blocks = ln_qkv.b2_split(c)
        assert 1 <= blocks <= 3 and 1 <= ctas <= 8
        assert (ctas - 1) * blocks * 64 < c <= ctas * blocks * 64


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("batch, n, c", [(2, 110, 64), (1, 37, 192), (2, 110, 768)])
def test_emulation_matches_pallas_b2_and_plain(dtype, batch, n, c):
    """Ragged M: 220 rows are a full 192-row tile and 28 rows; 37 fewer than one."""
    a = _inputs(batch * n + c, batch * n, c, dtype)
    tdt = getattr(torch, dtype)
    t = {k: torch.from_numpy(v).to(tdt if k in ("x", "dqkv", "w") else torch.float32) for k, v in a.items()}
    got = emulate_b2(t["x"], t["dqkv"], t["w"], t["s"], t["b"])
    jdt = getattr(jnp, dtype)
    jx = jnp.asarray(a["x"].reshape(batch, n, c), jdt)
    jdq = jnp.asarray(a["dqkv"].reshape(batch, n, 3 * c), jdt)
    jw = jnp.asarray(a["w"].T, jdt)  # the JAX kernel's [C, 3C]
    dx, xn, dsc, dbi = jax_ln_qkv._b2_call(jx, jdq, jw, jnp.asarray(a["s"]), jnp.asarray(a["b"]), 1e-6, True)
    ref = [np.asarray(jnp.asarray(v).astype(jnp.float32)).reshape(batch * n, c) for v in (dx, xn)]
    ref += [np.asarray(dsc).sum(axis=(0, 1)), np.asarray(dbi).sum(axis=(0, 1))]
    _hold(got, ref, dtype, f"vs pallas {dtype} M={batch * n} C={c}")
    plain = ln_qkv.ln_qkv_b2_plain(t["x"], t["dqkv"], t["w"], t["s"], t["b"])
    _hold(got, [p.float().numpy() for p in plain], dtype, f"vs plain {dtype} M={batch * n} C={c}")
    # a CPU tensor takes the plain version through the wrapper
    through = ln_qkv.ln_qkv_b2(t["x"], t["dqkv"], t["w"], t["s"], t["b"])
    for p, q in zip(plain, through):
        assert torch.equal(p, q)


def test_emulation_stays_finite_on_a_near_constant_row():
    """x = 120 + N(0, 1e-3) at C = 384: the slices' sums of x and x^2 give a
    fast variance that is cancellation noise of either sign (in any
    summation order); the clamp keeps rstd at most 1/sqrt(eps), so dx and xn
    stay finite, as the plain version's do."""
    rng = np.random.default_rng(9)
    c = 384
    x = torch.from_numpy((120.0 + rng.standard_normal((20, c)) * 1e-3).astype(np.float32))
    dq = torch.from_numpy(rng.standard_normal((20, 3 * c)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((3 * c, c)) * 0.05).astype(np.float32))
    s, b = torch.ones(c), torch.zeros(c)
    for out in (emulate_b2(x, dq, w, s, b), ln_qkv.ln_qkv_b2_plain(x, dq, w, s, b)):
        assert all(bool(torch.isfinite(g).all()) for g in out)
        assert float(out[1].abs().max()) <= 1e3 * 0.5 * (1 + 1e-6)  # |x - mu| <= ~0.5 here, rstd <= 1e3


def test_fp32_ranges_cover_every_width():
    """The fp32 kernel's eight K ranges of 3C: equal, in order, whole
    8-wide K-tiles, for every C the entry takes."""
    for c in range(64, 1025, 64):
        ranges = ln_qkv.b2_fp32_ranges(c)
        assert len(ranges) == ln_qkv.B2_FP32_CTAS == 8
        assert ranges[0].start == 0 and ranges[-1].stop == 3 * c
        assert all(a.stop == b.start for a, b in zip(ranges, ranges[1:]))
        assert all(r.stop - r.start == 3 * c // 8 and (r.stop - r.start) % 8 == 0 for r in ranges)


@pytest.mark.parametrize("batch, n, c", [(1, 9, 64), (1, 37, 192), (2, 154, 64), (1, 40, 768)])
def test_fp32_emulation_matches_pallas_b2_and_plain(batch, n, c):
    """Ragged M against the 16-row tiles: 9 rows (fewer than one), 37, 308
    (the fp32 step's rows at a narrow C), 40."""
    m = batch * n
    a = _inputs(m + 3 * c, m, c, "float32")
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    got = emulate_b2_fp32(t["x"], t["dqkv"], t["w"], t["s"], t["b"])
    jx = jnp.asarray(a["x"].reshape(batch, n, c))
    jdq = jnp.asarray(a["dqkv"].reshape(batch, n, 3 * c))
    dx, xn, dsc, dbi = jax_ln_qkv._b2_call(jx, jdq, jnp.asarray(a["w"].T), jnp.asarray(a["s"]), jnp.asarray(a["b"]),
                                           1e-6, True)
    ref = [np.asarray(v).reshape(m, c) for v in (dx, xn)]
    ref += [np.asarray(dsc).sum(axis=(0, 1)), np.asarray(dbi).sum(axis=(0, 1))]
    _hold(got, ref, "float32", f"fp32 vs pallas M={m} C={c}")
    plain = ln_qkv.ln_qkv_b2_plain(t["x"], t["dqkv"], t["w"], t["s"], t["b"])
    _hold(got, [p.numpy() for p in plain], "float32", f"fp32 vs plain M={m} C={c}")

