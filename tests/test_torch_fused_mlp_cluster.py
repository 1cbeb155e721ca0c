"""The bf16 fused-MLP kernels' order (csrc/fused_mlp.cu ``mlp_kernel``),
emulated in PyTorch on the CPU, against the prototype's Pallas kernels
(scripts/proto_mlp_fused.py ``fused_mlp_fwd_call`` / ``fused_mlp_bwd_call``
run interpreted) and the port's plain versions; and the kernels' pick
(``ops/fused_mlp.py`` ``split`` and ``plan``, mirrors of ``mlp_split`` and
``mlp_plan``).

The kernels run a cluster of CS CTAs per row block: C = 64 q is split into
CS = ceil(q / 3) CTAs of NB column blocks, H is walked in chunks of 64 CS
units, CTA r computes h (dg) of units [64 r, 64 r + 64) of each chunk over
the whole K in fp32, adds b1 and applies the GELU (multiplies by d), rounds
g (dh) once, and the chunk's g (dh) from every CTA feeds each CTA's columns
of y (dx), summed chunk by chunk in order (within a chunk the kernel takes
the CTA's own units first; that order is not emulated), then + b2 and rounded once. The
emulation repeats that partition and order, units past H and columns past C
included (zero weights, nothing stored), so it checks that the partition
covers H and C exactly once.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from passt_tpu_torch.ops import fused_mlp as F
from passt_tpu_torch.ops.activations import gelu_parts

SCRIPTS = os.path.join(os.path.dirname(__file__), "..", "scripts")
if SCRIPTS not in sys.path:
    sys.path.insert(0, SCRIPTS)

# max error relative to max|ref|, as tests/test_torch_proto_mlp_fused.py
# states them: fp32 differs in summation order only; in bf16 an fp32 ulp can
# flip the rounding of g, d, dh or y (one bf16 ulp at the largest value,
# 2**-7); dx passes through two roundings (dh, then its own sum), 2**-6
TOL = {"float32": 1e-5, "bfloat16": 2.0**-7}
TOL_DX = {"float32": 1e-5, "bfloat16": 2.0**-6}
SMS = 132  # an H100 SXM's multiprocessors
# (M, C, H): C = 64 (one CTA, one block), 192 (one CTA, three blocks), 256
# (two CTAs of two blocks; H = 192 leaves the second chunk of 128 half
# empty), 448 (three CTAs, the last with one of its three blocks; H = 448 is
# two chunks of 192 and a third), 704 (four CTAs, the last one block short;
# H = 320 is one chunk of 256 and a quarter)
CASES = [(37, 64, 256), (45, 192, 128), (33, 256, 192), (19, 448, 448), (21, 704, 320)]


def _pad(t: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    """t zero-padded along dim to size: the kernels' TMA zero fill."""
    pad = [0, 0] * (t.ndim - dim - 1) + [0, size - t.shape[dim]]
    return torch.nn.functional.pad(t, pad)


def _layout(c: int, h: int):
    cs, nb = F.split(c)
    hc = 64 * cs
    return cs, nb, hc, -(-h // hc)


def emulate_fwd(x, w1, b1, w2, b2):
    """y, g and d as the bf16 forward kernel computes them, in its order."""
    (m, c), h, dt = x.shape, w1.shape[1], x.dtype
    cs, nb, hc, chunks = _layout(c, h)
    units, cols = chunks * hc, 64 * nb * cs
    w1p, b1p = _pad(w1, 1, units).float(), _pad(b1, 0, units).float()
    w2p = _pad(_pad(w2, 0, units), 1, cols).float()
    y = torch.zeros(m, cols)
    g_all, d_all = torch.zeros(m, units, dtype=dt), torch.zeros(m, units, dtype=dt)
    for j in range(chunks):
        for r in range(cs):  # CTA r: its units of the chunk over the whole K
            u = slice(j * hc + hc // cs * r, j * hc + hc // cs * (r + 1))
            g, d = gelu_parts(torch.matmul(x.float(), w1p[:, u]) + b1p[u])
            g_all[:, u], d_all[:, u] = g.to(dt), d.to(dt)
        chunk = slice(j * hc, (j + 1) * hc)
        for r in range(cs):  # CTA r: its columns, the chunk's g from every CTA
            n = slice(64 * nb * r, 64 * nb * (r + 1))
            y[:, n] += torch.matmul(g_all[:, chunk].float(), w2p[chunk, n])
    y = (y[:, :c] + b2.float()).to(dt)
    return y, g_all[:, :h], d_all[:, :h]


def emulate_bwd(dy, d, w1, w2):
    """dx and dh as the bf16 backward kernel computes them, in its order."""
    (m, c), h, dt = dy.shape, w1.shape[1], dy.dtype
    cs, nb, hc, chunks = _layout(c, h)
    units, cols = chunks * hc, 64 * nb * cs
    w2p, dp = _pad(w2, 0, units).float(), _pad(d, 1, units).float()
    w1p = _pad(_pad(w1, 1, units), 0, cols).float()
    dx = torch.zeros(m, cols)
    dh_all = torch.zeros(m, units, dtype=dt)
    for j in range(chunks):
        for r in range(cs):
            u = slice(j * hc + hc // cs * r, j * hc + hc // cs * (r + 1))
            dh_all[:, u] = (torch.matmul(dy.float(), w2p[u].t()) * dp[:, u]).to(dt)
        chunk = slice(j * hc, (j + 1) * hc)
        for r in range(cs):
            n = slice(64 * nb * r, 64 * nb * (r + 1))
            dx[:, n] += torch.matmul(dh_all[:, chunk].float(), w1p[n, chunk].t())
    return dx[:, :c].to(dt), dh_all[:, :h]


def _arr(rng, shape, dtype, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return np.array(jnp.asarray(a, dtype).astype(jnp.float32))


def _inputs(seed, m, c, h, dtype):
    """x [m, c] with a zero row, w1, b1, w2, b2 (small non-zero biases)."""
    rng = np.random.default_rng(seed)
    x = _arr(rng, (m, c), dtype)
    x[3] = 0.0
    return (x, _arr(rng, (c, h), dtype, 0.05), _arr(rng, (h,), dtype, 0.1), _arr(rng, (h, c), dtype, 0.05),
            _arr(rng, (c,), dtype, 0.1))


def _close(got, ref, tol, name):
    got = got.detach().float().numpy()
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32)) if not isinstance(ref, torch.Tensor) else \
        ref.float().numpy()
    assert got.shape == ref.shape, name
    np.testing.assert_allclose(got, ref, atol=tol * np.abs(ref).max(), rtol=0, err_msg=name)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("m,c,h", CASES)
def test_forward_order_matches_pallas_and_plain(m, c, h, dtype):
    """y, g and d in the kernel's order against ``fused_mlp_fwd_call``
    interpreted and against the plain version."""
    from proto_mlp_fused import fused_mlp_fwd_call

    arrs = _inputs(m + c, m, c, h, dtype)
    ref = fused_mlp_fwd_call(*(jnp.asarray(a, dtype) for a in arrs), bm=16, residuals=True, interpret=True)
    ts = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    got = emulate_fwd(*ts)
    plain = F.fused_mlp_fwd_plain(*ts, residuals=True)
    for name, gt, r, p in zip(("y", "g", "d"), got, ref, plain):
        assert gt.dtype == getattr(torch, dtype), name
        _close(gt, r, TOL[dtype], f"{name} vs Pallas")
        _close(gt, p, TOL[dtype], f"{name} vs plain")


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("m,c,h", CASES)
def test_backward_order_matches_pallas_and_plain(m, c, h, dtype):
    """dx and dh in the kernel's order against ``fused_mlp_bwd_call``
    interpreted and against the plain version."""
    from proto_mlp_fused import fused_mlp_bwd_call

    _, w1, _, w2, _ = _inputs(m + c + 1, m, c, h, dtype)
    rng = np.random.default_rng(m + h)
    dy, d = _arr(rng, (m, c), dtype), _arr(rng, (m, h), dtype)
    rdx, rdh = fused_mlp_bwd_call(*(jnp.asarray(a, dtype) for a in (dy, d, w1, w2)), bm=16, interpret=True)
    ts = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (dy, d, w1, w2)]
    dx, dh = emulate_bwd(*ts)
    pdx, pdh = F.fused_mlp_bwd_plain(*ts)
    _close(dh, rdh, TOL[dtype], "dh vs Pallas")
    _close(dx, rdx, TOL_DX[dtype], "dx vs Pallas")
    _close(dh, pdh, TOL[dtype], "dh vs plain")
    _close(dx, pdx, TOL_DX[dtype], "dx vs plain")


@pytest.mark.parametrize("m,resident,want", [(5688, None, (128, 4, 180, 2)), (14280, None, (128, 4, 448, 4)),
                                              (5688, 30, (128, 4, 180, 2)), (14280, 30, (128, 4, 448, 4)),
                                              (5688, 22, (128, 4, 180, 3))])
def test_plan_at_the_passt_s_token_counts(m, resident, want):
    """PaSST-S (C = 768) at the training (12 x 474) and eval (12 x 1190)
    token counts on 132 SMs: four CTAs of 192 columns a cluster, 128-row
    blocks; 45 clusters at M = 5688 and 112 at M = 14280, waves of the
    clusters resident at once: at most 33 (the default), fewer where the
    card places fewer (the occupancy query; B2's clusters of 4 read 30)."""
    assert F.split(768) == (4, 3)
    assert F.plan(m, 768, SMS, resident) == want


def _smem(rows: int, cs: int) -> int:
    """The bf16 kernel's shared memory (csrc/fused_mlp.cu ``MlpTile::smem``):
    1024 bytes of alignment, the chunk's g buffer (a block a CTA) and the d
    block, 128 bytes of barriers, and a ring of as many stages (an x tile
    and a weight tile) as fit at C = 768, at most 4."""
    stage = rows * 128 + 64 * 128
    fixed = lambda n: 1024 + (n + 1) * rows * 128 + 128  # noqa: E731
    return fixed(cs) + min(4, (227 * 1024 - fixed(4)) // stage) * stage


@pytest.mark.parametrize("c", range(64, 769, 64))
def test_every_width_has_a_valid_plan(c):
    """For every C the wrapper accepts: a portable cluster, column blocks
    that a wgmma width takes (N = 64 NB <= 192) covering C exactly once
    with no CTA left empty, shared memory within a CTA's 227 KB, and at
    every M a plan whose CTAs and waves follow from its rows; every H a
    multiple of 64 is walked in whole chunks of 64 CS units."""
    cs, nb = F.split(c)
    assert 1 <= cs <= 8 and 1 <= nb <= F.MAX_BLOCKS
    assert (cs - 1) * nb * 64 < c <= cs * nb * 64
    for m in (1, 77, 130, 191, 193, 5688, 14280, 100000):
        rows, cs2, ctas, waves = F.plan(m, c, SMS)
        assert cs2 == cs and rows == F.ROWS
        assert ctas == -(-m // rows) * cs and waves == -(-(ctas // cs) // (SMS // cs))
        assert _smem(rows, cs) <= 227 * 1024
    for h in (64, 128, 320, 3072):
        hc = 64 * cs
        assert -(-h // hc) * hc >= h > (-(-h // hc) - 1) * hc


def test_timeline_stamps_apply_to_the_kernel():
    """Every stamp of ``tools/fused_mlp_timeline`` finds its place in the
    kernel source as it is (the tool builds the stamped copy on the card)."""
    from pathlib import Path

    from passt_tpu_torch.tools import fused_mlp_timeline as TL

    src = (Path(F.__file__).resolve().parent.parent / "csrc" / "fused_mlp.cu").read_text()
    out = TL.traced_source(src)
    assert out.count("TRC(") + out.count("TRP(") >= len(TL.EDITS) and "passt_fused_mlp_trace" in out
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            TL.main([])
