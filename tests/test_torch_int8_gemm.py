"""The int8 GEMM's wgmma main loop (``csrc/int8_gemm.cu``): its tile choice
and its persistent schedule, on the CPU.

The kernel runs only on the card; what surrounds it is Python that the CPU
reaches: ``pick_tile`` chooses the compiled output tile per call for the
least wave time over the card's multiprocessors, and ``tile_order`` is the
order in which the kernel's persistent blocks walk the output tiles
(``tile_coords``). The exact product that chip_smoke holds the kernel to is
held here against the JAX package's int8 product (``jnp.dot`` into int32,
as its ``_dense_kernel`` computes it) at the ragged shapes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from passt_tpu_torch.ops.int8 import TILES, int8_matmul, int8_matmul_plain, pick_tile, tile_order, wave_cost
from passt_tpu_torch.tools import int8_sweep

H100_SMS = 132


@pytest.mark.parametrize(
    "m, k, n, gelu, tile",
    [
        # fc1 + GELU at the training token count: 1080 tiles, 9 rounds (192: 720, 6), a tie: the narrowest
        (5688, 768, 3072, True, (128, 128)),
        # fc2 (DENSE): 270 tiles, 3 rounds (192: 180, 2; 256: 135, 2), a tie: the widest
        (5688, 3072, 768, False, (128, 192)),
        (5688, 768, 3072, False, (128, 192)),  # fc1's shape under DENSE: the same tie, the widest
        (5688, 768, 2304, False, (128, 128)),  # qkv: 810 tiles, 7 rounds (192: 540, 5; 256: 405, 4)
        (8192, 8192, 8192, False, (128, 192)),  # RAW: 2752 tiles, 21 rounds (128: 32 of 4096; 256: 16 of 2048)
        (8192, 8192, 8192, True, (128, 192)),  # no tie: the epilogue does not matter
    ],
)
def test_pick_tile_least_wave_time(m, k, n, gelu, tile):
    """At the model's shapes on 132 SMs: the rounds of tiles times the
    tile's width is least for the picked tile; on a tie the narrowest under
    GELU, the widest under DENSE and RAW."""
    got = TILES[pick_tile(m, n, H100_SMS, gelu=gelu)]
    assert got == tile
    costs = {}
    for bm, bn in TILES:
        rounds = -(-(-(-m // bm) * -(-n // bn)) // H100_SMS)
        costs[bm, bn] = rounds * bn
    assert costs[got] == min(costs.values())
    tied = [t for t in TILES if costs[t] == costs[got]]
    assert got == (min if gelu else max)(tied, key=lambda t: t[1])
    assert [wave_cost(m, n, i, H100_SMS) for i in range(len(TILES))] == [costs[t] for t in TILES]


@pytest.mark.parametrize("m, n", [(130, 96), (300, 333), (1000, 520), (5688, 3072), (8193, 8191), (1, 1)])
@pytest.mark.parametrize("tile", range(len(TILES)))
def test_persistent_schedule_visits_every_tile_once(m, n, tile):
    """The blocks of the persistent grid (one an SM, at most one a tile)
    together take every output tile exactly once, at ragged M and N; each
    group of row tiles is walked column by column."""
    bm, bn = TILES[tile]
    order = tile_order(m, n, tile)
    tiles_m, tiles_n = -(-m // bm), -(-n // bn)
    grid = min(len(order), H100_SMS)
    taken = [order[t] for b in range(grid) for t in range(b, len(order), grid)]
    assert sorted(taken) == [(i, j) for i in range(tiles_m) for j in range(tiles_n)]
    for t, (i, j) in enumerate(order):
        first = t // (8 * tiles_n) * 8
        assert first <= i < min(first + 8, tiles_m)
        if t % (8 * tiles_n) and order[t - 1][1] != j:  # inside a group
            assert order[t - 1][1] == j - 1 and i == first  # the next column starts at the group's first row


@pytest.mark.parametrize("m, k, n", [(130, 40, 96), (300, 200, 333), (200, 4000, 130)])
def test_exact_product_matches_jax_int8(m, k, n):
    """int8_matmul's exact product (the plain version on the CPU; the
    kernel on the card is held bit-equal to it) against the JAX package's
    int8 product into int32, at shapes that are multiples of no compiled
    tile and K of no 128 bytes; a row and a column of 127s give the largest
    sum (past 2**24 at K = 4000)."""
    rng = np.random.default_rng(m + n)
    a = rng.integers(-127, 128, (m, k), dtype=np.int8)
    b = rng.integers(-127, 128, (k, n), dtype=np.int8)
    a[0], b[:, 0] = 127, 127
    ref = np.asarray(jnp.dot(jnp.asarray(a), jnp.asarray(b), preferred_element_type=jnp.int32))
    got = int8_matmul(torch.from_numpy(a), torch.from_numpy(b), torch.int32)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert int(ref[0, 0]) == 127 * 127 * k
    np.testing.assert_array_equal(int8_matmul_plain(torch.from_numpy(a), torch.from_numpy(b), torch.int32).numpy(), ref)


def test_int8_sweep_tool_on_cpu(capsys):
    res = int8_sweep.run(device="cpu", shapes={"tiny": (40, 64, 48, (torch.int8, torch.bfloat16))})
    out = capsys.readouterr().out
    assert out.startswith("device: cpu")
    for dtype in ("int8", "bfloat16"):
        for key in [f"{bm}x{bn}" for bm, bn in TILES] + ["library"]:
            assert res[f"tiny_{dtype}_{key}_tops"] == "not measured"
    assert res["tiny_picked_tile"] == "128x128" and '"tiny_picked_tile"' in out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            int8_sweep.run()
