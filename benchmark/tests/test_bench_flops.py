"""The yardstick's arithmetic against the port's kernel table (PERF.md,
section 6): rows 2 and 5, and the model FLOPs of PaSST-S."""

import pytest

from benchmark.lib import flops, harness


def _cfg(name="passt_s_ap476", **kw):
    return dict(harness.load_cell("passt_s.serve.b20").config if name == "passt_s_ap476"
                else harness.load_cell("passt_s_30s.serve.b20").config, **kw)


@pytest.mark.parametrize("backward, b, n, gflop, bound_ms", [
    (False, 20, 1190, 87.0, 0.0880),  # row 2: the serving forward
    (True, 12, 474, 20.7, 0.0209),  # row 5: the training backward
])
def test_attention_bound_matches_kernel_table(backward, b, n, gflop, bound_ms):
    cost = flops.attention_bwd_cost if backward else flops.attention_fwd_cost
    ops, nbytes = cost(b, n, 12, 64)
    assert ops / 1e9 == pytest.approx(gflop, abs=0.05)
    assert 1e3 * flops.bound_s(ops, nbytes) == pytest.approx(bound_ms, abs=0.00005)


def test_forward_bytes_match_kernel_table():
    _, nbytes = flops.attention_fwd_cost(20, 1190, 12, 64)
    assert nbytes / 1e6 == pytest.approx(146.2, abs=0.1)


@pytest.mark.parametrize("name, frames, train, n, gflop", [
    ("passt_s_ap476", 1000, True, 474, 89.3),
    ("passt_s_ap476", 1000, False, 1190, 254.8),
    ("passt_s_30s_ap473", 3000, False, 3590, 1086.3),
])
def test_model_flops(name, frames, train, n, gflop):
    cfg = _cfg(name, s_patchout_t=40, s_patchout_f=4)
    assert flops.tokens(cfg, frames, train) == n
    f, t = flops.grid(cfg, frames)
    assert flops.forward_flops(cfg, n, f * t) / 1e9 == pytest.approx(gflop, abs=0.05)


def test_attention_share_of_the_30s_forward():
    cfg = _cfg("passt_s_30s_ap473")
    per_block = flops.forward_flops(dict(cfg, depth=1), 3590, 0) - 2 * cfg["embed_dim"] * cfg["num_classes"]
    attn = 4 * 3590 ** 2 * cfg["embed_dim"]
    assert attn / 1e9 == pytest.approx(39.6, abs=0.05)
    assert per_block / 1e9 == pytest.approx(90.4, abs=0.05)
