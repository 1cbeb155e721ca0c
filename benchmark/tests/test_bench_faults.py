"""A run driven end to end at a tiny size on the CPU, the harness's look
for a card skipped, with the timed path broken underneath: ``correct``
comes out false for each fault a cell can have, under the cell's own
limits, and true for the program as it is."""

import json
import subprocess
import sys
import time

import pytest
import torch

from benchmark.lib import harness
from benchmark.tests._tiny import tiny_cell


def _run(name: str, seconds: float = 0.5) -> dict:
    env = harness.Env(seed=2 ** 31 + 13, seconds=seconds, trace=False, device=torch.device("cpu"),
                      t_start=time.time())
    return harness.run_rank(tiny_cell(name), env)


@pytest.mark.parametrize("name", ["passt_s.train.b12", "passt_s.serve.b20", "passt_s_30s.serve.b20"])
def test_sound_program_is_correct(name):
    assert _run(name)["correct"] is True


def test_train_step_that_returns_its_state_unchanged(monkeypatch):
    from passt_tpu_torch.train import steps

    real = steps.make_train_step

    def frozen(*args, **kwargs):
        step = real(*args, **kwargs)
        return lambda state, batch, seed: (state, step(state, batch, seed)[1])

    monkeypatch.setattr(steps, "make_train_step", frozen)
    line = _run("passt_s.train.b12")
    assert line["correct"] is False
    assert line["checks"]["change_gap_bf16"]["value"] == pytest.approx(1.0)
    assert line["checks"]["change_gap_fp32"]["value"] == pytest.approx(1.0)


def test_train_step_that_stores_bf16_leaves_rounded_to_nearest(monkeypatch):
    """The SR apply replaced by a nearest-rounded bf16 add: updates far
    below a weight's bf16 spacing are lost, every bf16 matrix stays where
    it was, and the fp32 leaves move as before."""
    from passt_tpu_torch.train import optim, steps

    monkeypatch.setattr(steps, "apply_updates_sr", lambda params, updates, generator, shares=None:
                        optim.apply_updates(params, updates))
    line = _run("passt_s.train.b12")
    assert line["correct"] is False
    assert line["checks"]["change_gap_bf16"]["value"] > 0.9  # only weights near zero still move
    assert line["checks"]["change_gap_fp32"]["value"] <= line["checks"]["change_gap_fp32"]["limit"]


def test_train_step_over_half_the_batch(monkeypatch):
    from passt_tpu_torch.train import losses, steps

    def half(logits, targets, perm=None, lam=None, rows=None):
        y = targets * lam[:, None] + targets[perm] * (1.0 - lam[:, None])
        h = logits.shape[0] // 2
        return losses.bce_with_logits(logits[:h], y[:h]).mean()

    monkeypatch.setitem(steps.LOSS_FNS, "multilabel", half)
    assert _run("passt_s.train.b12")["correct"] is False


def _altered(monkeypatch, fn):
    from passt_tpu_torch import hear

    real = hear.Predictor.__call__
    monkeypatch.setattr(hear.Predictor, "__call__", lambda self, wave: fn(real(self, wave)))


@pytest.mark.parametrize("name", ["passt_s.serve.b20", "passt_s_30s.serve.b20"])
def test_served_answer_altered(monkeypatch, name):
    def alter(logits):
        out = logits.clone()
        out[0] = logits[1]
        return out

    _altered(monkeypatch, alter)
    assert _run(name)["correct"] is False


@pytest.mark.parametrize("name", ["passt_s.serve.b20", "passt_s_30s.serve.b20"])
def test_served_half_batch_left_out(monkeypatch, name):
    def half(logits):
        out = logits.clone()
        h = logits.shape[0] // 2
        out[h: 2 * h] = logits[:h]
        return out

    _altered(monkeypatch, half)
    assert _run(name)["correct"] is False


@pytest.mark.parametrize("fault, correct", [("none", True), ("no_exchange", False)])
def test_data_parallel_exchange_left_out(tmp_path, fault, correct):
    port = harness._free_port()
    out = tmp_path / "line.json"
    procs = [subprocess.Popen([sys.executable, str(harness.HERE / "tests" / "_ddp_worker.py"), fault, str(r), "2",
                               str(port), str(out)], cwd=str(harness.ROOT)) for r in range(2)]
    for p in procs:
        assert p.wait(timeout=600) == 0
    assert json.loads(out.read_text())["correct"] is correct
