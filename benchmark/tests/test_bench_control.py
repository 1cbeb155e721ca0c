"""The checks' control and planted faults at each cell's own size, on the
card, on three seeds: each fails at least one of the cell's limits; and
the program itself, run through its window's path on a dozen seeds,
passes every limit.

    python -m pytest benchmark/tests/test_bench_control.py -m card -s

prints every reading (what the limits were set from, with PERF.md)."""

import json
import time

import pytest
import torch

from benchmark.lib import control, harness

CELLS = [w["name"] for w in json.loads((harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEEDS = [2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303]
PROGRAM_SEEDS = [2 ** 31 + 1009 + 7919 * i for i in range(12)]


def _fails(reading: dict, limits: dict) -> bool:
    return any(reading[k] > lim for k, lim in limits.items())


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", CELLS)
def test_control_and_faults_fail(card, name, seed):
    cell = harness.load_cell(name)
    fn = control.train_readings if cell.workload["traffic"] == "train_step" else control.serve_readings
    readings = fn(cell, seed, card)
    print(f"\nREADINGS {name} {seed} {json.dumps(readings)}", flush=True)
    for side, reading in readings.items():
        assert _fails(reading, cell.limits), f"{side} passes every limit of {name}: {reading}"


@pytest.mark.card
@pytest.mark.parametrize("seed", PROGRAM_SEEDS)
@pytest.mark.parametrize("name", CELLS)
def test_program_within_limits(card, name, seed):
    """A whole run of the cell with a 2-s window, in this process."""
    cell = harness.load_cell(name)
    env = harness.Env(seed=seed, seconds=2.0, trace=False, device=torch.device("cuda", 0), t_start=time.time())
    line = harness.run_rank(cell, env)
    checks = {k: c["value"] for k, c in line["checks"].items()}
    print(f"\nPROGRAM {name} {seed} {json.dumps(checks)} {json.dumps(line['shown'])}", flush=True)
    assert line["correct"] is True
