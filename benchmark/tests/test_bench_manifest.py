"""``BENCHMARK.json`` against the benchmark's contract, the files it names,
finding a new cell by its name alone, and the result line's schema."""

import json
import re
import shutil
import time

import pytest
import torch

from benchmark.lib import harness
from benchmark.tests._tiny import tiny_cell

ROOT = harness.ROOT
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_manifest_keys_and_limits():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(MANIFEST)) <= 64 * 1024
    assert 1 <= MANIFEST["run_seconds"] <= 51
    cells = MANIFEST["workloads"]
    # 2 + 14 runs a cell, each run_seconds + 60 s, 180 s a cell to compile, 1200 s spare, for 24 cells
    assert (2 + 14 * 24) * (MANIFEST["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert sum(c["chips"] == 4 for c in cells) <= max(1, len(cells) // 4)
    for path in MANIFEST["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", path) and (ROOT / path).is_dir()


def test_every_name_and_unit():
    names = [x["name"] for key in ("configs", "workloads", "end_to_end", "per_layer") for x in MANIFEST[key]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_cells_name_their_files():
    configs = {c["name"]: c for c in MANIFEST["configs"]}
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["why"]) <= 200 and "\n" not in c["why"]
    e2e = MANIFEST["end_to_end"]
    for w in MANIFEST["workloads"]:
        assert len(w["why"]) <= 200 and "\n" not in w["why"]
        cell = harness.load_cell(w["name"])
        assert (ROOT / configs[w["config"]]["file"]).is_file()
        assert (ROOT / "benchmark" / "traffic" / f"{w['traffic']}.py").is_file()
        reported = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in reported
            assert callable(harness.metric_reader(m["name"]))
        assert cell.limits, "every cell compares some number with a limit"
    assert {m["name"] for m in e2e} >= {"setup_s"}
    assert all(m["workloads"] for m in MANIFEST["per_layer"]), "a per-layer metric names its cells"


def test_a_new_cell_is_found_by_name(tmp_path):
    """Adding a cell takes a workload file and a manifest entry: no file of
    the harness changes."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark")
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    w = json.loads((ROOT / "benchmark/workloads/passt_s.serve.b20.json").read_text())
    w.update(name="passt_s.serve.b1", why="one clip a call")
    w["params"]["batch"] = 1
    (tmp_path / "benchmark/workloads/passt_s.serve.b1.json").write_text(json.dumps(w))
    manifest["workloads"].append({k: w[k] for k in ("name", "config", "traffic", "chips", "why")})
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "passt_s.serve.b20" in m.get("workloads", ()):
            m["workloads"].append("passt_s.serve.b1")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))
    cell = harness.load_cell("passt_s.serve.b1", root=tmp_path)
    assert cell.params["batch"] == 1
    assert {m["name"] for m in cell.end_to_end} == {"serve_clips_per_s", "serve_call_ms_p95", "setup_s"}
    assert harness.traffic_module(cell, root=tmp_path).run
    assert all(callable(harness.metric_reader(m["name"], root=tmp_path)) for m in cell.per_layer)


@pytest.mark.parametrize("name", ["passt_s.train.b12", "passt_s.serve.b20"])
@pytest.mark.parametrize("trace", [0, 1])
def test_result_line_schema(name, trace):
    cell = tiny_cell(name)
    env = harness.Env(seed=2 ** 31 + 11, seconds=0.5, trace=bool(trace), device=torch.device("cpu"),
                      t_start=time.time())
    line = harness.run_rank(cell, env)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    want = cell.per_layer if trace else cell.end_to_end
    names = {m["name"] for m in want}
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == names
        assert all(v["value"] > 0 for v in line["metrics"].values())
    else:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(line)


def test_spawn_ranks_relays_rank_0s_last_line(tmp_path):
    """A multi-card cell's parent starts one process a rank with the
    rendezvous in its environment, waits for all, and hands on rank 0's
    last line alone."""
    script = tmp_path / "rank.py"
    script.write_text("import json, os\nrank = int(os.environ['RANK'])\nprint('chatter')\n"
                      "assert os.environ['WORLD_SIZE'] == '3' and os.environ['MASTER_ADDR'] == 'localhost'\n"
                      "print(json.dumps({'rank': rank}))\n")
    code, line = harness.spawn_ranks([str(script)], 3, time.time(), 120)
    assert code == 0 and json.loads(line) == {"rank": 0}
    script.write_text("import os, sys\nsys.exit(3 if os.environ['RANK'] == '2' else 0)\n")
    code, _ = harness.spawn_ranks([str(script)], 3, time.time(), 120)
    assert code == 3
