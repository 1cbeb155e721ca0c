"""The port's loader and loop throughput tools (python -m
passt_tpu_torch.tools.measure_mp3_loader, loader_worker_sweep,
fit_throughput) on the CPU.

- ``build_container`` writes the JAX script's container: the same names,
  targets and mp3 bytes (dataset for dataset), both encoding with this
  machine's libmp3lame.
- ``sweep`` returns a positive warm-pass rate for every native mode and
  worker count (no scaling is asserted: the rates are the host's).
- ``fit_throughput``'s ``make_container`` packs the script's container, and
  its ``main`` at a depth-1 arch (two steps by two epochs) prints its JSON
  line with the script's keys and the bench's beside them (not measured on
  the CPU).
- All seven tools of this slice import in a fresh interpreter with jax,
  flax, optax, the JAX package, scripts/ and h5py blocked.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest

import passt_tpu_torch.models.registry as registry
from passt_tpu.data import native as jax_native
from passt_tpu_torch.data import native as port_native
from passt_tpu_torch.data.prepare import mp3enc
from passt_tpu_torch.tools import fit_throughput, loader_worker_sweep, measure_mp3_loader
from test_torch_prepare import assert_dataset_equal

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
if SCRIPTS not in sys.path:
    sys.path.insert(0, SCRIPTS)

import fit_throughput as jax_fit_throughput  # noqa: E402
import measure_mp3_loader as jax_measure  # noqa: E402


def _codec_stack():
    """Skip where the mp3 chain's libraries are absent (libmp3lame to encode,
    the native plane's libmpg123 to decode)."""
    if not (mp3enc.available() and port_native.mp3_available() and jax_native.mp3_available()):
        pytest.skip("libmp3lame / the native plane with libmpg123 not on this machine")


@pytest.mark.parametrize("n_clips,seed", [(3, 0), (10, 1)])
def test_build_container_is_the_scripts(n_clips, seed, tmp_path):
    _codec_stack()
    jax_measure.build_container(str(tmp_path / "jax.h5"), n_clips, seconds=2, seed=seed)
    measure_mp3_loader.build_container(str(tmp_path / "port.h5"), n_clips, seconds=2, seed=seed)
    assert_dataset_equal(str(tmp_path / "port.h5"), str(tmp_path / "jax.h5"))


def test_sweep_rates():
    _codec_stack()
    res = loader_worker_sweep.sweep(8, [1, 2], (True, False))
    assert sorted(res) == [False, True]
    for native_on, per_worker in res.items():
        assert sorted(per_worker) == [1, 2]
        for w, rate in per_worker.items():
            assert np.isfinite(rate) and rate > 0, (native_on, w, rate)


def test_fit_container_is_the_scripts(tmp_path):
    jax_fit_throughput.make_container(str(tmp_path / "jax.h5"), 5, n_classes=20, seconds=1)
    fit_throughput.make_container(str(tmp_path / "port.h5"), 5, n_classes=20, seconds=1)
    assert_dataset_equal(str(tmp_path / "port.h5"), str(tmp_path / "jax.h5"))


def test_fit_throughput_on_the_cpu(tmp_path, monkeypatch, capsys):
    arch = "passt_s_swa_p16_128_ap476"
    monkeypatch.setitem(registry.ARCHS, arch, dataclasses.replace(registry.ARCHS[arch], depth=1, embed_dim=64,
                                                                  num_heads=4))
    out = fit_throughput.main(["--steps", "2", "--epochs", "2", "--batch-size", "4", "--workdir", str(tmp_path)],
                              device="cpu", extra=["model.input_fdim=32", "mel.n_mels=32", "model.dtype=float32",
                                                   "data.num_workers=2", "data.eval_batch_size=4"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(out))
    assert set(line) == {"metric", "value", "unit", "epoch_it_per_s", "steps_per_epoch", "batch_size",
                         "wall_s_total", "bench_ms_per_step", "bench_specs_per_s", "vs_in_graph_bench",
                         "device_prefetch", "transfer_dtype", "checkpointing", "device"}
    assert line["metric"] == "fit_loop_sustained_throughput" and line["unit"] == "specs/second"
    assert len(line["epoch_it_per_s"]) == 2 and line["value"] > 0 and line["steps_per_epoch"] == 2
    assert line["batch_size"] == 4 and line["checkpointing"] is True and line["device"] == "cpu"
    assert line["bench_ms_per_step"] is None and line["vs_in_graph_bench"] is None
    assert sorted(os.listdir(tmp_path)) == ["ckpt", "eval_120.h5", "train_8.h5"]


def test_new_tools_import_without_jax_or_h5py():
    """In a fresh interpreter with jax, flax, optax, the JAX package, scripts/
    and h5py blocked, the seven tools import."""
    import subprocess

    tools = ("convergence_demo", "finetune_rehearsal", "run_flagship_parity", "measure_mp3_loader",
             "loader_worker_sweep", "fit_throughput", "multiseed_quality")
    code = f"""
import importlib, importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split('.')[0] in ('jax', 'flax', 'optax', 'passt_tpu', 'h5py', 'scripts'):
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
for t in {tools!r}:
    importlib.import_module('passt_tpu_torch.tools.' + t)
print('ok', sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax', 'passt_tpu', 'h5py')))
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "ok []"
