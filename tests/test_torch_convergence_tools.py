"""The port's training tools (python -m passt_tpu_torch.tools.convergence_demo,
finetune_rehearsal, multiseed_quality) against the JAX package's scripts.

- The convergence demo: its tones (``FREQS``, ``make_split``) bit-equal to
  the script's, taken out of scripts/convergence_demo.py with ``ast`` (the
  script trains at import), its config equal field by field to
  ``passt_tpu.config.apply_overrides`` of the script's dict, its reduced
  arch the script's, and two short epochs of ``run`` at a depth-1 arch on
  the CPU: finite losses, the registry as it was.
- The fine-tune rehearsal: the synthesized ``.npz`` equal in keys, shapes,
  dtypes and values to the script's step 1 (``jax.eval_shape`` and the same
  fill) at a depth-2 arch; the whole chain (pretrained npz, ``esc50 main``,
  SIGTERM, resume, ``evaluate_only`` of the best checkpoint) through a CLI
  shim on the CPU at that arch. The shim holds its child after the epoch
  line the parent waits for until the SIGTERM arrives, so the 2-s poll
  never decides where the signal lands.
- The multi-seed loop: ``commands()`` the six runs scripts/multiseed_quality.sh
  makes, and ``main``'s log the script's (the shell script run with a
  ``timeout`` on PATH that records its arguments and prints five lines).
"""

import ast
import dataclasses
import json
import os
import stat
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import passt_tpu.models.registry as jax_registry
import passt_tpu_torch.models.registry as registry
from passt_tpu.config import apply_overrides as jax_apply_overrides
from passt_tpu.experiments import EXPERIMENTS as JAX_EXPERIMENTS
from passt_tpu.models.passt import PaSST as JaxPaSST
from passt_tpu.models.pretrained import save_params_npz as jax_save_params_npz
from passt_tpu_torch.experiments import EXPERIMENTS
from passt_tpu_torch.tools import convergence_demo, finetune_rehearsal, multiseed_quality
from test_torch_prepare import assert_dataset_equal

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
ARCH = "passt_s_swa_p16_128_ap476"
TINY = dict(depth=2, embed_dim=64, num_heads=4)


@pytest.fixture
def tiny_arch():
    """ARCH at TINY in both packages' registries."""
    with pytest.MonkeyPatch.context() as mp:
        for reg in (jax_registry, registry):
            mp.setitem(reg.ARCHS, ARCH, dataclasses.replace(reg.ARCHS[ARCH], **TINY))
        yield


# ---- the convergence demo --------------------------------------------------------------------------------------
def _demo_script():
    """The script's ``sr``, ``freqs`` and ``make_split``, its override dict
    (``tmp`` bound to "/x") and its reduced arch's keywords, taken out with
    ``ast``."""
    tree = ast.parse(open(os.path.join(SCRIPTS, "convergence_demo.py")).read())
    keep = [n for n in tree.body if (isinstance(n, ast.Assign) and isinstance(n.targets[0], ast.Name)
                                     and n.targets[0].id in ("sr", "freqs"))
            or (isinstance(n, ast.FunctionDef) and n.name == "make_split")]
    ns = {"np": np}
    exec(compile(ast.Module(body=keep, type_ignores=[]), "convergence_demo.py", "exec"), ns)
    call = next(n.value for n in tree.body if isinstance(n, ast.Assign) and isinstance(n.targets[0], ast.Name)
                and n.targets[0].id == "cfg")
    ns["overrides"] = eval(compile(ast.Expression(call.args[1]), "convergence_demo.py", "eval"), {"tmp": "/x"})
    replace = next(n.value for n in tree.body if isinstance(n, ast.Assign)
                   and isinstance(n.targets[0], ast.Subscript))
    ns["reduced"] = {kw.arg: ast.literal_eval(kw.value) for kw in replace.keywords}
    return ns


@pytest.mark.parametrize("n_per,seed", [(20, 1), (4, 2), (1, 9)])
def test_demo_split_bit_equal(n_per, seed):
    script = _demo_script()
    assert script["sr"] == convergence_demo.SR
    np.testing.assert_array_equal(script["freqs"], convergence_demo.FREQS)
    got, want = convergence_demo.make_split(n_per, seed), script["make_split"](n_per, seed)
    assert len(got) == len(want) == 50 * n_per
    for (gn, gw, gy), (wn, ww, wy) in zip(got, want):
        assert gn == wn and gw.dtype == ww.dtype and gy.dtype == wy.dtype
        np.testing.assert_array_equal(gw, ww)
        np.testing.assert_array_equal(gy, wy)


def test_demo_config_and_arch_equal():
    script = _demo_script()
    want = jax_apply_overrides(JAX_EXPERIMENTS["esc50"].default_config, script["overrides"])
    got = convergence_demo.config("/x/train.h5", "/x/test.h5")
    got_fields, want_fields = json.loads(got.pretty()), json.loads(want.pretty())
    assert sorted(got_fields) == sorted(want_fields)
    for section in want_fields:
        assert got_fields[section] == want_fields[section], section
    assert convergence_demo.REDUCED == script["reduced"]
    extra = ["trainer.max_epochs=3", "model.dtype=float32"]
    want = jax_apply_overrides(want, dict(kv.split("=", 1) for kv in extra))
    assert convergence_demo.config("/x/train.h5", "/x/test.h5", extra).pretty() == want.pretty()


def test_demo_run_on_the_cpu(monkeypatch):
    """Two epochs of two steps at a depth-1 arch (the containers packed by
    the tool); the registry is put back."""
    monkeypatch.setattr(convergence_demo, "REDUCED", dict(depth=1, embed_dim=64, num_heads=4))
    before = dict(registry.ARCHS)
    hist = convergence_demo.run(["model.input_fdim=32", "mel.n_mels=32", "model.dtype=float32",
                                 "trainer.max_epochs=2", "trainer.limit_train_batches=2",
                                 "trainer.limit_eval_batches=1", "data.num_workers=2"], device="cpu")
    assert registry.ARCHS == before
    assert [r["epoch"] for r in hist] == [0, 1]
    for rec in hist:
        assert np.isfinite(rec["train_loss"]) and 0.0 <= rec["accuracy"] <= 1.0 and rec["n_eval"] == 50


# ---- the fine-tune rehearsal -----------------------------------------------------------------------------------
def test_rehearsal_npz_equals_the_scripts(tiny_arch, tmp_path):
    """Step 1 at a depth-2 arch: the script's shapes from ``jax.eval_shape``
    filled in ``jax.tree.map``'s order, against the tool's."""
    pcfg = JAX_EXPERIMENTS["esc50"].default_config.passt_config()
    model = JaxPaSST(pcfg)
    x = jnp.zeros((1, pcfg.in_chans, pcfg.input_fdim, pcfg.input_tdim), jnp.float32)
    shapes = jax.eval_shape(lambda r: model.init({"params": r}, x, train=False), jax.random.PRNGKey(123))["params"]
    host_rng = np.random.default_rng(123)
    params = jax.tree.map(lambda s: (host_rng.standard_normal(s.shape) * 0.02).astype(s.dtype), shapes)
    jax_save_params_npz(str(tmp_path / "jax.npz"), params)
    finetune_rehearsal.synth_pretrained(str(tmp_path / "port.npz"), EXPERIMENTS["esc50"].default_config.passt_config())
    with np.load(tmp_path / "jax.npz") as want, np.load(tmp_path / "port.npz") as got:
        assert sorted(got.files) == sorted(want.files) and len(want.files) > 30
        for key in want.files:
            assert got[key].shape == want[key].shape and got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_rehearsal_container_is_the_scripts(tmp_path):
    """The ESC-50-shaped container the tool packs equals the script's
    (dataset for dataset)."""
    if SCRIPTS not in sys.path:
        sys.path.insert(0, SCRIPTS)
    import finetune_rehearsal as jax_rehearsal

    jax_rehearsal.synth_container(str(tmp_path / "jax.h5"), 7, seconds=0.5, seed=3)
    finetune_rehearsal.synth_container(str(tmp_path / "port.h5"), 7, seconds=0.5, seed=3)
    assert_dataset_equal(str(tmp_path / "port.h5"), str(tmp_path / "jax.h5"))


#: the CLI shim of the chain test: ARCH at TINY, the CPU, fp32, and the
#: hold after the preempted phase's epoch line
SHIM = """
import dataclasses, sys
from passt_tpu_torch.models import registry
registry.ARCHS[{arch!r}] = dataclasses.replace(registry.ARCHS[{arch!r}], **{tiny!r})
from passt_tpu_torch.experiments import EXPERIMENTS
from passt_tpu_torch.experiments.common import run_command
from passt_tpu_torch.tools.finetune_rehearsal import hold_after_epoch
argv = sys.argv[2:]
if argv[0] == "main" and "trainer.resume=true" not in argv:
    hold_after_epoch({k})
run_command(EXPERIMENTS[sys.argv[1]], argv + ["model.dtype=float32", "data.num_workers=2"], device="cpu")
"""


def test_rehearsal_chain_through_a_cpu_shim(tiny_arch, tmp_path, capsys):
    k = 1
    cli = [sys.executable, "-c", SHIM.format(arch=ARCH, tiny=TINY, k=k), "esc50"]
    rc = finetune_rehearsal.main(["--workdir", str(tmp_path), "--epochs", "4", "--sigterm-after-epoch", str(k),
                                  "--train-clips", "24", "--eval-clips", "10"], cli=cli)
    assert rc == 0
    out = capsys.readouterr().out
    assert "REHEARSAL OK" in out
    transcript = json.load(open(tmp_path / "transcript.json"))
    assert transcript["preempted_after_epoch"] == transcript["resumed_from"] == k
    assert [e["epoch"] for e in transcript["epochs"]] == [0, 1, 2, 3]
    assert transcript["swa_evaluated"] is True
    log_a = open(tmp_path / "phase_a.log").read()
    assert f"preempted: exiting cleanly after completed epoch {k}" in log_a


# ---- the multi-seed loop ---------------------------------------------------------------------------------------
def test_multiseed_commands_are_the_shell_scripts(tmp_path, monkeypatch):
    """scripts/multiseed_quality.sh with a ``timeout`` on PATH that records
    its arguments and prints five lines (and runs nothing): the six runs'
    overrides, in order, equal ``commands()``'s, and ``main`` over runs that
    print the same five lines writes the same log."""
    fake = tmp_path / "bin"
    fake.mkdir()
    (fake / "timeout").write_text(f'#!/bin/sh\necho "$@" >> {tmp_path / "calls"}\n'
                                  'for i in 1 2 3 4 5; do echo "line $i"; done\n')
    (fake / "timeout").chmod(stat.S_IRWXU)
    env = dict(os.environ, PATH=f"{fake}:{os.environ['PATH']}", OUT=str(tmp_path / "out.log"))
    subprocess.run(["sh", os.path.join(SCRIPTS, "multiseed_quality.sh")], env=env, check=True, timeout=60)
    calls = [line.split() for line in open(tmp_path / "calls").read().splitlines()]
    assert len(calls) == 6
    want = []
    for call in calls:
        assert call[:3] == ["1800", "python", "scripts/fullsize_train_demo.py"]
        want.append(call[3:])
    got = multiseed_quality.commands()
    assert [c[:3] for c in got] == [[sys.executable, "-m", "passt_tpu_torch.tools.fullsize_train_demo"]] * 6
    assert [c[3:] for c in got] == want
    want_log = open(tmp_path / "out.log").read()
    assert want_log.splitlines()[-1] == "ALL DONE" and want_log.count("line 5") == 6
    five = [sys.executable, "-c", "for i in range(1, 6): print('line', i)"]
    runs = [(seed, arm, five) for seed, arm, _ in multiseed_quality.runs()]
    monkeypatch.setattr(multiseed_quality, "runs", lambda: runs)
    monkeypatch.setenv("OUT", str(tmp_path / "port.log"))
    assert multiseed_quality.main() == 0
    assert open(tmp_path / "port.log").read() == want_log
