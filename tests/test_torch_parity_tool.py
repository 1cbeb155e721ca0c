"""The port's checkpoint-parity oracle (python -m
passt_tpu_torch.tools.run_flagship_parity) against
scripts/run_flagship_parity.py, imported as tests/test_flagship_parity_script.py
imports it.

A depth-2 ``.pt`` in the reference's layout (a port model's state dict,
random weights from a seed; the arch shrunk in both registries) and an
8-clip 527-class eval container (the JAX packer) go through both: the
port's value within 1e-5 of the script's, on the ``.pt`` and on the port's
own ``.npz``; the ungated run (``trainer.limit_eval_batches``) reports
``pass: null`` with rc 0; ``--expect`` the value with ``--tol 1e-6`` gives
rc 0, a far ``--expect`` rc 1; an ``.npz`` input skips the port step; and
``MODES`` is the script's table.
"""

import dataclasses
import json
import os
import re
import sys

import numpy as np
import pytest
import torch

import passt_tpu.models.registry as jax_registry
import passt_tpu_torch.models.registry as registry
from passt_tpu.data.prepare import pack_waveform_hdf5
from passt_tpu_torch.tools import run_flagship_parity

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
if SCRIPTS not in sys.path:
    sys.path.insert(0, SCRIPTS)

import run_flagship_parity as jax_parity  # noqa: E402

ARCH = "passt_s_swa_p16_128_ap476"
TINY = dict(depth=2, embed_dim=64, num_heads=4)
#: fp32, 1-s clips, 2 eval batches (the script's wiring test's)
SHRINK = ["model.dtype=float32", "data.clip_length=1", "data.eval_batch_size=4"]


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """(pt, h5, tmp): the reference-layout ``.pt`` of a depth-2 port model
    and the eval container."""
    tmp = tmp_path_factory.mktemp("parity")
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(registry.ARCHS, ARCH, dataclasses.replace(registry.ARCHS[ARCH], **TINY))
        model = registry.get_model(ARCH, pretrained=False, generator=torch.Generator().manual_seed(7), device="cpu")
    pt = str(tmp / "synthetic-flagship.pt")
    torch.save(model.state_dict(), pt)
    rng = np.random.default_rng(3)
    items = []
    for i in range(8):
        target = np.zeros(527)
        target[i % 527] = 1
        items.append((f"e{i}.wav", (rng.standard_normal(32000) * 0.1).astype(np.float32), target))
    h5 = str(tmp / "eval.h5")
    pack_waveform_hdf5(h5, items, packed_targets=True)
    return pt, h5, tmp


@pytest.fixture
def tiny():
    with pytest.MonkeyPatch.context() as mp:
        for reg in (jax_registry, registry):
            mp.setitem(reg.ARCHS, ARCH, dataclasses.replace(reg.ARCHS[ARCH], **TINY))
        yield


def _record(out: str) -> dict:
    return json.loads([ln for ln in out.splitlines() if ln.startswith('{"mode"')][-1])


def _exact_value(out: str, key: str = "ap") -> float:
    """The metric as evaluate_only printed it, unrounded."""
    return float(re.findall(rf"(?<!swa_)'{key}': ([0-9.e-]+)", out)[-1])


def test_value_matches_the_script(artifacts, tiny, capsys):
    pt, h5, tmp = artifacts
    assert jax_parity.main([pt, h5, "--out-npz", str(tmp / "jax.npz"), "--expect", "0.5", "--tol", "1"] + SHRINK) == 0
    want = _record(capsys.readouterr().out)
    npz = str(tmp / "port.npz")
    assert run_flagship_parity.main([pt, h5, "--out-npz", npz, "--expect", "0.5", "--tol", "1"] + SHRINK,
                                    device="cpu") == 0
    got = _record(capsys.readouterr().out)
    assert got["ported_npz"] == npz and got["gated"] is True and got["pass"] is True
    assert {k: got[k] for k in ("mode", "metric", "expected", "tol", "provenance")} == {
        k: want[k] for k in ("mode", "metric", "expected", "tol", "provenance")}
    assert abs(got["value"] - want["value"]) <= 1e-5, (got["value"], want["value"])
    # the port's .npz in both packages: the script reads it as its own tree
    assert jax_parity.main([npz, h5, "--expect", "0.5", "--tol", "1"] + SHRINK) == 0
    assert abs(_record(capsys.readouterr().out)["value"] - got["value"]) <= 1e-5


def test_ungated_and_gated_exit_codes(artifacts, tiny, capsys):
    pt, h5, tmp = artifacts
    npz = str(tmp / "gates.npz")
    rc = run_flagship_parity.main([pt, h5, "--out-npz", npz] + SHRINK + ["trainer.limit_eval_batches=1"],
                                  device="cpu")
    out = capsys.readouterr().out
    rec = _record(out)
    assert rc == 0 and rec["pass"] is None and rec["gated"] is False and rec["ported_npz"] == npz
    assert rec["mode"] == "audioset" and rec["metric"] == "ap" and 0.0 <= rec["value"] <= 1.0
    assert f"ported {pt} -> {npz}" in out

    # the whole eval, gated on the value itself: rc 0; the .npz input skips the port
    rc = run_flagship_parity.main([npz, h5] + SHRINK, device="cpu")
    value = _exact_value(capsys.readouterr().out)
    rc = run_flagship_parity.main([npz, h5, "--expect", repr(value), "--tol", "1e-6"] + SHRINK, device="cpu")
    out = capsys.readouterr().out
    rec = _record(out)
    assert rc == 0 and rec["pass"] is True and rec["gated"] is True and rec["ported_npz"] == npz
    assert "ported " not in out
    rc = run_flagship_parity.main([npz, h5, "--expect", repr(value + 0.5), "--tol", "1e-6"] + SHRINK, device="cpu")
    rec = _record(capsys.readouterr().out)
    assert rc == 1 and rec["pass"] is False


def test_missing_inputs_exit(tmp_path):
    for argv, msg in (([str(tmp_path / "none.pt"), str(tmp_path)], "checkpoint not found"),
                      ([str(tmp_path), str(tmp_path / "none.h5")], "eval HDF5 not found")):
        with pytest.raises(SystemExit, match=msg):
            run_flagship_parity.main(argv, device="cpu")


def test_modes_are_the_scripts():
    assert run_flagship_parity.MODES == jax_parity.MODES
