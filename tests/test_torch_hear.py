"""Port Predictor (passt_tpu_torch.hear) vs the JAX Predictor, on the CPU,
with the JAX Predictor's weights bridged into the port."""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import passt_tpu.models.registry as jax_registry
import passt_tpu_torch.models.registry as port_registry
from passt_tpu.hear import Predictor as JaxPredictor
from passt_tpu_torch import hear
from passt_tpu_torch.hear import Predictor
from passt_tpu_torch.models.pretrained import state_dict_from_flax

ARCH = "passt_s_swa_p16_128_ap476"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-4  # fp32, the JAX package's bound against the reference torch model


@pytest.fixture(scope="module")
def predictors():
    """(jax Predictor, port Predictor) of one tiny net with equal weights."""
    saved = (jax_registry.ARCHS[ARCH], port_registry.ARCHS[ARCH])
    jax_registry.ARCHS[ARCH] = dataclasses.replace(saved[0], depth=2, embed_dim=64, num_heads=4)
    port_registry.ARCHS[ARCH] = dataclasses.replace(saved[1], depth=2, embed_dim=64, num_heads=4)
    try:
        jp = JaxPredictor.create(arch=ARCH, dtype="float32", input_tdim=98)
        tp = Predictor.create(arch=ARCH, dtype="float32", input_tdim=98, device="cpu")
        tp.model.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, jp.params)))
        yield jp, tp
    finally:
        jax_registry.ARCHS[ARCH], port_registry.ARCHS[ARCH] = saved


def _close(got, ref, atol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(ref), atol=atol, rtol=0)


def test_logits_and_scene_embeddings_match_jax(predictors):
    jp, tp = predictors
    wave = np.random.default_rng(1).standard_normal((2, 32000)).astype(np.float32)
    jl, jf = jp.logits_and_features(wave)
    logits, feats = tp.logits_and_features(wave)
    assert tuple(logits.shape) == (2, 527) and tuple(feats.shape) == (2, 64)
    _close(logits, jl)
    _close(feats, jf)
    _close(tp(wave), jp(wave))
    for mode in ("all", "logits", "embed_only"):
        _close(tp.scene_embeddings(wave, mode=mode), jp.scene_embeddings(wave, mode=mode))
    assert tuple(hear.get_scene_embeddings(wave, tp).shape) == (2, 527 + 64)
    with pytest.raises(ValueError, match="unknown embedding mode"):
        tp.scene_embeddings(wave, mode="nope")


@pytest.mark.parametrize("num_samples,chunk", [(32000, 256), (32000, 8), (3200, 256)])
def test_timestamp_embeddings_match_jax(predictors, num_samples, chunk):
    """0.16 s windows every 50 ms (N = 14 tokens each), in padded chunks;
    values and the timestamp grid both match, including a clip shorter
    than one window and a tail chunk that needs padding."""
    jp, tp = predictors
    wave = np.random.default_rng(num_samples).standard_normal((2, num_samples)).astype(np.float32)
    jp.timestamp_chunk = tp.timestamp_chunk = chunk
    try:
        jemb, jts = jp.timestamp_embeddings(wave)
        emb, ts = tp.timestamp_embeddings(wave)
    finally:
        jp.timestamp_chunk = tp.timestamp_chunk = 256
    assert tuple(emb.shape) == tuple(jemb.shape)
    _close(emb, jemb)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(jts))
    emb2, ts2 = hear.get_timestamp_embeddings(wave, tp)
    _close(emb2, jemb)


def test_port_never_imports_jax():
    code = (
        "import sys, passt_tpu_torch, passt_tpu_torch.hear, passt_tpu_torch.models, "
        "passt_tpu_torch.ops; "
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'flax', 'passt_tpu.'))); "
        "assert not bad, bad"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                            capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr
