"""Port frontend (passt_tpu_torch.ops) vs the JAX frontend, on the CPU.

On a CPU tensor the port's ``fused_log_mel`` runs its plain version, the
function the Hopper mel kernel computes; the JAX side runs its Pallas mel
kernel in interpret mode or its XLA matmul path. Inputs come from numpy
seeds and go to both.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from passt_tpu.ops.frontend import MelConfig as JaxMelConfig
from passt_tpu.ops.frontend import log_mel_spectrogram as jax_log_mel
from passt_tpu.ops.mel import kaldi_mel_banks as jax_mel_banks
from passt_tpu.ops.pallas.mel_kernel import fused_log_mel as jax_fused_log_mel
from passt_tpu.ops.stft import make_stft_filters as jax_stft_filters
from passt_tpu_torch.ops import _build
from passt_tpu_torch.ops.frontend import MelConfig, log_mel_spectrogram, mel_frontend
from passt_tpu_torch.ops.mel import kaldi_mel_banks, kaldi_mel_banks_np
from passt_tpu_torch.ops.mel_kernel import fused_log_mel
from passt_tpu_torch.ops.stft import make_stft_filters, num_stft_frames

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")
AUDIOSET = dict(fmin_aug_range=10, fmax_aug_range=2000)


def _wave(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _check_vs_kernel(got, ref):
    """The bound tests/test_pallas_mel.py holds the JAX kernel to against
    its own XLA path: fp32 summation order moves near-empty mel bins, where
    the log is steep, by up to 1e-3; wherever the mel energy exceeds 1e-2
    the two agree to 2e-4."""
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-3)
    strong = np.exp(5.0 * ref - 4.5) > 1e-2
    np.testing.assert_allclose(got[strong], ref[strong], atol=2e-4)


def test_stft_basis_and_mel_bank_match_jax():
    np.testing.assert_array_equal(make_stft_filters(1024, 800), jax_stft_filters(1024, 800))
    # the FFT-bin mels are baked from float64 on both sides; only fmin/fmax
    # go through fp32 (bitwise equal with one libm; 1e-6 allows another)
    got = kaldi_mel_banks(128, 1024, 32000, 0.0, 15000.0).numpy()
    ref = np.asarray(jax_mel_banks(128, 1024, 32000, 0.0, 15000.0))
    np.testing.assert_allclose(got, ref, atol=1e-6)
    # fp32 bank vs the float64 construction: fp32 rounding of the mel edges
    np.testing.assert_allclose(got, kaldi_mel_banks_np(128, 1024, 32000, 0.0, 15000.0), atol=1e-4)


@pytest.mark.parametrize("num_samples", [32000, 48001])
def test_fused_log_mel_matches_pallas_interpret(num_samples):
    wave = _wave(num_samples, (2, num_samples))
    bank = kaldi_mel_banks(128, 1024, 32000, 0.0, 15000.0)
    _build.reset_launches()
    got = fused_log_mel(torch.from_numpy(wave), bank).numpy()
    assert _build.LAUNCHES["fused_log_mel"] == 0  # a CPU tensor never launches
    ref = np.asarray(
        jax_fused_log_mel(jnp.asarray(wave), jnp.asarray(bank.numpy()), interpret=True)
    )
    _check_vs_kernel(got, ref)


@pytest.mark.parametrize("hop", [100, 160])
def test_fused_log_mel_hops_the_tpu_kernel_refuses(hop):
    """hop 100/160 (the stfthop archs) fail the TPU kernel's gate; the port's
    kernel takes them, so its function is held to the JAX matmul frontend
    (same fp32 products: 5e-5)."""
    wave = _wave(hop, (2, 32000))
    cfg = JaxMelConfig(hopsize=hop, **AUDIOSET)
    ref = np.asarray(jax_log_mel(jnp.asarray(wave), cfg))
    got = log_mel_spectrogram(torch.from_numpy(wave), MelConfig(hopsize=hop, **AUDIOSET)).numpy()
    assert got.shape == ref.shape == (2, 128, MelConfig(hopsize=hop).frames(32000))
    np.testing.assert_allclose(got, ref, atol=5e-5)


@pytest.mark.parametrize("stft_method", ["auto", "matmul"])
def test_log_mel_spectrogram_matches_jax(stft_method):
    """Eval frontend at the AudioSet settings (fmax 15000): both sides run
    the same fp32 matmul formulation (1e-5; observed 4e-7)."""
    wave = _wave(3, (3, 35200))
    ref = np.asarray(jax_log_mel(jnp.asarray(wave), JaxMelConfig(**AUDIOSET)))
    got = log_mel_spectrogram(
        torch.from_numpy(wave), MelConfig(stft_method=stft_method, **AUDIOSET)
    ).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    stacked = mel_frontend(torch.from_numpy(wave)[None], MelConfig(**AUDIOSET)).numpy()
    np.testing.assert_array_equal(stacked[0], got)


def test_log_mel_matches_golden_fixture():
    """The reference AugmentMelSTFT output at flagship geometry; the JAX
    package holds itself to 2e-4 here (tests/test_golden_fixtures.py)."""
    path = os.path.join(FIXDIR, "mel_flagship.npz")
    fix = np.load(path)
    got = log_mel_spectrogram(torch.from_numpy(fix["wave"]), MelConfig(**AUDIOSET)).numpy()
    assert got.shape == fix["mel"].shape
    assert np.abs(got - fix["mel"]).max() < 2e-4


def test_config_and_unported_modes():
    cfg = MelConfig(**AUDIOSET)
    assert cfg.effective_fmax == JaxMelConfig(**AUDIOSET).effective_fmax == 15000
    assert cfg.frames(320000) == JaxMelConfig().frames(320000) == 1000
    assert num_stft_frames(5119, 1024, 320) == 16
    with pytest.raises(ValueError, match="generator"):
        log_mel_spectrogram(torch.zeros(1, 32000), cfg, train=True)
    with pytest.raises(ValueError, match="stft_method"):
        MelConfig(stft_method="pallas")
