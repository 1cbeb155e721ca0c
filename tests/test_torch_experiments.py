"""The port's recipes end to end (passt_tpu_torch.experiments: ``main``,
``evaluate_only``, ``predict``) against the JAX package's, on the CPU.

Both packages run the same command line (``run_command``, the CLI's own
path) on the same synthetic HDF5 container (written with the JAX packer)
and the same weights: the JAX package's initial parameters, written with
its ``save_params_npz`` and read by both through ``model.pretrained=true
model.checkpoint_path=...``. The recipe's arch is monkeypatched to a tiny
one in both registries (depth 2, width 64, 4 heads), at 32 mels x 98
frames (1-s clips), fp32, with fp32 optimizer moments
(``trainer.opt_moments_dtype=null``: bf16 stochastic rounding cannot draw
the same bits from threefry and Philox).

The step's draws are turned off by overrides (mel jitter, SpecAugment,
mixup, patchout); the data-side augmentations (roll, gain, wavmix, the
samplers, the native batch plane) stay on, as they are bit-equal between
the packages. The AudioSet recipe also runs with its step's draws on,
injected on both sides as tests/test_torch_loop.py injects them
(SpecAugment masks, patchout indices, the mixup perm and lambda).

Bounds: each epoch's ``train_loss`` and ``val_loss`` within 1e-5 relative
(tests/test_torch_loop.py's; observed at most 2.6e-7); ``ap`` /
``accuracy`` and their SWA values within 1e-4 (a swap of two near-tied
scores moves them; observed: equal in every recipe); the final parameters
within 2e-5 of max(1, the leaf's max |value|), i.e. test_torch_loop.py's
2e-5 where a leaf is below 1 (observed at most 2.4e-6, ESC-50). Against
each leaf's own max the bound would not hold: the qkv key bias starts at 0
and gets a gradient that is rounding noise (the softmax cancels it), which
AdamW turns into updates of ~1e-7 that differ between the packages.
"""

import contextlib
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import passt_tpu.experiments.common as jax_common
import passt_tpu.models.passt as jax_passt_mod
import passt_tpu.models.registry as jax_registry
import passt_tpu.ops.frontend as jax_frontend_mod
import passt_tpu.train.steps as jax_steps_mod
import passt_tpu_torch.experiments.common as common
import passt_tpu_torch.models.passt as passt_mod
import passt_tpu_torch.models.registry as registry
import passt_tpu_torch.ops.frontend as frontend_mod
import passt_tpu_torch.train.steps as steps_mod
from passt_tpu.data.prepare import pack_waveform_hdf5
from passt_tpu.experiments import EXPERIMENTS as JAX_EXPERIMENTS
from passt_tpu.models.passt import init_passt
from passt_tpu.models.pretrained import save_params_npz as jax_save_params_npz
from passt_tpu_torch.experiments import EXPERIMENTS
from passt_tpu_torch.models.pretrained import state_dict_from_flax

TINY = dict(depth=2, embed_dim=64, num_heads=4)
B = 4  # train and eval batch
N_CLIPS = 8  # clips a container: 2 batches an epoch, 2 eval batches
#: the tiny geometry and the short run every recipe gets (the loaders run
#: to their end: a loader cut short by a limit is slow to stop in the JAX
#: package's prefetcher)
SHRINK = [
    "model.input_fdim=32", "mel.n_mels=32", "model.input_tdim=98", "model.dtype=float32",
    "data.clip_length=1", f"data.batch_size={B}", f"data.eval_batch_size={B}", f"data.epoch_len={N_CLIPS}",
    "data.num_workers=2", "trainer.max_epochs=2", "trainer.lr=1e-3", "trainer.swa_epoch_start=0",
    "trainer.swa_freq=1", "trainer.log_every_steps=1000", "trainer.opt_moments_dtype=null",
]
#: the step's draws off
NO_DRAWS = ["mel.freqm=0", "mel.timem=0", "mel.fmin_aug_range=1", "mel.fmax_aug_range=1", "trainer.use_mixup=false",
            "model.s_patchout_t=0", "model.s_patchout_f=0", "model.u_patchout=0"]
#: the step's draws on (SpecAugment, mixup, patchout), injected on both sides; no mel jitter
DRAWS = ["mel.freqm=8", "mel.timem=20", "mel.fmin_aug_range=1", "mel.fmax_aug_range=1", "trainer.use_mixup=true",
         "model.s_patchout_t=2", "model.s_patchout_f=1", "model.u_patchout=2"]


@contextlib.contextmanager
def _tiny_archs(*archs):
    """The archs shrunk to TINY in both packages' registries."""
    with pytest.MonkeyPatch.context() as mp:
        for reg in (jax_registry, registry):
            for arch in archs:
                mp.setitem(reg.ARCHS, arch, dataclasses.replace(reg.ARCHS[arch], **TINY))
        yield mp


def _container(path: str, kind: str, classes: int, seed: int) -> str:
    """N_CLIPS 1-s clips of noise with targets of the recipe's kind,
    packed by the JAX package (int16 PCM)."""
    rng = np.random.default_rng(seed)
    items = []
    for i in range(N_CLIPS):
        if kind == "single_label":
            target = np.asarray(i % classes)
        elif kind == "masked":
            k = classes // 2
            target = np.concatenate([rng.uniform(size=k) < 0.3, rng.uniform(size=k) < 0.7]).astype(np.float32)
        else:
            target = np.zeros(classes)
            target[rng.choice(12, int(rng.integers(1, 4)), replace=False)] = 1
        items.append((f"c{i:02d}.wav", (rng.standard_normal(32000) * 0.1).astype(np.float32), target))
    pack_waveform_hdf5(path, items, packed_targets=kind == "multilabel")
    return path


def _recipe_argv(name: str, root: str) -> list:
    """The tiny recipe's overrides: its container and the JAX package's
    initial weights (written once per recipe under ``root``; call it with
    the arch shrunk)."""
    exp = JAX_EXPERIMENTS[name]
    cfg = exp.default_config
    kind = "single_label" if exp.single_label else ("masked" if cfg.trainer.loss_type == "masked" else "multilabel")
    train, val = os.path.join(root, f"{name}_train.h5"), os.path.join(root, f"{name}_eval.h5")
    npz = os.path.join(root, f"{name}_init.npz")
    if not os.path.exists(npz):
        _container(train, kind, cfg.data.num_classes, seed=0)
        _container(val, kind, cfg.data.num_classes, seed=1)
        _, jcfg = jax_common.parse_cli(["with"] + SHRINK, cfg)
        _, params = init_passt(jcfg.passt_config(), jax.random.PRNGKey(7))
        jax_save_params_npz(npz, params)
    return SHRINK + [f"data.train_hdf5={train}", f"data.eval_hdf5={val}", "model.pretrained=true",
                     f"model.checkpoint_path={npz}"]


def _np_mask(batch, size, mask_param, iid):
    rng = np.random.default_rng(size)
    n = batch if iid else 1
    width = np.floor(rng.uniform(size=(n, 1)) * mask_param)
    start = np.floor(rng.uniform(size=(n, 1)) * (size - width))
    idx = np.arange(size)[None, :]
    return np.broadcast_to((idx >= start) & (idx < start + width), (batch, size))


def _np_keep(size, keep):
    return np.sort(np.random.default_rng(1000 * size + keep).permutation(size)[:keep])


def _inject_draws(mp):
    """The draws of tests/test_torch_loop.py's ``injected_draws``, with a
    mixup perm and lambda for B clips."""
    mp.setattr(jax_frontend_mod, "_axis_mask", lambda key, b, size, p, iid: jnp.asarray(_np_mask(b, size, p, iid)))
    mp.setattr(frontend_mod, "_axis_mask",
               lambda gen, b, size, p, iid: torch.from_numpy(_np_mask(b, size, p, iid).copy()))
    mp.setattr(jax_passt_mod, "_sorted_keep_indices", lambda key, size, keep: jnp.asarray(_np_keep(size, keep)))
    mp.setattr(passt_mod, "_sorted_keep_indices", lambda gen, size, keep: torch.from_numpy(_np_keep(size, keep)))
    perm, lam = np.array([2, 0, 3, 1]), np.array([0.7, 0.55, 0.9, 0.62], np.float32)
    mp.setattr(jax_steps_mod, "sample_mixup", lambda key, b, a: (jnp.asarray(perm[:b]), jnp.asarray(lam[:b])))
    mp.setattr(steps_mod, "sample_mixup", lambda gen, b, a: (torch.from_numpy(perm[:b]), torch.from_numpy(lam[:b])))


def _run_main_both(name: str, root: str, draws: bool):
    """``main`` of one recipe through both packages' ``run_command``:
    {"jax"/"port": (history, fit result)}."""
    out = {}
    with _tiny_archs(JAX_EXPERIMENTS[name].default_config.model.arch) as mp:
        argv = ["main", "with"] + _recipe_argv(name, root) + (DRAWS if draws else NO_DRAWS)
        if draws:
            _inject_draws(mp)
        for side, mod in (("jax", jax_common), ("port", common)):
            real = mod.fit
            fits = []
            mp.setattr(mod, "fit", lambda real=real, fits=fits, **kw: fits.append(real(**kw)) or fits[-1])
            if side == "jax":
                res = jax_common.run_command(JAX_EXPERIMENTS[name], argv)
            else:
                res = common.run_command(EXPERIMENTS[name], argv, device="cpu")
            assert res["done"] and not res["interrupted"] and len(res["history"]) == 2
            out[side] = (res["history"], fits[0])
    return out


@pytest.fixture(scope="module")
def main_runs(tmp_path_factory):
    """One run of each case per module, made when a test first asks."""
    root = str(tmp_path_factory.mktemp("recipes"))
    cache = {}

    def get(case):
        if case not in cache:
            name, _, variant = case.partition("-")
            cache[case] = _run_main_both(name, root, draws=variant == "draws")
        return cache[case]

    return get


def _check_losses(runs):
    jh, _ = runs["jax"]
    ph, _ = runs["port"]
    for j, p in zip(jh, ph):
        assert (p["epoch"], p["step"]) == (j["epoch"], j["step"])
        np.testing.assert_allclose(p["train_loss"], j["train_loss"], rtol=1e-5, atol=0)
        np.testing.assert_allclose(p["lr"], j["lr"], rtol=1e-6)


def _check_eval(runs, single_label: bool):
    jh, _ = runs["jax"]
    ph, _ = runs["port"]
    key = "accuracy" if single_label else "ap"
    for j, p in zip(jh, ph):
        for pre in ("", "swa_"):
            np.testing.assert_allclose(p[f"{pre}val_loss"], j[f"{pre}val_loss"], rtol=1e-5, atol=0)
            assert abs(p[f"{pre}{key}"] - j[f"{pre}{key}"]) <= 1e-4, (pre, key)
            assert p[f"{pre}n_eval"] == j[f"{pre}n_eval"] == 2 * B
        assert p.get("swa_n") == j.get("swa_n")


def _check_params(runs):
    _, jfit = runs["jax"]
    _, pfit = runs["port"]
    ref = state_dict_from_flax(jax.tree.map(np.asarray, jfit.state.params))
    assert set(ref) == set(pfit.state.params)
    for k, r in ref.items():
        got = pfit.state.params[k]
        assert got.dtype == torch.float32
        bound = 2e-5 * max(1.0, float(r.abs().max()))
        assert float((got - r).abs().max()) <= bound, k
    assert pfit.state.step == int(jfit.state.step) == 4
    assert pfit.swa.n_averaged == int(jfit.swa.n_averaged) >= 1


CASES = ["audioset", "audioset-draws", "esc50", "fsd50k", "openmic"]


@pytest.mark.parametrize("case", CASES)
def test_main_train_losses_match_jax(main_runs, case):
    """Each epoch's train loss (and its lr) against the JAX recipe's."""
    _check_losses(main_runs(case))


@pytest.mark.parametrize("case", CASES)
def test_main_eval_metrics_match_jax(main_runs, case):
    """Each epoch's eval of the trained and the SWA weights (val_loss,
    ap or accuracy, n_eval, swa_n) against the JAX recipe's."""
    _check_eval(main_runs(case), single_label=case == "esc50")


@pytest.mark.parametrize("case", CASES)
def test_main_final_params_match_jax(main_runs, case):
    """The parameters after the last step, the step count and the SWA
    count against the JAX recipe's."""
    _check_params(main_runs(case))


def test_evaluate_only_restores_the_best_checkpoint_and_matches_its_eval(tmp_path):
    """``main`` with keep-1-best-by-ap checkpoints and the metrics JSONL,
    then ``evaluate_only`` on the same directory: it restores the best
    epoch and its metrics (the trained and the SWA weights) equal that
    epoch's logged eval exactly (the same eval step on the same clips)."""
    import json

    ckpt = str(tmp_path / "ckpt")
    with _tiny_archs("passt_s_swa_p16_128_ap476"):
        argv = _recipe_argv("audioset", str(tmp_path)) + NO_DRAWS + [
            f"trainer.checkpoint_dir={ckpt}", "trainer.keep_last_n=1", "trainer.monitor=ap"]
        hist = common.run_command(EXPERIMENTS["audioset"], ["main"] + argv, device="cpu")["history"]
        got = common.run_command(EXPERIMENTS["audioset"], ["evaluate_only"] + argv, device="cpu")
    logged = [json.loads(line) for line in open(os.path.join(ckpt, "audioset_metrics.jsonl"))]
    assert [r["epoch"] for r in logged] == [0, 1] and logged[-1]["train_loss"] == hist[-1]["train_loss"]
    from passt_tpu_torch.train.loop import checkpoint_epochs

    best = max(range(2), key=lambda e: (hist[e]["ap"], e))
    assert checkpoint_epochs(ckpt) == [best]
    for k in ("val_loss", "ap", "roc", "n_eval", "swa_val_loss", "swa_ap", "swa_n_eval"):
        assert got[k] == hist[best][k], k


def test_predict_matches_jax(tmp_path):
    """``predict`` writes the eval set's names, probabilities and targets;
    the port's equal the JAX package's (probabilities within 1e-5) on the
    same weights."""
    out = {}
    with _tiny_archs("passt_s_swa_p16_128_ap476"):
        argv = ["predict"] + _recipe_argv("audioset", str(tmp_path))
        for side in ("jax", "port"):
            d = str(tmp_path / side)
            os.makedirs(d)
            if side == "jax":
                res = jax_common.run_command(JAX_EXPERIMENTS["audioset"], argv + [f"trainer.checkpoint_dir={d}"])
            else:
                res = common.run_command(EXPERIMENTS["audioset"], argv + [f"trainer.checkpoint_dir={d}"],
                                         device="cpu")
            assert res == {"n": N_CLIPS, "path": os.path.join(d, "predictions.npz")}
            with np.load(res["path"]) as f:
                out[side] = {k: f[k] for k in f.files}
    j, p = out["jax"], out["port"]
    assert p["out"].shape == (N_CLIPS, 527) and p["out"].dtype == np.float32
    assert list(p["names"]) == list(j["names"]) and np.array_equal(p["target"], j["target"])
    np.testing.assert_allclose(p["out"], j["out"], atol=1e-5, rtol=0)
    assert ((p["out"] >= 0) & (p["out"] <= 1)).all()
