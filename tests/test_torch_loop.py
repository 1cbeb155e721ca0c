"""The port's loop layer (passt_tpu_torch.train: metrics, SWA, evaluate,
fit, checkpoints, the step options grad_accum / grad norms / input_tdim, and
the bench's best-of-runs timing) against the JAX package, on the CPU.

Both sides run on the same weights (``state_dict_from_flax``) and the same
numpy batches, at the tiny geometry of tests/test_checkpoint.py. The step's
random draws are injected on both sides as tests/test_torch_train.py injects
them (SpecAugment masks, patchout indices, the mixup perm and lambda).
"""

import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import passt_tpu.models.passt as jax_passt_mod
import passt_tpu.ops.frontend as jax_frontend_mod
import passt_tpu.train.steps as jax_steps_mod
import passt_tpu_torch.models.passt as passt_mod
import passt_tpu_torch.ops.frontend as frontend_mod
import passt_tpu_torch.train.steps as steps_mod
from passt_tpu.models.passt import PaSSTConfig as JaxConfig
from passt_tpu.ops.frontend import MelConfig as JaxMelConfig
from passt_tpu.train import loop as jax_loop
from passt_tpu.train import metrics as jax_metrics
from passt_tpu.train import swa as jax_swa
from passt_tpu_torch import bench
from passt_tpu_torch.models.passt import PaSST, PaSSTConfig
from passt_tpu_torch.models.pretrained import state_dict_from_flax
from passt_tpu_torch.ops.frontend import MelConfig, log_mel_spectrogram
from passt_tpu_torch.train import loop, metrics, swa
from passt_tpu_torch.train.steps import (
    TrainState,
    create_train_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
    step_generators,
)

GEOM = dict(input_fdim=32, input_tdim=50, embed_dim=64, depth=2, num_heads=4, num_classes=8)
MEL = dict(n_mels=32, freqm=4, timem=8)


class _ListLoader:
    """Numpy batches, the same for every epoch; records set_epoch."""

    def __init__(self, batches):
        self.batches = batches
        self.epochs = []

    def set_epoch(self, epoch):
        self.epochs.append(epoch)

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)


def _batches(seed, n, b=4, classes=8, t=16000, kind="multilabel"):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        bi = b if i < n - 1 else max(1, b - 1)  # a ragged tail
        wave = (rng.standard_normal((bi, t)) * 0.3).astype(np.float32)
        if kind == "single_label":
            target = rng.integers(0, classes, bi)
        elif kind == "masked":
            k = classes // 2
            target = np.concatenate([rng.uniform(size=(bi, k)) < 0.4, rng.uniform(size=(bi, k)) < 0.7], 1)
            target = target.astype(np.float32)
        else:
            target = (rng.uniform(size=(bi, classes)) < 0.35).astype(np.float32)
        out.append({"wave": wave, "target": target, "name": [f"x{i}_{j}" for j in range(bi)]})
    return out


def _port(seed=0, moments_dtype=None, param_dtype=None, param_sr=False, steps_per_epoch=2, **opt):
    cfg = PaSSTConfig(**GEOM)
    mcfg = MelConfig(**MEL)
    tx = make_optimizer(lr=1e-3, steps_per_epoch=steps_per_epoch, moments_dtype=moments_dtype, **opt)
    model, state = create_train_state(cfg, tx, torch.Generator().manual_seed(seed), param_dtype=param_dtype,
                                      device="cpu")
    step = make_train_step(model, tx, mcfg, param_sr=param_sr)
    return model, tx, state, step, make_eval_step(model, mcfg)


# ---- metrics ----------------------------------------------------------------------------


def test_metrics_equal_jax():
    """AP, ROC-AUC, masked AP/ROC and the class-mean AP (sklearn path and
    the numpy fallback) on random scores with ties, a class without
    positives and a masked class without observations: equal to JAX's."""
    rng = np.random.default_rng(0)
    targets = (rng.uniform(size=(60, 12)) < 0.3).astype(np.float32)
    targets[:, 3] = 0.0
    scores = np.round(rng.uniform(size=(60, 12)), 2)  # ties
    mask = (rng.uniform(size=(60, 12)) < 0.7).astype(np.float32)
    mask[:, 5] = 0.0
    np.testing.assert_array_equal(metrics.average_precision(targets, scores),
                                  jax_metrics.average_precision(targets, scores))
    np.testing.assert_array_equal(metrics.roc_auc(targets, scores), jax_metrics.roc_auc(targets, scores))
    for use_sklearn in (True, False):
        assert metrics.mean_average_precision(targets, scores, use_sklearn) == \
            jax_metrics.mean_average_precision(targets, scores, use_sklearn)
    # the fallback agrees with sklearn (a no-positive class counts 0.0 in both)
    assert abs(metrics.mean_average_precision(targets, scores, True)
               - metrics.mean_average_precision(targets, scores, False)) < 1e-12
    for name in ("masked_mean_average_precision", "masked_roc_auc"):
        got = getattr(metrics, name)(targets, scores, mask)
        ref = getattr(jax_metrics, name)(targets, scores, mask)
        assert (np.isnan(got) and np.isnan(ref)) or got == ref, name
    # observed samples without positives count 0.0 in the masked mean
    only_neg = np.zeros((5, 1), np.float32)
    assert metrics.masked_mean_average_precision(only_neg, rng.uniform(size=(5, 1)), np.ones((5, 1))) == 0.0


# ---- SWA ----------------------------------------------------------------------------------


def test_swa_equal_jax():
    """The cadence over 12 epochs (start 3, freq 2) and the fp32 running
    average of a fixed bf16/fp32 params sequence, with the deferred init
    (the first epoch that fires): equal to JAX's average."""
    for start, freq, max_epochs in ((3, 2, 12), (1, 1, 5), (50, 5, 100)):
        j = jax_swa.SWAState(avg_params=None, swa_epoch_start=start, swa_freq=freq)
        p = swa.SWAState(avg_params=None, swa_epoch_start=start, swa_freq=freq)
        for e in range(max_epochs + 2):
            assert swa.swa_should_update(p, e, max_epochs) == jax_swa.swa_should_update(j, e, max_epochs)
            assert swa.swa_should_update(p, e) == jax_swa.swa_should_update(j, e)
    rng = np.random.default_rng(1)
    seq = [{"w": rng.standard_normal((5, 7)).astype(np.float32),
            "b": rng.standard_normal(7).astype(np.float32)} for _ in range(12)]
    jstate = pstate = None
    for e, params in enumerate(seq):
        tparams = {"w": torch.from_numpy(params["w"]).to(torch.bfloat16), "b": torch.from_numpy(params["b"])}
        jparams = {"w": jnp.asarray(params["w"], jnp.bfloat16), "b": jnp.asarray(params["b"])}
        probe = swa.SWAState(avg_params=None, swa_epoch_start=3, swa_freq=2)
        if swa.swa_should_update(pstate or probe, e, 12):
            if pstate is None:
                pstate = swa.swa_init(tparams, 3, 2)
                jstate = jax_swa.swa_init(jparams, 3, 2)
                assert pstate.avg_params["w"].data_ptr() != tparams["w"].data_ptr()
            pstate = swa.swa_update(pstate, tparams)
            jstate = jax_swa.swa_update(jstate, jparams)
    assert pstate.n_averaged == jstate.n_averaged == 5
    for k in ("w", "b"):
        assert pstate.avg_params[k].dtype == torch.float32
        np.testing.assert_allclose(pstate.avg_params[k].numpy(), np.asarray(jstate.avg_params[k]),
                                   rtol=2e-7, atol=0)  # fp32 rounding of the running mean
    assert swa.swa_step(pstate, tparams, 0, 12) is pstate  # epoch 0 does not fire (start 3)
    assert swa.swa_step(pstate, tparams, 1, 12).n_averaged == 6


# ---- evaluate ------------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["multilabel", "masked", "single_label"])
@pytest.mark.parametrize("transfer", ["float32", "int16"])
def test_evaluate_matches_jax(kind, transfer):
    """The metrics dict of ``evaluate`` against JAX ``evaluate`` on the same
    bridged weights and batches (4 + 4 + 3: a ragged tail), through the
    feed (depth 2) and inline (depth 0): n_eval exact, val_loss within 1e-5
    (fp32 order through two blocks), the rank metrics (ap, roc, accuracy)
    within 1e-6: they move only if two scores swap order, which the
    outputs' 2e-4 agreement (tests/test_torch_train.py) does not reach on
    these batches."""
    classes = 10 if kind == "masked" else 8  # masked: 5 labels + 5 mask columns
    kw = dict(GEOM, num_classes=5 if kind == "masked" else classes)
    jmodel, jparams = jax_passt_mod.init_passt(JaxConfig(**kw, attn_impl="xla"), jax.random.PRNGKey(3))
    jeval = jax_steps_mod.make_eval_step(jmodel, JaxMelConfig(**MEL), "single_label" if kind == "single_label"
                                         else "masked" if kind == "masked" else "multilabel")
    batches = _batches(4, 3, classes=classes, kind=kind)
    flags = dict(single_label=kind == "single_label", masked=kind == "masked")
    ref = jax_loop.evaluate(jeval, jparams, _ListLoader(batches), transfer_dtype=transfer, **flags)
    model = PaSST(PaSSTConfig(**kw))
    peval = make_eval_step(model, MelConfig(**MEL), "single_label" if kind == "single_label"
                           else "masked" if kind == "masked" else "multilabel")
    params = state_dict_from_flax(jax.tree.map(np.asarray, jparams))
    for depth in (2, 0):
        got = loop.evaluate(peval, params, _ListLoader(batches), transfer_dtype=transfer, device_prefetch=depth,
                            **flags)
        assert set(got) == set(ref), (got, ref)
        assert got["n_eval"] == ref["n_eval"] == 11
        assert abs(got["val_loss"] - ref["val_loss"]) < 1e-5
        for k in set(got) - {"n_eval", "val_loss"}:
            assert abs(got[k] - ref[k]) < 1e-6, (k, got[k], ref[k])
    assert loop.evaluate(peval, params, _ListLoader(batches), limit_batches=1, **flags)["n_eval"] == 4


def test_evaluate_edges_and_int16_quantizer():
    """An empty loader raises; an unknown transfer dtype raises; the int16
    quantizer is the JAX package's (round, clip at full scale) and its
    dequantization is exact for int16-container values."""
    _, _, state, _, ev = _port()
    with pytest.raises(ValueError, match="no eval batches"):
        loop.evaluate(ev, state.params, _ListLoader([]))
    with pytest.raises(ValueError, match="transfer_dtype"):
        loop.evaluate(ev, state.params, _ListLoader(_batches(0, 1)), transfer_dtype="bfloat16")
    wave = np.random.default_rng(2).uniform(-1.2, 1.2, (3, 1000)).astype(np.float32)
    q = loop._quantize_wave_int16(wave)
    np.testing.assert_array_equal(q, jax_loop._quantize_wave_int16(wave))
    np.testing.assert_array_equal(loop._dequant_int16(torch.from_numpy(q)).numpy(),
                                  np.asarray(jax_loop._DEQUANT_INT16(jnp.asarray(q))))


# ---- fit ------------------------------------------------------------------------------------


def _fit(state, step, ev, loader, val=None, **kw):
    args = dict(train_step=step, eval_step=ev, state=state, train_loader=loader, val_loader=val, seed=7,
                logger=loop.MetricsLogger(quiet=True), handle_sigterm=False)
    args.update(kw)
    return loop.fit(**args)


def _assert_params_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0, msg=k)


def test_fit_losses_equal_the_step_in_a_loop():
    """fit over 2 epochs x 2 steps (log_every_steps=1, int16 transfer, the
    feed at depth 2): every logged loss, the final params and the step
    count equal the port's own train step called in a loop on the same
    dequantized batches; the loader's epoch is set each epoch, lr and SWA
    land in the epoch records."""
    model, tx, state, step, ev = _port(moments_dtype="bfloat16_sr", param_dtype="bfloat16_sr", param_sr=True)
    batches = _batches(5, 2)
    rows = []

    class Rows(loop.MetricsLogger):
        def log(self, record):
            rows.append(record)

    loader = _ListLoader(batches)
    res = _fit(state, step, ev, loader, max_epochs=2, log_every_steps=1, transfer_dtype="int16",
               logger=Rows(quiet=True), lr_schedule=lambda s: 1e-3 * (s + 1), swa_epoch_start=1, swa_freq=1)
    assert loader.epochs == [0, 1] and res.state.step == 4 and not res.interrupted
    ref_state, ref_losses = state, []
    for _ in range(2):
        for b in batches:
            wave = torch.from_numpy(loop._quantize_wave_int16(b["wave"])).float() * (1.0 / 32768.0)
            ref_state, m = step(ref_state, {"wave": wave, "target": torch.from_numpy(b["target"])}, 7)
            ref_losses.append(float(m["loss"]))
    assert [r["loss"] for r in rows if "loss" in r] == ref_losses
    _assert_params_equal(res.state.params, ref_state.params)
    epochs = [r for r in rows if "epoch_time_s" in r]
    assert [r["train_loss"] for r in epochs] == [ref_losses[1], ref_losses[3]]
    assert [r["lr"] for r in epochs] == [1e-3 * 3, 1e-3 * 5]
    # swa_epoch_start=1 fires at the end of epoch 0 only (the last epoch's
    # params never enter the average)
    assert [r.get("swa_n") for r in epochs] == [1, None] and res.swa.n_averaged == 1


def test_fit_checkpoints_keep_last_n_and_best(tmp_path):
    """keep_last_n=2 without a monitor keeps the two latest epochs; with
    monitor="val_loss" / "min" the two best; epochs without the metric are
    not saved, and a monitor that eval never writes raises."""
    _, _, state, step, ev = _port()
    loader, val = _ListLoader(_batches(6, 2)), _ListLoader(_batches(7, 2))
    res = _fit(state, step, ev, loader, max_epochs=4, checkpoint_dir=str(tmp_path / "last"), keep_last_n=2)
    assert loop.checkpoint_epochs(str(tmp_path / "last")) == [2, 3]

    res = _fit(state, step, ev, loader, val, max_epochs=4, checkpoint_dir=str(tmp_path / "best"), keep_last_n=2,
               monitor="val_loss", monitor_mode="min")
    losses = {r["epoch"]: r["val_loss"] for r in res.history}
    best2 = sorted(sorted(losses, key=losses.get)[:2])
    assert loop.checkpoint_epochs(str(tmp_path / "best")) == best2
    assert not [f for f in os.listdir(tmp_path / "best") if not f.endswith(".pt")]  # no temporary left

    _fit(state, step, ev, loader, val, max_epochs=3, eval_every=2, checkpoint_dir=str(tmp_path / "skip"),
         keep_last_n=5, monitor="ap")
    assert loop.checkpoint_epochs(str(tmp_path / "skip")) == [1]
    with pytest.raises(ValueError, match="not found in the epoch record"):
        _fit(state, step, ev, loader, val, max_epochs=1, checkpoint_dir=str(tmp_path / "bad"), monitor="allap_x")


def test_restore_checkpoint_by_step_and_monitor(tmp_path):
    """restore_checkpoint: the latest, a given epoch, and the best by a
    monitor (the prefixed name of a two-set run resolves too); the restored
    params, optimizer state, step and SWA average equal what fit held."""
    _, tx, state, step, ev = _port(moments_dtype="bfloat16_sr", param_dtype="bfloat16_sr", param_sr=True)
    loader = _ListLoader(_batches(8, 2))
    vals = {"valid": _ListLoader(_batches(9, 1)), "eval": _ListLoader(_batches(10, 1))}
    d = str(tmp_path / "ck")
    res = _fit(state, step, ev, loader, val_loaders=vals, max_epochs=3, checkpoint_dir=d, keep_last_n=3,
               monitor="valid_ap", swa_epoch_start=2, swa_freq=1)
    assert loop.checkpoint_epochs(d) == [0, 1, 2]
    assert "eval_swa_ap" in res.history[1] and "valid_ap" in res.history[0]
    _, _, template, _, _ = _port(seed=5, moments_dtype="bfloat16_sr", param_dtype="bfloat16_sr")
    latest, swa_rest, epoch = loop.restore_checkpoint(d, template)
    assert epoch == 2 and latest.step == 6
    _assert_params_equal(latest.params, res.state.params)
    assert latest.opt_state.count == res.state.opt_state.count == 6
    _assert_params_equal(latest.opt_state.nu, res.state.opt_state.nu)
    _assert_params_equal(swa_rest[0], res.swa.avg_params)
    assert swa_rest[1] == res.swa.n_averaged == 2  # the ends of epochs 0 and 1
    by_step, swa0, e0 = loop.restore_checkpoint(d, template, step=0)
    assert e0 == 0 and by_step.step == 2 and swa0[1] == 1
    aps = {r["epoch"]: r["valid_ap"] for r in res.history}
    best_epoch = max(sorted(aps), key=lambda e: (aps[e], e))
    for monitor in ("valid_ap", "ap"):  # "ap" resolves to the one saved "valid_ap"
        assert loop.restore_checkpoint(d, template, monitor=monitor)[2] == best_epoch
    with pytest.raises(KeyError, match="not among"):
        loop.restore_checkpoint(d, template, monitor="roc")
    with pytest.raises(FileNotFoundError):
        loop.restore_checkpoint(str(tmp_path / "none"), template)
    _, _, fp32_template, _, _ = _port()
    with pytest.raises(RuntimeError, match="optimizer state"):
        loop.restore_checkpoint(d, fp32_template)


def test_resume_equals_the_uninterrupted_run(tmp_path):
    """3 epochs in one run against a run preempted (SIGTERM in the last step
    of epoch 0: it finishes the epoch, its SWA, eval and checkpoint, then
    stops), a restore, and the remaining 2 epochs from start_epoch=1 with
    the SWA average handed back: the same params, optimizer state, SWA
    average and history losses, bit for bit (on the CPU the step is
    deterministic)."""
    _, _, state, step, ev = _port(moments_dtype="bfloat16_sr", param_dtype="bfloat16_sr", param_sr=True)
    loader, val = _ListLoader(_batches(11, 2)), _ListLoader(_batches(12, 1))
    kw = dict(swa_epoch_start=2, swa_freq=1, transfer_dtype="int16", max_epochs=3)
    full = _fit(state, step, ev, loader, val, checkpoint_dir=str(tmp_path / "a"), **kw)

    def preempted(s, batch, seed):
        if s.step == 1:
            os.kill(os.getpid(), signal.SIGTERM)
        return step(s, batch, seed)

    d = str(tmp_path / "b")
    first = _fit(state, preempted, ev, loader, val, checkpoint_dir=d, handle_sigterm=True, **kw)
    assert first.interrupted and len(first.history) == 1 and first.history[0]["swa_n"] == 1
    _, _, template, _, _ = _port(seed=9, moments_dtype="bfloat16_sr", param_dtype="bfloat16_sr")
    restored, swa_rest, epoch = loop.restore_checkpoint(d, template)
    assert epoch == 0 and swa_rest[1] == 1
    rest = _fit(restored, step, ev, loader, val, start_epoch=epoch + 1, swa_restore=swa_rest, checkpoint_dir=d,
                **kw)
    _assert_params_equal(rest.state.params, full.state.params)
    _assert_params_equal(rest.state.opt_state.mu, full.state.opt_state.mu)
    _assert_params_equal(rest.swa.avg_params, full.swa.avg_params)
    assert rest.state.step == full.state.step == 6
    assert [r["train_loss"] for r in first.history + rest.history] == [r["train_loss"] for r in full.history]
    assert [r["val_loss"] for r in first.history + rest.history] == [r["val_loss"] for r in full.history]


def test_sigterm_stops_at_the_batch_boundary_and_restores_the_handler():
    """A SIGTERM during a step sets a flag that fit honours before the next
    batch: the step in flight completes, the run ends interrupted, and the
    previous SIGTERM handler is back afterwards (also after an error)."""
    _, _, state, step, ev = _port()
    seen = []

    def prev(signum, frame):
        seen.append(signum)

    old = signal.signal(signal.SIGTERM, prev)
    try:
        calls = []

        def stepping(s, batch, seed):
            calls.append(s.step)
            if len(calls) == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            return step(s, batch, seed)

        res = _fit(state, stepping, ev, _ListLoader(_batches(13, 4)), max_epochs=3, handle_sigterm=True,
                   device_prefetch=0)
        assert res.interrupted and res.state.step == 2 and calls == [0, 1] and res.history == []
        assert signal.getsignal(signal.SIGTERM) is prev and seen == []

        def failing(s, batch, seed):
            raise RuntimeError("step failed")

        with pytest.raises(RuntimeError, match="step failed"):
            _fit(state, failing, ev, _ListLoader(_batches(13, 2)), max_epochs=1, handle_sigterm=True)
        assert signal.getsignal(signal.SIGTERM) is prev
    finally:
        signal.signal(signal.SIGTERM, old)


def test_fit_limits_val_sets_dump_and_profile(tmp_path):
    """limit_train_batches / limit_eval_batches, two val sets with
    prefixes, the JSONL log, grad norms forwarded to the step rows, the
    spectrogram dump drawn from the step's own mel generator, and the
    torch.profiler trace window."""
    model, tx, state, _, ev = _port()
    mcfg = MelConfig(**MEL)
    step = make_train_step(model, tx, mcfg, log_grad_norm=True)
    vals = {"valid": _ListLoader(_batches(14, 3)), "eval": _ListLoader(_batches(15, 2))}
    log = str(tmp_path / "log" / "m.jsonl")
    batches = _batches(16, 3)
    res = _fit(state, step, ev, _ListLoader(batches), val_loaders=vals, max_epochs=1, limit_train_batches=2,
               limit_eval_batches=1, log_every_steps=1, logger=loop.MetricsLogger(log, quiet=True),
               dump_spectrograms=1, mel_cfg=mcfg, checkpoint_dir=str(tmp_path / "ck"),
               profile_dir=str(tmp_path / "prof"), profile_start_step=0, profile_num_steps=1)
    rec = res.history[0]
    assert res.state.step == 2 and rec["valid_n_eval"] == 4 and rec["eval_n_eval"] == 4
    lines = open(log).read().splitlines()
    assert len(lines) == 3 and "grad_norm" in lines[0]
    dump = np.load(tmp_path / "ck" / "spectrograms_step0.npy")
    ref = log_mel_spectrogram(torch.from_numpy(batches[0]["wave"]), mcfg,
                              generator=step_generators(7, 0, "cpu")["mel"], train=True)
    np.testing.assert_array_equal(dump, ref.numpy())
    assert not os.path.exists(tmp_path / "ck" / "spectrograms_step1.npy")
    assert os.listdir(tmp_path / "prof") == ["trace_step0.json"]
    with pytest.raises(ValueError, match="either val_loader or val_loaders"):
        _fit(state, step, ev, _ListLoader(batches), val=vals["eval"], val_loaders=vals, max_epochs=1)


# ---- the step options against the JAX step ------------------------------------------------


def _np_mask(batch, size, mask_param, iid):
    rng = np.random.default_rng(size)
    n = batch if iid else 1
    width = np.floor(rng.uniform(size=(n, 1)) * mask_param)
    start = np.floor(rng.uniform(size=(n, 1)) * (size - width))
    idx = np.arange(size)[None, :]
    return np.broadcast_to((idx >= start) & (idx < start + width), (batch, size))


def _np_keep(size, keep):
    return np.sort(np.random.default_rng(1000 * size + keep).permutation(size)[:keep])


@pytest.fixture
def injected_draws(monkeypatch):
    """The draws of tests/test_torch_train.py: SpecAugment masks, patchout
    indices and the mixup perm/lambda from numpy on both sides."""
    monkeypatch.setattr(jax_frontend_mod, "_axis_mask",
                        lambda key, b, size, p, iid: jnp.asarray(_np_mask(b, size, p, iid)))
    monkeypatch.setattr(frontend_mod, "_axis_mask",
                        lambda gen, b, size, p, iid: torch.from_numpy(_np_mask(b, size, p, iid).copy()))
    monkeypatch.setattr(jax_passt_mod, "_sorted_keep_indices",
                        lambda key, size, keep: jnp.asarray(_np_keep(size, keep)))
    monkeypatch.setattr(passt_mod, "_sorted_keep_indices",
                        lambda gen, size, keep: torch.from_numpy(_np_keep(size, keep)))
    perm, lam = np.array([2, 0, 1]), np.array([0.7, 0.55, 0.9], np.float32)
    monkeypatch.setattr(jax_steps_mod, "sample_mixup", lambda key, b, a: (jnp.asarray(perm), jnp.asarray(lam)))
    monkeypatch.setattr(steps_mod, "sample_mixup", lambda gen, b, a: (torch.from_numpy(perm), torch.from_numpy(lam)))


def _both_steps(step_kw, opt_kw, tdim_model=98):
    """A JAX and a port fp32 train step on bridged weights (the geometry and
    tolerances of test_torch_train.py's whole-step test)."""
    kw = dict(embed_dim=64, depth=2, num_heads=4, input_tdim=tdim_model, s_patchout_t=3, s_patchout_f=2,
              u_patchout=4)
    mel_kw = dict(fmin_aug_range=1, fmax_aug_range=1, freqm=16, timem=20)
    jtx = jax_steps_mod.make_optimizer(**opt_kw)
    jmodel, jstate = jax_steps_mod.create_train_state(JaxConfig(**kw, attn_impl="xla"), jtx, jax.random.PRNGKey(1))
    jstep = jax_steps_mod.make_train_step(jmodel, jtx, JaxMelConfig(**mel_kw), donate=False, **step_kw)
    model = PaSST(PaSSTConfig(**kw))
    ttx = make_optimizer(**opt_kw)
    params = state_dict_from_flax(jax.tree.map(np.asarray, jstate.params))
    state = TrainState(params=params, opt_state=ttx.init(params), step=0)
    return jstep, jstate, make_train_step(model, ttx, MelConfig(**mel_kw), **step_kw), state


def _step_batches(n):
    rng = np.random.default_rng(28)
    return [(rng.standard_normal((3, 32000)).astype(np.float32),
             (rng.uniform(size=(3, 527)) < 0.1).astype(np.float32)) for _ in range(n)]


def test_grad_accum_matches_optax_multisteps(injected_draws):
    """grad_accum=2 over 4 micro-steps (2 updates, an lr that changes every
    step so the u*K schedule index shows): the losses, the accumulator and
    the parameters after each micro-step against optax.MultiSteps, at the
    whole-step test's bounds (loss 1e-5, params 2e-5)."""
    opt_kw = dict(lr=1e-3, steps_per_epoch=1, warm_up_len=4, grad_accum=2)
    jstep, jstate, step, state = _both_steps({}, opt_kw)
    params0 = dict(state.params)
    for i, (wave, target) in enumerate(_step_batches(4)):
        jstate, jm = jstep(jstate, {"wave": jnp.asarray(wave), "target": jnp.asarray(target)},
                           jax.random.PRNGKey(5))
        state, m = step(state, {"wave": torch.from_numpy(wave), "target": torch.from_numpy(target)}, 5)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), atol=1e-5)
        assert state.opt_state.mini_step == int(jstate.opt_state.mini_step) == (i + 1) % 2
        assert state.opt_state.gradient_step == int(jstate.opt_state.gradient_step) == (i + 1) // 2
        jparams = state_dict_from_flax(jax.tree.map(np.asarray, jstate.params))
        for k, ref in jparams.items():
            np.testing.assert_allclose(state.params[k].numpy(), ref.numpy(), atol=2e-5, rtol=0, err_msg=k)
        if i == 0:  # a micro-step that does not update leaves every parameter as it was
            _assert_params_equal(state.params, params0)
            jacc = state_dict_from_flax(jax.tree.map(np.asarray, jstate.opt_state.acc_grads))
            for k, ref in jacc.items():
                scale = max(float(ref.abs().max()), 1e-30)
                assert float((state.opt_state.acc_grads[k] - ref).abs().max()) <= 1e-4 * scale, k
    assert state.opt_state.inner_opt_state.count == 2


def test_grad_norms_match_jax(injected_draws):
    """log_grad_norm and log_grad_norm_per_block: the same metric names as
    the JAX step (one per top-level parameter group) and the same values
    within 1e-4 of each (the gradients' summation order)."""
    step_kw = dict(log_grad_norm=True, log_grad_norm_per_block=True)
    jstep, jstate, step, state = _both_steps(step_kw, dict(lr=1e-3, steps_per_epoch=1, warm_up_len=1))
    (wave, target), = _step_batches(1)
    _, jm = jstep(jstate, {"wave": jnp.asarray(wave), "target": jnp.asarray(target)}, jax.random.PRNGKey(5))
    _, m = step(state, {"wave": torch.from_numpy(wave), "target": torch.from_numpy(target)}, 5)
    assert set(m) == set(jm) and "grad_norm/blocks_1" in m and "grad_norm/head_linear" in m
    for k in m:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-4, err_msg=k)


def test_input_tdim_override_matches_jax(injected_draws, monkeypatch):
    """input_tdim=60 on a model built for 98 frames: the train step's loss
    and parameters, and the eval step's outputs, against the JAX steps with
    the same override. The train-mode time-embedding offset (a randint on
    each side; the other randint draws here have a range of one) is
    injected as 0 on both sides."""
    monkeypatch.setattr(jax.random, "randint", lambda key, shape, lo, hi, dtype=jnp.int32: jnp.zeros(shape, dtype))
    real_randint = torch.randint
    monkeypatch.setattr(torch, "randint", lambda lo, hi, size, **kw: real_randint(lo, lo + 1, size, **kw))
    opt_kw = dict(lr=1e-3, steps_per_epoch=1, warm_up_len=1)
    jstep, jstate, step, state = _both_steps(dict(input_tdim=60), opt_kw)
    (wave, target), = _step_batches(1)
    jnew, jm = jstep(jstate, {"wave": jnp.asarray(wave), "target": jnp.asarray(target)}, jax.random.PRNGKey(5))
    new, m = step(state, {"wave": torch.from_numpy(wave), "target": torch.from_numpy(target)}, 5)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), atol=1e-5)
    jparams = state_dict_from_flax(jax.tree.map(np.asarray, jnew.params))
    for k, ref in jparams.items():
        np.testing.assert_allclose(new.params[k].numpy(), ref.numpy(), atol=2e-5, rtol=0, err_msg=k)
    kw = dict(embed_dim=64, depth=2, num_heads=4, input_tdim=98, num_classes=527)
    jmodel = jax_passt_mod.PaSST(JaxConfig(**kw, attn_impl="xla"))
    jeval = jax_steps_mod.make_eval_step(jmodel, JaxMelConfig(), input_tdim=60)
    ref = jeval(jstate.params, {"wave": jnp.asarray(wave), "target": jnp.asarray(target)})
    got = make_eval_step(PaSST(PaSSTConfig(**kw)), MelConfig(), input_tdim=60)(
        state.params, {"wave": torch.from_numpy(wave), "target": torch.from_numpy(target)})
    for k in ("out", "loss_per_example", "features"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=2e-4, rtol=0, err_msg=k)


# ---- the bench's timing ------------------------------------------------------------------------


def test_bench_best_of_runs_on_a_fake_step():
    """best_of_runs calls one timed run per run and keeps the least ms/step;
    spread is (slowest - best) / best; the bench refuses to run without a
    card (no CPU fallback) and defaults to the best of 3 runs of 200."""
    times = iter([80.0, 61.5, 70.0])
    calls = []

    def run():
        calls.append(1)
        return next(times)

    best, got = bench.best_of_runs(run, 3)
    assert best == 61.5 and got == [80.0, 61.5, 70.0] and len(calls) == 3
    assert bench.spread(got) == pytest.approx((80.0 - 61.5) / 61.5)
    with pytest.raises(ValueError):
        bench.best_of_runs(run, 0)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="no CUDA device"):
            bench.main([])
    import inspect

    src = inspect.getsource(bench.main)
    assert 'default=200' in src and 'default=3' in src
