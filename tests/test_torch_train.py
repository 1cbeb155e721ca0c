"""Port training slice (passt_tpu_torch.train, train-mode frontend and model)
vs the JAX package, on the CPU.

JAX's threefry draws and torch's Philox draws never agree, so the draw
functions are module-level on both sides (``_axis_mask``,
``_sorted_keep_indices``, ``sample_mixup`` as the steps modules see it) and
the tests monkeypatch the same function on both sides with one that returns
numpy-made draws. The weights go across through ``state_dict_from_flax``.
Stochastic rounding has no common bit stream either: it is held
statistically.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import passt_tpu.models.passt as jax_passt_mod
import passt_tpu.ops.frontend as jax_frontend_mod
import passt_tpu.train.steps as jax_steps_mod
import passt_tpu_torch.models.passt as passt_mod
import passt_tpu_torch.ops.frontend as frontend_mod
import passt_tpu_torch.train.steps as steps_mod
from passt_tpu.models.passt import PaSSTConfig as JaxConfig
from passt_tpu.models.passt import init_passt
from passt_tpu.ops.frontend import MelConfig as JaxMelConfig
from passt_tpu.train import losses as jax_losses
from passt_tpu.train import mixup as jax_mixup
from passt_tpu.train import optim as jax_optim
from passt_tpu.train import schedules as jax_schedules
from passt_tpu_torch.models.passt import PaSST, PaSSTConfig
from passt_tpu_torch.models.pretrained import state_dict_from_flax
from passt_tpu_torch.ops.frontend import MelConfig, log_mel_spectrogram
from passt_tpu_torch.train import losses, mixup, optim, schedules
from passt_tpu_torch.train.steps import TrainState, make_optimizer, make_train_step

TINY = dict(embed_dim=64, depth=2, num_heads=4, input_tdim=98)
FIXED_RANGE = dict(fmin_aug_range=1, fmax_aug_range=1)  # randint(0, 1): no jitter


def _np_mask(batch, size, mask_param, iid):
    """A SpecAugment-style mask made with numpy from the axis size alone, so
    both sides get the same one whatever their call order."""
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
    """SpecAugment masks and patchout indices from numpy on both sides."""
    monkeypatch.setattr(jax_frontend_mod, "_axis_mask",
                        lambda key, b, size, p, iid: jnp.asarray(_np_mask(b, size, p, iid)))
    monkeypatch.setattr(frontend_mod, "_axis_mask",
                        lambda gen, b, size, p, iid: torch.from_numpy(_np_mask(b, size, p, iid).copy()))
    monkeypatch.setattr(jax_passt_mod, "_sorted_keep_indices",
                        lambda key, size, keep: jnp.asarray(_np_keep(size, keep)))
    monkeypatch.setattr(passt_mod, "_sorted_keep_indices",
                        lambda gen, size, keep: torch.from_numpy(_np_keep(size, keep)))


def _wave(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# ---- frontend -----------------------------------------------------------------


@pytest.mark.parametrize("iid", [False, True])
def test_train_frontend_matches_jax(injected_draws, iid):
    """Train-mode log-mel with the masks injected and fmin/fmax fixed: the
    same fp32 matmul formulation on both sides (1e-5, as in eval)."""
    wave = _wave(21, (3, 35200))
    kw = dict(FIXED_RANGE, iid_masks=iid, freqm=20, timem=30)
    ref = np.asarray(jax_frontend_mod.log_mel_spectrogram(
        jnp.asarray(wave), JaxMelConfig(**kw), rng=jax.random.PRNGKey(0), train=True))
    got = log_mel_spectrogram(torch.from_numpy(wave), MelConfig(**kw),
                              generator=torch.Generator(), train=True).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    # masked cells hold the normalised zero, (0 + 4.5) / 5
    assert (np.isclose(got, 0.9).all(axis=2)).any() and (np.isclose(got, 0.9).all(axis=1)).any()


def test_axis_mask_semantics():
    """Shared masks: one contiguous integer interval for the whole batch,
    narrower than mask_param; iid masks: one interval per sample."""
    gen = torch.Generator().manual_seed(3)
    widths = []
    for _ in range(200):
        m = frontend_mod._axis_mask(gen, 4, 100, 30, False)
        assert m.shape == (4, 100) and m.dtype == torch.bool
        assert (m == m[0]).all()
        idx = torch.nonzero(m[0]).flatten()
        if len(idx):
            assert (idx[-1] - idx[0] + 1) == len(idx)
        widths.append(len(idx))
    assert max(widths) < 30 and min(widths) == 0 and np.mean(widths) > 10
    m = frontend_mod._axis_mask(torch.Generator().manual_seed(4), 64, 100, 30, True)
    assert m.shape == (64, 100) and len({tuple(r.tolist()) for r in m}) > 1


def test_frontend_jitter_draws_and_no_aug_equals_eval():
    """With no masks and fixed ranges, train equals eval; with the AudioSet
    ranges the jittered band edges move the output, reproducibly per seed."""
    wave = torch.from_numpy(_wave(22, (2, 32000)))
    plain = MelConfig(freqm=0, timem=0, **FIXED_RANGE)
    torch.testing.assert_close(
        log_mel_spectrogram(wave, plain, generator=torch.Generator(), train=True),
        log_mel_spectrogram(wave, plain), rtol=0, atol=0)
    aug = MelConfig(freqm=0, timem=0, fmin_aug_range=10, fmax_aug_range=2000)
    a = log_mel_spectrogram(wave, aug, generator=torch.Generator().manual_seed(5), train=True)
    b = log_mel_spectrogram(wave, aug, generator=torch.Generator().manual_seed(5), train=True)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, log_mel_spectrogram(wave, aug))


# ---- model ----------------------------------------------------------------------


def _jax_params(cfg, seed=1):
    model, params = init_passt(cfg, jax.random.PRNGKey(seed))
    return model, jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("dtype,attn_impl", [("float32", "xla"), ("float32", "fused"), ("bfloat16", "xla")])
def test_train_mode_passt_matches_jax(injected_draws, dtype, attn_impl):
    """Structured (time, then frequency) and unstructured patchout with the
    indices injected, at input_tdim equal to the nominal grid (no offset
    drawn), no dropout. JAX runs its "xla" attention; the port's "fused"
    entry takes the kernels' plain versions on CPU tensors. Bounds as the
    eval tests: fp32 2e-4 (observed < 1e-6); bf16 2e-2, two bf16 ulps of
    logits < 1 (the port rounds where flax rounds)."""
    kw = dict(TINY, dtype=dtype, s_patchout_t=3, s_patchout_f=2, u_patchout=5)
    jmodel, params = _jax_params(JaxConfig(**kw, attn_impl="xla"))
    x = np.random.default_rng(23).standard_normal((2, 1, 128, 98)).astype(np.float32)
    jl, jf = jmodel.apply({"params": params}, jnp.asarray(x), train=True,
                          rngs={"patchout": jax.random.PRNGKey(0)})
    model = PaSST(PaSSTConfig(**kw, attn_impl=attn_impl))
    model.load_state_dict(state_dict_from_flax(params))
    logits, features = model(torch.from_numpy(x), train=True, generators={"patchout": torch.Generator()})
    assert PaSSTConfig(**kw).seq_len(train=True) == (12 - 2) * (9 - 3) - 5 + 2
    tol = 2e-4 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jl), atol=tol, rtol=0)
    np.testing.assert_allclose(features.detach().numpy(), np.asarray(jf), atol=tol, rtol=0)


LN_VARIANTS = {"fuse_ln_qkv": dict(fuse_ln_qkv=True), "ln_fused": dict(ln_impl="fused")}


@pytest.mark.parametrize("variant", sorted(LN_VARIANTS))
def test_train_mode_ln_variants_match_jax(injected_draws, monkeypatch, variant):
    """The train-mode forward under fuse_ln_qkv / ln_impl="fused" (fused
    attention, fp32, patchout indices injected) vs the JAX model with the
    same switches, its Pallas kernels in interpret mode. The fused norm1
    path takes the backward's gate (N = 58 fits). fp32 2e-4 as above."""
    kw = dict(TINY, dtype="float32", s_patchout_t=3, s_patchout_f=2, u_patchout=5, attn_impl="fused",
              **LN_VARIANTS[variant])
    jmodel, params = _jax_params(JaxConfig(**kw))
    x = np.random.default_rng(33).standard_normal((2, 1, 128, 98)).astype(np.float32)
    jl, jf = jmodel.apply({"params": params}, jnp.asarray(x), train=True,
                          rngs={"patchout": jax.random.PRNGKey(0)})
    model = PaSST(PaSSTConfig(**kw))
    model.load_state_dict(state_dict_from_flax(params))
    fused = passt_mod.fused_ln_qkv_attention
    calls = []
    monkeypatch.setattr(passt_mod, "fused_ln_qkv_attention", lambda *a, **k: calls.append(1) or fused(*a, **k))
    logits, features = model(torch.from_numpy(x), train=True, generators={"patchout": torch.Generator()})
    assert len(calls) == (TINY["depth"] if variant == "fuse_ln_qkv" else 0)
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jl), atol=2e-4, rtol=0)
    np.testing.assert_allclose(features.detach().numpy(), np.asarray(jf), atol=2e-4, rtol=0)


def test_train_time_offset_crops_the_time_embedding():
    """A clip shorter than the time grid takes a window of the time
    embedding at a random offset: the same as eval (a prefix) on a model
    whose embedding starts at that offset."""
    cfg = PaSSTConfig(**TINY)
    model = passt_mod.init_weights(PaSST(cfg), torch.Generator().manual_seed(2))
    x = torch.from_numpy(np.random.default_rng(24).standard_normal((2, 1, 128, 56)).astype(np.float32))
    t_cur, t_grid = (56 - 16) // 10 + 1, cfg.grid_size[1]
    gen = torch.Generator().manual_seed(9)
    offset = int(torch.randint(0, t_grid - t_cur + 1, (), generator=torch.Generator().manual_seed(9)))
    with torch.no_grad():
        got, _ = model(x, train=True, generators={"patchout": gen})
        shifted = PaSST(cfg)
        shifted.load_state_dict(model.state_dict())
        shifted.time_new_pos_embed[..., :t_cur] = model.time_new_pos_embed[..., offset:offset + t_cur]
        want, _ = shifted(x)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_dropout_and_drop_path_draw_from_their_generators():
    """Dropout and stochastic depth change the output, reproducibly from the
    generators; train without them equals eval."""
    x = torch.from_numpy(np.random.default_rng(25).standard_normal((3, 1, 128, 98)).astype(np.float32))
    base = passt_mod.init_weights(PaSST(PaSSTConfig(**TINY)), torch.Generator().manual_seed(2))
    with torch.no_grad():
        torch.testing.assert_close(base(x, train=True)[0], base(x)[0], rtol=0, atol=0)
        noisy = PaSST(PaSSTConfig(**TINY, drop_rate=0.2, attn_drop_rate=0.1, drop_path_rate=0.3))
        noisy.load_state_dict(base.state_dict())

        def run(seed):
            gens = {k: torch.Generator().manual_seed(seed + i) for i, k in enumerate(("dropout", "droppath"))}
            return noisy(x, train=True, generators=gens)[0]

        torch.testing.assert_close(run(1), run(1), rtol=0, atol=0)
        assert not torch.equal(run(1), run(2)) and not torch.equal(run(1), noisy(x)[0])
    with pytest.raises(ValueError, match="dropout"):
        noisy(x, train=True, generators={"droppath": torch.Generator()})
    m = passt_mod.drop_path(torch.ones(4000, 3), 0.25, torch.Generator().manual_seed(0))
    assert set(m[:, 0].unique().tolist()) <= {0.0, float(np.float32(1.0 / 0.75))} and abs(float(m.mean()) - 1.0) < 0.05


# ---- losses, mixup, schedules ----------------------------------------------------


def test_losses_match_jax():
    """The same fp32 formulas (1e-6)."""
    rng = np.random.default_rng(26)
    logits = rng.standard_normal((6, 20)).astype(np.float32) * 3
    targets = (rng.uniform(size=(6, 20)) < 0.3).astype(np.float32)
    with_mask = np.concatenate([targets[:, :10], (rng.uniform(size=(6, 10)) < 0.7)], 1).astype(np.float32)
    labels = rng.integers(0, 20, 6)
    perm = rng.permutation(6)
    lam = rng.uniform(0.5, 1.0, 6).astype(np.float32)
    T = torch.from_numpy
    cases = [
        (losses.multilabel_loss(T(logits), T(targets)), jax_losses.multilabel_loss(logits, targets)),
        (losses.multilabel_loss(T(logits), T(targets), T(perm), T(lam)),
         jax_losses.multilabel_loss(logits, targets, perm, lam)),
        (losses.single_label_mixup_loss(T(logits), T(labels)), jax_losses.single_label_mixup_loss(logits, labels)),
        (losses.single_label_mixup_loss(T(logits), T(labels), T(perm), T(lam)),
         jax_losses.single_label_mixup_loss(logits, labels, perm, lam)),
    ]
    for mix_masks in (False, True):
        cases.append((
            losses.masked_bce_loss(T(logits[:, :10]), T(with_mask), T(perm), T(lam), mix_masks=mix_masks),
            jax_losses.masked_bce_loss(logits[:, :10], with_mask, perm, lam, mix_masks=mix_masks),
        ))
    for got, ref in cases:
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6, atol=1e-6)


def test_apply_mixup_matches_jax_and_sample_mixup_statistics():
    """apply_mixup with injected perm/lambda equals JAX's (same fp32 ops);
    sample_mixup draws a permutation and lambda = max(B, 1 - B) with
    B ~ Beta(a, a): its mean over 20000 draws is E[max(B, 1 - B)] within
    five standard errors (numpy's Beta sampler gives the expectation)."""
    rng = np.random.default_rng(27)
    x = rng.standard_normal((5, 1, 8, 7)).astype(np.float32)
    perm, lam = rng.permutation(5), rng.uniform(0.5, 1, 5).astype(np.float32)
    got = mixup.apply_mixup(torch.from_numpy(x), torch.from_numpy(perm), torch.from_numpy(lam))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_mixup.apply_mixup(x, perm, lam)), atol=1e-7)

    n, alpha = 20000, 0.3
    p, lam = mixup.sample_mixup(torch.Generator().manual_seed(1), n, alpha)
    assert p.dtype == torch.int64 and sorted(p.tolist()) == list(range(n))
    assert lam.dtype == torch.float32 and float(lam.min()) >= 0.5 and float(lam.max()) <= 1.0
    b = np.random.default_rng(2).beta(alpha, alpha, 200000)
    want = np.maximum(b, 1 - b)
    assert abs(float(lam.mean()) - want.mean()) < 5 * want.std() / np.sqrt(n)
    assert abs(float(lam.std()) - want.std()) < 0.01


def test_schedules_match_jax():
    """Epoch lambdas equal in float64; the step schedule's fp32 table equal."""
    for args in ((5, 50, 50, 0.01, "exp_lin"), (3, 10, 7, 0.05, "exp_lin"), (20, 100, 50, 0.01, "cos_cyc")):
        f, g = schedules.get_scheduler_lambda(*args), jax_schedules.get_scheduler_lambda(*args)
        for e in range(0, 130):
            assert f(e) == g(e)
    for name in ("exp_rampup", "linear_rampup"):
        assert getattr(schedules, name)(7)(3) == getattr(jax_schedules, name)(7)(3)
    fn = schedules.get_scheduler_lambda()
    ours = schedules.make_lr_schedule(2e-5, fn, 37)
    theirs = jax_schedules.make_lr_schedule(2e-5, fn, 37)
    for step in (0, 1, 36, 37, 500, 3700, 10 ** 7):
        assert ours(step) == float(theirs(step))


# ---- optimizers ----------------------------------------------------------------


def _tree(seed, shapes, dtypes=None):
    rng = np.random.default_rng(seed)
    dtypes = dtypes or {}
    return {k: rng.standard_normal(s).astype(np.float32) * 0.1 for k, s in shapes.items()}, dtypes


SHAPES = {"w": (16, 8), "b": (8,), "emb": (1, 4, 6)}


def _run_both(jtx, ttx, params_np, cast, steps=3):
    """``steps`` updates from the same params and grads on both sides;
    returns the per-step (jax, port) updates and final states."""
    jp = {k: jnp.asarray(v, cast.get(k, jnp.float32)) for k, v in params_np.items()}
    tp = {k: torch.from_numpy(v).to(getattr(torch, str(jnp.dtype(cast.get(k, jnp.float32)))))
          for k, v in params_np.items()}
    js, ts = jtx.init({k: jnp.asarray(v) for k, v in params_np.items()}), ttx.init(
        {k: torch.from_numpy(v) for k, v in params_np.items()})
    out = []
    for i in range(steps):
        grads = {k: np.random.default_rng(100 + i).standard_normal(v.shape).astype(np.float32) * (i + 1)
                 for k, v in params_np.items()}
        ju, js = jtx.update({k: jnp.asarray(g, jp[k].dtype) for k, g in grads.items()}, js, jp)
        tu, ts = ttx.update({k: torch.from_numpy(g).to(tp[k].dtype) for k, g in grads.items()}, ts, tp)
        out.append((ju, tu))
    return out, js, ts


def test_adamw_matches_optax():
    """fp32 AdamW (moments None) and bf16 first moment vs optax.adamw with a
    schedule: updates to 1e-6 of their size (fp32 rounding order), moments
    to their storage precision."""
    sched_j = jax_steps_mod.make_schedule(lr=1e-3, steps_per_epoch=2, warm_up_len=2)
    for mu_dtype in (None, "bfloat16"):
        jtx = optax.adamw(sched_j, weight_decay=1e-4, mu_dtype=None if mu_dtype is None else jnp.bfloat16)
        ttx = make_optimizer(lr=1e-3, steps_per_epoch=2, warm_up_len=2, moments_dtype=mu_dtype)
        params, _ = _tree(0, SHAPES)
        steps, js, ts = _run_both(jtx, ttx, params, {})
        for ju, tu in steps:
            for k in params:
                ref = np.asarray(ju[k])
                np.testing.assert_allclose(tu[k].numpy(), ref, rtol=0, atol=1e-6 * np.abs(ref).max())
        adam = js[0]
        assert ts.count == int(adam.count) == 3
        for k in params:
            assert ts.mu[k].dtype == (torch.bfloat16 if mu_dtype else torch.float32)
            np.testing.assert_allclose(ts.mu[k].float().numpy(), np.asarray(adam.mu[k].astype(jnp.float32)),
                                       rtol=2.0**-7 if mu_dtype else 1e-6, atol=1e-7)
            np.testing.assert_allclose(ts.nu[k].numpy(), np.asarray(adam.nu[k]), rtol=1e-6)


def test_adamw_bf16sr_without_sr_matches_jax():
    """adamw_bf16sr(sr_nu=False) on bf16 matrices and fp32 vectors: fp32
    updates for every leaf, to 1e-4 of their size: the bias correction
    c2 = 1 - exp(t log b2) keeps 3 digits of an fp32 exp, so one ulp of
    exp (numpy's on the host here, XLA's in JAX) is 6e-5 of c2 and 3e-5 of
    the update; bf16 moments equal up to one bf16 ulp where the fp32 values
    straddle a rounding boundary."""
    params, _ = _tree(1, SHAPES)
    cast = {"w": jnp.bfloat16, "emb": jnp.bfloat16}
    jtx = jax_optim.adamw_bf16sr(1e-3, weight_decay=1e-4, sr_nu=False)
    ttx = optim.adamw_bf16sr(1e-3, weight_decay=1e-4, sr_nu=False)
    steps, js, ts = _run_both(jtx, ttx, params, cast)
    for ju, tu in steps:
        for k in params:
            assert tu[k].dtype == torch.float32
            ref = np.asarray(ju[k].astype(jnp.float32))
            np.testing.assert_allclose(tu[k].numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    for k in params:
        for got, ref in ((ts.mu[k], js.mu[k]), (ts.nu[k], js.nu[k])):
            assert got.dtype == torch.bfloat16
            np.testing.assert_allclose(got.float().numpy(), np.asarray(ref.astype(jnp.float32)), rtol=2.0**-7)


def test_stochastic_rounding_is_unbiased():
    """Each SR result is one of the two bf16 neighbours of the fp32 value,
    and the mean over 200000 draws is the value within five standard errors
    of the Bernoulli rounding (ulp / 2 / sqrt(n) at worst); NaN and inf pass
    through; bf16-exact values stay exact."""
    n = 200000
    for value in (0.1, -3.3333, 1e-3 + 1e-7):
        bits = np.array([value], np.float32).view(np.uint32) & np.uint32(0xFFFF0000)
        lo, hi = bits.view(np.float32)[0], (bits + np.uint32(0x10000)).view(np.float32)[0]
        x = torch.full((n,), value, dtype=torch.float32)
        got = optim._stochastic_round_bf16(x, torch.Generator().manual_seed(7)).float().numpy()
        assert set(np.unique(got).tolist()) <= {lo, hi}
        ulp = abs(float(hi) - float(lo))
        assert abs(got.astype(np.float64).mean() - np.float32(value)) < 5 * ulp / 2 / np.sqrt(n)
    special = torch.tensor([float("nan"), float("inf"), -float("inf"), 0.5, -2.0])
    got = optim._stochastic_round_bf16(special, torch.Generator().manual_seed(1)).float()
    assert torch.isnan(got[0]) and got[1] == float("inf") and got[2] == -float("inf")
    assert got[3] == 0.5 and got[4] == -2.0


def test_apply_updates_sr_moves_bf16_weights_in_expectation():
    """An update far below the bf16 ulp moves a bf16 weight in expectation
    (nearest rounding would drop it); fp32 leaves add exactly."""
    n = 100000
    p = {"w": torch.full((n, 1), 0.1).to(torch.bfloat16), "b": torch.zeros(3)}
    u = {"w": torch.full((n, 1), 1e-5), "b": torch.full((3,), 1e-5)}
    out = optim.apply_updates_sr(p, u, torch.Generator().manual_seed(3))
    assert out["w"].dtype == torch.bfloat16 and out["b"].dtype == torch.float32
    assert torch.equal(optim.apply_updates(p, u)["w"], p["w"])  # nearest: lost
    want = float(p["w"][0].float()) + 1e-5
    ulp = 2.0**-10  # bf16 spacing in [0.0625, 0.125)
    assert abs(float(out["w"].double().mean()) - want) < 5 * ulp / 2 / np.sqrt(n)
    torch.testing.assert_close(out["b"], u["b"], rtol=0, atol=0)
    cast = optim.cast_params_storage({"m": torch.ones(2, 2), "v": torch.ones(2)}, "bfloat16_sr")
    assert cast["m"].dtype == torch.bfloat16 and cast["v"].dtype == torch.float32


# ---- the whole step --------------------------------------------------------------


def test_fp32_train_step_matches_jax(injected_draws, monkeypatch):
    """One whole fp32 train step from bridged params with every draw injected
    (masks, patchout indices, mixup perm/lambda; fmin/fmax fixed; no
    dropout): the loss, the gradients and the new parameters vs the JAX
    step. The gradients are read from the first moment after one AdamW
    step, mu = (1 - b1) g, on both sides. JAX runs its "xla" attention (a
    small compile; the attention-gradient tests hold the interpret-mode
    kernels); the port runs its "fused" entries, whose backward takes the
    backward kernel's plain version here. Bounds: loss 1e-5, each leaf's
    mu 1e-4 of the leaf's max (fp32 summation order through two blocks and
    their backward); parameters 2e-5, 7% of this step's lr (2.9e-4): an
    AdamW step is lr g / (|g| + eps), which for |g| near eps = 1e-8 turns
    the gradient's last digits into a visible share of lr."""
    _fp32_step_vs_jax(monkeypatch, dict(attn_impl="xla"), dict(attn_impl="fused"))


@pytest.mark.parametrize("variant", sorted(LN_VARIANTS))
def test_fp32_train_step_ln_variants_match_jax(injected_draws, monkeypatch, variant):
    """The same whole fp32 step under fuse_ln_qkv / ln_impl="fused": the
    port (fused attention, the kernels' plain versions here) against the
    JAX step with the same switches, whose Pallas kernels (F1, B2 and the
    flat attention kernels, or the LayerNorm backward) run in interpret
    mode. The same bounds as the default step."""
    extra = LN_VARIANTS[variant]
    jax_kw = dict(attn_impl="fused" if variant == "fuse_ln_qkv" else "xla", **extra)
    _fp32_step_vs_jax(monkeypatch, jax_kw, dict(attn_impl="fused", **extra))


def _fp32_step_vs_jax(monkeypatch, jax_kw, port_kw):
    """One fp32 step on both sides (see test_fp32_train_step_matches_jax)."""
    perm, lam = np.array([2, 0, 1]), np.array([0.7, 0.55, 0.9], np.float32)
    monkeypatch.setattr(jax_steps_mod, "sample_mixup", lambda key, b, a: (jnp.asarray(perm), jnp.asarray(lam)))
    monkeypatch.setattr(steps_mod, "sample_mixup", lambda gen, b, a: (torch.from_numpy(perm), torch.from_numpy(lam)))
    kw = dict(TINY, s_patchout_t=3, s_patchout_f=2, u_patchout=4)
    mel_kw = dict(FIXED_RANGE, freqm=16, timem=20)
    opt_kw = dict(lr=1e-3, steps_per_epoch=1, warm_up_len=1)

    jcfg = JaxConfig(**kw, **jax_kw)
    jtx = jax_steps_mod.make_optimizer(**opt_kw)
    jmodel, jstate = jax_steps_mod.create_train_state(jcfg, jtx, jax.random.PRNGKey(1))
    jstep = jax_steps_mod.make_train_step(jmodel, jtx, JaxMelConfig(**mel_kw), donate=False)
    rng = np.random.default_rng(28)
    wave = rng.standard_normal((3, 32000)).astype(np.float32)
    target = (rng.uniform(size=(3, 527)) < 0.1).astype(np.float32)
    jnew, jmetrics = jstep(jstate, {"wave": jnp.asarray(wave), "target": jnp.asarray(target)},
                           jax.random.PRNGKey(5))

    model = PaSST(PaSSTConfig(**kw, **port_kw))
    ttx = make_optimizer(**opt_kw)
    params = state_dict_from_flax(jax.tree.map(np.asarray, jstate.params))
    assert set(params) == {k for k, _ in model.named_parameters()}
    state = TrainState(params=params, opt_state=ttx.init(params), step=0)
    step = make_train_step(model, ttx, MelConfig(**mel_kw))
    new, metrics = step(state, {"wave": torch.from_numpy(wave), "target": torch.from_numpy(target)}, 5)

    assert new.step == 1 and new.opt_state.count == 1
    np.testing.assert_allclose(float(metrics["loss"]), float(jmetrics["loss"]), atol=1e-5)
    jmu = state_dict_from_flax(jax.tree.map(np.asarray, jnew.opt_state[0].mu))
    jparams = state_dict_from_flax(jax.tree.map(np.asarray, jnew.params))
    for k, ref in jmu.items():
        scale = max(float(ref.abs().max()), 1e-30)
        assert float((new.opt_state.mu[k] - ref).abs().max()) <= 1e-4 * scale, k
    for k, ref in jparams.items():
        np.testing.assert_allclose(new.params[k].numpy(), ref.numpy(), atol=2e-5, rtol=0, err_msg=k)
    moved = sum(not torch.equal(new.params[k], params[k]) for k in params)
    assert moved >= len(params) - 2


def test_mel_batch_key_skips_the_frontend():
    """A batch with ``mel`` runs the same step as one with ``wave`` whose
    train-mode frontend draws nothing (no masks, fixed band edges): the
    state and loss agree exactly."""
    mel_cfg = MelConfig(freqm=0, timem=0, **FIXED_RANGE)
    model = PaSST(PaSSTConfig(**TINY, s_patchout_t=2))
    passt_mod.init_weights(model, torch.Generator().manual_seed(3))
    tx = make_optimizer(lr=1e-3, steps_per_epoch=1, warm_up_len=1, moments_dtype="bfloat16_sr")
    params = {k: p.detach() for k, p in model.named_parameters()}
    step = make_train_step(model, tx, mel_cfg)
    wave = torch.from_numpy(_wave(29, (2, 32000)))
    target = torch.from_numpy((np.random.default_rng(30).uniform(size=(2, 527)) < 0.1).astype(np.float32))
    mel = log_mel_spectrogram(wave, mel_cfg)[:, None, :, :98]
    outs = [step(TrainState(params, tx.init(params), 4), dict(batch, target=target), 7)
            for batch in ({"wave": wave}, {"mel": mel})]
    (a, ma), (b, mb) = outs
    assert a.step == b.step == 5
    torch.testing.assert_close(ma["loss"], mb["loss"], rtol=0, atol=0)
    for k in params:
        torch.testing.assert_close(a.params[k], b.params[k], rtol=0, atol=0)


@pytest.mark.parametrize("loss_type", ["multilabel", "single_label", "masked"])
def test_eval_step_matches_jax(loss_type):
    """The eval step's outputs (sigmoid or log-softmax), per-example and
    mean loss and features vs the JAX eval step at fp32, from bridged
    params (2e-4 as the eval model tests; observed < 1e-6)."""
    from passt_tpu_torch.train.steps import make_eval_step

    classes = 10 if loss_type == "masked" else 20  # masked: 10 labels + 10 mask columns
    kw = dict(TINY, num_classes=classes)
    jmodel, params = _jax_params(JaxConfig(**kw, attn_impl="xla"))
    rng = np.random.default_rng(31)
    wave = rng.standard_normal((2, 32000)).astype(np.float32)
    if loss_type == "single_label":
        target = rng.integers(0, 20, 2)
    elif loss_type == "masked":
        target = np.concatenate([rng.uniform(size=(2, 10)), rng.uniform(size=(2, 10)) < 0.7], 1)
        target = target.astype(np.float32)
    else:
        target = (rng.uniform(size=(2, 20)) < 0.3).astype(np.float32)
    mel_kw = dict(fmin_aug_range=10, fmax_aug_range=2000)
    ref = jax_steps_mod.make_eval_step(jmodel, JaxMelConfig(**mel_kw), loss_type)(
        params, {"wave": jnp.asarray(wave), "target": jnp.asarray(target)})
    model = PaSST(PaSSTConfig(**kw, attn_impl="fused"))
    got = make_eval_step(model, MelConfig(**mel_kw), loss_type)(
        state_dict_from_flax(params), {"wave": torch.from_numpy(wave), "target": torch.from_numpy(target)})
    assert set(got) == set(ref)
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), atol=2e-4, rtol=0, err_msg=k)
