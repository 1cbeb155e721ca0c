"""Port model (passt_tpu_torch.models) vs the JAX PaSST, on the CPU.

Weights go from the JAX params to the port through the bridge
(``state_dict_from_flax``); the spectrogram input comes from a numpy seed.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from passt_tpu.models.passt import PaSSTConfig as JaxConfig
from passt_tpu.models.passt import init_passt
from passt_tpu.models.pretrained import convert_torch_state_dict, save_params_npz
from passt_tpu_torch.models import get_model_config
from passt_tpu_torch.models.passt import PaSST, PaSSTConfig
from passt_tpu_torch.models.pretrained import load_pretrained, state_dict_from_flax

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")
TINY = dict(embed_dim=64, depth=2, num_heads=4, input_tdim=98)


def _jax_params(cfg, seed=1):
    model, params = init_passt(cfg, jax.random.PRNGKey(seed))
    return model, jax.tree.map(np.asarray, params)


def _port(cfg_kwargs, params):
    model = PaSST(PaSSTConfig(**cfg_kwargs))
    model.load_state_dict(state_dict_from_flax(params))
    return model.eval()


def test_bridge_round_trip_is_exact():
    cfg = JaxConfig(**TINY)
    _, params = _jax_params(cfg)
    back = convert_torch_state_dict(state_dict_from_flax(params), cfg)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)


# fp32: the same ops in the same order on CPU kernels of two frameworks;
# 2e-4 is the bound the JAX package holds to the reference torch model
# (tests/test_golden_fixtures.py), observed < 1e-6.
# bf16: the port rounds where flax rounds (Dense product before the bias,
# LayerNorm in fp32, bf16 residual adds, tanh-GELU from fp32), so the bf16
# values mostly agree bit for bit; 2e-2 is about two bf16 ulps of logits of
# magnitude < 1 (observed < 1e-6).
MODEL_TOL = {"float32": 2e-4, "bfloat16": 2e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("attn_impl", ["xla", "fused"])
@pytest.mark.parametrize("plus1", [False, True])
def test_tiny_passt_matches_jax(plus1, attn_impl, dtype):
    kwargs = dict(TINY, dtype=dtype, attn_impl=attn_impl, plus1_attn=plus1)
    jmodel, params = _jax_params(JaxConfig(**kwargs))
    x = np.random.default_rng(7).standard_normal((2, 1, 128, 98)).astype(np.float32)
    jl, jf = jmodel.apply({"params": params}, jnp.asarray(x), train=False)
    with torch.inference_mode():
        logits, features = _port(kwargs, params)(torch.from_numpy(x))
    assert logits.dtype == features.dtype == torch.float32
    assert tuple(logits.shape) == (2, 527) and tuple(features.shape) == (2, 64)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=MODEL_TOL[dtype], rtol=0)
    np.testing.assert_allclose(features.numpy(), np.asarray(jf), atol=MODEL_TOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tanh_gelu_matches_jax(dtype):
    """The value JAX computes (fp32 math, one cast): fp32 to a few ulps of
    the fp32 formula (2e-6 at |x| < 8), bf16 to one bf16 ulp where the
    fp32 values straddle a rounding boundary (2**-8 relative)."""
    from passt_tpu.ops.activations import _fwd_value
    from passt_tpu_torch.ops.activations import tanh_gelu

    x = (np.random.default_rng(9).standard_normal(4096) * 3).astype(np.float32)
    ref = np.asarray(_fwd_value(jnp.asarray(x, dtype=jnp.dtype(dtype))).astype(jnp.float32))
    got = tanh_gelu(torch.from_numpy(x).to(getattr(torch, dtype))).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, atol=2e-6, rtol=0)
    else:
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=2.0**-8)


def test_short_input_uses_time_embedding_prefix():
    """Eval on a shorter clip than input_tdim takes a prefix of the time
    embedding (the timestamp windows: 16 frames -> t-grid 1, N = 14)."""
    kwargs = dict(TINY, attn_impl="fused")
    jmodel, params = _jax_params(JaxConfig(**kwargs))
    x = np.random.default_rng(8).standard_normal((3, 1, 128, 16)).astype(np.float32)
    jl, jf = jmodel.apply({"params": params}, jnp.asarray(x), train=False)
    with torch.inference_mode():
        logits, features = _port(kwargs, params)(torch.from_numpy(x))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=2e-4, rtol=0)
    np.testing.assert_allclose(features.numpy(), np.asarray(jf), atol=2e-4, rtol=0)


@pytest.mark.parametrize("attn_impl", ["xla", "fused"])
def test_full_geometry_fixture_loads_with_load_state_dict(attn_impl):
    """The reference torch state dict (embed 128, depth 3, 2 heads, N = 1190)
    loads with a plain load_state_dict and reproduces the stored reference
    logits and features (the JAX package's bound: 2e-4 / rtol 1e-4)."""
    fix = np.load(os.path.join(FIXDIR, "model_fullgeom.npz"))
    sd = {k[3:]: torch.from_numpy(fix[k]) for k in fix.files if k.startswith("sd.")}
    cfg = PaSSTConfig(embed_dim=128, depth=3, num_heads=2, attn_impl=attn_impl)
    assert cfg.seq_len(train=False) == 1190
    model = PaSST(cfg)
    model.load_state_dict(sd)
    with torch.inference_mode():
        logits, features = model.eval()(torch.from_numpy(fix["x"]))
    np.testing.assert_allclose(features.numpy(), fix["features"], atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(logits.numpy(), fix["logits"], atol=2e-4, rtol=1e-4)


def test_load_pretrained_npz_and_pt(tmp_path):
    """passt_tpu's .npz tree and a reference-layout .pt both load into the
    port, to the bridged weights bit for bit; a longer time embedding is
    cropped to the model's grid."""
    _, params = _jax_params(JaxConfig(**TINY))
    want = state_dict_from_flax(params)
    npz = str(tmp_path / "w.npz")
    save_params_npz(npz, params)
    pt = str(tmp_path / "w.pt")
    longer = dict(want)
    longer["time_new_pos_embed"] = torch.cat([want["time_new_pos_embed"]] * 2, dim=-1)
    torch.save(longer, pt)
    for path in (npz, pt):
        model = PaSST(PaSSTConfig(**TINY))
        if path == pt:
            with pytest.warns(UserWarning, match="cropping"):
                load_pretrained(model, path)
        else:
            load_pretrained(model, path)
        got = model.state_dict()
        assert set(got) == set(want)
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)


@pytest.mark.parametrize("ckpt_distilled", [True, False])
def test_token_count_mismatch_refused_by_both_packages(tmp_path, ckpt_distilled):
    """A reference-layout .pt whose token count differs from the model's (a
    distilled checkpoint into distilled=False, and the reverse): the JAX
    package loads the tree and its apply raises ScopeParamShapeError on
    new_pos_embed; the port refuses it up front, naming both counts and the
    distilled setting."""
    from flax.errors import ScopeParamShapeError

    from passt_tpu.models.pretrained import load_pretrained_params

    _, params = _jax_params(JaxConfig(**TINY, distilled=ckpt_distilled))
    path = str(tmp_path / "w.pt")
    torch.save(state_dict_from_flax(params), path)
    model_distilled = not ckpt_distilled
    jcfg = JaxConfig(**TINY, distilled=model_distilled)
    jmodel, init = _jax_params(jcfg, seed=2)
    loaded = load_pretrained_params(path, jcfg, init)
    with pytest.raises(ScopeParamShapeError, match="new_pos_embed"):
        jmodel.apply({"params": loaded}, jnp.zeros((1, 1, 128, 98)), train=False)
    n_ckpt, n_model = (2, 1) if ckpt_distilled else (1, 2)
    with pytest.raises(ValueError, match=f"{n_ckpt} token.*distilled={model_distilled}.* has {n_model}"):
        load_pretrained(PaSST(PaSSTConfig(**TINY, distilled=model_distilled)), path)


def test_distilled_pt_loads_into_both_packages_alike(tmp_path):
    """The matching case: a distilled .pt into a distilled model loads in
    both packages and gives the same fp32 logits and features (the bounds
    of test_tiny_passt_matches_jax)."""
    from passt_tpu.models.pretrained import load_pretrained_params

    jcfg = JaxConfig(**TINY)
    _, params = _jax_params(jcfg)
    path = str(tmp_path / "w.pt")
    torch.save(state_dict_from_flax(params), path)
    jmodel, init = _jax_params(jcfg, seed=2)
    x = np.random.default_rng(12).standard_normal((2, 1, 128, 98)).astype(np.float32)
    jl, jf = jmodel.apply({"params": load_pretrained_params(path, jcfg, init)}, jnp.asarray(x), train=False)
    model = PaSST(PaSSTConfig(**TINY))
    load_pretrained(model, path)
    with torch.inference_mode():
        logits, features = model.eval()(torch.from_numpy(x))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=MODEL_TOL["float32"], rtol=0)
    np.testing.assert_allclose(features.numpy(), np.asarray(jf), atol=MODEL_TOL["float32"], rtol=0)


def test_imagenet_checkpoint_raises_with_its_roadmap_item(tmp_path):
    """An ImageNet/DeiT checkpoint (no time_new_pos_embed) is not adapted
    yet; the error names where that work is queued."""
    _, params = _jax_params(JaxConfig(**TINY))
    sd = state_dict_from_flax(params)
    del sd["time_new_pos_embed"], sd["freq_new_pos_embed"]
    path = str(tmp_path / "deit.pt")
    torch.save(sd, path)
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 8"):
        load_pretrained(PaSST(PaSSTConfig(**TINY)), path)


def test_config_matches_jax_and_unported_options_raise():
    cfg = get_model_config("passt_s_swa_p16_128_ap476", dtype="bfloat16")
    assert cfg.grid_size == (12, 99) and cfg.seq_len(train=False) == 1190
    assert cfg.gelu_approximate and not PaSSTConfig().gelu_approximate
    assert not PaSSTConfig(attn_impl="xla").use_fused_attn
    assert PaSSTConfig(attn_impl="fused").use_fused_attn
    for bad in (dict(blocks_impl="scan"), dict(blocks_impl="stacked"), dict(remat=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            PaSST(PaSSTConfig(**dict(TINY, **bad)))
    # training draws from named generators; a missing one raises
    with pytest.raises(ValueError, match="patchout"):
        PaSST(PaSSTConfig(**dict(TINY, s_patchout_t=2)))(torch.zeros(1, 1, 128, 98), train=True)


def test_contradictory_ln_configs_raise_as_in_jax():
    """fuse_ln_qkv with ln_impl="fused" or attn_impl="xla" raises in both
    packages, with the same keywords; the variants alone build."""
    from passt_tpu.models.passt import PaSSTConfig as JaxCfg

    for bad, word in ((dict(ln_impl="fused"), "ln_impl"), (dict(attn_impl="xla"), "attn_impl")):
        with pytest.raises(NotImplementedError, match=word):
            JaxCfg(fuse_ln_qkv=True, **bad).use_scan_blocks
        with pytest.raises(NotImplementedError, match=word):
            PaSST(PaSSTConfig(**dict(TINY, fuse_ln_qkv=True, **bad)))
    with pytest.raises(ValueError, match="ln_impl"):
        PaSST(PaSSTConfig(**dict(TINY, ln_impl="pallas")))
    for ok in (dict(fuse_ln_qkv=True), dict(ln_impl="fused"), dict(ln_impl="xla")):
        PaSST(PaSSTConfig(**dict(TINY, **ok)))


LN_VARIANTS = {"fuse_ln_qkv": dict(fuse_ln_qkv=True), "ln_fused": dict(ln_impl="fused")}


def count_fused_calls(monkeypatch):
    """Count the model's calls of the fused norm1 + qkv + attention and of
    the kernel-backed LayerNorm (CPU tensors launch no kernel to count)."""
    import passt_tpu_torch.models.passt as passt_mod

    calls = {"ln_qkv": 0, "layer_norm": 0}

    def wrap(name, fn):
        def counted(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return counted

    monkeypatch.setattr(passt_mod, "fused_ln_qkv_attention", wrap("ln_qkv", passt_mod.fused_ln_qkv_attention))
    monkeypatch.setattr(passt_mod, "layer_norm", wrap("layer_norm", passt_mod.layer_norm))
    return calls


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", sorted(LN_VARIANTS))
def test_ln_variants_match_jax(monkeypatch, variant, dtype):
    """Eval logits and features under fuse_ln_qkv / ln_impl="fused" (fused
    attention) vs the JAX model with the same switches, whose Pallas kernels
    run in interpret mode, from bridged params; the port takes the fused
    path in every block (fuse_ln_qkv: the gate holds at N = 110) or the
    kernel-backed LayerNorm in all 2 x depth + 1 norms. Bounds as
    test_tiny_passt_matches_jax (fp32 2e-4, bf16 2e-2)."""
    kwargs = dict(TINY, dtype=dtype, attn_impl="fused", **LN_VARIANTS[variant])
    jmodel, params = _jax_params(JaxConfig(**kwargs))
    x = np.random.default_rng(11).standard_normal((2, 1, 128, 98)).astype(np.float32)
    jl, jf = jmodel.apply({"params": params}, jnp.asarray(x), train=False)
    calls = count_fused_calls(monkeypatch)
    with torch.inference_mode():
        logits, features = _port(kwargs, params)(torch.from_numpy(x))
    depth = TINY["depth"]
    want = {"ln_qkv": depth, "layer_norm": 0} if variant == "fuse_ln_qkv" else {"ln_qkv": 0, "layer_norm": 2 * depth + 1}
    assert calls == want
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=MODEL_TOL[dtype], rtol=0)
    np.testing.assert_allclose(features.numpy(), np.asarray(jf), atol=MODEL_TOL[dtype], rtol=0)


def test_fuse_ln_qkv_outside_the_gate_runs_inline_norm1(monkeypatch):
    """Where the gate fails (fp32 eval at the full-geometry N = 1190) the
    block applies norm1 inline in the JAX order and takes the [B, N, H, D]
    entry: the logits equal the module path's (fp32, 2e-5 as the JAX
    package's own test) and the fused path is never called."""
    fix = np.load(os.path.join(FIXDIR, "model_fullgeom.npz"))
    sd = {k[3:]: torch.from_numpy(fix[k]) for k in fix.files if k.startswith("sd.")}
    x = torch.from_numpy(fix["x"])
    calls = count_fused_calls(monkeypatch)
    outs = []
    for extra in ({}, dict(fuse_ln_qkv=True)):
        model = PaSST(PaSSTConfig(embed_dim=128, depth=3, num_heads=2, attn_impl="fused", **extra))
        model.load_state_dict(sd)
        with torch.inference_mode():
            outs.append(model.eval()(x)[0])
    assert calls["ln_qkv"] == 0
    np.testing.assert_allclose(outs[1].numpy(), outs[0].numpy(), atol=2e-5, rtol=0)
