"""The port's checkpoint adaptation and block layouts
(passt_tpu_torch.models.pretrained) against the JAX package's, on the CPU.

No DeiT or ImageNet checkpoint is in the repo and nothing is downloaded:
the ImageNet-layout state dicts are synthetic, made from numpy seeds (a
square 14 x 14 position grid, an RGB patch conv, a 1000-class head).
Bounds: the conv adaptation exactly; the bicubic resize and the position
embeddings 1e-6 x max|ref|; the layouts exactly.
"""

import warnings

import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from passt_tpu.models import pretrained as jax_pretrained
from passt_tpu.models.passt import PaSSTConfig as JaxConfig
from passt_tpu.models.passt import init_passt
from passt_tpu_torch.models import registry
from passt_tpu_torch.models import pretrained
from passt_tpu_torch.models.passt import PaSST, PaSSTConfig

TINY = dict(embed_dim=64, depth=2, num_heads=4, input_tdim=98)  # grid (12, 9)


def _rel(got, ref, rel, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    assert float(np.abs(got - ref).max()) <= rel * float(np.abs(ref).max()), what


@pytest.mark.parametrize("cin,cout", [(3, 1), (6, 1), (3, 2), (3, 4), (1, 1)])
def test_adapt_input_conv_matches_jax(cin, cout):
    """RGB summed to mono, groups of three summed, tiled and rescaled to
    more channels, or left as it is: the JAX function's arrays exactly."""
    w = np.random.default_rng(cin * 10 + cout).standard_normal((16, 16, cin, 8)).astype(np.float32)
    np.testing.assert_array_equal(pretrained.adapt_input_conv(cout, w), jax_pretrained.adapt_input_conv(cout, w))


@pytest.mark.parametrize("out_hw", [(12, 9), (12, 99), (20, 7), (14, 14)])
def test_bicubic_resize_matches_jax_and_torch(out_hw):
    """torch's bicubic resize (a = -0.75, half-pixel centers, borders
    replicated), separable in float64: the JAX helper's values and
    ``F.interpolate(mode="bicubic", align_corners=False)``'s."""
    grid = np.random.default_rng(1).standard_normal((14, 14, 5))
    got = pretrained.bicubic_resize_2d(grid, out_hw)
    _rel(got, jax_pretrained.bicubic_resize_2d(grid, out_hw), 1e-6, "jax")
    ref = F.interpolate(torch.from_numpy(grid).permute(2, 0, 1)[None], size=out_hw, mode="bicubic",
                        align_corners=False)[0].permute(1, 2, 0).numpy()
    _rel(got, ref, 1e-6, "torch")


@pytest.mark.parametrize("tokens", [1, 2])
def test_adapt_image_pos_embed_matches_jax(tokens):
    """The square grid resized to (F, T) and averaged: the JAX embeddings in
    the port's layouts ((1, D, F, 1) and (1, D, 1, T))."""
    pos = np.random.default_rng(tokens).standard_normal((1, tokens + 196, 32)).astype(np.float32)
    got = pretrained.adapt_image_pos_embed(pos, tokens, (12, 99))
    ref = jax_pretrained.adapt_image_pos_embed(pos, tokens, (12, 99))
    np.testing.assert_array_equal(got["new_pos_embed"].numpy(), ref["new_pos_embed"])
    _rel(got["freq_new_pos_embed"].numpy(), np.asarray(ref["freq_new_pos_embed"]).transpose(0, 3, 1, 2), 1e-6)
    _rel(got["time_new_pos_embed"].numpy(), np.asarray(ref["time_new_pos_embed"]).transpose(0, 3, 1, 2), 1e-6)


def _deit_state_dict(distilled: bool, seed=5):
    """A synthetic DeiT/ViT state dict in the reference layout: blocks from
    the JAX init, a 14 x 14 pos_embed, an RGB conv, 1000-class heads."""
    _, params = init_passt(JaxConfig(**dict(TINY, distilled=distilled)), jax.random.PRNGKey(seed))
    sd = {k: v.numpy() for k, v in pretrained.state_dict_from_flax(jax.tree.map(np.asarray, params)).items()}
    for k in [k for k in sd if "pos_embed" in k or k.startswith(("head.", "head_dist."))]:
        del sd[k]
    rng = np.random.default_rng(seed)
    tokens = 2 if distilled else 1
    sd["pos_embed"] = rng.standard_normal((1, tokens + 196, 64)).astype(np.float32)
    sd["patch_embed.proj.weight"] = rng.standard_normal((64, 3, 16, 16)).astype(np.float32)
    sd["head.weight"] = rng.standard_normal((1000, 64)).astype(np.float32)
    sd["head.bias"] = rng.standard_normal(1000).astype(np.float32)
    if distilled:
        sd["head_dist.weight"] = rng.standard_normal((1000, 64)).astype(np.float32)
        sd["head_dist.bias"] = rng.standard_normal(1000).astype(np.float32)
    return sd


@pytest.mark.parametrize("distilled,impl", [(True, "loop"), (False, "loop"), (True, "scan")])
def test_deit_checkpoint_loads_as_jax_converts_it(tmp_path, distilled, impl):
    """A DeiT ``{"model": ...}`` file loads into the port (either block
    layout): every leaf the JAX package's ``convert_torch_state_dict``
    produces from it equals the port's (the resized embeddings 1e-6 x
    max|ref|, the rest exactly); the model keeps its own head."""
    sd = _deit_state_dict(distilled)
    path = str(tmp_path / "deit.pt")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    model = PaSST(PaSSTConfig(**dict(TINY, distilled=distilled, blocks_impl=impl)))
    head = model.head[1].weight.detach().clone()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        pretrained.load_pretrained(model, path)
        ref = jax_pretrained.convert_torch_state_dict({"model": sd}, JaxConfig(**dict(TINY, distilled=distilled)),
                                                      strict=False)
    ref = pretrained.state_dict_from_flax(jax.tree.map(np.asarray, ref))
    got = pretrained.unstack_block_params(model.state_dict())
    for k, want in ref.items():
        tol = 1e-6 * float(want.abs().max()) if "pos_embed" in k else 0.0
        np.testing.assert_allclose(got[k].numpy(), want.numpy(), atol=tol, rtol=0, err_msg=k)
    assert torch.equal(model.head[1].weight, head)


@pytest.mark.parametrize("saved,into", [("loop", "scan"), ("scan", "loop"), ("scan", "stacked"), ("loop", "loop")])
def test_npz_loads_across_block_layouts(tmp_path, saved, into):
    """An ``.npz`` the JAX package saved in one block layout loads into the
    port's model of another, exactly; the port's ``.npz`` of a stacked
    model is the JAX stacked tree (JAX ``load_params_npz`` reads it)."""
    _, params = init_passt(JaxConfig(**dict(TINY, blocks_impl=saved)), jax.random.PRNGKey(3))
    params = jax.tree.map(np.asarray, params)
    path = str(tmp_path / "p.npz")
    jax_pretrained.save_params_npz(path, params)
    model = PaSST(PaSSTConfig(**dict(TINY, blocks_impl=into)))
    pretrained.load_pretrained(model, path)
    want = pretrained.unstack_block_params(pretrained.state_dict_from_flax(params))
    got = pretrained.unstack_block_params(model.state_dict())
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    out = str(tmp_path / "port.npz")
    pretrained.save_params_npz(out, dict(model.named_parameters()))
    back = jax.tree.map(np.asarray, jax_pretrained.load_params_npz(out))
    own = jax.tree.map(np.asarray, jax_pretrained.stack_block_params(params) if into != "loop"
                       else jax_pretrained.unstack_block_params(params))
    assert jax.tree.structure(back) == jax.tree.structure(own)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(own)):
        np.testing.assert_array_equal(a, b)


def test_stack_unstack_round_trip_and_jax_stack():
    """``unstack(stack(sd)) == sd`` exactly, and the port's stack of the
    bridged loop tree is the bridge of the JAX ``stack_block_params``."""
    _, params = init_passt(JaxConfig(**TINY), jax.random.PRNGKey(1))
    params = jax.tree.map(np.asarray, params)
    sd = pretrained.state_dict_from_flax(params)
    st = pretrained.stack_block_params(sd)
    assert {k for k in st if k.startswith("blocks.")} == {f"blocks.block.{k[len('blocks.0.'):]}" for k in sd
                                                          if k.startswith("blocks.0.")}
    back = pretrained.unstack_block_params(st)
    assert list(back) == list(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k
    jst = pretrained.state_dict_from_flax(jax.tree.map(np.asarray, jax_pretrained.stack_block_params(params)))
    for k in jst:
        assert torch.equal(st[k], jst[k]), k
    assert pretrained.flax_from_state_dict(st)["blocks"]["block"]["attn"]["qkv"]["kernel"].shape == (2, 64, 192)


def test_lighten_params_keeps_the_stacked_layout():
    """Cutting blocks from a stacked parameter dict: the loop dict's cut,
    restacked."""
    _, params = init_passt(JaxConfig(**dict(TINY, depth=4)), jax.random.PRNGKey(2))
    sd = pretrained.state_dict_from_flax(jax.tree.map(np.asarray, params))
    want, depth = registry.lighten_params(sd, 1)
    got, depth2 = registry.lighten_params(pretrained.stack_block_params(sd), 1)
    assert depth == depth2 == 3
    want = pretrained.stack_block_params(want)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
