"""Weights in and out of the port (counterpart of passt_tpu/models/pretrained.py).

- :func:`state_dict_from_flax`: the bridge from a ``passt_tpu`` flax param
  tree (per-block ``blocks_{i}`` or scan-stacked ``blocks/block``) to this
  package's state dict (``blocks.{i}.*`` or ``blocks.block.*``), the exact
  inverse of ``passt_tpu.models.pretrained.convert_torch_state_dict``.
- :func:`load_torch_checkpoint`: a reference ``.pt`` file (a DeiT
  ``{"model": ...}`` wrapper unwrapped).
- :func:`load_params_npz`: the ``.npz`` trees that ``passt_tpu``'s
  ``save_params_npz`` writes, in the layout they were written in.
- :func:`flax_from_state_dict` and :func:`save_params_npz`: the inverse
  bridge, and an ``.npz`` that both packages' ``load_params_npz`` read
  (the ensemble's ``<arch>.npz`` members, written where jax is absent).
- :func:`stack_block_params` / :func:`unstack_block_params`: the per-block
  and the stacked block layouts of a state dict, one into the other;
  every load re-lays a checkpoint to the model's layout.
- :func:`adapt_state_dict`: an ImageNet/DeiT ViT checkpoint (a square
  position grid, an RGB patch conv, a plain Linear head) adapted to PaSST:
  the grid bicubic-resized to (F, T) and averaged into the frequency and
  time embeddings (:func:`adapt_image_pos_embed`), the input conv summed to
  the model's channels (:func:`adapt_input_conv`).
- :func:`load_pretrained`: any of these files into a built :class:`PaSST`.

A checkpoint whose token count differs from the model's (a distilled one
into ``distilled=False``, or the reverse) is refused with the reason, as
the JAX package cannot run one either.
"""

from __future__ import annotations

import warnings
from typing import Dict, Mapping

import numpy as np
import torch


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


#: a block's layers: (port module path, JAX tree path, kind)
_BLOCK_LAYERS = (
    ("norm1", ("norm1",), "norm"),
    ("attn.qkv", ("attn", "qkv"), "dense"),
    ("attn.proj", ("attn", "proj"), "dense"),
    ("norm2", ("norm2",), "norm"),
    ("mlp.fc1", ("mlp", "fc1"), "dense"),
    ("mlp.fc2", ("mlp", "fc2"), "dense"),
)


def _t(w: np.ndarray) -> np.ndarray:
    """A Dense kernel's transpose (the last two axes: a stacked leaf keeps
    its depth axis first)."""
    return np.swapaxes(w, -1, -2)


def state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """``passt_tpu`` flax params (leaves array-like; per-block ``blocks_{i}``
    or scan-stacked ``blocks/block``) -> reference-layout state dict of fp32
    CPU tensors (``blocks.{i}.*``, or ``blocks.block.*`` stacked). Patch conv
    HWIO -> OIHW, every Dense kernel transposed, position embeddings
    (1,F,1,D) -> (1,D,F,1) and (1,1,T,D) -> (1,D,1,T), LayerNorm ``scale`` ->
    ``weight``."""
    sd: Dict[str, np.ndarray] = {}

    def dense(prefix, p):
        sd[prefix + ".weight"] = _t(_np(p["kernel"]))
        if "bias" in p:
            sd[prefix + ".bias"] = _np(p["bias"])

    def norm(prefix, p):
        sd[prefix + ".weight"] = _np(p["scale"])
        sd[prefix + ".bias"] = _np(p["bias"])

    def block(prefix, blk):
        for port, path, kind in _BLOCK_LAYERS:
            node = blk
            for part in path:
                node = node[part]
            (dense if kind == "dense" else norm)(f"{prefix}.{port}", node)

    sd["cls_token"] = _np(params["cls_token"])
    if "dist_token" in params:
        sd["dist_token"] = _np(params["dist_token"])
    sd["new_pos_embed"] = _np(params["new_pos_embed"])
    sd["freq_new_pos_embed"] = _np(params["freq_new_pos_embed"]).transpose(0, 3, 1, 2)
    sd["time_new_pos_embed"] = _np(params["time_new_pos_embed"]).transpose(0, 3, 1, 2)
    proj = params["patch_embed"]["proj"]
    sd["patch_embed.proj.weight"] = _np(proj["kernel"]).transpose(3, 2, 0, 1)
    sd["patch_embed.proj.bias"] = _np(proj["bias"])

    if "blocks" in params:
        block("blocks.block", params["blocks"]["block"])
    depth = len([k for k in params if k.startswith("blocks_")])
    for i in range(depth):
        block(f"blocks.{i}", params[f"blocks_{i}"])
    norm("norm", params["norm"])
    if "pre_logits" in params:
        dense("pre_logits.fc", params["pre_logits"])
    if "head_norm" in params:
        norm("head.0", params["head_norm"])
        dense("head.1", params["head_linear"])
    if "head_dist" in params:
        dense("head_dist", params["head_dist"])
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in sd.items()}


def flax_from_state_dict(sd: Mapping[str, torch.Tensor]) -> dict:
    """The port's state dict (or parameter dict) -> ``passt_tpu``'s flax
    param tree of fp32 numpy arrays, in the dict's block layout (per-block
    ``blocks_{i}``, or ``blocks/block`` for ``blocks.block.*``): the exact
    inverse of :func:`state_dict_from_flax`."""
    sd = {k: _np(v.detach().float() if isinstance(v, torch.Tensor) else v).astype(np.float32)
          for k, v in sd.items()}
    tree: dict = {}

    def put(path, value):
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = value

    def dense(prefix, path):
        put(path + ("kernel",), _t(sd[prefix + ".weight"]).copy())
        if prefix + ".bias" in sd:
            put(path + ("bias",), sd[prefix + ".bias"])

    def norm(prefix, path):
        put(path + ("scale",), sd[prefix + ".weight"])
        put(path + ("bias",), sd[prefix + ".bias"])

    def block(prefix, path):
        for port, jax_path, kind in _BLOCK_LAYERS:
            (dense if kind == "dense" else norm)(f"{prefix}.{port}", path + jax_path)

    for name in ("cls_token", "dist_token", "new_pos_embed"):
        if name in sd:
            put((name,), sd[name])
    for name in ("freq_new_pos_embed", "time_new_pos_embed"):
        put((name,), sd[name].transpose(0, 2, 3, 1).copy())
    put(("patch_embed", "proj", "kernel"), sd["patch_embed.proj.weight"].transpose(2, 3, 1, 0).copy())
    put(("patch_embed", "proj", "bias"), sd["patch_embed.proj.bias"])
    if "blocks.block.norm1.weight" in sd:
        block("blocks.block", ("blocks", "block"))
    for i in _block_ids(sd):
        block(f"blocks.{i}", (f"blocks_{i}",))
    norm("norm", ("norm",))
    if "pre_logits.fc.weight" in sd:
        dense("pre_logits.fc", ("pre_logits",))
    if "head.0.weight" in sd:
        norm("head.0", ("head_norm",))
        dense("head.1", ("head_linear",))
    if "head_dist.weight" in sd:
        dense("head_dist", ("head_dist",))
    return tree


def _block_ids(sd: Mapping) -> list:
    """The per-block layout's block indices (``blocks.{i}.*``), sorted."""
    return sorted({int(k.split(".")[1]) for k in sd if k.startswith("blocks.") and k.split(".")[1].isdigit()})


def stack_block_params(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Per-block layout (``blocks.{i}.<leaf>``) -> stacked layout
    (``blocks.block.<leaf>`` ``[depth, ...]``), the stacked leaves where the
    first block's were; other entries, and a dict with no per-block leaves,
    pass as they are. Layout only: the values are the same."""
    ids = _block_ids(sd)
    if not ids:
        return dict(sd)
    leaves = [k[len("blocks.0."):] for k in sd if k.startswith("blocks.0.")]
    out: Dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        if not k.startswith("blocks."):
            out[k] = v
        elif not any(n.startswith("blocks.block.") for n in out):
            for leaf in leaves:
                out[f"blocks.block.{leaf}"] = torch.stack([torch.as_tensor(sd[f"blocks.{i}.{leaf}"]) for i in ids])
    return out


def unstack_block_params(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The inverse of :func:`stack_block_params`: block by block, where the
    stacked leaves were."""
    stacked = {k[len("blocks.block."):]: torch.as_tensor(v).unbind(0) for k, v in sd.items()
               if k.startswith("blocks.block.")}
    if not stacked:
        return dict(sd)
    out: Dict[str, torch.Tensor] = {}
    for k, v in sd.items():
        if not k.startswith("blocks.block."):
            out[k] = v
        elif "blocks.0." + next(iter(stacked)) not in out:
            for i in range(len(next(iter(stacked.values())))):
                for leaf, parts in stacked.items():
                    out[f"blocks.{i}.{leaf}"] = parts[i].clone()
    return out


def match_block_layout(sd: Mapping[str, torch.Tensor], own: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``sd`` (either block layout) in the layout of ``own`` (the model's
    state dict), so every load path takes checkpoints of either
    ``blocks_impl``."""
    want_stacked = any(k.startswith("blocks.block.") for k in own)
    out = stack_block_params(sd) if want_stacked else unstack_block_params(sd)
    if set(out) == set(own):
        out = {k: out[k] for k in own}  # in the order of own's keys
    return out


def save_params_npz(path: str, params: Mapping[str, torch.Tensor]) -> None:
    """Write the port's parameters as the ``.npz`` the JAX package's
    ``save_params_npz`` writes: the flax tree's leaves under '/'-joined
    keys, fp32 (bf16 storage is widened, exactly)."""
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                out["/".join(prefix + (k,))] = v

    walk(flax_from_state_dict(params), ())
    np.savez(path, **out)


def load_torch_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """A reference ``.pt`` file -> flat state dict of CPU tensors. The file
    is unpickled in full, so load only checkpoints you trust."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if isinstance(obj, dict) and "model" in obj and not hasattr(obj["model"], "shape"):
        obj = obj["model"]
    return {k: torch.as_tensor(v).float() for k, v in obj.items()}


def load_params_npz(path: str) -> dict:
    """An ``.npz`` written by ``passt_tpu``'s ``save_params_npz`` (keys are
    '/'-joined tree paths) -> nested dict of numpy arrays, in its own block
    layout (per-block ``blocks_{i}`` or scan-stacked ``blocks/block``)."""
    tree: dict = {}
    with np.load(path) as data:
        for name in data.files:
            node = tree
            parts = name.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[name]
    return tree


# ---------------------------------------------------------------------------
# ImageNet / DeiT adaptation (reference passt.py:246-268, 656-706)


def adapt_input_conv(in_chans: int, conv_hwio: np.ndarray) -> np.ndarray:
    """An HWIO patch-conv kernel adapted to ``in_chans`` input channels: RGB
    summed to one channel (groups of three summed where there are more),
    or tiled and rescaled to more (reference passt.py:246-268)."""
    kh, kw, i, o = conv_hwio.shape
    if i == in_chans:
        return conv_hwio
    if in_chans == 1:
        if i > 3:
            assert i % 3 == 0
            return conv_hwio.reshape(kh, kw, i // 3, 3, o).sum(axis=3)
        return conv_hwio.sum(axis=2, keepdims=True)
    if i != 3:
        raise NotImplementedError("weight format not supported for channel adaptation")
    repeat = -(-in_chans // 3)
    out = np.tile(conv_hwio, (1, 1, repeat, 1))[:, :, :in_chans, :]
    return out * (3.0 / float(in_chans))


def _cubic_weights(frac: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys' cubic-convolution weights of the four taps around each sample
    point, with PyTorch's a = -0.75."""
    x = frac[:, None] + np.array([1.0, 0.0, -1.0, -2.0])[None, :]
    ax = np.abs(x)
    w_near = (a + 2.0) * ax**3 - (a + 3.0) * ax**2 + 1.0
    w_far = a * ax**3 - 5.0 * a * ax**2 + 8.0 * a * ax - 4.0 * a
    return np.where(ax <= 1.0, w_near, np.where(ax < 2.0, w_far, 0.0))


def _bicubic_resize_axis(x: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """1-D cubic resize along ``axis`` as ``F.interpolate(mode='bicubic',
    align_corners=False)`` does it: half-pixel centers, the border
    replicated."""
    in_size = x.shape[axis]
    src = (np.arange(out_size, dtype=np.float64) + 0.5) * (in_size / out_size) - 0.5
    i0 = np.floor(src).astype(np.int64)
    weights = _cubic_weights(src - i0)  # (out, 4)
    taps = np.clip(i0[:, None] + np.array([-1, 0, 1, 2])[None, :], 0, in_size - 1)
    gathered = np.moveaxis(x, axis, 0)[taps]  # (out, 4, ...)
    return np.moveaxis(np.einsum("ot,ot...->o...", weights, gathered), 0, axis)


def bicubic_resize_2d(grid: np.ndarray, out_hw) -> np.ndarray:
    """``[H, W, D]`` -> ``[H', W', D]`` in float64, torch's bicubic resize
    (separable)."""
    out = _bicubic_resize_axis(grid.astype(np.float64), out_hw[0], axis=0)
    return _bicubic_resize_axis(out, out_hw[1], axis=1)


def adapt_image_pos_embed(pos_embed, num_tokens: int, grid_size) -> Dict[str, torch.Tensor]:
    """An ImageNet ViT's 1-D position embedding ``[1, tokens + S*S, D]`` ->
    PaSST's (reference ``adapt_image_pos_embed_to_passt``, passt.py:656-676):
    the square grid bicubic-resized to ``grid_size`` (F, T), then its mean
    over time is the frequency embedding and its mean over frequency the
    time embedding. Returns fp32 tensors in the port's layouts:
    ``new_pos_embed [1, num_tokens, D]``, ``freq_new_pos_embed [1, D, F,
    1]``, ``time_new_pos_embed [1, D, 1, T]``."""
    f_grid, t_grid = grid_size
    pos_embed = _np(pos_embed).astype(np.float32)
    grid = pos_embed[0, num_tokens:]
    side = int(np.sqrt(len(grid)))
    resized = bicubic_resize_2d(grid.reshape(side, side, grid.shape[-1]), (f_grid, t_grid))  # (F, T, D)
    freq = resized.mean(axis=1).astype(np.float32)  # (F, D)
    time = resized.mean(axis=0).astype(np.float32)  # (T, D)
    return {
        "new_pos_embed": torch.from_numpy(pos_embed[:, :num_tokens].copy()),
        "freq_new_pos_embed": torch.from_numpy(freq.T[None, :, :, None].copy()),
        "time_new_pos_embed": torch.from_numpy(time.T[None, :, None, :].copy()),
    }


def adapt_state_dict(sd: Mapping[str, torch.Tensor], cfg) -> Dict[str, torch.Tensor]:
    """A reference-layout state dict (a DeiT ``{"model": ...}`` wrapper
    unwrapped) adapted to the model of ``cfg``, as the JAX package's
    ``convert_torch_state_dict`` adapts it: an ImageNet checkpoint (no
    ``time_new_pos_embed``) gets PaSST's position embeddings from its
    ``pos_embed`` and loses its plain Linear head (with a warning); a
    pre-conv patchify weight is reshaped to OIHW and the patch conv summed
    or tiled to ``cfg.in_chans``."""
    if "model" in sd and not hasattr(sd["model"], "shape"):
        sd = sd["model"]
    sd = {k: torch.as_tensor(_np(v)).float() for k, v in sd.items()}
    if "time_new_pos_embed" not in sd:
        sd.update(adapt_image_pos_embed(sd.pop("pos_embed"), cfg.num_tokens, cfg.grid_size))
        if "head.weight" in sd:
            warnings.warn("ImageNet plain-Linear head dropped (PaSST head is LayerNorm+Linear)")
            del sd["head.weight"], sd["head.bias"]
    w = sd["patch_embed.proj.weight"].numpy()
    if w.ndim < 4:  # pre-conv patchify checkpoints (passt.py:697-700)
        w = w.reshape(cfg.embed_dim, -1, *cfg.patch_size)
    hwio = adapt_input_conv(cfg.in_chans, w.transpose(2, 3, 1, 0))
    sd["patch_embed.proj.weight"] = torch.from_numpy(np.ascontiguousarray(hwio.transpose(3, 2, 0, 1)))
    return sd


def load_pretrained(model, path: str) -> None:
    """Load a reference ``.pt`` (PaSST, or an ImageNet/DeiT ViT adapted by
    :func:`adapt_state_dict`) or a ``passt_tpu`` ``.npz`` (either block
    layout) into ``model``, re-laid to its block layout. A longer time
    embedding is cropped to the model's grid (with a warning), a shorter one
    raises; a classifier for another class count keeps the model's own head
    (with a warning). A checkpoint with another token count
    (``new_pos_embed`` [1, 2, D] distilled, [1, 1, D] not) raises a
    ``ValueError``."""
    if path.endswith(".npz"):
        sd = state_dict_from_flax(load_params_npz(path))
    else:
        sd = adapt_state_dict(load_torch_checkpoint(path), model.cfg)
    tokens, want = sd["new_pos_embed"].shape[1], model.cfg.num_tokens
    if tokens != want:
        raise ValueError(
            f"checkpoint new_pos_embed has {tokens} token(s) but the model (distilled={model.cfg.distilled}) "
            f"has {want}: build the model with distilled={tokens == 2} for this checkpoint"
        )
    own = model.state_dict()
    sd = match_block_layout(sd, own)
    for k in [k for k in sd if k.startswith(("dist_token", "head_dist.")) and k not in own]:
        del sd[k]  # a distilled checkpoint's extras, unused by this model
    t_grid = own["time_new_pos_embed"].shape[-1]
    t_ckpt = sd["time_new_pos_embed"].shape[-1]
    if t_ckpt < t_grid:
        raise ValueError(
            f"checkpoint time pos embed covers {t_ckpt} patches < model grid {t_grid}"
        )
    if t_ckpt > t_grid:
        warnings.warn(f"cropping checkpoint time pos embed {t_ckpt} -> {t_grid}")
        sd["time_new_pos_embed"] = sd["time_new_pos_embed"][..., :t_grid].contiguous()
    for head in ("head.1", "head_dist"):
        key = head + ".weight"
        if key in sd and key in own and sd[key].shape != own[key].shape:
            warnings.warn(f"checkpoint classifier {head} dropped (num_classes mismatch)")
            for k in [k for k in sd if k.startswith(head + ".") or (head == "head.1" and k.startswith("head.0."))]:
                del sd[k]
    if "pre_logits.fc.weight" in sd and "pre_logits.fc.weight" not in own:
        # fine-tuning drops the representation layer (reference passt.py:717-722)
        del sd["pre_logits.fc.weight"], sd["pre_logits.fc.bias"]
    missing, unexpected = model.load_state_dict(sd, strict=False)
    allowed_missing = {k for k in own if k.startswith(("head.", "head_dist.", "dist_token", "pre_logits."))}
    if unexpected or set(missing) - allowed_missing:
        raise ValueError(
            f"checkpoint does not fit the model: missing {sorted(set(missing) - allowed_missing)[:8]}, "
            f"unexpected {sorted(unexpected)[:8]}"
        )
