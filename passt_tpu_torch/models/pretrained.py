"""Weights in and out of the port (counterpart of passt_tpu/models/pretrained.py).

- :func:`state_dict_from_flax`: the bridge from a ``passt_tpu`` flax param
  tree to this package's state dict, the exact inverse of
  ``passt_tpu.models.pretrained.convert_torch_state_dict``.
- :func:`load_torch_checkpoint`: a reference ``.pt`` file.
- :func:`load_params_npz`: the ``.npz`` trees that ``passt_tpu``'s
  ``save_params_npz`` writes.
- :func:`flax_from_state_dict` and :func:`save_params_npz`: the inverse
  bridge, and an ``.npz`` that both packages' ``load_params_npz`` read
  (the ensemble's ``<arch>.npz`` members, written where jax is absent).
- :func:`load_pretrained`: either file into a built :class:`PaSST`.

ImageNet/DeiT checkpoints (square position grid, RGB patch conv) are not
adapted yet (ROADMAP.md queue 1 item 8); :func:`load_pretrained` raises on
them. A checkpoint whose token count differs from the model's (a distilled
one into ``distilled=False``, or the reverse) is refused with the reason, as
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


def state_dict_from_flax(params: Mapping) -> Dict[str, torch.Tensor]:
    """``passt_tpu`` flax params (per-block layout, leaves array-like) ->
    reference-layout state dict of fp32 CPU tensors. Patch conv HWIO -> OIHW,
    every Dense ``kernel.T``, position embeddings (1,F,1,D) -> (1,D,F,1) and
    (1,1,T,D) -> (1,D,1,T), LayerNorm ``scale`` -> ``weight``."""
    sd: Dict[str, np.ndarray] = {}

    def dense(prefix, p):
        sd[prefix + ".weight"] = _np(p["kernel"]).T
        if "bias" in p:
            sd[prefix + ".bias"] = _np(p["bias"])

    def norm(prefix, p):
        sd[prefix + ".weight"] = _np(p["scale"])
        sd[prefix + ".bias"] = _np(p["bias"])

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
        raise ValueError("stacked (scan) block layout: unstack it to blocks_{i} first")
    depth = len([k for k in params if k.startswith("blocks_")])
    for i in range(depth):
        blk = params[f"blocks_{i}"]
        p = f"blocks.{i}"
        norm(f"{p}.norm1", blk["norm1"])
        dense(f"{p}.attn.qkv", blk["attn"]["qkv"])
        dense(f"{p}.attn.proj", blk["attn"]["proj"])
        norm(f"{p}.norm2", blk["norm2"])
        dense(f"{p}.mlp.fc1", blk["mlp"]["fc1"])
        dense(f"{p}.mlp.fc2", blk["mlp"]["fc2"])
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
    param tree of fp32 numpy arrays (per-block layout): the exact inverse
    of :func:`state_dict_from_flax`."""
    sd = {k: _np(v.detach().float() if isinstance(v, torch.Tensor) else v).astype(np.float32)
          for k, v in sd.items()}
    tree: dict = {}

    def put(path, value):
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = value

    def dense(prefix, path):
        put(path + ("kernel",), sd[prefix + ".weight"].T.copy())
        if prefix + ".bias" in sd:
            put(path + ("bias",), sd[prefix + ".bias"])

    def norm(prefix, path):
        put(path + ("scale",), sd[prefix + ".weight"])
        put(path + ("bias",), sd[prefix + ".bias"])

    for name in ("cls_token", "dist_token", "new_pos_embed"):
        if name in sd:
            put((name,), sd[name])
    for name in ("freq_new_pos_embed", "time_new_pos_embed"):
        put((name,), sd[name].transpose(0, 2, 3, 1).copy())
    put(("patch_embed", "proj", "kernel"), sd["patch_embed.proj.weight"].transpose(2, 3, 1, 0).copy())
    put(("patch_embed", "proj", "bias"), sd["patch_embed.proj.bias"])
    depth = len({k.split(".")[1] for k in sd if k.startswith("blocks.")})
    for i in range(depth):
        p, b = f"blocks.{i}", f"blocks_{i}"
        norm(f"{p}.norm1", (b, "norm1"))
        dense(f"{p}.attn.qkv", (b, "attn", "qkv"))
        dense(f"{p}.attn.proj", (b, "attn", "proj"))
        norm(f"{p}.norm2", (b, "norm2"))
        dense(f"{p}.mlp.fc1", (b, "mlp", "fc1"))
        dense(f"{p}.mlp.fc2", (b, "mlp", "fc2"))
    norm("norm", ("norm",))
    if "pre_logits.fc.weight" in sd:
        dense("pre_logits.fc", ("pre_logits",))
    if "head.0.weight" in sd:
        norm("head.0", ("head_norm",))
        dense("head.1", ("head_linear",))
    if "head_dist.weight" in sd:
        dense("head_dist", ("head_dist",))
    return tree


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
    '/'-joined tree paths) -> nested dict of numpy arrays, per-block layout
    (a scan-stacked ``blocks/block`` tree is unstacked)."""
    tree: dict = {}
    with np.load(path) as data:
        for name in data.files:
            node = tree
            parts = name.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[name]
    if "blocks" in tree:
        stacked = tree.pop("blocks")["block"]

        def index(node, i):
            return {k: index(v, i) if isinstance(v, dict) else v[i] for k, v in node.items()}

        depth = stacked["norm1"]["scale"].shape[0]
        for i in range(depth):
            tree[f"blocks_{i}"] = index(stacked, i)
    return tree


def load_pretrained(model, path: str) -> None:
    """Load a reference ``.pt`` or a ``passt_tpu`` ``.npz`` into ``model``.
    A longer time embedding is cropped to the model's grid (with a
    warning), a shorter one raises; a classifier for another class count
    keeps the model's own head (with a warning). A checkpoint with another
    token count (``new_pos_embed`` [1, 2, D] distilled, [1, 1, D] not)
    raises a ``ValueError``."""
    if path.endswith(".npz"):
        sd = state_dict_from_flax(load_params_npz(path))
    else:
        sd = load_torch_checkpoint(path)
    if "time_new_pos_embed" not in sd:
        raise NotImplementedError(
            "ImageNet/DeiT checkpoint (no time_new_pos_embed): its position-embedding "
            "adaptation is not ported yet (ROADMAP.md queue 1 item 8)"
        )
    tokens, want = sd["new_pos_embed"].shape[1], model.cfg.num_tokens
    if tokens != want:
        raise ValueError(
            f"checkpoint new_pos_embed has {tokens} token(s) but the model (distilled={model.cfg.distilled}) "
            f"has {want}: build the model with distilled={tokens == 2} for this checkpoint"
        )
    own = model.state_dict()
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
        del sd["pre_logits.fc.weight"], sd["pre_logits.fc.bias"]
    missing, unexpected = model.load_state_dict(sd, strict=False)
    allowed_missing = {k for k in own if k.startswith(("head.", "head_dist.", "dist_token"))}
    if unexpected or set(missing) - allowed_missing:
        raise ValueError(
            f"checkpoint does not fit the model: missing {sorted(set(missing) - allowed_missing)[:8]}, "
            f"unexpected {sorted(unexpected)[:8]}"
        )
