"""Architecture registry and pretrained zoo metadata (port of
passt_tpu/models/registry.py): the same data, ``get_model`` building a
PyTorch module from a seeded ``torch.Generator`` or a local checkpoint, the
reference's model surgery (``fix_embedding_layer``, ``lighten_params``) and
the published ensembles (``ENSEMBLES``, ``get_ensemble_model``,
``ensemble_apply``)."""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch.func import functional_call

from passt_tpu_torch.models.passt import PaSST, PaSSTConfig, init_weights

_PASST_RELEASES = "https://github.com/kkoutini/PaSST/releases/download"


def _zoo(url, num_classes=527, input_size=(1, 128, 998), classifier=("head.1", "head_dist")):
    return {
        "url": url,
        "num_classes": num_classes,
        "input_size": input_size,
        "classifier": classifier,
    }


#: Pretrained checkpoint zoo, as published by the reference (metadata only:
#: nothing is downloaded).
DEFAULT_CFGS: Dict[str, dict] = {
    "passt_s_swa_p16_128_ap476": _zoo(f"{_PASST_RELEASES}/v0.0.1-audioset/passt-s-f128-p16-s10-ap.476-swa.pt"),
    "passt_s_kd_p16_128_ap486": _zoo(f"{_PASST_RELEASES}/v.0.0.9/passt-s-kd-ap.486.pt"),
    "passt_l_kd_p16_128_ap47": _zoo(f"{_PASST_RELEASES}/v.0.0.10/passt-l-kd-ap.47.pt"),
    "passt_s_swa_p16_128_ap4761": _zoo(f"{_PASST_RELEASES}/v0.0.2-audioset/passt-s-f128-p16-s10-ap.4761-swa.pt"),
    "passt_s_p16_128_ap472": _zoo(f"{_PASST_RELEASES}/v0.0.2-audioset/passt-s-f128-p16-s10-ap.472.pt"),
    "passt_s_p16_s16_128_ap468": _zoo(f"{_PASST_RELEASES}/v0.0.2-audioset/passt-s-f128-p16-s16-ap.468.pt"),
    "passt_s_swa_p16_s16_128_ap473": _zoo(f"{_PASST_RELEASES}/v0.0.2-audioset/passt-s-f128-p16-s16-ap.473-swa.pt"),
    "passt_s_swa_p16_s14_128_ap471": _zoo(f"{_PASST_RELEASES}/v0.0.2-audioset/passt-s-f128-p16-s14-ap.471-swa.pt"),
    "passt_s_p16_s14_128_ap469": _zoo(f"{_PASST_RELEASES}/v0.0.2-audioset/passt-s-f128-p16-s14-ap.469.pt"),
    "passt_s_swa_p16_s12_128_ap473": _zoo(f"{_PASST_RELEASES}/v0.0.2-audioset/passt-s-f128-p16-s12-ap.473-swa.pt"),
    "passt_s_p16_s12_128_ap470": _zoo(f"{_PASST_RELEASES}/v0.0.2-audioset/passt-s-f128-p16-s12-ap.470.pt"),
    "passt_s_swa_f128_stfthop100_p16_s10_ap473": _zoo(
        f"{_PASST_RELEASES}/v0.0.3-audioset/passt-s-f128-stfthop100-p16-s10-ap.473-swa.pt",
        input_size=(1, 128, 3200),
    ),
    "passt_s_swa_f128_stfthop160_p16_s10_ap473": _zoo(
        f"{_PASST_RELEASES}/v0.0.3-audioset/passt-s-f128-stfthop160-p16-s10-ap.473-swa.pt",
        input_size=(1, 128, 2000),
    ),
    "passt-s-f128-20sec-p16-s10-ap474-swa": _zoo(
        f"{_PASST_RELEASES}/v0.0.5/passt-s-f128-20sec-p16-s10-ap.474-swa.pt", input_size=(1, 128, 2000)
    ),
    "passt-s-f128-30sec-p16-s10-ap473-swa": _zoo(
        f"{_PASST_RELEASES}/v0.0.5/passt-s-f128-30sec-p16-s10-ap.473-swa.pt", input_size=(1, 128, 3000)
    ),
    "openmic2008_passt_u_f128_p16_s10_ap85_swa": _zoo(
        f"{_PASST_RELEASES}/v0.0.4-openmic/openmic2008.passt-u-f128-p16-s10-ap.85-swa.pt",
        num_classes=20, input_size=(1, 128, 3200),
    ),
    "openmic2008_passt_u_f128_p16_s10_ap85": _zoo(
        f"{_PASST_RELEASES}/v0.0.4-openmic/openmic2008.passt-u-f128-p16-s10-ap.85.pt",
        num_classes=20, input_size=(1, 128, 2000),
    ),
    "deit_base_distilled_patch16_384": {
        "url": "https://dl.fbaipublicfiles.com/deit/deit_base_distilled_patch16_384-d0272ac0.pth",
        "num_classes": 1000,
        "input_size": (3, 384, 384),
        "classifier": ("head", "head_dist"),
    },
}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    """Static architecture description behind an arch name."""

    depth: int = 12
    embed_dim: int = 768
    num_heads: int = 12
    distilled: bool = True
    expected_stride: Optional[Tuple[int, int]] = (10, 10)
    pretrained_name: Optional[str] = None  # key into DEFAULT_CFGS
    input_tdim: int = 998  # time grid the checkpoint was trained with
    hopsize: int = 320  # STFT hop of the checkpoint's frontend


#: Arch name -> spec (the reference builder functions' surface).
ARCHS: Dict[str, ArchSpec] = {
    "passt_deit_bd_p16_384": ArchSpec(expected_stride=None, pretrained_name="deit_base_distilled_patch16_384"),
    "passt_s_kd_p16_128_ap486": ArchSpec(pretrained_name="passt_s_kd_p16_128_ap486"),
    "passt_l_kd_p16_128_ap47": ArchSpec(depth=7, pretrained_name="passt_l_kd_p16_128_ap47"),
    "passt_s_swa_p16_128_ap476": ArchSpec(pretrained_name="passt_s_swa_p16_128_ap476"),
    "passt_s_swa_p16_128_ap4761": ArchSpec(pretrained_name="passt_s_swa_p16_128_ap4761"),
    "passt_s_p16_128_ap472": ArchSpec(pretrained_name="passt_s_p16_128_ap472"),
    "passt_s_p16_s16_128_ap468": ArchSpec(expected_stride=(16, 16), pretrained_name="passt_s_p16_s16_128_ap468"),
    "passt_s_swa_p16_s16_128_ap473": ArchSpec(expected_stride=(16, 16), pretrained_name="passt_s_swa_p16_s16_128_ap473"),
    "passt_s_swa_p16_s14_128_ap471": ArchSpec(expected_stride=(14, 14), pretrained_name="passt_s_swa_p16_s14_128_ap471"),
    "passt_s_p16_s14_128_ap469": ArchSpec(expected_stride=(14, 14), pretrained_name="passt_s_p16_s14_128_ap469"),
    "passt_s_swa_p16_s12_128_ap473": ArchSpec(expected_stride=(12, 12), pretrained_name="passt_s_swa_p16_s12_128_ap473"),
    "passt_s_p16_s12_128_ap470": ArchSpec(expected_stride=(12, 12), pretrained_name="passt_s_p16_s12_128_ap470"),
    "passt_s_f128_20sec_p16_s10_ap474": ArchSpec(pretrained_name="passt-s-f128-20sec-p16-s10-ap474-swa", input_tdim=2000),
    "passt_s_f128_30sec_p16_s10_ap473": ArchSpec(pretrained_name="passt-s-f128-30sec-p16-s10-ap473-swa", input_tdim=3000),
    "passt_s_swa_f128_stfthop100_p16_s10_ap473": ArchSpec(
        pretrained_name="passt_s_swa_f128_stfthop100_p16_s10_ap473", input_tdim=3200, hopsize=100
    ),
    "passt_s_swa_f128_stfthop160_p16_s10_ap473": ArchSpec(
        pretrained_name="passt_s_swa_f128_stfthop160_p16_s10_ap473", input_tdim=2000, hopsize=160
    ),
}


def get_model_config(
    arch: str = "passt_s_kd_p16_128_ap486",
    n_classes: int = 527,
    in_channels: int = 1,
    fstride: int = 10,
    tstride: int = 10,
    input_fdim: int = 128,
    input_tdim: int = 998,
    u_patchout: int = 0,
    s_patchout_t: int = 0,
    s_patchout_f: int = 0,
    dtype: str = "float32",
    gelu: str = "auto",
    plus1_attn: bool = False,
    attn_impl: str = "auto",
    ln_impl: str = "auto",
    patch_embed_impl: str = "unfold",
    blocks_impl: str = "loop",
    fuse_ln_qkv: bool = False,
) -> PaSSTConfig:
    """Resolve an arch name + overrides to a :class:`PaSSTConfig`."""
    if arch not in ARCHS:
        raise RuntimeError(f"Unknown model {arch}")
    spec = ARCHS[arch]
    if spec.expected_stride is not None and (fstride, tstride) != spec.expected_stride:
        warnings.warn(
            f"{arch} was pre-trained with strides {spec.expected_stride}, "
            f"but (fstride, tstride) is {(fstride, tstride)}."
        )
    return PaSSTConfig(
        input_fdim=input_fdim,
        input_tdim=input_tdim,
        stride=(fstride, tstride),
        in_chans=in_channels,
        num_classes=n_classes,
        embed_dim=spec.embed_dim,
        depth=spec.depth,
        num_heads=spec.num_heads,
        distilled=spec.distilled,
        u_patchout=u_patchout,
        s_patchout_t=s_patchout_t,
        s_patchout_f=s_patchout_f,
        dtype=dtype,
        gelu=gelu,
        plus1_attn=plus1_attn,
        attn_impl=attn_impl,
        ln_impl=ln_impl,
        patch_embed_impl=patch_embed_impl,
        blocks_impl=blocks_impl,
        fuse_ln_qkv=fuse_ln_qkv,
    )


def resolve_device(device) -> torch.device:
    """The device an entry point puts its model on: the card unless the
    caller asks for another; a CUDA device where there is none raises
    (nothing falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} asked for, but no CUDA device is available; "
            "pass device='cpu' to run on the CPU"
        )
    return device


def get_model(
    arch: str = "passt_s_kd_p16_128_ap486",
    pretrained: bool = True,
    checkpoint_path: Optional[str] = None,
    generator: Optional[torch.Generator] = None,
    device="cuda",
    dtype: str = "float32",
    **overrides,
) -> PaSST:
    """Build the model for an arch in eval mode on ``device`` (the card by
    default; see :func:`resolve_device`): random weights from ``generator``
    (a CPU generator; seed 0 when None), then the checkpoint when
    ``pretrained``. ``dtype`` is the compute dtype; the parameters stay
    fp32. Nothing is downloaded: ``pretrained=True`` needs
    ``checkpoint_path`` (a reference ``.pt`` or a ``passt_tpu`` ``.npz``)."""
    device = resolve_device(device)
    cfg = get_model_config(arch, dtype=dtype, **overrides)
    model = PaSST(cfg)
    init_weights(model, generator if generator is not None else torch.Generator().manual_seed(0))
    if pretrained:
        if checkpoint_path is None:
            url = DEFAULT_CFGS.get(ARCHS[arch].pretrained_name, {}).get("url", "?")
            raise FileNotFoundError(
                f"pretrained weights for {arch} must be given as checkpoint_path "
                f"(download {url} on a machine with network access)."
            )
        from passt_tpu_torch.models.pretrained import load_pretrained

        load_pretrained(model, checkpoint_path)
    return model.eval().to(device)


def fix_embedding_layer(model: PaSST, params: Optional[Dict[str, torch.Tensor]] = None, embed: str = "default"):
    """Patch-embedding surgery (reference passt.py:922-930). Only
    ``embed="default"`` works in the reference too: its "overlap" /
    "am_keepconv" branches name classes defined nowhere in its repo, so they
    raise here as they do in the JAX package. Returns (model, params)."""
    if embed == "default":
        return model, params
    raise NotImplementedError(
        f"embed={embed!r}: the reference's adaptive-mean patch embeds are "
        "undefined in its codebase (passt.py:922-930 NameError); not ported"
    )




def lighten_params(params: Dict[str, torch.Tensor], cut_depth: int) -> Tuple[Dict[str, torch.Tensor], int]:
    """Remove transformer blocks from a parameter dict — the reference
    ``lighten_model`` (passt.py:932-954), on the port's names
    (``blocks.{i}.…``). Positive ``cut_depth`` keeps block 0 plus
    ``blocks[cut_depth+1:]``; negative keeps every ``-cut_depth``-th
    interior block plus the first and last. The kept blocks are renumbered
    from 0; a stacked layout (``blocks.block.*``) stays stacked. Returns
    (new_params, new_depth)."""
    from passt_tpu_torch.models.pretrained import _block_ids, stack_block_params, unstack_block_params

    if any(k.startswith("blocks.block.") for k in params):
        out, depth = lighten_params(unstack_block_params(params), cut_depth)
        return stack_block_params(out), depth
    block_ids = _block_ids(params)
    if cut_depth == 0:
        return params, len(block_ids)
    if cut_depth < 0:
        keep = [block_ids[0]] + block_ids[1:-1][::-cut_depth] + [block_ids[-1]]
    else:
        if len(block_ids) < cut_depth + 2:
            raise ValueError(
                f"cut_depth for a ViT with {len(block_ids)} layers must be "
                f"between 1 and {len(block_ids) - 2}"
            )
        keep = [block_ids[0]] + block_ids[cut_depth + 1:]
    out = {k: v for k, v in params.items() if not k.startswith("blocks.")}
    for new_i, old_i in enumerate(keep):
        prefix = f"blocks.{old_i}."
        for k, v in params.items():
            if k.startswith(prefix):
                out[f"blocks.{new_i}.{k[len(prefix):]}"] = v
    return out, len(keep)


#: Published ensemble recipes: name -> ([(arch, fstride, tstride), ...], mAP)
#: (reference config_updates.py:136-222; README.md:313-326).
ENSEMBLES: Dict[str, Tuple[List[Tuple[str, int, int]], float]] = {
    "ensemble_s10": (
        [
            ("passt_s_swa_p16_128_ap476", 10, 10),
            ("passt_s_swa_p16_128_ap4761", 10, 10),
            ("passt_s_p16_128_ap472", 10, 10),
        ],
        0.4864,
    ),
    "ensemble_many": (
        [
            ("passt_s_swa_p16_128_ap476", 10, 10),
            ("passt_s_swa_p16_128_ap4761", 10, 10),
            ("passt_s_p16_128_ap472", 10, 10),
            ("passt_s_p16_s12_128_ap470", 12, 12),
            ("passt_s_swa_p16_s12_128_ap473", 12, 12),
            ("passt_s_p16_s14_128_ap469", 14, 14),
            ("passt_s_swa_p16_s14_128_ap471", 14, 14),
            ("passt_s_swa_p16_s16_128_ap473", 16, 16),
            ("passt_s_p16_s16_128_ap468", 16, 16),
        ],
        0.4956,
    ),
    "ensemble_4": (
        [
            ("passt_s_swa_p16_128_ap476", 10, 10),
            ("passt_s_swa_p16_s12_128_ap473", 12, 12),
            ("passt_s_swa_p16_s14_128_ap471", 14, 14),
            ("passt_s_swa_p16_s16_128_ap473", 16, 16),
        ],
        0.4926,
    ),
    "ensemble_5": (
        [
            ("passt_s_swa_p16_128_ap476", 10, 10),
            ("passt_s_swa_p16_128_ap4761", 10, 10),
            ("passt_s_swa_p16_s12_128_ap473", 12, 12),
            ("passt_s_swa_p16_s14_128_ap471", 14, 14),
            ("passt_s_swa_p16_s16_128_ap473", 16, 16),
        ],
        0.49459,
    ),
    "ensemble_s16_14": (
        [
            ("passt_s_swa_p16_s14_128_ap471", 14, 14),
            ("passt_s_swa_p16_s16_128_ap473", 16, 16),
        ],
        0.48579,
    ),
}


def get_ensemble_model(
    arch_list: Sequence[Tuple[str, int, int]],
    seed: int = 0,
    checkpoint_paths: Optional[Sequence[Optional[str]]] = None,
    device="cuda",
    **overrides,
) -> List[Tuple[PaSST, Dict[str, torch.Tensor]]]:
    """Build [(model, params), ...] for an ensemble spec — the reference
    ``get_ensemble_model`` (passt.py:1039-1045): each member at its own
    stride, its random weights from a CPU generator of its own (seed
    ``seed + i`` for member i), then its checkpoint where a path is given.
    ``params`` are the model's own parameter tensors. Apply with
    :func:`ensemble_apply`."""
    out = []
    for i, (arch, fstride, tstride) in enumerate(arch_list):
        path = checkpoint_paths[i] if checkpoint_paths else None
        model = get_model(
            arch=arch,
            pretrained=path is not None,
            checkpoint_path=path,
            generator=torch.Generator().manual_seed(seed + i),
            device=device,
            fstride=fstride,
            tstride=tstride,
            **overrides,
        )
        out.append((model, {k: p.detach() for k, p in model.named_parameters()}))
    return out


def ensemble_apply(models_and_params: Sequence[Tuple[PaSST, Dict[str, torch.Tensor]]], x: torch.Tensor):
    """Average the logits of independently built models — the reference
    ``EnsembelerModel`` (passt.py:1021-1036): returns (mean_logits,
    mean_logits), its (out, out) convention."""
    total = None
    for model, params in models_and_params:
        out, _ = functional_call(model, params, (x,), dict(train=False))
        total = out if total is None else total + out
    mean = total / len(models_and_params)
    return mean, mean
