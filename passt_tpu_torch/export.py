"""Serialized inference artifacts via ``torch.export`` (port of
passt_tpu/export.py).

The reference's deployment story is the ``hear21passt`` pip package: a
torch module rebuilt from a checkpoint in an environment with the full
framework installed (reference README.md:48-65). The artifact here is the
complete inference function — the eval-mode mel frontend and the PaSST
forward, weights baked in — traced once by ``torch.export`` and saved to
one file, which :func:`load_exported` calls with nothing of this package's
model or training code imported: ``torch``, numpy and the kernels' custom
ops (``passt_tpu_torch.ops.library``). The mel kernel and the attention
forward kernel (and F1 under ``fuse_ln_qkv``) are custom ops inside the
program, so the loaded program launches them on the card, and runs their
plain versions on the CPU. A symbolic batch (``batch="b"``, a
``torch.export.Dim``) lets one artifact serve any batch size.

Produces ``<out>.passt.pt2`` (``torch.export.save``) and ``<out>.passt.json``
(a manifest with the arch, the audio contract and the platform, so a serving
layer can check its inputs without loading the program), and with
``bake_weights=False`` ``<out>.params.npz``, the weights the program then
takes as its first argument.

The program's tensors live on the device it was exported on ("cuda" unless
the caller asks for the CPU), and the manifest's ``platforms`` names it.
CLI: ``python -m passt_tpu_torch.tools.export_inference``; serving a folder
of wav files: ``python -m passt_tpu_torch.tools.serve``. The traced function
is :func:`passt_tpu_torch.hear.inference_forward`, what the live
``Predictor`` runs.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
from typing import Dict, Optional, Tuple

import torch

from passt_tpu_torch.ops.frontend import MelConfig

# passt_tpu_torch.hear and .models are imported inside the export functions:
# a serving process needs only torch, numpy and the custom ops to load and
# call an artifact (tests/test_torch_export.py checks it).

MANIFEST_SUFFIX = ".passt.json"
ARTIFACT_SUFFIX = ".passt.pt2"
PARAMS_SUFFIX = ".params.npz"


def _derive_seconds(input_tdim: int, mel_cfg: MelConfig) -> float:
    """The arch's clip length, rounded up to the next 0.1 s: the flagship's
    998 frames are 9.98 s, a slice of a 10-s mel, and rounding up restores
    10.0 / 20.0 / 30.0 s for every zoo arch (the frontend's
    ``[:input_tdim]`` crop drops the extra frames)."""
    raw = input_tdim * mel_cfg.hopsize / mel_cfg.sr
    return math.ceil(raw * 10.0 - 1e-9) / 10.0


def _prepare_mel(mel_cfg: Optional[MelConfig], n_mels: int) -> MelConfig:
    """The artifact's frontend config, defaulted. Unlike the JAX package,
    which swaps "auto" for its portable matmul STFT, "auto" stays: the mel
    kernel is a custom op of the program."""
    if mel_cfg is None:
        mel_cfg = MelConfig(n_mels=n_mels, fmin_aug_range=10, fmax_aug_range=2000)
    return mel_cfg


class _Inference(torch.nn.Module):
    """The traced function: wave -> (logits, features), weights baked in."""

    def __init__(self, model, mel_cfg: MelConfig):
        super().__init__()
        self.model = model
        self.mel_cfg = mel_cfg

    def forward(self, wave):
        from passt_tpu_torch.hear import inference_forward

        return inference_forward(self.model, self.mel_cfg, self.model.cfg.input_tdim, wave)


class _ExternalInference(torch.nn.Module):
    """The traced function: (params, wave) -> (logits, features). The
    inference module is held in a tuple, not as a submodule, so none of the
    model's weights enter the program."""

    def __init__(self, model, mel_cfg: MelConfig):
        super().__init__()
        self._held = (_Inference(model, mel_cfg),)

    def forward(self, params: Dict[str, torch.Tensor], wave):
        named = {f"model.{k}": v for k, v in params.items()}
        return torch.func.functional_call(self._held[0], named, (wave,))


def _export_and_write(
    module: torch.nn.Module,
    out_path: str,
    device: torch.device,
    batch,
    n_samples: int,
    mel_cfg: MelConfig,
    manifest_fields: dict,
    extra_args: tuple = (),
) -> Tuple[str, str]:
    """Shared export tail: resolve the batch dim (a symbolic name or a fixed
    positive int), trace ``module`` on ``device``, and write the program and
    the manifest. ``extra_args`` are leading dicts of tensors (the external
    weights) placed before the wave."""
    if batch is None:
        batch = 1
    if isinstance(batch, str):
        if not batch.isidentifier():
            raise ValueError(f"a symbolic batch needs a dimension name, got {batch!r}")
        # trace at B = 2: torch.export specializes sizes 0 and 1
        example_b, dims = 2, {0: torch.export.Dim(batch)}
    else:
        batch = int(batch)
        if batch < 1:
            raise ValueError(f"fixed batch must be >= 1, got {batch}")
        example_b, dims = batch, None
    wave = torch.zeros((example_b, n_samples), dtype=torch.float32, device=device)
    dynamic = tuple(dict.fromkeys(a) for a in extra_args) + (dims,)  # the weights' shapes are fixed
    with torch.no_grad():
        program = torch.export.export(module, (*extra_args, wave), dynamic_shapes=dynamic)

    artifact = out_path + ARTIFACT_SUFFIX
    manifest = out_path + MANIFEST_SUFFIX
    os.makedirs(os.path.dirname(os.path.abspath(artifact)), exist_ok=True)
    torch.export.save(program, artifact)
    with open(manifest, "w") as f:
        json.dump(
            {
                "platforms": [device.type],
                "sample_rate": mel_cfg.sr,
                "mel": {
                    "n_mels": mel_cfg.n_mels,
                    "hopsize": mel_cfg.hopsize,
                    "fmin_aug_range": mel_cfg.fmin_aug_range,
                    "fmax_aug_range": mel_cfg.fmax_aug_range,
                },
                "input": {
                    "shape": [None if isinstance(batch, str) else int(batch), n_samples],
                    "dtype": "float32",
                },
                "torch_version": torch.__version__,
                **manifest_fields,
            },
            f,
            indent=2,
        )
    return artifact, manifest


def export_inference(
    arch: str,
    out_path: str,
    checkpoint_path: Optional[str] = None,
    device="cuda",
    seconds: Optional[float] = None,
    dtype: str = "float32",
    batch: Optional[str] = "b",
    generator: Optional[torch.Generator] = None,
    mel_cfg: Optional[MelConfig] = None,
    bake_weights: bool = True,
    **overrides,
) -> Tuple[str, str]:
    """Export one registry arch (random weights from ``generator``, seed 0
    when None, or the weights of ``checkpoint_path``) as an artifact and its
    manifest, traced on ``device`` (the card by default; ``device="cpu"`` for
    a CPU artifact).

    The defaults follow the checkpoint: ``input_tdim`` from the arch spec,
    ``mel_cfg`` from :func:`passt_tpu_torch.hear.default_inference_mel_cfg`
    (the recipe's augmentation ranges and the arch's hop), ``seconds`` from
    input_tdim·hop/sr. ``batch="b"`` exports a symbolic batch; an int fixes
    it. Returns (artifact_path, manifest_path)."""
    from passt_tpu_torch.hear import default_inference_mel_cfg
    from passt_tpu_torch.models.registry import ARCHS, get_model

    if "input_tdim" not in overrides and arch in ARCHS:
        overrides["input_tdim"] = ARCHS[arch].input_tdim
    model = get_model(
        arch=arch,
        pretrained=checkpoint_path is not None,
        checkpoint_path=checkpoint_path,
        generator=generator,
        device=device,
        dtype=dtype,
        **overrides,
    )
    if mel_cfg is None:
        mel_cfg = dataclasses.replace(default_inference_mel_cfg(arch), n_mels=model.cfg.input_fdim)
    return export_model(
        model,
        out_path,
        seconds=seconds,
        batch=batch,
        mel_cfg=mel_cfg,
        bake_weights=bake_weights,
        manifest_extra={"arch": arch, "pretrained": checkpoint_path is not None},
    )


def export_model(
    model,
    out_path: str,
    seconds: Optional[float] = None,
    batch: Optional[str] = "b",
    mel_cfg: Optional[MelConfig] = None,
    manifest_extra: Optional[dict] = None,
    bake_weights: bool = True,
) -> Tuple[str, str]:
    """Trace and save a built model (a ``PaSST``, on the device the
    artifact is for). Patchout is train-only and never enters the eval
    program. ``seconds=None`` derives the wave length from the time grid
    (:func:`_derive_seconds`).

    ``bake_weights=True`` keeps the weights in the program: one file.
    ``bake_weights=False`` exports ``fn(params, wave)`` and writes the
    weights to ``<out>.params.npz`` (fp32, keyed by the model's parameter
    names): one artifact then serves every checkpoint of the arch.
    :func:`load_exported` handles both, by the manifest."""
    import numpy as np

    cfg = model.cfg
    device = next(model.parameters()).device
    mel_cfg = _prepare_mel(mel_cfg, cfg.input_fdim)
    if seconds is None:
        seconds = _derive_seconds(cfg.input_tdim, mel_cfg)
    manifest_fields = {
        "seconds": seconds,
        "weights": "baked" if bake_weights else "external",
        "outputs": {"logits": cfg.num_classes, "features": cfg.num_features},
        "dtype": cfg.dtype,
        **(manifest_extra or {}),
    }
    n_samples = int(round(seconds * mel_cfg.sr))  # round: 32.3 * 32000 is ...99.99 in floats
    if bake_weights:
        return _export_and_write(_Inference(model, mel_cfg), out_path, device, batch, n_samples, mel_cfg,
                                 manifest_fields)
    params = {k: p.detach() for k, p in model.named_parameters()}
    if any(p.dtype != torch.float32 for p in params.values()):
        raise ValueError("external weights are written as fp32: the model's parameters must be fp32")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)) or ".", exist_ok=True)
    np.savez(out_path + PARAMS_SUFFIX, **{k: p.cpu().numpy() for k, p in params.items()})
    return _export_and_write(_ExternalInference(model, mel_cfg), out_path, device, batch, n_samples, mel_cfg,
                             manifest_fields, extra_args=(params,))


class _EnsembleInference(torch.nn.Module):
    """The traced ensemble: the mel once, every member on it, the mean of
    their logits (``ensemble_apply``)."""

    def __init__(self, members, mel_cfg: MelConfig, input_tdim: int):
        super().__init__()
        self.members = torch.nn.ModuleList(members)
        self.mel_cfg = mel_cfg
        self.input_tdim = input_tdim

    def forward(self, wave):
        from passt_tpu_torch.models.registry import ensemble_apply
        from passt_tpu_torch.ops.frontend import log_mel_spectrogram

        mel = log_mel_spectrogram(wave, self.mel_cfg, train=False)
        pairs = [(m, dict(m.named_parameters())) for m in self.members]
        mean, _ = ensemble_apply(pairs, mel[:, None, :, : self.input_tdim])
        return mean


def export_ensemble(
    name: str,
    out_path: str,
    checkpoint_dir: Optional[str] = None,
    device="cuda",
    seconds: Optional[float] = None,
    batch: Optional[str] = "b",
    dtype: str = "float32",
    mel_cfg: Optional[MelConfig] = None,
    seed: int = 0,
    **overrides,
) -> Tuple[str, str]:
    """Export a published logit-averaged ensemble as ONE artifact: the mel
    frontend computed once, the members, the logit mean (the reference's
    EnsembelerModel, passt.py:1021-1036). ``name`` indexes
    ``passt_tpu_torch.models.registry.ENSEMBLES``; ``checkpoint_dir`` holds
    ``<arch>.npz`` member weights (the ``evaluate_ensemble`` convention),
    else member i takes random weights from seed ``seed + i``. Returns
    (artifact, manifest)."""
    from passt_tpu_torch.hear import default_inference_mel_cfg
    from passt_tpu_torch.models.registry import ENSEMBLES, get_ensemble_model

    if name not in ENSEMBLES:
        raise KeyError(f"unknown ensemble {name!r}; one of {list(ENSEMBLES)}")
    arch_list, published_map = ENSEMBLES[name]
    paths = None
    if checkpoint_dir is not None:
        paths = [os.path.join(checkpoint_dir, f"{arch}.npz") for arch, _, _ in arch_list]
    pairs = get_ensemble_model(arch_list, seed=seed, checkpoint_paths=paths, device=device, dtype=dtype,
                               **overrides)
    cfg = pairs[0][0].cfg  # members share the input geometry (their strides differ)
    if mel_cfg is None:
        mel_cfg = dataclasses.replace(default_inference_mel_cfg(arch_list[0][0]), n_mels=cfg.input_fdim)
    mel_cfg = _prepare_mel(mel_cfg, cfg.input_fdim)
    if seconds is None:
        seconds = _derive_seconds(cfg.input_tdim, mel_cfg)
    module = _EnsembleInference([m for m, _ in pairs], mel_cfg, cfg.input_tdim)
    return _export_and_write(
        module,
        out_path,
        torch.device(device),
        batch,
        int(round(seconds * mel_cfg.sr)),
        mel_cfg,
        {
            "seconds": seconds,
            "ensemble": name,
            "members": [list(m) for m in arch_list],
            "published_map": published_map,
            "pretrained": checkpoint_dir is not None,
            "outputs": {"logits": cfg.num_classes},
            "dtype": dtype,
        },
    )


@contextlib.contextmanager
def _fp32_products():
    """fp32 products stay fp32 (no TF32) while a loaded program runs,
    whatever the caller's flags: the port's rule for fp32 dots."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def load_exported(out_path: str):
    """Load an artifact; returns ``fn(wave) -> (logits, features)`` (an
    ensemble's: the mean logits), ``wave`` a [B, T] float32 array or tensor
    (moved to the program's device). Needs torch, numpy and the custom ops,
    not this package's model code. An external-weights artifact (manifest
    ``weights: external``) loads ``<out>.params.npz`` and passes it first."""
    from passt_tpu_torch.ops import library  # noqa: F401  (registers the ops the program calls)

    base = out_path[: -len(ARTIFACT_SUFFIX)] if out_path.endswith(ARTIFACT_SUFFIX) else out_path
    program = torch.export.load(base + ARTIFACT_SUFFIX)
    manifest = read_manifest(base) if os.path.exists(base + MANIFEST_SUFFIX) else {}
    device = torch.device(manifest.get("platforms", ["cpu"])[0])
    params = None
    if manifest.get("weights") == "external":
        params = _load_params_npz_plain(base + PARAMS_SUFFIX, device)
    module = program.module()

    def fn(wave):
        wave = torch.as_tensor(wave, dtype=torch.float32, device=device)
        with torch.inference_mode(), _fp32_products():
            if params is not None:
                return module(params, wave)
            return module(wave)

    return fn


def _load_params_npz_plain(path: str, device) -> Dict[str, torch.Tensor]:
    """The flat ``name -> array`` npz :func:`export_model` writes, as tensors
    on ``device`` (no model code needed)."""
    import numpy as np

    with np.load(path) as data:
        return {k: torch.from_numpy(data[k]).to(device) for k in data.files}


def read_manifest(out_path: str) -> dict:
    """Accepts the prefix, the .passt.pt2 path, or the .passt.json path."""
    if out_path.endswith(ARTIFACT_SUFFIX):
        out_path = out_path[: -len(ARTIFACT_SUFFIX)]
    path = out_path if out_path.endswith(MANIFEST_SUFFIX) else out_path + MANIFEST_SUFFIX
    with open(path) as f:
        return json.load(f)


__all__ = [
    "ARTIFACT_SUFFIX",
    "MANIFEST_SUFFIX",
    "PARAMS_SUFFIX",
    "export_ensemble",
    "export_inference",
    "export_model",
    "load_exported",
    "read_manifest",
]
