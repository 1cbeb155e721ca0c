"""Typed experiment configuration with dotted CLI overrides and named presets
(port of passt_tpu/config.py).

The same dataclasses, fields, defaults, presets and error texts as the JAX
package's, so a command line means the same thing to both packages: the
``model.*``, ``mel.*``, ``data.*`` and ``trainer.*`` dotted keys and the
named presets of the reference's sacred CLI (``with key=value
named_config``), resolved eagerly into frozen dataclasses. It builds on the
port's own :class:`~passt_tpu_torch.ops.frontend.MelConfig` and
:class:`~passt_tpu_torch.models.passt.PaSSTConfig`.

A few trainer knobs name JAX machinery; they stay so that command lines
carry over, and mean here: ``profile_dir`` a ``torch.profiler`` trace of
``fit``'s steps; ``compilation_cache_dir`` nothing (the port compiles no
XLA program; ``run_command`` says so); ``n_data`` the processes of a
data-parallel run, one card each (``torch.distributed``, started by
``torchrun``; ``passt_tpu_torch.parallel``); ``n_model`` the processes
that split each block's weights (tensor parallelism), so a run takes
``n_data * n_model`` processes.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Dict, List, Optional, Tuple

from passt_tpu_torch.models.passt import PaSSTConfig
from passt_tpu_torch.ops.frontend import MelConfig


@dataclasses.dataclass(frozen=True)
class ModelSelect:
    """get_model arguments (reference models/passt.py:957-961)."""

    arch: str = "passt_s_swa_p16_128_ap476"
    pretrained: bool = False
    checkpoint_path: Optional[str] = None
    n_classes: int = 527
    in_channels: int = 1
    fstride: int = 10
    tstride: int = 10
    input_fdim: int = 128
    input_tdim: int = 998
    u_patchout: int = 0
    s_patchout_t: int = 40  # AudioSet recipe default (ex_audioset.py:62)
    s_patchout_f: int = 4
    dtype: str = "bfloat16"
    gelu: str = "auto"  # "erf" | "tanh" | "auto" (erf under fp32, tanh under bf16)
    plus1_attn: bool = False  # "+1 trick" quiet attention (reference PLUS1_TRICK)
    attn_impl: str = "auto"  # "fused" (the attention kernels) | "xla" (the
    # einsum composition) | "auto" (fused where CUDA is)
    ln_impl: str = "auto"  # block LayerNorms: "xla" | "fused" (the
    # LayerNorm-backward kernel) | "auto" (= xla)
    patch_embed_impl: str = "unfold"  # "unfold" | "conv": the same function here
    fuse_ln_qkv: bool = False  # norm1 absorbed into the attention boundary
    # (the F1 / B2 kernels; see PaSSTConfig.fuse_ln_qkv)
    blocks_impl: str = "loop"  # transformer depth: "loop" (per-block
    # params) | "scan" (one Block over stacked [depth, ...] params) |
    # "stacked" (the same params, the hand-written backward with batched
    # weight gradients; see PaSSTConfig). Checkpoints interconvert between
    # the layouts.
    # ensemble evaluation (reference ensemble named configs,
    # config_updates.py:136-222): name into registry.ENSEMBLES plus a
    # directory of checkpoints named <arch>.npz
    ensemble: Optional[str] = None
    ensemble_checkpoint_dir: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class DataConfig:
    train_hdf5: Optional[str] = None
    train_hdf5_extra: Optional[str] = None  # AudioSet unbalanced split
    valid_hdf5: Optional[str] = None
    eval_hdf5: Optional[str] = None
    num_classes: int = 527
    clip_length: Optional[float] = 10.0
    sample_rate: int = 32000
    batch_size: int = 12  # reference train loader (ex_audioset.py:42)
    eval_batch_size: int = 20  # reference validate loader (ex_audioset.py:47)
    wavmix: bool = True  # ex_audioset.py:71
    roll: bool = True
    roll_shift_range: int = 50
    gain_augment_db: int = 7
    weighted_sampler: bool = True  # AudioSet class-balanced sampler
    epoch_len: int = 100000
    sampler_replace: bool = False
    packed_targets: bool = True
    merge_mask_wavmix: bool = False  # OpenMIC
    crop: str = "head"  # "random" for FSD50K training
    eval_set: str = "eval"  # "valid" for FSD50K's second eval loader
    eval_pad_multiple_s: float = 0.0  # variable-length eval: pad batches to
    # a multiple of this many seconds (bounds the graphs captured)
    num_replicas: int = 1  # 0: torch.distributed's world size and rank
    rank: int = 0
    seed: int = 42
    prefetch: int = 2
    num_workers: int = 8  # parallel per-item read threads
    native_loader: bool = True  # fused C++ batch assembly when
    # libhostplane.so is built and the container/augmentation chain is
    # eligible (int16 PCM, fixed clip length); falls back to numpy, loudly
    ir_augment: float = 0.0  # impulse-response convolution probability
    ir_path: Optional[str] = None  # .wav IR bank directory
    cut_irs_offset: Optional[int] = None  # keep the reference's 10-IR
    # window starting at this offset


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    max_epochs: int = 130  # ex_audioset.py:74
    lr: float = 0.00002
    weight_decay: float = 0.0001
    schedule_mode: str = "exp_lin"
    warm_up_len: int = 5
    ramp_down_start: int = 50
    ramp_down_len: int = 50
    last_lr_value: float = 0.01
    use_mixup: bool = True
    mixup_alpha: float = 0.3
    loss_type: str = "multilabel"
    swa: bool = True
    swa_epoch_start: int = 50
    swa_freq: int = 5
    eval_every: int = 1
    limit_train_batches: Optional[int] = None  # mini_train (config_updates.py:24-26)
    limit_eval_batches: Optional[int] = None
    checkpoint_dir: Optional[str] = None
    keep_last_n: int = 1
    monitor: Optional[str] = None  # retain checkpoints by the BEST value of
    # this eval metric (the reference FSD50K ModelCheckpoint(monitor="allap"),
    # ex_fsd50k.py:292-294); keep_last_n becomes "keep best N"
    monitor_mode: str = "max"  # "max" or "min"
    resume: bool = False  # resume from the latest checkpoint in checkpoint_dir
    dump_spectrograms: int = 0  # save the first N training batches' mels as
    # .npy under checkpoint_dir
    log_every_steps: int = 50
    opt_moments_dtype: Optional[str] = "bfloat16_sr"  # AdamW moment storage:
    # both bf16 with a stochastically rounded second moment; null: fp32
    # moments (the reference torch AdamW); "bfloat16": the first moment bf16
    param_dtype: Optional[str] = "auto"  # parameter STORAGE dtype:
    # "bfloat16_sr" (bf16 storage, stochastically rounded applies); "auto":
    # bfloat16_sr under model.dtype=bfloat16, fp32 under float32; null: fp32
    grad_accum: int = 1  # average K micro-batch grads per optimizer update
    log_grad_norm: bool = False  # per-step global gradient norm
    log_grad_norm_per_block: bool = False  # one norm per top-level param group
    handle_sigterm: bool = True  # SIGTERM -> clean resumable exit
    profile_dir: Optional[str] = None  # a torch.profiler chrome trace of the
    # training steps [profile_start_step, +profile_num_steps) in this dir,
    # with the host spans (step.plan, graphs.key, graphs.unpack) and the
    # step's phase marks (trace_mark_<phase> kernels; passt_tpu_torch/tracing.py)
    profile_start_step: int = 10
    profile_num_steps: int = 5
    n_data: Optional[int] = None  # data-parallel processes (one card each),
    # the size of the torchrun group; None: one process, no group
    n_model: int = 1  # tensor-parallel processes a data rank's model is
    # split over (heads and MLP hidden units; passt_tpu_torch.parallel)
    seed: int = 0
    device_prefetch: int = 2  # batches the pinned side-stream feed keeps in
    # flight ahead of the step (0: inline copies)
    transfer_dtype: str = "float32"  # "int16" ships the augmented wave as
    # int16 PCM and dequantizes on the card (half the host->card bytes)
    compilation_cache_dir: Optional[str] = None  # the JAX package's XLA
    # compile cache; the port has none (run_command prints one line)


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    name: str = "audioset"
    model: ModelSelect = ModelSelect()
    mel: MelConfig = MelConfig(fmin_aug_range=10, fmax_aug_range=2000)
    data: DataConfig = DataConfig()
    trainer: TrainerConfig = TrainerConfig()

    def resolved_param_dtype(self) -> Optional[str]:
        """``trainer.param_dtype`` with ``"auto"`` resolved: bf16+SR
        parameter storage when the model computes in bf16 (the forward casts
        to bf16 at each use anyway), fp32 master weights when it computes in
        fp32."""
        pd = self.trainer.param_dtype
        if pd == "auto":
            return "bfloat16_sr" if self.model.dtype == "bfloat16" else None
        return pd

    def passt_config(self) -> PaSSTConfig:
        from passt_tpu_torch.models.registry import get_model_config

        m = self.model
        return get_model_config(
            arch=m.arch,
            n_classes=m.n_classes,
            in_channels=m.in_channels,
            fstride=m.fstride,
            tstride=m.tstride,
            input_fdim=m.input_fdim,
            input_tdim=m.input_tdim,
            u_patchout=m.u_patchout,
            s_patchout_t=m.s_patchout_t,
            s_patchout_f=m.s_patchout_f,
            dtype=m.dtype,
            gelu=m.gelu,
            plus1_attn=m.plus1_attn,
            attn_impl=m.attn_impl,
            ln_impl=m.ln_impl,
            patch_embed_impl=m.patch_embed_impl,
            blocks_impl=m.blocks_impl,
            fuse_ln_qkv=m.fuse_ln_qkv,
        )

    def pretty(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)


# ---------------------------------------------------------------------------
# dotted overrides
# ---------------------------------------------------------------------------
def _coerce(old: Any, raw: str) -> Any:
    if raw.lower() in ("none", "null"):
        return None
    if old is None or isinstance(old, str):
        try:
            return json.loads(raw)  # allow numbers/bools/quoted strings
        except (json.JSONDecodeError, ValueError):
            return raw
    if isinstance(old, bool):
        low = raw.lower()
        if low in ("1", "true", "yes", "on"):
            return True
        if low in ("0", "false", "no", "off"):
            return False
        # a typo ("ture") must not silently turn a feature off
        raise ValueError(
            f"cannot interpret {raw!r} as a boolean "
            "(use true/false/1/0/yes/no/on/off)"
        )
    if isinstance(old, int):
        return int(raw)
    if isinstance(old, float):
        return float(raw)
    if isinstance(old, tuple):
        return tuple(json.loads(raw))
    return json.loads(raw)


def apply_overrides(cfg, overrides: Dict[str, str]):
    """Apply ``{"trainer.lr": "1e-4", ...}`` to a (frozen) dataclass tree,
    returning a new tree — the sacred ``with key=value`` surface."""
    for key, raw in overrides.items():
        parts = key.split(".")
        cfg = _apply_one(cfg, parts, raw)
    return cfg


def _apply_one(node, parts: List[str], raw: str):
    field = parts[0]
    if not dataclasses.is_dataclass(node):
        raise KeyError(f"cannot descend into {type(node).__name__} at {field}")
    names = {f.name for f in dataclasses.fields(node)}
    if field not in names:
        raise KeyError(
            f"unknown config key {field!r} on {type(node).__name__}; known: {sorted(names)}"
        )
    old = getattr(node, field)
    if len(parts) == 1:
        new = _coerce(old, raw) if isinstance(raw, str) else raw
    else:
        new = _apply_one(old, parts[1:], raw)
    return dataclasses.replace(node, **{field: new})


# ---------------------------------------------------------------------------
# named presets (the reference named configs, config_updates.py:24-229)
# ---------------------------------------------------------------------------
Preset = Callable[[ExperimentConfig], ExperimentConfig]
PRESETS: Dict[str, Dict[str, str]] = {
    # debugging
    "mini_train": {"trainer.limit_train_batches": "5", "trainer.limit_eval_batches": "5"},
    "nomixup": {"trainer.use_mixup": "false"},
    # the reference named config is "mixup" (config_updates.py:18); "mixupx"
    # is the JAX package's alias
    "mixup": {"trainer.use_mixup": "true", "trainer.mixup_alpha": "0.3"},
    "mixupx": {"trainer.use_mixup": "true", "trainer.mixup_alpha": "0.3"},
    "no_wavmix": {"data.wavmix": "false"},
    "dynamic_roll": {"data.roll": "true", "data.roll_shift_range": "10000"},
    # high-temporal-resolution STFT variants (reference hop100/hop160
    # checkpoints: 10 s -> tdim 3200 / 2000); pretrained=true like every
    # published-checkpoint preset
    "stfthop100": {
        "mel.hopsize": "100",
        "model.arch": "passt_s_swa_f128_stfthop100_p16_s10_ap473",
        "model.input_tdim": "3200",
        "model.pretrained": "true",
    },
    "stfthop160": {
        "mel.hopsize": "160",
        "model.arch": "passt_s_swa_f128_stfthop160_p16_s10_ap473",
        "model.input_tdim": "2000",
        "model.pretrained": "true",
    },
    # FSD50K variable-length eval (reference ex_fsd50k.py variable_eval)
    "variable_eval": {
        "data.clip_length": "null",
        "data.eval_batch_size": "4",
        "data.eval_pad_multiple_s": "5",
    },
    # every clip at its true length, no padding; batches grouped by exact
    # length (containers without length metadata fall back to batch_size=1)
    "exact_eval": {
        "data.clip_length": "null",
        "data.eval_batch_size": "20",
        "data.eval_pad_multiple_s": "0",
    },
    # pretrained archs (config_updates.py:55-134); the wide-stride archs set
    # the stride their checkpoint was trained at (config_updates.py:87-134)
    **{
        name: {"model.arch": name, "model.pretrained": "true"}
        for name in [
            "passt_s_swa_p16_128_ap476",
            "passt_s_swa_p16_128_ap4761",
            "passt_s_p16_128_ap472",
            "passt_s_kd_p16_128_ap486",
            "passt_l_kd_p16_128_ap47",
        ]
    },
    **{
        name: {
            "model.arch": name,
            "model.pretrained": "true",
            "model.fstride": str(stride),
            "model.tstride": str(stride),
        }
        for name, stride in [
            ("passt_s_p16_s16_128_ap468", 16),
            ("passt_s_swa_p16_s16_128_ap473", 16),
            ("passt_s_swa_p16_s14_128_ap471", 14),
            ("passt_s_p16_s14_128_ap469", 14),
            ("passt_s_swa_p16_s12_128_ap473", 12),
            ("passt_s_p16_s12_128_ap470", 12),
        ]
    },
    # long-audio variants (config_updates.py:36-53): the reference feeds
    # 20-s clips to BOTH (the 30-s arch crops its time encoding); set
    # data.clip_length=30 to use the full window
    "passt_20sec": {
        "model.arch": "passt_s_f128_20sec_p16_s10_ap474",
        "model.input_tdim": "2000",
        "model.pretrained": "true",
        "data.clip_length": "20",
    },
    "passt_30sec": {
        "model.arch": "passt_s_f128_30sec_p16_s10_ap473",
        "model.input_tdim": "3000",
        "model.pretrained": "true",
        "data.clip_length": "20",
    },
}


def parse_cli(argv: List[str], base: ExperimentConfig) -> Tuple[str, ExperimentConfig]:
    """``[command] [preset|key=value ...]`` -> (command, config).

    Mirrors the reference CLI shape
    ``python ex_audioset.py command with key=value named_config``
    (README.md:154-175); the literal token "with" is accepted and skipped.
    """
    command = "main"
    cfg = base
    rest = list(argv)
    if rest and "=" not in rest[0] and rest[0] not in PRESETS and rest[0] != "with":
        command = rest.pop(0)
    overrides: Dict[str, str] = {}
    for tok in rest:
        if tok == "with":
            continue
        if "=" in tok:
            k, _, v = tok.partition("=")
            overrides[k] = v
        elif tok in PRESETS:
            cfg = apply_overrides(cfg, PRESETS[tok])
        else:
            raise SystemExit(f"unknown preset or override: {tok!r}")
    cfg = apply_overrides(cfg, overrides)
    return command, cfg
