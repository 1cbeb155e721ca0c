"""The experiment runner: config -> datasets -> loaders -> model -> commands
(port of passt_tpu/experiments/common.py).

Each recipe exposes the reference's commands (``main``, ``evaluate_only``,
``model_speed_test``, ``test_loaders``, ``print_config``; ex_audioset.py:336,
430, 365, 445) and the JAX package's others (``evaluate_ensemble``,
``predict``, ``test_loaders_train_speed``, ``print_named_configs``,
``preload``) on top of a typed
:class:`passt_tpu_torch.config.ExperimentConfig`.

The commands that run the model take ``device`` ("cuda" unless the caller
asks for the CPU, as the tests do; no card raises, nothing falls back) and
run the steps as CUDA graphs there, the counterpart of the JAX package's
``jax.jit``. One process drives one card; ``main``, ``evaluate_only`` and
``model_speed_test`` with ``trainer.n_data=N`` run data-parallel across the
N processes of a ``torchrun`` group (``passt_tpu_torch.parallel``), as the
JAX package's do across a mesh, and with ``trainer.n_model=M`` each data
rank's model split over M processes (tensor parallelism).

HDF5 containers are opened (and ``h5py`` imported) only where one is read:
the dataset builders, :func:`train_target_chunks`, ``_steps_per_epoch``'s
length read and ``preload``.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from passt_tpu_torch import graphs
from passt_tpu_torch.config import ExperimentConfig, parse_cli
from passt_tpu_torch.data import (
    ConcatDataset,
    DataLoader,
    HDF5AudioDataset,
    SequentialSampler,
    ShuffleSampler,
    WavMixDataset,
    WeightedEpochSampler,
)
from passt_tpu_torch.data.pipeline import default_collate
from passt_tpu_torch.models.registry import resolve_device
from passt_tpu_torch.train.loop import MetricsLogger, evaluate, fit
from passt_tpu_torch.train.steps import create_train_state, make_eval_step, make_optimizer, make_train_step


def build_base_train_dataset(cfg: ExperimentConfig, path: str, seed: int):
    """The un-augmented HDF5 base for one training container — the single
    construction point shared by the numpy chain (build_train_dataset) and
    the native C++ batch plane (data.native_loader), so their kwargs cannot
    drift apart."""
    d = cfg.data
    bank = None
    if d.ir_augment and d.ir_path:
        import h5py

        from passt_tpu_torch.data.datasets import load_ir_bank

        # IR convolution runs BEFORE the stride resample, at the container's
        # SOURCE rate, so the bank is loaded at that rate (loading it at the
        # target rate would time-stretch every IR on 16/8 kHz presets)
        with h5py.File(path, "r") as f:
            source_rate = int(f.attrs.get("sample_rate", 32000))
        bank = load_ir_bank(d.ir_path, source_rate, d.cut_irs_offset)
    return HDF5AudioDataset(
        path,
        sample_rate=d.sample_rate,
        classes_num=d.num_classes,
        clip_length=d.clip_length,
        packed_targets=d.packed_targets,
        gain_augment_db=d.gain_augment_db,
        crop=d.crop,
        seed=seed,
        impulse_responses=bank,
        ir_augment_rate=d.ir_augment if bank else 0.0,
    )


def build_train_dataset(cfg: ExperimentConfig):
    d = cfg.data
    if d.train_hdf5 is None:
        raise FileNotFoundError(
            "data.train_hdf5 is not set — point it at a packed HDF5 "
            "(see passt_tpu_torch.data.prepare)"
        )
    sets = [build_base_train_dataset(cfg, d.train_hdf5, d.seed)]
    if d.train_hdf5_extra:
        sets.append(build_base_train_dataset(cfg, d.train_hdf5_extra, d.seed + 1))
    ds = sets[0] if len(sets) == 1 else ConcatDataset(sets)
    if d.roll:
        from passt_tpu_torch.data.datasets import RollDataset

        ds = RollDataset(ds, d.roll_shift_range, seed=d.seed + 17)
    if d.wavmix:
        ds = WavMixDataset(ds, merge_masks=d.merge_mask_wavmix, seed=d.seed + 31)
    return ds


def build_eval_dataset(cfg: ExperimentConfig, which: str = "eval"):
    d = cfg.data
    path = d.eval_hdf5 if which == "eval" else d.valid_hdf5
    if path is None:
        raise FileNotFoundError(f"data.{which}_hdf5 is not set")
    return HDF5AudioDataset(
        path,
        sample_rate=d.sample_rate,
        classes_num=d.num_classes,
        clip_length=d.clip_length,
        packed_targets=d.packed_targets,
        crop="head",
    )


def train_target_chunks(cfg: ExperimentConfig, chunk_rows: int = 131072) -> Iterator[np.ndarray]:
    """The training containers' multi-hot targets in row chunks, for the
    class-balanced sampler's streamed weights (unpacking AudioSet-2M's whole
    2M x 527 matrix at once peaked at ~20 GB of host memory)."""
    import h5py

    d = cfg.data
    for path in filter(None, [d.train_hdf5, d.train_hdf5_extra]):
        with h5py.File(path, "r") as f:
            col = f["target"]
            for lo in range(0, len(col), chunk_rows):
                t = col[lo: lo + chunk_rows]
                if d.packed_targets:
                    t = np.unpackbits(t, axis=-1, count=d.num_classes)
                yield t


def _resolve_rank(d, n_model: int = 1):
    """``num_replicas=0`` -> the data-parallel size and data rank of the
    initialised ``torch.distributed`` process group (its size and rank over
    ``n_model``: the model ranks of a data rank read the same rows), (1, 0)
    without one (the reference reads DDP/NODE_RANK env vars,
    audioset/dataset.py:296-300)."""
    if d.num_replicas == 0:
        dist = torch.distributed
        if dist.is_available() and dist.is_initialized():
            return dist.get_world_size() // n_model, dist.get_rank() // n_model
        return 1, 0
    return d.num_replicas, d.rank


def build_train_loader(cfg: ExperimentConfig, dataset=None):
    d = cfg.data
    ds = dataset if dataset is not None else build_train_dataset(cfg)
    num_replicas, rank = _resolve_rank(d, cfg.trainer.n_model)
    if d.weighted_sampler:
        from passt_tpu_torch.data.sampler import class_balanced_sample_weights_streamed

        weights = class_balanced_sample_weights_streamed(lambda: train_target_chunks(cfg), d.num_classes)
        sampler = WeightedEpochSampler(
            weights,
            epoch_len=d.epoch_len,
            replacement=d.sampler_replace,
            num_replicas=num_replicas,
            rank=rank,
            seed=d.seed,
        )
    else:
        sampler = ShuffleSampler(len(ds), num_replicas, rank, seed=d.seed)
    builder = None
    if dataset is None:
        from passt_tpu_torch.data.native_loader import maybe_native_builder

        builder = maybe_native_builder(cfg, build_base_train_dataset)
    return DataLoader(
        ds,
        d.batch_size,
        sampler,
        drop_last=True,
        prefetch=d.prefetch,
        num_workers=d.num_workers,
        batch_builder=builder,
    )


def build_eval_loader(
    cfg: ExperimentConfig,
    which: Optional[str] = None,
    batch_size=None,
    sharded: bool = True,
):
    """``sharded=False`` forces the full (unsharded) eval set: the commands
    with no cross-process gather (evaluate_ensemble, predict)."""
    which = which or cfg.data.eval_set
    d = cfg.data
    ds = build_eval_dataset(cfg, which)
    bs = batch_size or d.eval_batch_size
    num_replicas, rank = _resolve_rank(d, cfg.trainer.n_model) if sharded else (1, 0)
    if d.clip_length is None and not d.eval_pad_multiple_s and bs > 1:
        # EXACT variable-length eval, batched: clips grouped by exact length
        # so no clip is padded (bitwise the reference's batch_size=1
        # protocol) and each distinct length captures one graph
        try:
            lengths = ds.item_lengths()
        except ValueError as e:
            print(f"[eval] exact eval falls back to batch_size=1 ({e})")
            bs = 1
        else:
            from passt_tpu_torch.data.sampler import LengthGroupedBatchSampler

            bsampler = LengthGroupedBatchSampler(lengths, bs, num_replicas, rank)
            print(
                f"[eval] length-grouped exact eval: {len(lengths)} clips, "
                f"{bsampler.num_distinct_lengths} distinct lengths, "
                f"{len(bsampler)} batches"
            )
            return DataLoader(
                ds,
                batch_sampler=bsampler,
                collate=default_collate,
                prefetch=d.prefetch,
                num_workers=d.num_workers,
            )
    collate = default_collate
    if d.eval_pad_multiple_s:
        import functools

        collate = functools.partial(
            default_collate,
            pad_to_multiple=int(d.eval_pad_multiple_s * d.sample_rate),
        )
    return DataLoader(
        ds,
        bs,
        SequentialSampler(len(ds), num_replicas, rank),
        collate=collate,
        prefetch=d.prefetch,
        num_workers=d.num_workers,
    )


def _process_rank() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _stop(it) -> None:
    if hasattr(it, "stop"):
        it.stop()  # release the prefetch thread and the queued batches


@dataclasses.dataclass
class Experiment:
    """A named recipe: default config + command dispatch."""

    name: str
    default_config: ExperimentConfig
    single_label: bool = False
    # model_speed_test default batch — the reference uses B=12 for AudioSet
    # (ex_audioset.py:365) but B=100 for the fine-tune recipes
    # (ex_esc50.py:281, ex_fsd50k.py); recipes override this field.
    speed_test_batch_size: int = 12
    # train-set length cache keyed by hdf5 paths (steps_per_epoch feeds the
    # LR schedule)
    _len_cache: Dict = dataclasses.field(default_factory=dict, repr=False)

    # ------------------------------------------------------------------
    def _steps_per_epoch(self, cfg: ExperimentConfig, train_loader=None) -> int:
        """Steps per epoch for the epoch-indexed LR schedule. Must reflect
        the REAL loader length: deriving it from data.epoch_len when the
        recipe uses a shuffle sampler (esc50/fsd50k/openmic) would freeze
        the schedule at epoch 0."""
        if cfg.trainer.limit_train_batches:
            return max(1, cfg.trainer.limit_train_batches)
        if train_loader is not None:
            return max(1, len(train_loader))
        if cfg.data.weighted_sampler:
            n = cfg.data.epoch_len
        else:
            # shuffle sampler: the dataset length (readable without
            # decoding), cached per hdf5 paths; the fallback is loud
            key = (cfg.data.train_hdf5, cfg.data.train_hdf5_extra)
            n = self._len_cache.get(key)
            if n is None:
                try:
                    import h5py

                    n = 0
                    for path in filter(None, [cfg.data.train_hdf5, cfg.data.train_hdf5_extra]):
                        with h5py.File(path, "r") as f:
                            n += len(f["audio_name"])
                except Exception as e:
                    n = cfg.data.epoch_len
                    print(
                        f"WARNING: could not read train HDF5 length ({e!r}); "
                        f"steps_per_epoch falls back to epoch_len={n} — the "
                        "LR schedule may be off"
                    )
                if n == 0 and not (cfg.data.train_hdf5 or cfg.data.train_hdf5_extra):
                    # no train paths at all (an eval-only build): a cached 0
                    # would pin steps_per_epoch to 1 for the process lifetime
                    n = cfg.data.epoch_len
                    print(
                        "WARNING: no train HDF5 configured; steps_per_epoch "
                        f"falls back to epoch_len={n}"
                    )
                self._len_cache[key] = n
        num_replicas = _resolve_rank(cfg.data, cfg.trainer.n_model)[0]
        return max(1, n // max(1, num_replicas) // cfg.data.batch_size)

    def build(
        self,
        cfg: ExperimentConfig,
        generator: Optional[torch.Generator] = None,
        steps_per_epoch: Optional[int] = None,
        device="cuda",
        runtime=None,
    ):
        """(model, state, train_step, eval_step, tx) from a config, on
        ``device``. The order is the JAX package's, kept by
        :func:`create_train_state`: random weights from ``generator`` (a CPU
        generator seeded with ``trainer.seed`` when None), then
        ``model.checkpoint_path``, then the optimizer's init on those fp32
        weights, and only then the storage cast (``trainer.param_dtype``).
        The steps are the graphed ones (``jit=True``; the train step donates
        its state). With ``runtime`` (a ``DDPRuntime``) the state is rank
        0's on every rank and the train step is the data-parallel one, on
        the rank's device."""
        device = runtime.device if runtime is not None else resolve_device(device)
        if steps_per_epoch is None:
            steps_per_epoch = self._steps_per_epoch(cfg)
        tx = make_optimizer(
            lr=cfg.trainer.lr,
            weight_decay=cfg.trainer.weight_decay,
            steps_per_epoch=steps_per_epoch,
            schedule_mode=cfg.trainer.schedule_mode,
            warm_up_len=cfg.trainer.warm_up_len,
            ramp_down_start=cfg.trainer.ramp_down_start,
            ramp_down_len=cfg.trainer.ramp_down_len,
            last_lr_value=cfg.trainer.last_lr_value,
            moments_dtype=cfg.trainer.opt_moments_dtype,
            grad_accum=cfg.trainer.grad_accum,
        )
        if cfg.model.pretrained and cfg.model.checkpoint_path is None:
            raise FileNotFoundError(
                "model.pretrained=true requires model.checkpoint_path "
                "(no network in this environment)"
            )
        checkpoint_path = cfg.model.checkpoint_path if cfg.model.pretrained else None
        param_dtype = cfg.resolved_param_dtype()
        model, state = create_train_state(
            cfg.passt_config(),
            tx,
            generator if generator is not None else torch.Generator().manual_seed(cfg.trainer.seed),
            param_dtype=param_dtype,
            device=device,
            checkpoint_path=checkpoint_path,
        )
        if checkpoint_path is not None:
            print(f"loaded pretrained checkpoint: {checkpoint_path}")
        train_step = make_train_step(
            model,
            tx,
            cfg.mel,
            loss_type=cfg.trainer.loss_type,
            use_mixup=cfg.trainer.use_mixup,
            mixup_alpha=cfg.trainer.mixup_alpha,
            log_grad_norm=cfg.trainer.log_grad_norm,
            log_grad_norm_per_block=cfg.trainer.log_grad_norm_per_block,
            param_sr=param_dtype == "bfloat16_sr",
        )
        eval_step = make_eval_step(model, cfg.mel, loss_type=cfg.trainer.loss_type,
                                   tensor_parallel=None if runtime is None else runtime.tensor_parallel)
        if runtime is not None:
            state = runtime.replicate_state(state)
            train_step = runtime.wrap_train_step(train_step)
        return model, state, train_step, eval_step, tx

    # ------------------------------------------------------------------
    # commands
    # ------------------------------------------------------------------
    def _schedule(self, cfg: ExperimentConfig, steps_per_epoch: Optional[int] = None):
        from passt_tpu_torch.train.steps import make_schedule

        if steps_per_epoch is None:
            steps_per_epoch = self._steps_per_epoch(cfg)
        return make_schedule(
            cfg.trainer.lr,
            steps_per_epoch,
            cfg.trainer.schedule_mode,
            cfg.trainer.warm_up_len,
            cfg.trainer.ramp_down_start,
            cfg.trainer.ramp_down_len,
            cfg.trainer.last_lr_value,
        )

    @staticmethod
    def _resolve_monitor(monitor, val_loaders) -> "Optional[str]":
        """Normalize trainer.monitor against the eval-set naming: with ONE
        eval set the epoch record's keys are unprefixed ("allap"), with
        several they carry the set prefix ("valid_allap"/"eval_allap"), as
        the reference logs set_name+"allap" (ex_fsd50k.py:222,254). A
        prefixed monitor against a single set resolves to the unprefixed
        key instead of never matching."""
        if monitor and len(val_loaders) <= 1:
            for p in ("valid_", "eval_"):
                if monitor.startswith(p):
                    return monitor[len(p):]
        return monitor

    def _eval_kw(self, cfg: ExperimentConfig) -> dict:
        return dict(
            limit_batches=cfg.trainer.limit_eval_batches,
            single_label=self.single_label,
            masked=cfg.trainer.loss_type == "masked",
            device_prefetch=cfg.trainer.device_prefetch,
            transfer_dtype=cfg.trainer.transfer_dtype,
        )

    def _runtime(self, cfg: ExperimentConfig, device):
        """(the ``DDPRuntime`` of ``trainer.n_data``, or None; the device the
        command runs on)."""
        from passt_tpu_torch.parallel.runtime import maybe_ddp_runtime

        runtime = maybe_ddp_runtime(cfg.trainer, device)
        if runtime is None:
            return None, resolve_device(device)
        print(f"data parallel: rank {runtime.rank} of {runtime.world_size} (data rank {runtime.data_rank} of "
              f"{runtime.n_data}, model rank {runtime.model_rank} of {runtime.n_model}) on {runtime.device} "
              f"(global batch {cfg.data.batch_size * runtime.n_data})")
        if runtime.spans_processes and cfg.data.num_replicas == 1:
            print("WARNING: data.num_replicas=1: every rank reads the whole dataset; "
                  "data.num_replicas=0 gives each rank its slice")
        return runtime, runtime.device

    def main(self, cfg: ExperimentConfig, device="cuda") -> Dict:
        """Train (the reference ``main`` command, ex_audioset.py:336-361) on
        one card, or with ``trainer.n_data=N`` data-parallel on N (the
        reference's ``DDP=N``)."""
        runtime, device = self._runtime(cfg, device)
        train_loader = build_train_loader(cfg)
        steps_per_epoch = self._steps_per_epoch(cfg, train_loader)
        model, state, train_step, eval_step, _ = self.build(cfg, steps_per_epoch=steps_per_epoch, device=device,
                                                            runtime=runtime)
        from passt_tpu_torch.utils import count_non_zero_params

        desc, total, non_zero = count_non_zero_params(state.params)
        print(f"model: {desc}")  # (reference logs these, ex_audioset.py:121-123)
        # every configured eval set is validated each epoch: FSD50K trains
        # against both [valid, eval] (ex_fsd50k.py:318-322)
        val_loaders = {}
        for which in ("valid", "eval"):
            try:
                val_loaders[which] = build_eval_loader(cfg, which=which)
            except FileNotFoundError:
                pass
        # the JSONL on rank 0 only: ranks log identical records
        logger = MetricsLogger(
            path=cfg.trainer.checkpoint_dir + f"/{self.name}_metrics.jsonl"
            if cfg.trainer.checkpoint_dir and _process_rank() == 0
            else None
        )
        start_epoch = 0
        swa_restore = None
        if cfg.trainer.resume and cfg.trainer.checkpoint_dir:
            from passt_tpu_torch.train.loop import restore_checkpoint

            try:
                state, swa_restore, last_epoch = restore_checkpoint(cfg.trainer.checkpoint_dir, state,
                                                                    runtime=runtime)
                start_epoch = last_epoch + 1
                print(f"resumed from epoch {last_epoch} (step {int(state.step)})")
            except FileNotFoundError:
                print("resume requested but no checkpoint found; starting fresh")
        result = fit(
            train_step=train_step,
            eval_step=eval_step,
            state=state,
            train_loader=train_loader,
            val_loaders=val_loaders,
            max_epochs=cfg.trainer.max_epochs,
            seed=cfg.trainer.seed + 1,
            swa_epoch_start=cfg.trainer.swa_epoch_start if cfg.trainer.swa else None,
            swa_freq=cfg.trainer.swa_freq,
            limit_train_batches=cfg.trainer.limit_train_batches,
            limit_eval_batches=cfg.trainer.limit_eval_batches,
            eval_every=cfg.trainer.eval_every,
            log_every_steps=cfg.trainer.log_every_steps,
            logger=logger,
            checkpoint_dir=cfg.trainer.checkpoint_dir,
            keep_last_n=cfg.trainer.keep_last_n,
            monitor=self._resolve_monitor(cfg.trainer.monitor, val_loaders),
            monitor_mode=cfg.trainer.monitor_mode,
            handle_sigterm=cfg.trainer.handle_sigterm,
            profile_dir=cfg.trainer.profile_dir,
            profile_start_step=cfg.trainer.profile_start_step,
            profile_num_steps=cfg.trainer.profile_num_steps,
            device_prefetch=cfg.trainer.device_prefetch,
            transfer_dtype=cfg.trainer.transfer_dtype,
            single_label=self.single_label,
            masked=cfg.trainer.loss_type == "masked",
            swa_restore=swa_restore,
            lr_schedule=self._schedule(cfg, steps_per_epoch),
            start_epoch=start_epoch,
            dump_spectrograms=cfg.trainer.dump_spectrograms,
            mel_cfg=cfg.mel,
            runtime=runtime,
        )
        logger.close()
        return {
            "done": True,
            "interrupted": result.interrupted,
            "history": result.history,
        }

    def evaluate_only(self, cfg: ExperimentConfig, device="cuda") -> Dict:
        """Evaluate a (pretrained) model (ex_audioset.py:430-441).

        With ``trainer.checkpoint_dir`` set and populated, restores the
        TRAINED checkpoint first — best-by-``trainer.monitor`` when set,
        else latest. When the restored checkpoint carries SWA weights, the
        averaged model is evaluated too (``swa_``-prefixed metrics). With
        ``trainer.n_data=N`` each rank evaluates its slice of the eval set
        (``data.num_replicas=0``) and the outputs are gathered."""
        runtime, device = self._runtime(cfg, device)
        model, state, _, eval_step, _ = self.build(cfg, device=device, runtime=runtime)
        val_loader = build_eval_loader(cfg)
        swa_params = None
        if cfg.trainer.checkpoint_dir:
            from passt_tpu_torch.train.loop import restore_checkpoint

            monitor = self._resolve_monitor(cfg.trainer.monitor, {"eval": val_loader})
            try:
                state, swa_restore, epoch = restore_checkpoint(
                    cfg.trainer.checkpoint_dir,
                    state,
                    monitor=monitor,
                    monitor_mode=cfg.trainer.monitor_mode,
                    runtime=runtime,
                )
                which = f"best by {monitor!r}" if monitor is not None else "latest"
                print(
                    f"evaluate_only: restored {which} checkpoint "
                    f"(epoch {epoch}) from {cfg.trainer.checkpoint_dir}"
                )
                if swa_restore is not None and swa_restore[1] > 0:
                    swa_params = swa_restore[0]
            except FileNotFoundError:
                print(
                    f"evaluate_only: no checkpoint in "
                    f"{cfg.trainer.checkpoint_dir}; evaluating the built model"
                )
        metrics = evaluate(eval_step, state.params, val_loader, runtime=runtime, **self._eval_kw(cfg))
        if swa_params is not None:
            sm = evaluate(eval_step, swa_params, val_loader, runtime=runtime, **self._eval_kw(cfg))
            metrics.update({f"swa_{k}": v for k, v in sm.items()})
        print({"validation": metrics})
        return metrics

    def evaluate_ensemble(self, cfg: ExperimentConfig, device="cuda") -> Dict:
        """Evaluate a logit-averaged checkpoint ensemble (reference ensemble
        named configs, config_updates.py:136-222; EnsembelerModel
        passt.py:1021-1036). Requires ``model.ensemble=<name>`` and
        ``model.ensemble_checkpoint_dir`` with ``<arch>.npz`` files. The
        mel, the members and the sigmoid run as one CUDA graph a batch
        shape, the members' parameters read in place."""
        from passt_tpu_torch.models.registry import ENSEMBLES, ensemble_apply, get_ensemble_model
        from passt_tpu_torch.ops.frontend import log_mel_spectrogram
        from passt_tpu_torch.train.metrics import mean_average_precision

        if cfg.model.ensemble not in ENSEMBLES:
            raise SystemExit(f"model.ensemble must be one of {list(ENSEMBLES)}")
        arch_list, published_map = ENSEMBLES[cfg.model.ensemble]
        if not cfg.model.ensemble_checkpoint_dir:
            # randomly initialised members would run a full eval pass and
            # print ap~0.002 next to the published mAP: fail fast
            raise SystemExit(
                "model.ensemble_checkpoint_dir is required for "
                "evaluate_ensemble (a directory of ported <arch>.npz "
                "checkpoints; see scripts/port_checkpoint.py)"
            )
        device = resolve_device(device)
        paths = [os.path.join(cfg.model.ensemble_checkpoint_dir, f"{arch}.npz") for arch, _, _ in arch_list]
        pairs = get_ensemble_model(
            arch_list,
            checkpoint_paths=paths,
            device=device,
            n_classes=cfg.model.n_classes,
            input_fdim=cfg.model.input_fdim,
            input_tdim=cfg.model.input_tdim,
            dtype=cfg.model.dtype,
        )
        mel_cfg = cfg.mel
        tdim = cfg.model.input_tdim
        members = [m for m, _ in pairs]

        def ens_step(params_list, wave):
            with torch.inference_mode():
                mel = log_mel_spectrogram(wave, mel_cfg, train=False)
                out, _ = ensemble_apply(list(zip(members, params_list)), mel[:, None, :, :tdim])
                return torch.sigmoid(out)

        cache = graphs.GraphCache(ens_step)
        params_list = graphs.InPlace([p for _, p in pairs])
        loader = build_eval_loader(cfg, sharded=False)  # no gather here
        outs, targets = [], []
        it = iter(loader)
        for i, batch in enumerate(it):
            if cfg.trainer.limit_eval_batches is not None and i >= cfg.trainer.limit_eval_batches:
                _stop(it)
                break
            wave = torch.from_numpy(np.asarray(batch["wave"], np.float32)).to(device)
            outs.append(cache(params_list, wave)[0].float().cpu().numpy())
            targets.append(batch["target"])
        ap = mean_average_precision(np.concatenate(targets), np.concatenate(outs))
        print({"ensemble": cfg.model.ensemble, "ap": ap, "published_map": published_map})
        return {"ap": ap, "published_map": published_map}

    def model_speed_test(
        self, cfg: ExperimentConfig, speed_test_batch_size: Optional[int] = None,
        test_length: int = 100, device="cuda",
    ) -> Dict:
        """Training-throughput harness (ex_audioset.py:365-426): the train
        step (graphed, donated) on a resident batch of ``ones`` mel
        spectrograms (the batch key "mel" skips the frontend), ``test_length``
        steps of warm-up (the first call eager, the second captures), then
        ``test_length`` timed steps, printed as specs/second. Timed with CUDA
        events on the card (the host clock on the CPU). The default batch is
        per recipe (``speed_test_batch_size``): 12 for AudioSet/OpenMIC, 100
        for the ESC-50/FSD50K fine-tune recipes (ex_esc50.py:281). With
        ``trainer.n_data=N`` it times the data-parallel step, each rank on its
        own batch, and reports the aggregate rate (global batch
        ``speed_test_batch_size x N``)."""
        if speed_test_batch_size is None:
            speed_test_batch_size = self.speed_test_batch_size
        runtime, device = self._runtime(cfg, device)
        model, state, train_step, _, _ = self.build(cfg, device=device, runtime=runtime)
        b = speed_test_batch_size
        x = torch.ones((b, 1, cfg.model.input_fdim, cfg.model.input_tdim), dtype=torch.float32, device=device)
        n_out = cfg.model.n_classes * (2 if cfg.trainer.loss_type == "masked" else 1)
        if self.single_label:
            y = torch.zeros((b,), dtype=torch.int64, device=device)
        else:
            y = torch.ones((b, n_out), dtype=torch.float32, device=device)
        batch = {"mel": x, "target": y}

        def run(state, n):
            loss = torch.zeros((), device=device)
            for _ in range(n):
                state, m = train_step(state, batch, 0)
                loss += m["loss"]
            return state, loss

        # the warm-up has the timed run's length, as the JAX harness's
        state, loss = run(state, test_length)
        float(loss)
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            state, loss = run(state, test_length)
            end.record()
            end.synchronize()
            dt = start.elapsed_time(end) / 1000.0
        else:
            t0 = time.perf_counter()
            state, loss = run(state, test_length)
            float(loss)
            dt = time.perf_counter() - t0
        speed = test_length * b * (runtime.n_data if runtime is not None else 1) / dt
        print("average speed: ", speed, " specs/second")
        return {"specs_per_second": speed}

    def test_loaders_train_speed(self, cfg: ExperimentConfig) -> Dict:
        """Loader-only throughput: two timed full passes over the training
        loader, no step (reference test_loaders_train_speed,
        config_updates.py:233-251 — pass 1 is cold cache, pass 2 warm).
        Prints clips/second, to hold against model_speed_test's rate."""
        loader = build_train_loader(cfg)
        native = loader.batch_builder is not None
        out: Dict[str, float] = {"native": native, "num_workers": loader.num_workers}
        for pass_i in (1, 2):
            loader.set_epoch(pass_i)
            n_clips = 0
            limit = cfg.trainer.limit_train_batches
            t0 = time.perf_counter()
            it = iter(loader)
            for i, batch in enumerate(it):
                if limit is not None and i >= limit:
                    _stop(it)
                    break
                n_clips += len(batch["wave"])
            dt = time.perf_counter() - t0
            rate = n_clips / dt if dt > 0 else float("inf")
            print(
                f"pass {pass_i}: {n_clips} clips in {dt:.2f}s = {rate:.1f} clips/s "
                f"(native={native}, workers={loader.num_workers})"
            )
            out[f"pass{pass_i}_clips_per_s"] = rate
        return out

    def test_loaders(self, cfg: ExperimentConfig) -> Dict:
        """Pull one batch from each loader (ex_audioset.py:444-456)."""
        out = {}
        for name, builder in [
            ("training", lambda: build_train_loader(cfg)),
            ("test", lambda: build_eval_loader(cfg)),
        ]:
            try:
                loader = builder()
                it = iter(loader)
                batch = next(it)
                _stop(it)  # a single-batch peek must not leak the worker
                print(name, batch["wave"].shape, batch["target"].shape, batch["name"][:3])
                out[name] = tuple(batch["wave"].shape)
            except FileNotFoundError as e:
                print(name, "skipped:", e)
        return out

    def print_config(self, cfg: ExperimentConfig) -> Dict:
        print(cfg.pretty())
        return {}

    def predict(self, cfg: ExperimentConfig, out_path: Optional[str] = None, device="cuda") -> Dict:
        """Run inference over the eval set and dump (names, probabilities or
        log-probabilities) (the reference ``M.predict`` hook,
        ex_audioset.py:208-214). Writes ``<checkpoint_dir or .>/predictions.npz``
        with arrays ``names``, ``out``, ``target``."""
        device = resolve_device(device)
        model, state, _, eval_step, _ = self.build(cfg, device=device)
        loader = build_eval_loader(cfg, sharded=False)  # no gather here
        names, outs, targets = [], [], []
        it = iter(loader)
        for i, batch in enumerate(it):
            if cfg.trainer.limit_eval_batches is not None and i >= cfg.trainer.limit_eval_batches:
                _stop(it)
                break
            target = np.asarray(batch["target"]).astype(np.int64 if self.single_label else np.float32)
            res = eval_step(
                state.params,
                {
                    "wave": torch.from_numpy(np.asarray(batch["wave"], np.float32)).to(device),
                    "target": torch.from_numpy(target).to(device),
                },
            )
            names.extend(batch["name"])
            outs.append(res["out"].float().cpu().numpy())
            targets.append(batch["target"])
        out = np.concatenate(outs)
        target = np.concatenate(targets)
        path = out_path or os.path.join(cfg.trainer.checkpoint_dir or ".", "predictions.npz")
        np.savez(path, names=np.asarray(names), out=out, target=target)
        print(f"wrote {len(names)} predictions to {path}")
        return {"n": len(names), "path": path}

    def print_named_configs(self, cfg: ExperimentConfig) -> Dict:
        """List the presets (reference print_named_configs, README.md:253-256)."""
        from passt_tpu_torch.config import PRESETS

        for name, overrides in PRESETS.items():
            print(f"{name}: {overrides}")
        return {"presets": list(PRESETS)}

    def preload(self, cfg: ExperimentConfig) -> Dict:
        """Sequentially read every training item — NFS cache warm +
        container integrity check (reference preload_mp3,
        ex_audioset.py:465-472, audioset/dataset.py:246-254)."""
        import h5py

        total = 0
        for path in filter(None, [cfg.data.train_hdf5, cfg.data.train_hdf5_extra]):
            with h5py.File(path, "r") as f:
                col = next(c for c in ("waveform", "raw_f32", "raw_i16", "wav", "mp3") if c in f)
                n = len(f[col])
                for i in range(n):
                    _ = f[col][i]
                total += n
                print(f"preloaded {n} items from {path}")
        return {"preloaded": total}

    COMMANDS = (
        "main",
        "evaluate_only",
        "evaluate_ensemble",
        "predict",
        "model_speed_test",
        "test_loaders",
        "test_loaders_train_speed",
        "print_config",
        "print_named_configs",
        "preload",
    )
    #: the commands that run the model, on ``run_command``'s ``device``
    DEVICE_COMMANDS = ("main", "evaluate_only", "evaluate_ensemble", "predict", "model_speed_test")


def run_command(experiment: Experiment, argv, device="cuda") -> Dict:
    command, cfg = parse_cli(list(argv), experiment.default_config)
    if command not in experiment.COMMANDS:
        raise SystemExit(
            f"unknown command {command!r}; available: {experiment.COMMANDS}"
        )
    if cfg.trainer.compilation_cache_dir:
        print(f"trainer.compilation_cache_dir={cfg.trainer.compilation_cache_dir!r}: the port compiles no XLA "
              "program and has no compile cache; the setting is ignored")
    fn = getattr(experiment, command)
    if command in experiment.DEVICE_COMMANDS:
        return fn(cfg, device=device)
    return fn(cfg)
