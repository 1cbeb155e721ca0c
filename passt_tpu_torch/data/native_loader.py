"""Native batch assembly: the C++ host plane wired into the DataLoader
(port of passt_tpu/data/native_loader.py; :func:`maybe_native_builder`
builds one from a recipe's config).

The reference's training loader spends its time in native code outside
Python — PyAV decode + torch collate across 16 worker processes
(reference: ex_audioset.py:42-48; audioset/README.md:3 calls decode the
bottleneck). The equivalent here is :class:`NativeBatchBuilder`, a
``DataLoader(batch_builder=...)`` hook that replaces the per-item numpy
chain (HDF5AudioDataset -> RollDataset -> WavMixDataset -> collate) with

1. ONE fancy-indexed HDF5 read per column per batch (per-item h5py call
   overhead dominates raw-PCM loading otherwise),
2. one fused C++ pass per batch: int16 -> float32 + pad/head-or-random-crop
   + gain + circular roll (``hostplane_assemble_batch``),
3. C++ packbits-target unpacking (``hostplane_unpack_targets``),
4. C++ wave-mixup against a partner batch (``hostplane_wavmix``), with the
   (apply, partner, lambda) plan drawn host-side from the same
   per-(seed, index) streams as WavMixDataset.mix_plan.

Semantics mirror the numpy chain exactly; with augmentation off the two
paths are bit-identical (tested). With augmentation on, the C++ plane uses
its own xorshift RNG, so individual draws differ from numpy's PCG64 while
the distributions and the (seed, epoch)-determinism are the same.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from passt_tpu_torch.data import native
from passt_tpu_torch.data.datasets import (
    HDF5AudioDataset,
    epoch_seed,
    wavmix_plan,
)


class NativeBatchBuilder:
    """fn(indices) -> batch dict, fused in C++ (see module docstring).

    ``dataset`` may be a single :class:`HDF5AudioDataset` or a sequence of
    them — the flagship AudioSet-2M recipe concatenates the balanced and
    unbalanced containers (reference audioset/dataset.py:239-243, 348-360)
    and this builder routes each batch's global indices to the owning
    container with one fancy-indexed read per container per batch."""

    def __init__(
        self,
        dataset: Union[HDF5AudioDataset, Sequence[HDF5AudioDataset]],
        *,
        roll_shift_range: int = 0,
        wavmix: bool = False,
        wavmix_rate: float = 0.5,
        wavmix_beta: float = 2.0,
        merge_masks: bool = False,
        seed: int = 0,
        num_workers: int = 8,
    ):
        if not native.available():
            raise RuntimeError("libhostplane.so not built (make -C native)")
        datasets: List[HDF5AudioDataset] = (
            [dataset] if isinstance(dataset, HDF5AudioDataset) else list(dataset)
        )
        for ds in datasets:
            if not isinstance(ds, HDF5AudioDataset):
                raise TypeError("NativeBatchBuilder feeds on plain HDF5AudioDatasets")
            if ds.audio_column == "mp3":
                if not native.mp3_available():
                    raise RuntimeError(
                        "mp3 containers need the native plane with libmpg123 "
                        "(make -C native; libmpg123.so.0 on the loader path)"
                    )
            elif ds.audio_column != "raw_i16":
                raise ValueError(
                    "native assembly needs an int16 PCM or mp3 column, got "
                    f"{ds.audio_column!r}"
                )
            if ds.clip_samples is None:
                raise ValueError("native assembly needs a fixed clip_length")
            if getattr(ds, "ir_augment_rate", 0.0) and ds.impulse_responses:
                raise ValueError(
                    "ir_augment is python-side only; IR chains keep the numpy path"
                )
            if ds.sample_rate != ds.source_rate:
                # C++ plane has no stride-resample; 16/8 kHz presets on 32 kHz
                # containers keep the numpy path
                raise ValueError(
                    "native assembly needs sample_rate == container rate "
                    f"({ds.sample_rate} != {ds.source_rate})"
                )
        first = datasets[0]
        for ds in datasets[1:]:
            same = (
                ds.audio_column == first.audio_column
                and ds.clip_samples == first.clip_samples
                and ds.sample_rate == first.sample_rate
                and ds.packed_targets == first.packed_targets
                and ds.classes_num == first.classes_num
                and ds.crop == first.crop
                and ds.gain_augment_db == first.gain_augment_db
            )
            if not same:
                raise ValueError(
                    "concatenated containers must share column/geometry/"
                    "augmentation settings for the fused batch plane"
                )
        self.datasets = datasets
        self.dataset = first  # geometry source (all validated identical)
        self._offsets = np.cumsum([0] + [len(ds) for ds in datasets])
        self._total = int(self._offsets[-1])
        self.roll_shift_range = roll_shift_range
        self.wavmix = wavmix
        self.wavmix_rate = wavmix_rate
        self.wavmix_beta = wavmix_beta
        self.merge_masks = merge_masks
        self._base_seed = seed
        self._seed = seed
        self.num_workers = num_workers
        if num_workers is not None and num_workers >= 0:
            # honor the configured worker count — INCLUDING 0 (inline
            # single-threaded decode, the deterministic-debug/profiling
            # mode hostplane supports; the old >0 guard silently left the
            # default many-thread pool running).
            # The numpy path obeys data.num_workers; so must this.
            native.load(n_threads=num_workers)

    def set_epoch(self, epoch: int) -> None:
        self._seed = epoch_seed(self._base_seed, epoch)

    # ------------------------------------------------------------------
    def _raw_batch(self, idxs):
        """Fetch (bufs, names, target_rows) for GLOBAL indices over the
        container concatenation — one fancy-indexed HDF5 read per container
        per batch, results restitched in request order (the numpy
        ConcatDataset semantics, datasets.py)."""
        if len(self.datasets) == 1:
            return self.datasets[0].raw_batch(list(idxs))
        g = np.asarray(idxs)
        which = np.searchsorted(self._offsets[1:], g, side="right")
        bufs = [None] * len(g)
        names = [None] * len(g)
        rows = [None] * len(g)
        for ci, ds in enumerate(self.datasets):
            pos = np.nonzero(which == ci)[0]
            if not pos.size:
                continue
            b, n, r = ds.raw_batch(list(g[pos] - self._offsets[ci]))
            for j, p in enumerate(pos):
                bufs[p], names[p], rows[p] = b[j], n[j], r[j]
        return bufs, names, np.stack(rows)

    def _assemble(self, bufs, seed: int, idxs) -> np.ndarray:
        ds = self.dataset
        idxs = np.asarray(idxs, np.int64)  # GLOBAL dataset indices: slot b
        # draws from fold(seed, idxs[b]) so augmentation streams are
        # per-item across the epoch, not per batch position
        if ds.audio_column == "mp3":
            # fused decode(libmpg123)+pad/crop+gain+roll, pool-parallel —
            # the reference's 16 PyAV decode workers (ex_audioset.py:42-48)
            wave, rates, lens = native.assemble_mp3_batch(
                bufs,
                ds.clip_samples,
                gain_db=ds.gain_augment_db,
                roll_range=self.roll_shift_range,
                random_crop=ds.crop == "random",
                seed=seed,
                indices=idxs,
            )
            bad = np.nonzero(lens < 0)[0]
            if bad.size:  # propagate like a torch worker exception
                raise ValueError(
                    f"mp3 decode failed for {bad.size} item(s) in batch "
                    f"(first error code {int(lens[bad[0]])})"
                )
            if (rates != ds.sample_rate).any():
                bad_r = np.nonzero(rates != ds.sample_rate)[0]
                raise ValueError(
                    f"mp3 native rate {int(rates[bad_r[0]])} (batch item "
                    f"{int(bad_r[0])}) != dataset sample_rate {ds.sample_rate}"
                )
            return wave
        # zero-copy reinterpret of the vlen-uint8 rows (tobytes() would copy
        # the whole batch)
        pcm = [
            b.view(np.int16)
            if isinstance(b, np.ndarray) and b.flags.c_contiguous
            else np.frombuffer(bytes(b), dtype=np.int16)
            for b in bufs
        ]
        return native.assemble_batch(
            pcm,
            ds.clip_samples,
            gain_db=ds.gain_augment_db,
            roll_range=self.roll_shift_range,
            random_crop=ds.crop == "random",
            seed=seed,
            indices=idxs,
        )

    def _targets(self, rows) -> np.ndarray:
        ds = self.dataset
        rows = np.asarray(rows)
        if ds.packed_targets:
            return native.unpack_targets(rows, ds.classes_num)
        return np.asarray(rows, dtype=np.float32)

    def __call__(self, idxs) -> Dict[str, np.ndarray]:
        idxs = list(idxs)
        bufs, names, rows = self._raw_batch(idxs)
        wave = self._assemble(bufs, self._seed, idxs)
        target = self._targets(rows)

        if self.wavmix:
            # (apply, partner, lambda) per item from the identical
            # per-(seed, index) streams as WavMixDataset.mix_plan.
            apply = np.zeros(len(idxs), np.uint8)
            partners = list(idxs)
            lam = np.ones(len(idxs), np.float32)
            for b, i in enumerate(idxs):
                applied, partner, l = wavmix_plan(
                    self._seed, i, self._total, self.wavmix_rate,
                    self.wavmix_beta,
                )
                if applied:
                    apply[b] = 1
                    partners[b] = partner
                    lam[b] = l
            if apply.any():
                # decode ONLY the applied partners (the numpy chain decodes
                # partners lazily too; at rate 0.5 this halves the extra
                # decode work) and scatter them into a full-batch buffer
                # for the fused C++ mix
                sel = np.nonzero(apply)[0]
                partner_idx = [partners[j] for j in sel]
                bufs2, _, rows2_sel = self._raw_batch(partner_idx)
                other_sel = self._assemble(
                    bufs2, self._seed ^ 0x9E3779B9, partner_idx
                )
                other = np.zeros_like(wave)
                other[sel] = other_sel
                native.wavmix(wave, other, lam, apply)
                y2 = np.zeros_like(target)
                y2[sel] = self._targets(rows2_sel)
                if self.merge_masks:
                    k = target.shape[1] // 2
                    m1 = (target[:, k:] > 0.5).astype(np.float32)
                    m2 = (y2[:, k:] > 0.5).astype(np.float32)
                    # zero unobserved labels BEFORE the blend (reference
                    # openmic/dataset.py:131-134; mirrors WavMixDataset)
                    mixed_labels = target[:, :k] * m1 * lam[:, None] + y2[
                        :, :k
                    ] * m2 * (1.0 - lam[:, None])
                    mixed = np.concatenate(
                        [mixed_labels, np.maximum(m1, m2)], axis=1
                    )
                else:
                    mixed = target * lam[:, None] + y2 * (1.0 - lam[:, None])
                target = np.where(apply[:, None] > 0, mixed, target)

        return {"wave": wave, "target": target, "name": names}


def maybe_native_builder(cfg, build_base) -> Optional[NativeBatchBuilder]:
    """A NativeBatchBuilder for the recipe's cfg-derived train chain, or
    None when the native plane is unavailable or the chain is ineligible
    (variable-length or resampled containers keep the numpy path). Callers
    with a custom dataset keep the numpy path: this builder is bound to the
    cfg-derived chain only. ``build_base(cfg, path, seed)`` makes the
    un-augmented base dataset of one container, the one the numpy chain
    starts from (the recipes pass
    ``experiments.common.build_base_train_dataset``).

    Every fallback is LOUD (one line at loader-build time): with
    ``data.native_loader=true`` the user believes the C++ plane is active,
    and training on the numpy path unannounced misrepresents throughput."""
    d = cfg.data
    if not getattr(d, "native_loader", False):
        return None
    if not native.available():
        print(
            "[data] native_loader=true but libhostplane.so is not built "
            "(make -C native) -> numpy loader path"
        )
        return None
    if getattr(d, "ir_augment", 0.0) and getattr(d, "ir_path", None):
        # decided before building: the builder rejects IR chains anyway, and
        # build_base would load and resample the whole .wav
        # bank just to throw it away
        print(
            "[data] native_loader=true but ir_augment is python-side only "
            "-> numpy loader path"
        )
        return None
    try:
        bases = [build_base(cfg, d.train_hdf5, d.seed)]
        if d.train_hdf5_extra:
            # the flagship balanced+unbalanced ConcatDataset chain
            bases.append(build_base(cfg, d.train_hdf5_extra, d.seed + 1))
        return NativeBatchBuilder(
            bases if len(bases) > 1 else bases[0],
            roll_shift_range=d.roll_shift_range if d.roll else 0,
            wavmix=d.wavmix,
            merge_masks=d.merge_mask_wavmix,
            seed=d.seed + 31,
            num_workers=d.num_workers,
        )
    except (TypeError, ValueError, RuntimeError) as e:
        print(f"[data] native_loader=true but chain ineligible ({e}) -> numpy loader path")
        return None
