"""Host-side audio datasets (port of passt_tpu/data/datasets.py): HDF5
containers, wav folders, waveform augmentation, wave mixup. Everything here
is numpy, copied from the JAX package so that the same seed and epoch give
bit-equal items; nothing imports torch, and h5py is imported only where an
HDF5 container is opened (the card's machine has none).

Reference semantics covered (file:line into the reference PaSST repo):
- ``AudioSetDataset``: lazy-opened HDF5 with columns ``audio_name``,
  compressed audio bytes (``mp3``) or raw ``waveform``, packed-bit ``target``;
  pad-or-truncate to clip_length*sr; stride-subsample resample for 16/8 kHz
  (audioset/dataset.py:143-216).
- FSD50K variant: *random-crop* instead of head-truncate, and
  ``clip_length=None`` variable length (fsd50k/dataset.py:70-79).
- OpenMIC variant: float targets ``[20 labels || 20 masks]`` without
  packbits (openmic/dataset.py:199-201).
- gain augment +/-7 dB (audioset/dataset.py:104-112), roll +/-50 samples
  (audioset/dataset.py:315-329), waveform mixup with Beta(2,2), rate 0.5 and
  mean-centering (audioset/dataset.py:115-140), mask-merging OpenMIC wavmix
  (openmic/dataset.py:117-137).

``mp3`` columns — the format of every published AudioSet/FSD50K/OpenMIC
container (reference decode_mp3 via PyAV, audioset/dataset.py:55-70) —
decode through the native C++ host plane backed by the system libmpg123
(native/hostplane.cpp; build with ``make -C native``). The decoder table
stays pluggable via ``register_decoder``. Raw-waveform and WAV-bytes
columns decode with no external dependency, and the offline prep tools
(passt_tpu/data/prepare) write raw containers that need no decoder at all.
"""

from __future__ import annotations

import io
import math
import threading
import warnings
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

Item = Tuple[np.ndarray, str, np.ndarray]  # (waveform [T], name, target)


def item_rng(seed: int, index: int) -> np.random.Generator:
    """Per-(seed, index) RNG: augmentation randomness is a pure function of
    the epoch seed and the item index, so parallel loader workers are both
    thread-safe and bit-reproducible regardless of read order (the
    reference gets approximate decorrelation from per-worker reseeding,
    helpers/workersinit.py:6-12; this is strictly stronger)."""
    return np.random.default_rng((seed, index))


def epoch_seed(base_seed: int, epoch: int) -> int:
    """Fold an epoch into a base seed (distinct augmentation every epoch,
    reproducible on resume)."""
    return base_seed + 1_000_003 * (epoch + 1)


def chain_epoch_dependent(ds) -> bool:
    """True when any dataset in the chain applies epoch-reseeded
    randomness (``epoch_dependent`` attribute): drives CachedDataset's
    cache keying — deterministic chains keep one cross-epoch cache."""
    if getattr(ds, "epoch_dependent", False):
        return True
    child = getattr(ds, "dataset", None)
    if child is not None and chain_epoch_dependent(child):
        return True
    return any(chain_epoch_dependent(c) for c in getattr(ds, "datasets", ()) or ())


def set_epoch_recursive(ds, epoch: int) -> None:
    """Walk a dataset chain calling ``set_epoch`` wherever defined (the
    reference reloads its DataLoaders every epoch for the same effect,
    ex_audioset.py:75)."""
    if hasattr(ds, "set_epoch"):
        ds.set_epoch(epoch)
    child = getattr(ds, "dataset", None)
    if child is not None:
        set_epoch_recursive(child, epoch)
    for c in getattr(ds, "datasets", ()) or ():
        set_epoch_recursive(c, epoch)


# ---------------------------------------------------------------------------
# waveform utilities
# ---------------------------------------------------------------------------
def pad_or_truncate(x: np.ndarray, audio_length: int) -> np.ndarray:
    """Zero-pad or head-truncate to ``audio_length`` (audioset/dataset.py:73-78)."""
    if len(x) <= audio_length:
        return np.concatenate([x, np.zeros(audio_length - len(x), dtype=np.float32)])
    return x[:audio_length]


def random_crop(x: np.ndarray, audio_length: int, rng: np.random.Generator) -> np.ndarray:
    """Zero-pad or random-crop (the FSD50K training behavior,
    fsd50k/dataset.py:70-79)."""
    if len(x) <= audio_length:
        return np.concatenate([x, np.zeros(audio_length - len(x), dtype=np.float32)])
    offset = int(rng.integers(0, len(x) - audio_length + 1))
    return x[offset : offset + audio_length]


def stride_resample(x: np.ndarray, sample_rate: int, source_rate: int = 32000) -> np.ndarray:
    """The reference's stride-subsample 'resampling' (audioset/dataset.py:202-216)."""
    if sample_rate == source_rate:
        return x
    if source_rate % sample_rate:
        raise ValueError(f"incorrect sample rate {sample_rate}")
    return x[:: source_rate // sample_rate]


def gain_augment(x: np.ndarray, gain_db: int, rng: np.random.Generator) -> np.ndarray:
    """Random gain in [-gain_db, gain_db) dB (audioset/dataset.py:108-111)."""
    gain = int(rng.integers(0, gain_db * 2)) - gain_db
    return x * np.float32(10.0 ** (gain / 20.0))


def roll_augment(x: np.ndarray, shift_range: int, rng: np.random.Generator) -> np.ndarray:
    """Circular roll by a random +/-shift_range samples
    (audioset/dataset.py:315-329)."""
    sf = int(rng.integers(-shift_range, shift_range + 1))
    return np.roll(x, sf, axis=-1)


def ir_augment(
    x: np.ndarray,
    impulse_responses,
    rate: float,
    rng: np.random.Generator,
) -> np.ndarray:
    """Impulse-response convolution augment (reference ``pydub_augment``'s
    ir branch, audioset/dataset.py:104-107 + IR bank loading 84-100; off by
    default in every recipe, ``ir_augment=0``). ``impulse_responses`` is a
    sequence of float waveforms (the reference loads a .wav bank)."""
    if not impulse_responses or rng.random() >= rate:
        return x
    ir = impulse_responses[int(rng.integers(0, len(impulse_responses)))]
    return np.convolve(x, ir, mode="full").astype(np.float32)


def load_ir_bank(
    ir_dir: str,
    sample_rate: int = 32000,
    cut_irs_offset: Optional[int] = None,
) -> List[np.ndarray]:
    """Load an impulse-response .wav bank: every *.wav under ``ir_dir``
    (recursive, sorted — the reference's ``rglob`` + ``sorted`` order),
    resampled to ``sample_rate``. ``sample_rate`` must be the CONTAINER
    SOURCE rate, not the pipeline target rate: ``ir_augment`` convolves
    before ``stride_resample`` (mirroring the reference, whose
    ``librosa.load(sr=32000)`` equals its containers' rate,
    audioset/dataset.py:100,202-216). ``cut_irs_offset`` keeps the
    reference's 10-IR window starting at that offset
    (audioset/dataset.py:84-100)."""
    import os
    import pathlib

    paths = sorted(pathlib.Path(os.path.expanduser(ir_dir)).rglob("*.wav"))
    if cut_irs_offset is not None:
        paths = paths[cut_irs_offset : cut_irs_offset + 10]
    if not paths:
        raise FileNotFoundError(f"no .wav impulse responses under {ir_dir}")
    bank = []
    for p in paths:
        buf = np.frombuffer(p.read_bytes(), dtype=np.uint8)
        bank.append(_decode_wav(buf, target_rate=sample_rate))
    return bank


def resample(wave_f32: np.ndarray, src_rate: int, dst_rate: int) -> np.ndarray:
    """Anti-aliased polyphase resample (44.1 kHz -> 32 kHz: up=320/down=441;
    a copy of passt_tpu/data/prepare/wavdec.py ``resample``).

    Uses scipy's ``resample_poly`` (windowed-sinc); integer-stride decimation
    when src is an exact multiple (the container contract stride_resample
    assumes); falls back to linear interpolation with a warning when scipy is
    absent.
    """
    if src_rate == dst_rate:
        return np.asarray(wave_f32, np.float32)
    if src_rate % dst_rate == 0:
        return np.asarray(wave_f32[:: src_rate // dst_rate], np.float32)
    try:
        from scipy.signal import resample_poly
    except ImportError:  # pragma: no cover - scipy is on both machines
        warnings.warn(
            "scipy unavailable: falling back to linear-interp resample "
            "(no anti-aliasing filter)"
        )
        n_out = int(round(len(wave_f32) * dst_rate / src_rate))
        t = np.arange(n_out) * (src_rate / dst_rate)
        return np.interp(t, np.arange(len(wave_f32)), wave_f32).astype(np.float32)
    g = math.gcd(src_rate, dst_rate)
    return resample_poly(wave_f32, dst_rate // g, src_rate // g).astype(np.float32)


# ---------------------------------------------------------------------------
# decoders
# ---------------------------------------------------------------------------
def _decode_raw_f32(buf: np.ndarray) -> np.ndarray:
    return np.frombuffer(buf.tobytes(), dtype=np.float32).copy()


def _decode_raw_i16(buf: np.ndarray) -> np.ndarray:
    return np.frombuffer(buf.tobytes(), dtype=np.int16).astype(np.float32) / 32768.0


def _decode_wav(buf: np.ndarray, target_rate: Optional[int] = None) -> np.ndarray:
    """Minimal RIFF/WAVE PCM decoder (mono or averaged-to-mono).

    ``target_rate`` resamples when the file's rate differs (the reference
    loads wavs through ``librosa.load(sr=32000)`` which resamples too,
    esc50/dataset.py); integer-factor downsampling strides (the reference's
    own 32k->16k/8k technique, audioset/dataset.py:202-216), anything else
    linearly interpolates. Without ``target_rate`` the file's samples are
    returned as-is (rate ignored — only correct for known-rate containers)."""
    import wave

    with wave.open(io.BytesIO(buf.tobytes())) as w:
        n = w.getnframes()
        width = w.getsampwidth()
        ch = w.getnchannels()
        rate = w.getframerate()
        raw = w.readframes(n)
    if width == 2:
        x = np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, dtype=np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width {width}")
    if ch > 1:
        x = x.reshape(-1, ch).mean(axis=1)
    if target_rate is not None and rate != target_rate and len(x):
        if rate % target_rate == 0:
            x = stride_resample(x, target_rate, source_rate=rate)
        else:
            # anti-aliased polyphase resample (prepare/wavdec.resample —
            # THE one resampler): plain np.interp here aliased all energy
            # above the new Nyquist back into band for 44.1k->32k inputs
            # (the reference's librosa.load(sr=) is a windowed-sinc
            # resample too)
            x = resample(x, rate, target_rate)
    return x


#: Public alias: the WAV decoder is consumed outside the dataset layer
#: (scripts/serve.py feeds exported artifacts from raw files).
decode_wav = _decode_wav


def _decode_wav_column(buf: np.ndarray, expected_rate: Optional[int] = None) -> np.ndarray:
    """The registered 'wav' column decoder: resamples each file to the
    container's source rate when they differ (the reference loads wavs via
    ``librosa.load(sr=32000)``, i.e. resample-on-load, esc50/dataset.py) —
    without this a 44.1 kHz payload in a 32 kHz container would reach the
    model silently time/pitch-warped (the mp3 column decoder validates the
    same condition)."""
    return _decode_wav(buf, target_rate=expected_rate)


_decode_wav_column.expects_source_rate = True  # type: ignore[attr-defined]


def _decode_mp3(buf: np.ndarray, expected_rate: Optional[int] = None) -> np.ndarray:
    """mp3 bytes -> float32 mono waveform at the file's native rate, via the
    native host plane + system libmpg123 (the reference's PyAV decode_mp3,
    audioset/dataset.py:55-70, decoded the same float32-at-native-rate way;
    verified against an independent decoder in tests/test_mp3.py).

    ``expected_rate`` (the container's ``sample_rate`` attr, which downstream
    ``stride_resample`` assumes) is validated against the decoded native
    rate: a mismatched mp3 (e.g. 44.1 kHz in a 32 kHz container) would
    otherwise be silently time/pitch-warped — the native batch plane raises
    on the same condition (native_loader.py), and the two paths must agree."""
    from passt_tpu_torch.data import native

    wav, rate = native.decode_mp3(buf)
    if expected_rate is not None and rate != expected_rate:
        raise ValueError(
            f"mp3 native rate {rate} != container sample_rate attr "
            f"{expected_rate}; repack the container or fix its attr"
        )
    return wav


#: Decoders with this attribute receive ``expected_rate=<container attr>``
#: so they can reject rate-mismatched payloads instead of warping them.
_decode_mp3.expects_source_rate = True  # type: ignore[attr-defined]


DECODERS: Dict[str, Callable[[np.ndarray], np.ndarray]] = {
    "waveform": _decode_raw_f32,
    "raw_f32": _decode_raw_f32,
    "raw_i16": _decode_raw_i16,
    "wav": _decode_wav_column,
    "mp3": _decode_mp3,
}


def register_decoder(column: str, fn: Callable[[np.ndarray], np.ndarray]) -> None:
    """Register a decoder for an audio column (e.g. an mp3 decoder backed by
    the native C++ plane or an external tool)."""
    DECODERS[column] = fn


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------
class AudioDataset:
    """Minimal dataset protocol: len() + [i] -> (waveform, name, target)."""

    def __len__(self) -> int:
        raise NotImplementedError

    def __getitem__(self, index: int) -> Item:
        raise NotImplementedError


class HDF5AudioDataset(AudioDataset):
    """The HDF5-container dataset (reference AudioSetDataset,
    audioset/dataset.py:143-216, plus the FSD50K/OpenMIC deltas).

    Parameters mirror the reference: ``clip_length`` seconds (None =
    variable length, FSD50K eval), ``classes_num`` for unpackbits,
    ``gain_augment_db`` (reference ``pydub_augment`` gain),
    ``crop`` in {"head", "random"}; ``packed_targets=False`` reads float
    targets directly (OpenMIC layout).
    """

    def __init__(
        self,
        hdf5_file: str,
        sample_rate: int = 32000,
        classes_num: int = 527,
        clip_length: Optional[float] = 10,
        audio_column: Optional[str] = None,
        packed_targets: bool = True,
        gain_augment_db: int = 0,
        crop: str = "head",
        in_mem: bool = False,
        seed: int = 0,
        impulse_responses: Optional[Sequence[np.ndarray]] = None,
        ir_augment_rate: float = 0.0,
    ):
        import h5py

        self.hdf5_path = hdf5_file
        self._h5py = h5py
        if in_mem:
            with open(hdf5_file, "rb") as f:
                self.hdf5_path = io.BytesIO(f.read())
        with h5py.File(self.hdf5_path, "r") as f:
            self.length = len(f["audio_name"])
            if audio_column is None:
                for cand in ("waveform", "raw_f32", "raw_i16", "wav", "mp3"):
                    if cand in f:
                        audio_column = cand
                        break
                else:
                    raise ValueError(f"no known audio column in {hdf5_file}")
            # container's stored rate (our packers write it; the reference
            # assumes 32 kHz containers, audioset/dataset.py:202-216)
            self.source_rate = int(f.attrs.get("sample_rate", 32000))
        self.audio_column = audio_column
        self._local = threading.local()  # one handle per thread AND process:
        # h5py serializes concurrent access on a single handle, so parallel
        # loader workers each get their own read-only File (fork-safe too)
        self.sample_rate = sample_rate
        self.classes_num = classes_num
        self.clip_samples = None if clip_length is None else int(clip_length * sample_rate)
        self.packed_targets = packed_targets
        self.gain_augment_db = gain_augment_db
        self.crop = crop
        self.impulse_responses = list(impulse_responses or [])
        self.ir_augment_rate = float(ir_augment_rate)
        self._base_seed = seed
        self._seed = seed

    def reseed(self, seed: int) -> None:
        """Explicit reseed (reference worker_init_fn,
        helpers/workersinit.py:6-12); item i's augmentation is a pure
        function of (seed, i)."""
        self._seed = seed

    def item_lengths(self) -> np.ndarray:
        """Per-item waveform lengths AFTER the pipeline's stride resample —
        drives length-grouped exact eval (LengthGroupedBatchSampler).

        Prefers the packers' ``length_samples`` column; raw-PCM columns
        fall back to one pass over the vlen rows (a one-time full read);
        encoded columns without the metadata raise (decoding everything
        just to learn lengths belongs to the caller's prep step)."""
        f = self._open()
        if "length_samples" in f:
            src = np.asarray(f["length_samples"][:], np.int64)
        elif self.audio_column == "raw_i16":
            src = np.asarray([len(r) // 2 for r in f[self.audio_column][:]], np.int64)
        elif self.audio_column in ("raw_f32", "waveform"):
            src = np.asarray([len(r) // 4 for r in f[self.audio_column][:]], np.int64)
        else:
            raise ValueError(
                f"container has no length_samples column and {self.audio_column!r} "
                "rows cannot be sized without decoding; repack with lengths"
            )
        factor = self.source_rate // self.sample_rate if self.sample_rate != self.source_rate else 1
        return -(-src // factor) if factor > 1 else src

    def set_epoch(self, epoch: int) -> None:
        self._seed = epoch_seed(self._base_seed, epoch)

    @property
    def epoch_dependent(self) -> bool:
        """True when items vary with the epoch seed (gain augmentation,
        random cropping, or IR convolution)."""
        return (
            self.gain_augment_db > 0
            or self.crop == "random"
            or (self.ir_augment_rate > 0 and bool(self.impulse_responses))
        )

    def __len__(self) -> int:
        return self.length

    def _open(self):
        f = getattr(self._local, "file", None)
        if f is None:
            f = self._h5py.File(self.hdf5_path, "r")
            self._local.file = f
        return f

    def raw_item(self, index: int):
        """(raw audio buffer, name, raw target row) without decode or
        augmentation — the feed for the native C++ batch assembler."""
        f = self._open()
        name = f["audio_name"][index]
        name = name.decode() if isinstance(name, bytes) else str(name)
        return f[self.audio_column][index], name, f["target"][index]

    def raw_batch(self, idxs):
        """(buffers, names, target rows) for a batch in ONE fancy-indexed
        HDF5 read per column — per-item h5py dataset.__getitem__ overhead
        (~0.3 ms/call) dominates raw-PCM loading otherwise. h5py fancy
        selection requires increasing unique indices; duplicates/order are
        restored by the inverse permutation."""
        f = self._open()
        idxs = np.asarray(idxs, dtype=np.int64)
        uniq, inverse = np.unique(idxs, return_inverse=True)
        sel = uniq.tolist()
        bufs = f[self.audio_column][sel]
        names = f["audio_name"][sel]
        targets = f["target"][sel]
        out_names = []
        for i in inverse:
            n = names[i]
            out_names.append(n.decode() if isinstance(n, bytes) else str(n))
        return [bufs[i] for i in inverse], out_names, targets[inverse]

    def __getitem__(self, index: int) -> Item:
        f = self._open()
        name = f["audio_name"][index]
        name = name.decode() if isinstance(name, bytes) else str(name)
        decoder = DECODERS.get(self.audio_column)
        if decoder is None:
            raise RuntimeError(
                f"no decoder registered for column {self.audio_column!r}; "
                "use passt_tpu_torch.data.register_decoder"
            )
        raw = f[self.audio_column][index]
        if getattr(decoder, "expects_source_rate", False):
            waveform = decoder(raw, expected_rate=self.source_rate).astype(np.float32)
        else:
            waveform = decoder(raw).astype(np.float32)
        rng = item_rng(self._seed, index)
        if self.ir_augment_rate and self.impulse_responses:
            # reference order: IR convolution BEFORE gain (pydub_augment,
            # audioset/dataset.py:104-112)
            waveform = ir_augment(
                waveform, self.impulse_responses, self.ir_augment_rate, rng
            )
        if self.gain_augment_db:
            waveform = gain_augment(waveform, self.gain_augment_db, rng)
        if self.clip_samples is not None:
            if self.crop == "random":
                waveform = random_crop(waveform, self.clip_samples, rng)
            else:
                waveform = pad_or_truncate(waveform, self.clip_samples)
        waveform = stride_resample(waveform, self.sample_rate, self.source_rate)
        target = f["target"][index]
        if self.packed_targets:
            target = np.unpackbits(target, axis=-1, count=self.classes_num)
        target = np.asarray(target, dtype=np.float32)
        return waveform, name, target


class FolderDataset(AudioDataset):
    """A directory of .wav files (decode-free inference input; the
    reference ecosystem's hear21passt consumes raw files the same way).
    Targets are zeros unless a ``labels`` dict (filename -> multi-hot or
    int) is given."""

    def __init__(
        self,
        root: str,
        num_classes: int = 527,
        sample_rate: int = 32000,
        clip_length: Optional[float] = None,
        labels: Optional[dict] = None,
    ):
        import glob
        import os

        self.files = sorted(glob.glob(os.path.join(root, "**", "*.wav"), recursive=True))
        if not self.files:
            raise FileNotFoundError(f"no .wav files under {root}")
        self.num_classes = num_classes
        self.sample_rate = sample_rate
        self.clip_samples = None if clip_length is None else int(clip_length * sample_rate)
        self.labels = labels or {}

    def __len__(self):
        return len(self.files)

    def __getitem__(self, index: int) -> Item:
        import os

        path = self.files[index]
        with open(path, "rb") as f:
            # resample to the dataset rate: files at 44.1/48/16 kHz would
            # otherwise silently reach the model time/pitch-warped
            wave = _decode_wav(
                np.frombuffer(f.read(), dtype=np.uint8), target_rate=self.sample_rate
            )
        if self.clip_samples is not None:
            wave = pad_or_truncate(wave, self.clip_samples)
        name = os.path.basename(path)
        label = self.labels.get(name)
        if label is None:
            target = np.zeros(self.num_classes, dtype=np.float32)
        else:
            target = np.asarray(label, dtype=np.float32)
        return wave.astype(np.float32), name, target


class ConcatDataset(AudioDataset):
    """Concatenation (reference uses torch ConcatDataset for
    balanced+unbalanced AudioSet, audioset/dataset.py:239-243)."""

    def __init__(self, datasets: Sequence[AudioDataset]):
        self.datasets = list(datasets)
        self.offsets = np.cumsum([0] + [len(d) for d in self.datasets])

    def __len__(self):
        return int(self.offsets[-1])

    def __getitem__(self, index):
        i = int(np.searchsorted(self.offsets, index, side="right") - 1)
        return self.datasets[i][index - int(self.offsets[i])]


class MapDataset(AudioDataset):
    """Apply fn(item) -> item (reference PreprocessDataset,
    helpers/audiodatasets.py). ``with_index=True`` calls fn(item, index)
    so stateless per-item randomness can derive from the index."""

    def __init__(
        self,
        dataset: AudioDataset,
        fn: Callable,
        with_index: bool = False,
    ):
        self.dataset = dataset
        self.fn = fn
        self.with_index = with_index

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, index):
        if self.with_index:
            return self.fn(self.dataset[index], index)
        return self.fn(self.dataset[index])


class RollDataset(AudioDataset):
    epoch_dependent = True
    """Random circular roll wrapper (reference get_roll_func applied via
    PreprocessDataset, audioset/dataset.py:315-329, 355-359); per-item
    deterministic in (seed, epoch, index)."""

    def __init__(self, dataset: AudioDataset, shift_range: int = 50, seed: int = 0):
        self.dataset = dataset
        self.shift_range = shift_range
        self._base_seed = seed
        self._seed = seed

    def reseed(self, seed: int) -> None:
        self._seed = seed

    def set_epoch(self, epoch: int) -> None:
        self._seed = epoch_seed(self._base_seed, epoch)

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, index):
        x, f, y = self.dataset[index]
        return roll_augment(x, self.shift_range, item_rng(self._seed, index)), f, y


class CachedDataset(AudioDataset):
    """Disk-cache every item as an .npz on first access (the reference's
    FilesCachedDataset / ObjectCacher torch.save caches,
    helpers/audiodatasets.py:51-173). Useful when the underlying decode or
    augmentation chain is expensive.

    The cache key includes the current epoch seed ONLY when the wrapped
    chain actually applies epoch-reseeded randomness
    (:func:`chain_epoch_dependent`): an augmented chain (gain/roll/wavmix)
    would otherwise be frozen to whatever epoch first populated the cache,
    silently training every epoch on identical augmentations — while a
    deterministic chain (the class's primary use case) keeps the constant
    ``sinit`` key and hits one cross-epoch cache with no disk growth.
    Augmented chains pay per-epoch disk; cache *below* the augmentation
    wrappers to avoid it."""

    def __init__(self, dataset: AudioDataset, cache_dir: str):
        import os

        self.dataset = dataset
        self.cache_dir = cache_dir
        # Sentinel until set_epoch is first called: an epoch-dependent
        # chain's augmentation state before set_epoch (constructor seed)
        # differs from after set_epoch(0) (epoch_seed(base, 0)), so the two
        # must not share a cache key.
        self._seed: object = "init"
        os.makedirs(cache_dir, exist_ok=True)

    def set_epoch(self, epoch: int) -> None:
        # children are reseeded by set_epoch_recursive; mirror the seed
        # derivation used by the chain so the key matches their state
        if chain_epoch_dependent(self.dataset):
            self._seed = epoch

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, index):
        import os

        path = os.path.join(self.cache_dir, f"s{self._seed}_{index}.npz")
        if os.path.exists(path):
            data = np.load(path, allow_pickle=False)
            return data["wave"], str(data["name"]), data["target"]
        wave, name, target = self.dataset[index]
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, wave=wave, name=name, target=target)
        os.replace(tmp, path)
        return wave, name, target


_WAVMIX_SALT = 0x5BF03635  # wavmix draw-stream id (distinct from item augs)


def wavmix_plan(seed: int, index: int, total: int, rate: float, beta: float):
    """(apply, partner index, lambda) for one item — THE wavmix draw
    sequence, a pure function of (seed, index). Both consumers
    (WavMixDataset.mix_plan and NativeBatchBuilder) call this single
    definition; the native/numpy bitwise-identical-plan contract depends
    on there being exactly one."""
    rng = item_rng(seed ^ _WAVMIX_SALT, index)
    if rng.random() >= rate:
        return False, index, np.float32(1.0)
    idx2 = int(rng.integers(0, total))
    lam = rng.beta(beta, beta)
    return True, idx2, np.float32(max(lam, 1.0 - lam))


class WavMixDataset(AudioDataset):
    epoch_dependent = True
    """Waveform mixup ("wavmix", reference MixupDataset,
    audioset/dataset.py:115-140): with probability ``rate``, mean-center and
    blend with a random second clip using ``lambda = max(B(beta,beta),
    1-B)``; targets blended. ``merge_masks``: OpenMIC layout, the mask halves
    are OR-merged (openmic/dataset.py:117-137)."""

    def __init__(
        self,
        dataset: AudioDataset,
        beta: float = 2.0,
        rate: float = 0.5,
        merge_masks: bool = False,
        seed: int = 0,
    ):
        self.dataset = dataset
        self.beta = beta
        self.rate = rate
        self.merge_masks = merge_masks
        self._base_seed = seed
        self._seed = seed

    def reseed(self, seed: int) -> None:
        self._seed = seed

    def set_epoch(self, epoch: int) -> None:
        self._seed = epoch_seed(self._base_seed, epoch)

    def __len__(self):
        return len(self.dataset)

    def mix_plan(self, index: int):
        """(apply, partner index, lambda) for item ``index`` — a pure
        function of (seed, index) so parallel workers and the native batch
        path draw the identical mix (see item_rng)."""
        return wavmix_plan(
            self._seed, index, len(self.dataset), self.rate, self.beta
        )

    def __getitem__(self, index):
        apply_mix, idx2, lam = self.mix_plan(index)
        if apply_mix:
            x1, f1, y1 = self.dataset[index]
            x2, _, y2 = self.dataset[idx2]
            x1 = x1 - x1.mean()
            x2 = x2 - x2.mean()
            n = min(len(x1), len(x2))
            x = x1[:n] * lam + x2[:n] * (1.0 - lam)
            x = x - x.mean()
            if self.merge_masks:
                k = len(y1) // 2
                m1 = (y1[k:] > 0.5).astype(np.float32)
                m2 = (y2[k:] > 0.5).astype(np.float32)
                # unobserved labels are ZEROED before the blend (reference
                # openmic/dataset.py:131-134) — otherwise a partner's
                # unobserved stored value leaks into a target the OR-merged
                # mask marks observed
                y = np.concatenate(
                    [
                        y1[:k] * m1 * lam + y2[:k] * m2 * (1.0 - lam),
                        np.maximum(m1, m2),
                    ]
                )
            else:
                y = y1 * lam + y2 * (1.0 - lam)
            return x.astype(np.float32), f1, y
        return self.dataset[index]
