"""Offline dataset packing: audio + targets -> one HDF5 per split (port of
passt_tpu/data/prepare/pack_hdf5.py).

The reference packs mp3 bytes + packbits targets into HDF5
(reference: audioset/prepare_scripts/create_h5pymp3_dataset.py:103-183;
fsd50k/prepare_scripts/create_h5pymp3_dataset.py:40-88; openmic
download_preprocess.py:74-91 stores float [labels || masks] targets).

ffmpeg is not assumed, so the first-class container here stores
either compressed bytes as-is (``pack_bytes_hdf5`` — same layout as the
reference, any column name: 'mp3', 'wav', ...) or int16 raw waveforms
(``pack_waveform_hdf5`` — 2 bytes/sample; a 10 s 32 kHz clip is 625 KiB,
~5x an mp3 but decode-free and random-access).
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import numpy as np


def _pack_targets(targets: np.ndarray, packed: bool):
    if packed:
        return np.packbits(targets.astype(np.uint8), axis=-1)
    return targets.astype(np.float32)


def _names_array(names) -> np.ndarray:
    """Fixed-width S column sized to the longest name: a fixed 'S64' would
    silently TRUNCATE longer names (numpy drops the overflow bytes), making
    predictions unattributable downstream."""
    width = max(64, max((len(n) for n in names), default=1))
    return np.asarray(names, dtype=f"S{width}")


def pack_waveform_hdf5(
    out_path: str,
    items: Iterable[Tuple[str, np.ndarray, np.ndarray]],
    sample_rate: int = 32000,
    packed_targets: bool = True,
) -> int:
    """items: iterable of (name, waveform float32 [-1,1], target multi-hot).
    Writes columns audio_name / raw_i16 (vlen) / target / length_samples.
    A thin loop over :class:`StreamingPacker` — ONE writer of the
    container schema (independent writers of the same layout drift, as
    they once did on length_samples)."""
    with StreamingPacker(
        out_path, column="raw_i16", sample_rate=sample_rate,
        packed_targets=packed_targets,
    ) as p:
        for name, wave, target in items:
            p.add_waveform(name, wave, target)
        n = len(p._names)
    return n


class StreamingPacker:
    """Incremental HDF5 packer for containers too large to buffer in RAM
    (FSD50K dev: ~41k variable-length clips, reference
    fsd50k/prepare_scripts/create_h5pymp3_dataset.py packs ~8 GB of mp3).

    Streams the heavy vlen audio column row by row into a resizable
    dataset; the small per-clip metadata (names, targets, lengths — a few
    MB even at AudioSet scale) is buffered and written at close so the
    fixed-width name column can be sized to the longest name. Produces the
    exact layout of :func:`pack_bytes_hdf5` / :func:`pack_waveform_hdf5`.

    >>> with StreamingPacker(path, column="mp3") as p:
    ...     p.add_bytes(name, mp3_bytes, target, length_samples=n)
    """

    def __init__(
        self,
        out_path: str,
        column: str = "mp3",
        sample_rate: int = 32000,
        packed_targets: bool = True,
    ):
        import h5py

        self._column = column
        self._sample_rate = sample_rate
        self._packed = packed_targets
        self._names: list = []
        self._targets: list = []
        self._lengths: list = []
        self._f = h5py.File(out_path, "w")
        self._audio = self._f.create_dataset(
            column,
            shape=(0,),
            maxshape=(None,),
            dtype=h5py.vlen_dtype(np.uint8),
            chunks=(256,),
        )

    def add_bytes(self, name, blob: bytes, target, length_samples: Optional[int] = None):
        """Append one clip of pre-encoded bytes (mp3/ogg/...)."""
        i = len(self._names)
        self._audio.resize((i + 1,))
        self._audio[i] = np.frombuffer(blob, dtype=np.uint8)
        self._names.append(name.encode() if isinstance(name, str) else name)
        self._targets.append(target)
        self._lengths.append(length_samples)

    def add_waveform(self, name, wave: np.ndarray, target):
        """Append one clip as int16 raw PCM (column must be 'raw_i16')."""
        if self._column != "raw_i16":
            raise ValueError("add_waveform requires column='raw_i16'")
        w = np.clip(np.asarray(wave, dtype=np.float32), -1.0, 1.0)
        q = (w * 32767.0).astype(np.int16)
        self.add_bytes(name, q.view(np.uint8).tobytes(), target, length_samples=len(q))

    def close(self) -> int:
        """Write the buffered metadata columns and close. Returns count."""
        try:
            self._f.create_dataset("audio_name", data=_names_array(self._names))
            targets = (
                np.stack(self._targets)
                if self._targets
                else np.zeros((0, 1), np.uint8)
            )
            self._f.create_dataset("target", data=_pack_targets(targets, self._packed))
            if all(n is not None for n in self._lengths) and self._lengths:
                self._f.create_dataset(
                    "length_samples", data=np.asarray(self._lengths, np.int64)
                )
            self._f.attrs["sample_rate"] = self._sample_rate
        finally:
            self._f.close()
        return len(self._names)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
        else:  # don't mask the in-flight error with a metadata write
            self._f.close()
        return False


def pack_bytes_hdf5(
    out_path: str,
    items: Iterable[Tuple[str, bytes, np.ndarray]],
    column: str = "mp3",
    sample_rate: int = 32000,
    packed_targets: bool = True,
    lengths: "Optional[Iterable[int]]" = None,
) -> int:
    """items: (name, encoded_bytes, target). Same container layout as the
    reference's mp3 HDF5s (audio_name S-col, vlen uint8 bytes, targets).
    ``lengths`` (decoded sample counts, known to the encoder) additionally
    writes the ``length_samples`` column that enables length-grouped exact
    eval on encoded containers. A thin loop over :class:`StreamingPacker`
    (one schema writer)."""
    items = list(items)
    if lengths is not None:
        lengths = list(lengths)
        if len(lengths) != len(items):
            raise ValueError("lengths must match items")
    with StreamingPacker(
        out_path, column=column, sample_rate=sample_rate,
        packed_targets=packed_targets,
    ) as p:
        for i, (name, blob, target) in enumerate(items):
            p.add_bytes(
                name, blob, target,
                length_samples=None if lengths is None else lengths[i],
            )
    return len(items)
