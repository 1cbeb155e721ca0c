"""Dataset-metadata parsing for the offline prep tools (port of
passt_tpu/data/prepare/metadata.py).

Covers the reference's L0 prep pipeline metadata handling
(reference: audioset/prepare_scripts/create_h5pymp3_dataset.py:19-99 —
AudioSet segment CSVs + class-label indices -> multi-hot targets;
fsd50k/prepare_scripts/create_h5pymp3_dataset.py:40-88 — FSD50K dev/eval
CSVs with train/val split column; esc50 meta CSV with fold column,
esc50/dataset.py:138-152; openmic labels+masks packing,
openmic/prepare_scripts/download_preprocess.py:74-91).

These are pure CSV->(files, targets) functions; the audio transcode step
(wav->mp3 via ffmpeg in the reference) is out of scope here — pack raw
PCM with pack_waveform_hdf5 or pre-encoded bytes with pack_bytes_hdf5
(:mod:`passt_tpu_torch.data.prepare.pack_hdf5`).
"""

from __future__ import annotations

import csv
from typing import Dict, List, Optional, Tuple

import numpy as np


def load_class_labels_indices(path: str) -> Dict[str, int]:
    """AudioSet class_labels_indices.csv: mid (e.g. /m/09x0r) -> index."""
    out: Dict[str, int] = {}
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            out[row["mid"]] = int(row["index"])
    return out


def parse_audioset_segments_csv(
    path: str,
    mid_to_index: Dict[str, int],
    num_classes: int = 527,
    name_format: str = "{ytid}_{start_ms}_{end_ms}.wav",
) -> Tuple[List[str], np.ndarray]:
    """AudioSet segments CSV (comment header lines starting '#';
    rows: YTID, start_seconds, end_seconds, "mid1,mid2,...") ->
    (["YTID_start_end.wav", ...], multi-hot [N, num_classes]).

    ``name_format`` maps a CSV row to the on-disk filename; placeholders
    {ytid}, {start_ms}, {end_ms}. The reference downloader convention is
    ``Y{ytid}.mp3`` (create_h5pymp3_dataset.py:41)."""
    files: List[str] = []
    targets: List[np.ndarray] = []
    with open(path, newline="") as f:
        for row in csv.reader(f, skipinitialspace=True):
            if not row or row[0].startswith("#"):
                continue
            ytid, start, end = row[0], float(row[1]), float(row[2])
            mids = row[3].split(",") if len(row) > 3 else []
            y = np.zeros(num_classes, dtype=np.uint8)
            for mid in mids:
                mid = mid.strip().strip('"')
                if mid in mid_to_index:
                    y[mid_to_index[mid]] = 1
            files.append(
                name_format.format(
                    ytid=ytid, start_ms=int(start * 1000), end_ms=int(end * 1000)
                )
            )
            targets.append(y)
    return files, np.stack(targets) if targets else np.zeros((0, num_classes), np.uint8)


def parse_fsd50k_csv(
    path: str, vocabulary: Dict[str, int], split: Optional[str] = None
) -> Tuple[List[str], np.ndarray]:
    """FSD50K dev.csv/eval.csv (fname, labels, mids[, split]) ->
    (["<fname>.wav", ...], multi-hot). ``split`` filters the dev csv's
    train/val column (fsd50k/prepare_scripts/create_h5pymp3_dataset.py:40-88)."""
    files: List[str] = []
    targets: List[np.ndarray] = []
    n = len(vocabulary)
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            if split is not None and row.get("split") != split:
                continue
            y = np.zeros(n, dtype=np.uint8)
            for label in row["labels"].split(","):
                if label in vocabulary:
                    y[vocabulary[label]] = 1
            files.append(f"{row['fname']}.wav")
            targets.append(y)
    return files, np.stack(targets) if targets else np.zeros((0, n), np.uint8)


def load_fsd50k_vocabulary(path: str) -> Dict[str, int]:
    """vocabulary.csv: index,label,mid -> label -> index."""
    out: Dict[str, int] = {}
    with open(path, newline="") as f:
        for row in csv.reader(f):
            out[row[1]] = int(row[0])
    return out


def parse_esc50_meta(
    path: str, fold: int, train: bool
) -> Tuple[List[str], np.ndarray]:
    """ESC-50 meta/esc50.csv (filename, fold, target, ...) filtered by fold:
    train -> fold != k, test -> fold == k (esc50/dataset.py:145-152).
    Returns (filenames, integer labels)."""
    files: List[str] = []
    labels: List[int] = []
    with open(path, newline="") as f:
        for row in csv.DictReader(f):
            is_test = int(row["fold"]) == fold
            if train == (not is_test):
                files.append(row["filename"])
                labels.append(int(row["target"]))
    return files, np.asarray(labels, dtype=np.int64)


def openmic_targets(y_true: np.ndarray, y_mask: np.ndarray) -> np.ndarray:
    """OpenMIC: [N, 20] relevance + [N, 20] observed-mask -> [N, 40] float
    targets ``[labels || masks]`` (download_preprocess.py:74-91)."""
    return np.concatenate(
        [np.asarray(y_true, np.float32), np.asarray(y_mask, np.float32)], axis=1
    )
