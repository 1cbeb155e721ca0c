"""ESC-50 end-to-end preparation (port of scripts/prepare_esc50.py): the
downloaded ESC-50 archive -> per-fold train/test HDF5 containers the
``esc50`` recipe consumes.

The reference has NO offline prep for ESC-50 — its dataset reads each WAV
with ``librosa.load(path, sr=32000, mono=True)`` and filters a pandas
DataFrame by fold at iteration time (esc50/dataset.py:138-188). The port's
data plane is container-based (random-access HDF5 feeding the native batch
plane), so the same work happens once, offline: decode WAV -> resample
44.1 kHz -> 32 kHz (anti-aliased polyphase, librosa-equivalent) -> pack one
(train, test) container pair per cross-validation fold with integer
single-label targets (the format the esc50 recipe's ``single_label`` loss
expects).

Usage:
  python -m passt_tpu_torch.tools.prepare_esc50 /path/to/ESC-50-master [--out DIR]
      [--folds 1,2,...|all] [--format raw|mp3] [--workers N] [--limit N]

ESC-50-master is the archive from github.com/karolpiczak/ESC-50 (audio/
with 2000 WAVs + meta/esc50.csv). ``--format raw`` (default) stores int16
PCM — decode-free at train time and bit-faithful to the source; ``mp3``
re-encodes in-process (libmp3lame) for a ~5x smaller container, mirroring
the reference's AudioSet/FSD50K mp3 flow. Needs h5py; ``mp3`` also
libmp3lame.

Then e.g. (reference protocol: esc50/README.md, one run per fold):
  python -m passt_tpu_torch.cli esc50 main \\
      data.train_hdf5=$OUT/esc50_fold1_train.h5 \\
      data.eval_hdf5=$OUT/esc50_fold1_test.h5 model.pretrained=true
"""

import argparse
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from passt_tpu_torch.data.prepare import StreamingPacker
from passt_tpu_torch.data.prepare.metadata import parse_esc50_meta
from passt_tpu_torch.data.prepare.mp3enc import encode_mp3
from passt_tpu_torch.data.prepare.wavdec import decode_wav, resample

TARGET_RATE = 32000
N_FOLDS = 5


def _load_clip(audio_dir: str, filename: str):
    wave, rate = decode_wav(os.path.join(audio_dir, filename))
    return resample(wave, rate, TARGET_RATE)


def pack_fold(
    esc50_dir: str,
    out_dir: str,
    fold: int,
    fmt: str = "raw",
    workers: int = 8,
    limit=None,
) -> list:
    meta_csv = os.path.join(esc50_dir, "meta", "esc50.csv")
    audio_dir = os.path.join(esc50_dir, "audio")
    outs = []
    for split, train in (("train", True), ("test", False)):
        files, labels = parse_esc50_meta(meta_csv, fold=fold, train=train)
        if limit:
            files, labels = files[:limit], labels[:limit]
        out = os.path.join(out_dir, f"esc50_fold{fold}_{split}.h5")
        column = "raw_i16" if fmt == "raw" else "mp3"
        with ThreadPoolExecutor(max_workers=workers) as pool, StreamingPacker(
            out, column=column, sample_rate=TARGET_RATE, packed_targets=False
        ) as packer:
            waves = pool.map(lambda fn: _load_clip(audio_dir, fn), files)
            for fn, wave, label in zip(files, waves, labels):
                target = np.asarray(label, np.int64)
                if fmt == "raw":
                    packer.add_waveform(fn, wave, target)
                else:
                    packer.add_bytes(
                        fn, encode_mp3(wave, TARGET_RATE), target,
                        length_samples=len(wave),
                    )
        print(f"fold {fold} {split}: {len(files)} clips -> {out}")
        outs.append(out)
    return outs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("esc50_dir", help="path to the extracted ESC-50-master")
    ap.add_argument("--out", default="esc50_hdf5s")
    ap.add_argument("--folds", default="all", help="'all' or comma list, e.g. 1,2")
    ap.add_argument("--format", choices=("raw", "mp3"), default="raw")
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--limit", type=int, default=None, help="clips/split (smoke runs)")
    args = ap.parse_args(argv)

    folds = (
        range(1, N_FOLDS + 1)
        if args.folds == "all"
        else [int(k) for k in args.folds.split(",")]
    )
    os.makedirs(args.out, exist_ok=True)
    for fold in folds:
        pack_fold(
            args.esc50_dir, args.out, fold,
            fmt=args.format, workers=args.workers, limit=args.limit,
        )
    print(
        "done. Train per fold (esc50/README.md protocol):\n"
        f"  python -m passt_tpu_torch.cli esc50 main "
        f"data.train_hdf5={args.out}/esc50_fold1_train.h5 "
        f"data.eval_hdf5={args.out}/esc50_fold1_test.h5 model.pretrained=true"
    )


if __name__ == "__main__":
    main()
