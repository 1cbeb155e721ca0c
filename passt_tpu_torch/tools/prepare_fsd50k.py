"""FSD50K end-to-end preparation (port of scripts/prepare_fsd50k.py): the
Zenodo download -> train/valid/eval mp3 HDF5 containers the ``fsd50k``
recipe consumes.

Replaces BOTH reference prep scripts with one in-process pipeline
(fsd50k/prepare_scripts/convert_to_mp3.py — a 20-process ffmpeg
``-codec:a mp3 -ar 32000`` sweep — and create_h5pymp3_dataset.py:40-110 —
pandas CSV joins + h5py packing): decode WAV -> anti-aliased polyphase
resample 44.1 kHz -> 32 kHz -> libmp3lame encode (thread pool) ->
stream-pack, with multi-hot 200-class targets from vocabulary.csv and the
dev.csv train/val split column. Variable clip lengths are preserved
(FSD50K clips are 0.3-30 s; the recipe random-crops training clips to 10 s
and supports exact variable-length eval) and recorded in the
``length_samples`` column for length-grouped exact eval. Needs h5py and
libmp3lame.

Usage:
  python -m passt_tpu_torch.tools.prepare_fsd50k /path/to/FSD50K [--out DIR]
      [--splits train,valid,eval] [--workers N] [--limit N]

/path/to/FSD50K holds FSD50K.dev_audio/, FSD50K.eval_audio/ and
FSD50K.ground_truth/{dev.csv,eval.csv,vocabulary.csv} as downloaded.

Then (reference protocol, fsd50k/README.md):
  python -m passt_tpu_torch.cli fsd50k main \\
      data.train_hdf5=$OUT/fsd50k_train.h5 data.valid_hdf5=$OUT/fsd50k_valid.h5 \\
      data.eval_hdf5=$OUT/fsd50k_eval.h5 model.pretrained=true
"""

import argparse
import os
from concurrent.futures import ThreadPoolExecutor

from passt_tpu_torch.data.prepare import StreamingPacker
from passt_tpu_torch.data.prepare.metadata import load_fsd50k_vocabulary, parse_fsd50k_csv
from passt_tpu_torch.data.prepare.mp3enc import encode_mp3
from passt_tpu_torch.data.prepare.wavdec import decode_wav, resample

TARGET_RATE = 32000

# split name -> (csv file, csv split filter, audio subdir)
SPLITS = {
    "train": ("dev.csv", "train", "FSD50K.dev_audio"),
    "valid": ("dev.csv", "val", "FSD50K.dev_audio"),
    "eval": ("eval.csv", None, "FSD50K.eval_audio"),
}


def _encode_clip(audio_dir: str, filename: str):
    """WAV -> (mp3 bytes, decoded 32 kHz sample count)."""
    wave, rate = decode_wav(os.path.join(audio_dir, filename))
    wave = resample(wave, rate, TARGET_RATE)
    return encode_mp3(wave, TARGET_RATE), len(wave)


def pack_split(
    fsd50k_base: str,
    out_dir: str,
    split: str,
    workers: int = 8,
    limit=None,
) -> str:
    csv_name, csv_split, audio_sub = SPLITS[split]
    gt = os.path.join(fsd50k_base, "FSD50K.ground_truth")
    vocab = load_fsd50k_vocabulary(os.path.join(gt, "vocabulary.csv"))
    files, targets = parse_fsd50k_csv(
        os.path.join(gt, csv_name), vocab, split=csv_split
    )
    if limit:
        files, targets = files[:limit], targets[:limit]
    audio_dir = os.path.join(fsd50k_base, audio_sub)
    out = os.path.join(out_dir, f"fsd50k_{split}.h5")

    with ThreadPoolExecutor(max_workers=workers) as pool, StreamingPacker(
        out, column="mp3", sample_rate=TARGET_RATE, packed_targets=True
    ) as packer:
        encoded = pool.map(lambda fn: _encode_clip(audio_dir, fn), files)
        for i, (fn, (blob, n_samples)) in enumerate(zip(files, encoded)):
            packer.add_bytes(fn, blob, targets[i], length_samples=n_samples)
            if (i + 1) % 1000 == 0:
                print(f"  {split}: {i + 1}/{len(files)}")
    print(f"{split}: {len(files)} clips -> {out}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("fsd50k_base", help="FSD50K root as downloaded from Zenodo")
    ap.add_argument("--out", default="fsd50k_hdf5s")
    ap.add_argument("--splits", default="train,valid,eval")
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--limit", type=int, default=None, help="clips/split (smoke runs)")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    for split in args.splits.split(","):
        if split not in SPLITS:
            raise SystemExit(f"unknown split {split!r} (choose from {list(SPLITS)})")
        pack_split(args.fsd50k_base, args.out, split, args.workers, args.limit)
    print(
        "done. Train (fsd50k/README.md protocol):\n"
        f"  python -m passt_tpu_torch.cli fsd50k main "
        f"data.train_hdf5={args.out}/fsd50k_train.h5 "
        f"data.valid_hdf5={args.out}/fsd50k_valid.h5 "
        f"data.eval_hdf5={args.out}/fsd50k_eval.h5 model.pretrained=true"
    )


if __name__ == "__main__":
    main()
