"""AudioSet packing (port of scripts/prepare_audioset.py): a directory of
32 kHz mp3s + the official segment CSVs -> balanced_train /
unbalanced_train / eval HDF5 containers.

The reference's audioset/prepare_scripts/create_h5pymp3_dataset.py rebuilt
as a tool over the port's prep plane: parse class_labels_indices.csv +
segment CSVs into multi-hot 527-class targets (metadata.py), check which
clips exist on disk (AudioSet downloads are always incomplete — YouTube
videos disappear; the reference prints found/notfound the same way,
create_h5pymp3_dataset.py:75-93), and stream-pack the mp3 bytes as-is with
packbits targets. The wav->mp3 step, when starting from raw downloads, is
``python -m passt_tpu_torch.tools.transcode_to_mp3`` (the reference's
convert_to_mp3.py). Needs h5py.

Usage:
  python -m passt_tpu_torch.tools.prepare_audioset MP3_ROOT METADATA_DIR [--out DIR]
      [--splits balanced_train_segments,eval_segments[,unbalanced_train_segments]]
      [--name-format "Y{ytid}.mp3"] [--limit N]

MP3_ROOT holds one subdirectory per split (reference layout) or a flat
pool of files; METADATA_DIR holds class_labels_indices.csv and the
segment CSVs from research.google.com/audioset. ``--name-format``
supports {ytid}/{start_ms}/{end_ms}; the default matches the reference
downloader's ``Y<YTID>.mp3``.

Then (reference protocol, ex_audioset.py / audioset/README.md):
  python -m passt_tpu_torch.cli audioset main \\
      data.train_hdf5=$OUT/balanced_train_segments_mp3.hdf \\
      data.train_hdf5_extra=$OUT/unbalanced_train_segments_mp3.hdf \\
      data.eval_hdf5=$OUT/eval_segments_mp3.hdf
"""

import argparse
import os

import numpy as np

from passt_tpu_torch.data.prepare import StreamingPacker
from passt_tpu_torch.data.prepare.metadata import (
    load_class_labels_indices,
    parse_audioset_segments_csv,
)

DEFAULT_SPLITS = "balanced_train_segments,eval_segments,unbalanced_train_segments"


def pack_split(
    mp3_root: str,
    metadata_dir: str,
    split: str,
    out_dir: str,
    name_format: str = "Y{ytid}.mp3",
    limit=None,
) -> str:
    mid_to_ix = load_class_labels_indices(
        os.path.join(metadata_dir, "class_labels_indices.csv")
    )
    files, targets = parse_audioset_segments_csv(
        os.path.join(metadata_dir, f"{split}.csv"),
        mid_to_ix,
        num_classes=len(mid_to_ix),
        name_format=name_format,
    )
    split_dir = os.path.join(mp3_root, split)
    audio_dir = split_dir if os.path.isdir(split_dir) else mp3_root

    out = os.path.join(out_dir, f"{split}_mp3.hdf")
    found = notfound = 0
    with StreamingPacker(out, column="mp3", packed_targets=True) as packer:
        for fn, target in zip(files, targets):
            path = os.path.join(audio_dir, fn)
            if not os.path.isfile(path):
                notfound += 1
                continue
            packer.add_bytes(fn, np.fromfile(path, dtype=np.uint8).tobytes(), target)
            found += 1
            if found % 1000 == 0:
                print(f"  {split}: {found} packed")
            if limit and found >= limit:
                break
    print(f"{split}: found {found}, not found {notfound} -> {out}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mp3_root", help="root of transcoded 32 kHz mp3s")
    ap.add_argument("metadata_dir", help="dir with class_labels_indices.csv + segment CSVs")
    ap.add_argument("--out", default="audioset_hdf5s")
    ap.add_argument("--splits", default=DEFAULT_SPLITS)
    ap.add_argument("--name-format", default="Y{ytid}.mp3")
    ap.add_argument("--limit", type=int, default=None, help="clips/split (smoke runs)")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    for split in args.splits.split(","):
        pack_split(
            args.mp3_root, args.metadata_dir, split, args.out,
            name_format=args.name_format, limit=args.limit,
        )


if __name__ == "__main__":
    main()
