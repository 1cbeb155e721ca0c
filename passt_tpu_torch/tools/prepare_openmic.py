"""OpenMIC-2018 end-to-end preparation (port of scripts/prepare_openmic.py)
— the reference's openmic/prepare_scripts/download_preprocess.py rebuilt
with ZERO external binaries: download (urllib) -> untar -> in-process
ogg->mp3 (libvorbisfile decode + stride/linear resample to 32 kHz +
libmp3lame encode, pool parallel) -> pack train/test HDF5 containers with
the [labels || mask] target layout the OpenMIC recipe consumes. Needs h5py,
libvorbisfile and libmp3lame.

Usage:
  python -m passt_tpu_torch.tools.prepare_openmic [--workdir DIR] [--out DIR]
      [--skip-download] [--limit N]

The reference flow (file:line):
  download zenodo tgz            download_preprocess.py:22-27
  untar                          :30-34
  ogg -> 32 kHz mp3 (ffmpeg x20) :37-54        (here: in-process pool)
  labels+mask from openmic npz   :60-91, 119-127
  pack mp3 HDF5 per split csv    :129-150

Then (reference protocol, openmic/README.md):
  python -m passt_tpu_torch.cli openmic main \\
      data.train_hdf5=$OUT/openmic_train.h5 data.eval_hdf5=$OUT/openmic_test.h5
"""

import argparse
import os
import tarfile
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from passt_tpu_torch.data.prepare import pack_bytes_hdf5
from passt_tpu_torch.data.prepare.metadata import openmic_targets
from passt_tpu_torch.data.prepare.mp3enc import encode_mp3
from passt_tpu_torch.data.prepare.oggdec import decode_ogg

OPENMIC_URL = (
    "https://zenodo.org/record/1432913/files/openmic-2018-v1.0.0.tgz?download=1"
)
TARGET_RATE = 32000
CLASSES = 20


def download(workdir: str, force: bool = False) -> str:
    tgz = os.path.join(workdir, "openmic-2018-v1.0.0.tgz")
    if force or not os.path.isfile(tgz):
        print("downloading OpenMIC from zenodo ...")
        urllib.request.urlretrieve(OPENMIC_URL, tgz)  # noqa: S310
    else:
        print(f"{tgz} already exists; skipping download")
    return tgz


def untar(tgz: str, workdir: str) -> str:
    root = os.path.join(workdir, "openmic-2018-v1.0.0")
    if not os.path.isdir(root):
        print(f"extracting {tgz} ...")
        with tarfile.open(tgz) as t:
            t.extractall(root)
    return os.path.join(root, "openmic-2018")


def _resample(wave: np.ndarray, rate: int) -> np.ndarray:
    if rate == TARGET_RATE:
        return wave
    if rate % TARGET_RATE == 0:
        return wave[:: rate // TARGET_RATE]
    t_new = np.arange(int(round(len(wave) * TARGET_RATE / rate))) * (
        rate / TARGET_RATE
    )
    return np.interp(t_new, np.arange(len(wave)), wave).astype(np.float32)


def ogg_to_mp3_bytes(path: str) -> bytes:
    wave, rate = decode_ogg(path)
    return encode_mp3(_resample(wave, rate), TARGET_RATE)


def pack_split(dataset_path: str, csv_path: str, out_path: str, limit=None):
    npz = np.load(os.path.join(dataset_path, "openmic-2018.npz"), allow_pickle=True)
    sample_to_ix = {sid: i for i, sid in enumerate(npz["sample_key"])}
    with open(csv_path) as f:
        keys = [line.strip() for line in f if line.strip()]
    if limit:
        keys = keys[:limit]

    jobs = []
    for key in keys:
        if key not in sample_to_ix:
            continue
        ogg = os.path.join(dataset_path, "audio", key[:3], key + ".ogg")
        if os.path.isfile(ogg):
            jobs.append((key, ogg))
    print(f"{csv_path}: {len(jobs)} of {len(keys)} clips found")

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as pool:
        blobs = list(pool.map(lambda kv: ogg_to_mp3_bytes(kv[1]), jobs))

    items = []
    for (key, _), blob in zip(jobs, blobs):
        ix = sample_to_ix[key]
        target = openmic_targets(
            np.asarray(npz["Y_true"][ix])[None], np.asarray(npz["Y_mask"][ix])[None]
        )[0]
        items.append((key + ".mp3", blob, target))
    n = pack_bytes_hdf5(
        out_path, items, column="mp3", sample_rate=TARGET_RATE, packed_targets=False
    )
    print(f"packed {n} clips -> {out_path}")
    return n


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workdir", default="openmic_work")
    ap.add_argument("--out", default="audioset_hdf5s/mp3")
    ap.add_argument("--skip-download", action="store_true")
    ap.add_argument("--limit", type=int, default=None)
    args = ap.parse_args(argv)
    os.makedirs(args.workdir, exist_ok=True)
    os.makedirs(args.out, exist_ok=True)
    if not args.skip_download:
        tgz = download(args.workdir)
    else:
        tgz = os.path.join(args.workdir, "openmic-2018-v1.0.0.tgz")
    dataset_path = untar(tgz, args.workdir)
    for split, out_name in [
        ("split01_train.csv", "openmic_train.h5"),
        ("split01_test.csv", "openmic_test.h5"),
    ]:
        pack_split(
            dataset_path,
            os.path.join(dataset_path, "partitions", split),
            os.path.join(args.out, out_name),
            limit=args.limit,
        )


if __name__ == "__main__":
    main()
