"""wav -> 32 kHz mp3 transcode for container prep (port of
scripts/transcode_to_mp3.py).

The reference's prep shells out to ffmpeg per file
(reference audioset/prepare_scripts/convert_to_mp3.py:30:
``ffmpeg -hide_banner -nostats -loglevel error -n -i <in> -codec:a mp3
-ar 32000 <out>``) over the PANN folder layout. This tool reproduces that
contract — same codec flags, same folder structure, parallel workers —
with subprocess instead of ``os.system`` (no shell-quoting bugs on odd
YouTube-ID filenames).

ffmpeg is NOT bundled in every image. The tool fails up front with an
actionable message when it's missing; the rest of the pipeline does not
need it — containers accept pre-encoded mp3 bytes or raw PCM
(``passt_tpu_torch/data/prepare/pack_hdf5.py``; mp3 encoding in-process
with ``passt_tpu_torch.data.prepare.mp3enc``), and mp3 *decode* is
in-process via libmpg123 (native/hostplane.cpp).

Usage:
  python -m passt_tpu_torch.tools.transcode_to_mp3 --source <audios_dir> --out <mp3_dir>
      [--folders balanced_train_segments eval_segments unbalanced_train_segments]
      [--workers 20] [--sample-rate 32000]
"""

import argparse
import multiprocessing
import os
import pathlib
import shutil
import subprocess
import sys


def ffmpeg_cmd(src: str, dst: str, sample_rate: int):
    """The reference's exact transcode invocation (convert_to_mp3.py:30)."""
    return [
        "ffmpeg", "-hide_banner", "-nostats", "-loglevel", "error", "-n",
        "-i", src, "-codec:a", "mp3", "-ar", str(sample_rate), dst,
    ]


def _one(args):
    src, dst, sample_rate = args
    r = subprocess.run(ffmpeg_cmd(src, dst, sample_rate), capture_output=True, text=True)
    if r.returncode != 0:
        return f"{src}: {r.stderr.strip()}"
    return None


def transcode_tree(source: str, out: str, folders, workers: int, sample_rate: int):
    if shutil.which("ffmpeg") is None:
        raise SystemExit(
            "ffmpeg not found on PATH — wav->mp3 transcode needs it "
            "(any build: conda/apt/static). Alternatives that need NO "
            "ffmpeg: pack raw PCM containers with "
            "passt_tpu_torch.data.prepare.pack_hdf5.pack_waveform_hdf5, or pack "
            "already-encoded mp3 bytes with pack_bytes_hdf5."
        )
    jobs = []
    skipped = 0
    for fol in folders:
        src_dir = os.path.join(source, fol) if fol else source
        dst_dir = os.path.join(out, fol) if fol else out
        os.makedirs(dst_dir, exist_ok=True)
        for f in sorted(pathlib.Path(src_dir).glob("*.wav")):
            dst = os.path.join(dst_dir, f.stem + ".mp3")
            if os.path.exists(dst):
                # resume support: ffmpeg -n exits nonzero on existing
                # outputs, which would count every done file as a failure
                # on a rerun; skip them up front instead
                skipped += 1
                continue
            jobs.append((str(f), dst, sample_rate))
    print(f"{len(jobs)} files -> {out}" + (f" ({skipped} already done, skipped)" if skipped else ""))
    errors = []
    # spawned workers: the parent may hold threads (a fork would copy their locks)
    with multiprocessing.get_context("spawn").Pool(processes=workers) as pool:
        for i, err in enumerate(pool.imap_unordered(_one, jobs, chunksize=16)):
            if err:
                errors.append(err)
            if (i + 1) % 100 == 0:
                print(f"{i + 1}/{len(jobs)}")
    for e in errors[:20]:
        print("ERROR:", e, file=sys.stderr)
    print(f"done: {len(jobs) - len(errors)} ok, {len(errors)} failed")
    return len(errors)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--source", required=True, help="dir with wav files (PANN layout or flat)")
    p.add_argument("--out", required=True)
    p.add_argument(
        "--folders", nargs="*",
        default=["balanced_train_segments", "eval_segments", "unbalanced_train_segments"],
        help="subfolders to process; pass --folders '' for a flat directory",
    )
    p.add_argument("--workers", type=int, default=20)  # reference uses 20
    p.add_argument("--sample-rate", type=int, default=32000)
    a = p.parse_args(argv)
    folders = a.folders or [""]
    rc = transcode_tree(a.source, a.out, folders, a.workers, a.sample_rate)
    sys.exit(1 if rc else 0)


if __name__ == "__main__":
    main()
