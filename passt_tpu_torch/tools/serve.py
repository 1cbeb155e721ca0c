"""Batch-serve an exported artifact over a directory of .wav files (port of
scripts/serve.py).

Loads a program written by ``python -m passt_tpu_torch.tools.export_inference``
with ``torch``, numpy and the kernels' custom ops, no model code, pads or
truncates each clip to the artifact's clip length (resampled to its rate),
batches the clips and writes one ``.npz`` of ``names`` and ``out`` (logits,
or with ``--probs`` sigmoid probabilities). The program runs on the device
it was exported on (its manifest's ``platforms``)::

    python -m passt_tpu_torch.tools.serve --artifact serving/passt_s \\
        --wav-dir /data/clips --out predictions.npz [--batch 8] [--probs]
"""

import argparse
import glob
import os

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--artifact", required=True, help="path prefix of <x>.passt.pt2")
    p.add_argument("--wav-dir", required=True)
    p.add_argument("--out", default="predictions.npz")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--probs", action="store_true", help="store sigmoid probabilities instead of logits")
    args = p.parse_args(argv)

    from passt_tpu_torch.data.datasets import decode_wav, pad_or_truncate
    from passt_tpu_torch.export import load_exported, read_manifest

    manifest = read_manifest(args.artifact)
    n_samples = manifest["input"]["shape"][1]
    rate = manifest["sample_rate"]
    fixed_batch = manifest["input"]["shape"][0]  # None = symbolic
    if fixed_batch is not None and fixed_batch != args.batch:
        print(f"artifact has fixed batch {fixed_batch}; using it")
        args.batch = fixed_batch
    fn = load_exported(args.artifact)

    files = sorted(glob.glob(os.path.join(args.wav_dir, "**", "*.wav"), recursive=True))
    if not files:
        raise SystemExit(f"no .wav files under {args.wav_dir}")
    names, outs = [], []
    for start in range(0, len(files), args.batch):
        chunk = files[start: start + args.batch]
        waves = []
        for path in chunk:
            with open(path, "rb") as f:
                w = decode_wav(np.frombuffer(f.read(), np.uint8), target_rate=rate)
            waves.append(pad_or_truncate(w, n_samples))
        batch = np.stack(waves)
        if fixed_batch is not None and len(batch) < fixed_batch:
            batch = np.concatenate([batch, np.zeros((fixed_batch - len(batch), n_samples), np.float32)])
        res = fn(batch)
        logits = (res[0] if isinstance(res, (tuple, list)) else res).float().cpu().numpy()
        logits = logits[: len(chunk)]
        if args.probs:
            logits = 1.0 / (1.0 + np.exp(-logits))
        # relative paths: a recursive glob can hold same-named files in
        # different subdirectories
        names.extend(os.path.relpath(c, args.wav_dir) for c in chunk)
        outs.append(logits)
        print(f"{min(start + args.batch, len(files))}/{len(files)}", flush=True)

    np.savez(args.out, names=np.asarray(names), out=np.concatenate(outs))
    print(f"wrote {args.out}: {len(names)} clips x {outs[0].shape[1]} outputs")
    return {"n": len(names), "path": args.out}


if __name__ == "__main__":
    main()
