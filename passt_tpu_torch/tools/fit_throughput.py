"""Sustained end-to-end ``fit`` throughput (port of scripts/fit_throughput.py).

``passt_tpu_torch.bench`` times the graphed train step on a resident
batch: no loader, no host-to-device copy, no per-step host work. This tool
measures what a user gets from ``audioset main``: the whole loop (the
loader threads, the pinned side-stream feed, the graphed step, eval,
checkpoints, the JSONL), as sustained specs/s from the epochs' ``it_per_s``
records, and beside it ``bench.timed_steps`` at the same batch in the same
process, after the run.

Protocol
- Packs a synthetic raw-int16 PCM container (decode-free: the loop's
  machinery is what differs from the bench, not the mp3 decode).
- Runs the recipe's ``main`` (weighted sampler, wavmix + roll on the host,
  mixup + SpecAugment on the card, checkpoints) for --epochs epochs.
- Epoch 0 pays the first calls (the graphs' capture); sustained = the best
  later epoch's it_per_s x batch size (it_per_s leaves eval and the
  checkpoint out: the epoch time is taken at the end of its batch loop).

Run: ``python -m passt_tpu_torch.tools.fit_throughput [--steps 167] [--epochs 3]``
on the card; ``main(..., device="cpu")`` runs on the CPU, where the bench
is not measured. Needs h5py unless --reuse finds the containers (or wav
folders of the same names).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np


def make_items(n_clips: int, n_classes: int = 527, seconds: int = 10, sr: int = 32000):
    """``n_clips`` (name, float32 wave, one-hot target): a rolled and scaled
    noise template (content is irrelevant to throughput)."""
    rng = np.random.default_rng(0)
    base = (rng.standard_normal(seconds * sr).astype(np.float32) * 0.1)
    for i in range(n_clips):
        wave = np.roll(base, (i * 997) % len(base)) * (0.5 + (i % 7) / 8.0)
        target = np.zeros(n_classes)
        target[i % n_classes] = 1
        yield (f"clip{i}.wav", wave, target)


def make_container(path: str, n_clips: int, n_classes: int = 527, seconds: int = 10,
                   sr: int = 32000) -> None:
    from passt_tpu_torch.data.prepare import pack_waveform_hdf5

    n = pack_waveform_hdf5(path, make_items(n_clips, n_classes, seconds, sr))
    print(f"packed {n} clips -> {path} ({os.path.getsize(path) / 1e9:.2f} GB)")


def bench_ms(batch_size: int, device) -> float:
    """``bench.timed_steps``' ms/step (100 steps after 2) of the bench's
    graphed step on a resident batch of ``batch_size`` 10-s clips."""
    import torch

    from passt_tpu_torch import bench

    _, state, step, batch = bench.setup(device)
    rng = np.random.default_rng(0)
    batch = {
        "wave": torch.from_numpy(rng.standard_normal((batch_size, bench.CLIP)).astype(np.float32)).to(device),
        "target": torch.from_numpy((rng.uniform(size=(batch_size, 527)) < 0.05).astype(np.float32)).to(device),
    }
    _, ms, _ = bench.timed_steps(step, state, batch, 100, 2)
    return ms


def main(argv=None, device="cuda", extra=()) -> dict:
    """Pack, train, print and return the JSON record; ``extra`` holds
    ``key=value`` overrides of the recipe's config."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=167, help="train steps per epoch")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--batch-size", type=int, default=12)
    ap.add_argument("--workdir", default="/tmp/fit_throughput")
    ap.add_argument("--reuse", action="store_true", help="reuse an existing container")
    ap.add_argument("--profile", action="store_true",
                    help="capture a torch.profiler trace of steps 60..75")
    ap.add_argument("--transfer-dtype", default=None, choices=["float32", "int16"],
                    help="override trainer.transfer_dtype (int16 halves "
                         "host->device bytes; see config.py)")
    ap.add_argument("--device-prefetch", type=int, default=None,
                    help="override trainer.device_prefetch (0 = inline "
                         "synchronous copies)")
    ap.add_argument("--no-checkpoint", action="store_true",
                    help="no checkpoint writes: their cost is real and worth "
                         "reporting, but not part of the steady-state step rate")
    args = ap.parse_args(argv)

    os.makedirs(args.workdir, exist_ok=True)
    n_clips = args.steps * args.batch_size
    train_h5 = os.path.join(args.workdir, f"train_{n_clips}.h5")
    eval_h5 = os.path.join(args.workdir, "eval_120.h5")
    if not (args.reuse and os.path.exists(train_h5)):
        make_container(train_h5, n_clips)
    if not (args.reuse and os.path.exists(eval_h5)):
        make_container(eval_h5, 120)

    import torch

    from passt_tpu_torch.config import apply_overrides
    from passt_tpu_torch.experiments.audioset import experiment
    from passt_tpu_torch.models.registry import resolve_device

    device = resolve_device(device)
    cfg = experiment.default_config
    cfg = dataclasses.replace(
        cfg,
        data=dataclasses.replace(
            cfg.data,
            train_hdf5=train_h5,
            eval_hdf5=eval_h5,
            epoch_len=n_clips,  # no-replacement weighted sampler: one full pass
            batch_size=args.batch_size,
        ),
        trainer=dataclasses.replace(
            cfg.trainer,
            max_epochs=args.epochs,
            checkpoint_dir=(None if args.no_checkpoint
                            else os.path.join(args.workdir, "ckpt")),
            limit_eval_batches=2,  # eval path exercised, not measured
            profile_dir=os.path.join(args.workdir, "trace") if args.profile else None,
            profile_start_step=60,
            profile_num_steps=15,
            **({"transfer_dtype": args.transfer_dtype}
               if args.transfer_dtype is not None else {}),
            **({"device_prefetch": args.device_prefetch}
               if args.device_prefetch is not None else {}),
        ),
    )
    if extra:
        cfg = apply_overrides(cfg, dict(kv.split("=", 1) for kv in extra))
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"device: {name}  steps/epoch: {args.steps}  B: {args.batch_size}")
    t0 = time.time()
    result = experiment.main(cfg, device=device)
    wall = time.time() - t0

    hist = result["history"]
    rates = [r["it_per_s"] for r in hist if "it_per_s" in r]
    sustained = max(rates[1:] or rates)  # epoch 0 pays the first calls
    specs = sustained * args.batch_size
    # the bench step at the same B, same process, after the run (the card only)
    ms = bench_ms(args.batch_size, device) if device.type == "cuda" else None
    bench_specs = None if ms is None else args.batch_size * 1000.0 / ms
    out = {
        "metric": "fit_loop_sustained_throughput",
        "value": round(specs, 2),
        "unit": "specs/second",
        "epoch_it_per_s": rates,
        "steps_per_epoch": args.steps,
        "batch_size": args.batch_size,
        "wall_s_total": round(wall, 1),
        "bench_ms_per_step": ms,
        "bench_specs_per_s": bench_specs,
        "vs_in_graph_bench": None if bench_specs is None else round(specs / bench_specs, 4),
        "device_prefetch": cfg.trainer.device_prefetch,
        "transfer_dtype": cfg.trainer.transfer_dtype,
        "checkpointing": not args.no_checkpoint,
        "device": name,
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
