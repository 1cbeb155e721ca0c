"""A/B of the depth's three forms at the bench's training step on the card
(counterpart of scripts/ab_scan_blocks.py).

    python3 -m passt_tpu_torch.tools.ab_scan_blocks [--steps 200] [--runs 3]

The ``passt_tpu_torch.bench`` step (PaSST-S, bf16, B = 12, N = 474, mixup,
bf16 SR AdamW and parameters), graphed, under ``blocks_impl`` "loop",
"scan" and "stacked", and "loop" with ``remat``: each warmed (its eager
call and its capture, timed), then ``--runs`` runs of ``--steps`` steps
taken in turns (loop, scan, stacked, remat, loop, ...), CUDA-event timed;
the best run counts. Per variant: each run's ms/step and the spread, the
warm-up calls' seconds, the device memory the set-up and warm-up peaked at
above what was allocated before, the memory of one eager step on a warmed
state (its own peak, and what the training forward holds for the backward:
``bench.step_memory``) and the kernel launches a step (the port's
counters over the timed replays). Prints one line per variant and one JSON
line.
Raises without a card; ``run()`` returns the record.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict

import torch

#: variant -> the model overrides of the bench's config
VARIANTS: Dict[str, dict] = {
    "loop": {},
    "scan": dict(blocks_impl="scan"),
    "stacked": dict(blocks_impl="stacked"),
    "loop+remat": dict(remat=True),
}


def run(device="cuda", steps: int = 200, runs: int = 3) -> dict:
    """Time the variants in turns (module docstring); returns name -> record."""
    from passt_tpu_torch import bench
    from passt_tpu_torch.ops import _build

    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError("ab_scan_blocks times the card; no CUDA device given")
    memory = {name: bench.step_memory(device, **overrides) for name, overrides in VARIANTS.items()}
    recs = {}
    for name, overrides in VARIANTS.items():
        state, step, batch, warm_s, peak = bench.warmed(device, True, 2, **overrides)
        recs[name] = dict(state=state, step=step, batch=batch, warm_s=warm_s, peak_bytes=peak, runs=[],
                          launches={})
    for _ in range(runs):
        for rec in recs.values():
            torch.cuda.synchronize(device)
            _build.reset_launches()
            rec["state"], ms, loss = bench.timed_steps(rec["step"], rec["state"], rec["batch"], steps, 0)
            rec["runs"].append(ms)
            rec["loss"] = float(loss)
            rec["launches"] = {k: v // steps for k, v in _build.LAUNCHES.items() if v}
    out = {}
    for name, rec in recs.items():
        out[name] = dict(ms_per_step=min(rec["runs"]), ms_per_step_runs=rec["runs"], spread=bench.spread(rec["runs"]),
                         warmup_s=rec["warm_s"], peak_memory_bytes=rec["peak_bytes"], loss=rec["loss"],
                         step_peak_bytes=memory[name]["step_peak"], forward_saved_bytes=memory[name]["forward_saved"],
                         launches_per_step=rec["launches"])
    del recs
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=200)
    parser.add_argument("--runs", type=int, default=3)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ab_scan_blocks: no CUDA device; it times the card only")
    from passt_tpu_torch.tools.timing import gpu_line

    out = run("cuda", args.steps, args.runs)
    gpu = gpu_line()
    for name, r in out.items():
        print(f"{name}: {', '.join(f'{t:.3f}' for t in r['ms_per_step_runs'])} ms/step (best {r['ms_per_step']:.3f}, "
              f"spread {100 * r['spread']:.2f}%), peak {r['peak_memory_bytes'] / 2**30:.2f} GiB, one eager step's "
              f"peak {r['step_peak_bytes'] / 2**30:.3f} GiB, its forward holds {r['forward_saved_bytes'] / 2**30:.3f} "
              f"GiB ({gpu})")
    print(json.dumps({"ab_scan_blocks": out, "device": gpu}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
