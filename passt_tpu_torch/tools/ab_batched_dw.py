"""A/B of the weight-gradient schedule at the training step's shapes on the
card (counterpart of scripts/ab_batched_dw.py).

    python3 -m passt_tpu_torch.tools.ab_batched_dw [--reps 10]

What ``blocks_impl="stacked"`` changes in the backward, isolated: the four
weight families of PaSST-S's 12 blocks (qkv 768 -> 2304, proj 768 -> 768,
fc1 768 -> 3072, fc2 3072 -> 768) at B = 12, N = 474 (M = 5688 rows), bf16
activations and cotangents from a numpy seed, bf16 weights and moments:

- "per_block": 48 weight-gradient products (one per block and family,
  fp32 results), each followed by its own AdamW step with stochastically
  rounded bf16 moments and parameter (``train/optim.py`` ``adamw_bf16sr``
  and ``apply_updates_sr`` on the one leaf), as autograd places them;
- "batched": the four batched products over the stacked ``[12, ...]``
  activations (``models/stacked_blocks.py`` ``_bdw``), then one AdamW step
  over the four stacked leaves.

The same products and the same update arithmetic; what differs is the
batching of the products and the number of update passes. Each variant's
device time per iteration is the summed time of its kernels from a
profiler trace (``tools.timing.kernel_ms``: the host's launch gaps drop
out), with the CUDA-event time of the eager calls beside it, the two
variants in turns; the products' operations over the time give TFLOP/s.
Prints one JSON line. Raises without a card; ``run()`` returns the record.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

DEPTH, M, C = 12, 12 * 474, 768
SHAPES = {"qkv": (C, 3 * C), "proj": (C, C), "fc1": (C, 4 * C), "fc2": (4 * C, C)}  # (in, out)


def _inputs(device):
    rng = np.random.default_rng(0)

    def arr(shape, scale=1.0):
        return (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)) * scale).to(device, torch.bfloat16)

    xs = {k: arr((DEPTH, M, i)) for k, (i, o) in SHAPES.items()}
    gs = {k: arr((DEPTH, M, o), 1e-3) for k, (i, o) in SHAPES.items()}
    ws = {k: arr((DEPTH, o, i), 0.02) for k, (i, o) in SHAPES.items()}
    return xs, gs, ws


def run(device="cuda", reps: int = 10) -> dict:
    """Time the two schedules (module docstring); returns the record."""
    from passt_tpu_torch.models.stacked_blocks import _bdw
    from passt_tpu_torch.tools.timing import cuda_ms, kernel_ms
    from passt_tpu_torch.train import optim

    device = torch.device(device)
    if device.type != "cuda":
        raise RuntimeError("ab_batched_dw times the card; no CUDA device given")
    xs, gs, ws = _inputs(device)
    tx = optim.adamw_bf16sr(2e-5)
    per = {f"{k}.{l}": ws[k][l].clone() for k in SHAPES for l in range(DEPTH)}
    per_state = {n: tx.init({n: w}) for n, w in per.items()}
    stacked = {k: w.clone() for k, w in ws.items()}
    st_state = tx.init(stacked)
    gen = torch.Generator(device=device)

    def per_block():
        for k in SHAPES:
            for l in range(DEPTH):
                n = f"{k}.{l}"
                dw = _bdw(xs[k][l:l + 1], gs[k][l:l + 1])[0]
                inputs = optim.host_inputs(tx.plan(per_state[n]), device)
                upd, per_state[n] = tx.update({n: dw}, per_state[n], {n: per[n]}, inputs)
                per[n] = optim.apply_updates_sr({n: per[n]}, upd, gen)[n]

    def batched():
        nonlocal st_state, stacked
        grads = {k: _bdw(xs[k], gs[k]) for k in SHAPES}
        inputs = optim.host_inputs(tx.plan(st_state), device)
        upd, st_state = tx.update(grads, st_state, stacked, inputs)
        stacked = optim.apply_updates_sr(stacked, upd, gen)

    flops = sum(2.0 * DEPTH * M * i * o for i, o in SHAPES.values())
    fns = {"per_block": per_block, "batched": batched}
    out = {name: {"kernel_ms": [], "events_ms": []} for name in fns}
    for _ in range(2):  # in turns: per_block, batched, per_block, batched
        for name, fn in fns.items():
            out[name]["kernel_ms"].append(kernel_ms(fn, reps))
            out[name]["events_ms"].append(cuda_ms(fn, reps=reps, warmup=1))
    for rec in out.values():
        best = min(rec["kernel_ms"])
        rec.update(best_kernel_ms=best, product_tflops=flops / best / 1e9, best_events_ms=min(rec["events_ms"]))
    # the products alone, batched and per block: the schedule's GEMM share
    out["products_only"] = {
        "per_block_ms": kernel_ms(lambda: [_bdw(xs[k][l:l + 1], gs[k][l:l + 1]) for k in SHAPES
                                           for l in range(DEPTH)], reps),
        "batched_ms": kernel_ms(lambda: [_bdw(xs[k], gs[k]) for k in SHAPES], reps),
    }
    out["flops_per_iter"] = flops
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=10)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ab_batched_dw: no CUDA device; it times the card only")
    from passt_tpu_torch.tools.timing import gpu_line

    print(json.dumps({"ab_batched_dw": run("cuda", args.reps), "device": gpu_line()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
