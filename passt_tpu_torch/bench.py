"""Training throughput of the port on one CUDA card.

    python3 -m passt_tpu_torch.bench [--steps 200] [--runs 3] [--warmup 2] [--eager]
        [--ln-impl fused | --fuse-ln-qkv]

The workload of the JAX package's root ``bench.py``: PaSST-S (12 x 768, 12
heads, 527 classes) in bf16 with structured patchout 40/4 (N = 474 tokens),
B = 12 ten-second 32 kHz clips of noise with 5%-positive targets, the
train-mode frontend, mixup, BCE, AdamW with bf16 moments and a
stochastically rounded second moment, and bf16 parameters applied with
stochastic rounding. Random weights from seed 0; no checkpoint is read.

The step is the graphed one (``make_train_step(jit=True)``, CUDA graphs
with the state donated), as the root ``bench.py`` times the jitted step;
``--eager`` also times the eager step (``jit=False``, its own state from
the same seed), run for run in turns with the graphed one. The steps are
timed as the root ``bench.py`` times them: after ``--warmup`` calls (the
graphed step's first call runs eagerly, its second captures the graph; the
seconds they take are reported, and the device memory the step's set-up
and warm-up peaked at), ``--runs`` runs
of ``--steps`` back-to-back calls, each run timed with CUDA events (so the
time includes whatever the card waits on the host), and the best run
counts. Prints each run's ms/step and the spread (slowest less best, over
best) on a line of its own, then one JSON line: specs/s and ms/step of the
best run, every run's ms/step, the spread, the eager step's (with
``--eager``), ``"platform": "cuda"`` and the card's name
(``device_kind``). There is no TPU baseline to divide by. ``--runs 1
--steps 20`` is the single run of 20 steps this bench took before.

``--ln-impl fused`` and ``--fuse-ln-qkv`` are the JAX config's own switches
(``PaSSTConfig.ln_impl`` / ``fuse_ln_qkv``): the same step with the
LayerNorm-backward kernel in every norm, or with norm1 fused into the qkv
projection and attention (the F1 and B2 kernels). The JSON line names them.

Where the device time goes is the benchmark's to say (``benchmark/``: its
``--trace 1`` runs read the train step's phase marks, ``tracing.py``).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from passt_tpu_torch.models.passt import PaSSTConfig
from passt_tpu_torch.ops.frontend import MelConfig
from passt_tpu_torch.train.steps import TrainState, create_train_state, make_optimizer, make_train_step

BATCH = 12
CLIP = 320000  # 10 s at 32 kHz
SEED = 42  # the runs' base seed for the per-step draws


#: the bench step's frontend and step options (``make_train_step``)
MEL_CFG = MelConfig(fmin_aug_range=10, fmax_aug_range=2000)
STEP_KW = dict(loss_type="multilabel", use_mixup=True, param_sr=True)


def optimizer():
    """AdamW with bf16 moments and a stochastically rounded second moment."""
    return make_optimizer(lr=2e-5, steps_per_epoch=1000, moments_dtype="bfloat16_sr")


def setup(device="cuda", jit: bool = True, **model_overrides):
    """The bench configuration, with ``model_overrides`` on its
    :class:`PaSSTConfig`, the step graphed (``jit``) or eager: returns
    (model, state, step, batch)."""
    cfg = PaSSTConfig(**dict(dict(dtype="bfloat16", s_patchout_t=40, s_patchout_f=4), **model_overrides))
    tx = optimizer()
    model, state = create_train_state(cfg, tx, torch.Generator().manual_seed(0),
                                      param_dtype="bfloat16_sr", device=device)
    step = make_train_step(model, tx, MEL_CFG, jit=jit, **STEP_KW)
    rng = np.random.default_rng(0)
    batch = {
        "wave": torch.from_numpy(rng.standard_normal((BATCH, CLIP)).astype(np.float32)).to(device),
        "target": torch.from_numpy((rng.uniform(size=(BATCH, 527)) < 0.05).astype(np.float32)).to(device),
    }
    return model, state, step, batch


def warmed(device, jit: bool, warmup: int, **model_overrides):
    """:func:`setup`, then ``warmup`` steps (the graphed step's first call
    runs eagerly, its second captures the graph and replays it): returns
    (state, step, batch, each warm-up call's seconds, the device memory the
    set-up and warm-up peaked at above what was allocated before, in
    bytes)."""
    torch.cuda.synchronize(device)
    before = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    _, state, step, batch = setup(device, jit=jit, **model_overrides)
    seconds = []
    for _ in range(warmup):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        state, _ = step(state, batch, SEED)
        torch.cuda.synchronize(device)
        seconds.append(time.perf_counter() - t0)
    return state, step, batch, seconds, torch.cuda.max_memory_allocated(device) - before


def step_memory(device, **model_overrides) -> Dict[str, int]:
    """The device memory of the bench step, eager, on a warmed state (one
    step taken first), in bytes above what was allocated just before:
    ``step_peak``, the peak of one whole step (activations, gradients, the
    optimizer's temporaries); ``forward_saved``, what the model's training
    forward on the step's spectrogram holds when it returns (the tensors
    saved for its backward and the logits; what remat cuts)."""
    from torch.func import functional_call

    from passt_tpu_torch.ops.frontend import log_mel_spectrogram

    model, state, step, batch = setup(device, jit=False, **model_overrides)
    state, _ = step(state, batch, SEED)
    out = {}
    torch.cuda.synchronize(device)
    before = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    state, _ = step(state, batch, SEED)
    torch.cuda.synchronize(device)
    out["step_peak"] = torch.cuda.max_memory_allocated(device) - before
    x = log_mel_spectrogram(batch["wave"], MEL_CFG)[:, None, :, :model.cfg.input_tdim]
    leaves = {k: p.detach().requires_grad_() for k, p in state.params.items()}
    gens = {k: torch.Generator(device).manual_seed(SEED) for k in ("patchout", "dropout", "droppath")}
    torch.cuda.synchronize(device)
    before = torch.cuda.memory_allocated(device)
    held = functional_call(model, leaves, (x,), dict(train=True, generators=gens))
    torch.cuda.synchronize(device)
    out["forward_saved"] = torch.cuda.memory_allocated(device) - before
    del held
    return out


def timed_steps(step, state: TrainState, batch: Dict[str, torch.Tensor], steps: int,
                warmup: int) -> Tuple[TrainState, float, torch.Tensor]:
    """Run ``warmup`` then ``steps`` train steps; returns the state, the mean
    ms per timed step (CUDA events) and the mean loss of the timed steps (a
    device scalar)."""
    for _ in range(warmup):
        state, _ = step(state, batch, SEED)
    device = batch["target"].device
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    loss_sum = torch.zeros((), device=device)
    start.record()
    for _ in range(steps):
        state, metrics = step(state, batch, SEED)
        loss_sum += metrics["loss"]
    end.record()
    end.synchronize()
    return state, start.elapsed_time(end) / steps, loss_sum / steps


def best_of_runs(run: Callable[[], float], runs: int) -> Tuple[float, List[float]]:
    """Call ``run`` (one timed run, returning its ms/step) ``runs`` times;
    returns the best (least) ms/step and every run's, in order."""
    if runs < 1:
        raise ValueError(f"runs must be >= 1, got {runs}")
    times = [run() for _ in range(runs)]
    return min(times), times


def spread(times: List[float]) -> float:
    """(slowest - best) / best of a list of run times."""
    return (max(times) - min(times)) / min(times)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=200, help="steps in each timed run")
    parser.add_argument("--runs", type=int, default=3, help="timed runs; the best counts")
    parser.add_argument("--warmup", type=int, default=2)
    parser.add_argument("--eager", action="store_true",
                        help="also time the eager step, run for run in turns with the graphed one")
    parser.add_argument("--ln-impl", choices=("auto", "fused"), default="auto",
                        help="the block and final LayerNorms: 'fused' takes the LayerNorm-backward kernel")
    parser.add_argument("--fuse-ln-qkv", action="store_true",
                        help="fuse norm1 into the qkv projection and attention (the F1 and B2 kernels)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("passt_tpu_torch.bench: no CUDA device; the bench runs on the card only")
    overrides = dict(ln_impl=args.ln_impl, fuse_ln_qkv=args.fuse_ln_qkv)
    steps = {}  # name -> [state, step]
    first_s, peak = {}, {}
    for name, jit in (("graph", True),) + ((("eager", False),) if args.eager else ()):
        state, step, batch, first_s[name], peak[name] = warmed(torch.device("cuda"), jit, args.warmup, **overrides)
        steps[name] = [state, step]
    times = {name: [] for name in steps}
    losses = {name: [] for name in steps}

    def one_run() -> float:
        for name, pair in steps.items():
            pair[0], run_ms, run_loss = timed_steps(pair[1], pair[0], batch, args.steps, 0)
            times[name].append(run_ms)
            losses[name].append(run_loss)
        return times["graph"][-1]

    ms, _ = best_of_runs(one_run, args.runs)
    for name, t in times.items():
        print(f"{name} step, runs of {args.steps} steps, ms/step: {', '.join(f'{x:.3f}' for x in t)}; best "
              f"{min(t):.3f}, spread {100.0 * spread(t):.2f}% ({torch.cuda.get_device_name(0)})")
    graph_times = times["graph"]
    record = {
        "metric": "train_throughput_b12_fwd_bwd_adamw_incl_mel",
        "value": BATCH * 1000.0 / ms,
        "unit": "specs/second",
        "ms_per_step": ms,
        "ms_per_step_runs": graph_times,
        "spread": spread(graph_times),
        "loss": float(losses["graph"][graph_times.index(ms)]),
        "step": "graph",
        "warmup_s": first_s["graph"],
        "peak_memory_bytes": peak["graph"],
        "steps": args.steps,
        "runs": args.runs,
        "model_overrides": overrides,
        "platform": "cuda",
        "device_kind": torch.cuda.get_device_name(0),
    }
    if args.eager:
        record.update(eager_ms_per_step=min(times["eager"]), eager_ms_per_step_runs=times["eager"],
                      eager_spread=spread(times["eager"]), eager_warmup_s=first_s["eager"],
                      eager_peak_memory_bytes=peak["eager"])
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
