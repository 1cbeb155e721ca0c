"""Traffic kind "train_step": the recipe's training step, issued back to
back on batches made on the card from the seed.

The set-up builds one step (``make_train_step(jit=True)``: CUDA graphs,
the state donated) with its model and optimizer state from the benchmark's
weights, and takes the first ``checked_steps`` steps through it on batches
0, 1, 2 of the pool (the first call runs eagerly, the second captures the
graph). The window then issues steps on the pool's batches in turn, at
most two in flight, until ``--seconds`` have passed, and waits for the last.
On several cards each rank takes its rows of every global batch, and the
ranks agree to stop at the same step.

``correct``: the plain reference follows the first ``checked_steps`` steps
in fp32 from the same weights, batches and draws, after the window, and
the program's readings taken during set-up are compared with it: each
step's loss, each leaf's first gradient (from the optimizer's first
moment after step 1) and the change over the checked steps, pooled over
the bf16-stored leaves and over the fp32 ones.
"""

from __future__ import annotations

import math
import statistics
import time

import torch

from benchmark.lib import draws as D
from benchmark.lib import flops, harness, program, reference, trace as T, weights as Wt

#: on several cards, the window's steps between two host all-reduces that
#: decide whether every rank is done (one card decides after each step)
AGREE_EVERY = 8


def _agree(done: bool, env) -> bool:
    """Whether any rank is done (a host all-reduce on the control group)."""
    if env.world == 1:
        return done
    import torch.distributed as dist

    flag = torch.tensor([1.0 if done else 0.0])
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=env.control)
    return bool(flag.item() > 0)


def _gather(value, env) -> list:
    if env.world == 1:
        return [value]
    import torch.distributed as dist

    out = [None] * env.world
    dist.all_gather_object(out, value, group=env.control)
    return out


def _norms(tensors) -> torch.Tensor:
    return torch.stack(torch._foreach_norm([t.float() for t in tensors]))


def build(cell, weights, env):
    """The program's step, state and optimizer from the cell's files."""
    from passt_tpu_torch.train.optim import cast_params_storage
    from passt_tpu_torch.train.steps import TrainState, make_optimizer, make_train_step

    p = cell.params
    m = p["model"]
    net = program.model(cell.config, weights, env.device, s_patchout_t=m["s_patchout_t"],
                        s_patchout_f=m["s_patchout_f"])
    o = p["optimizer"]
    tx = make_optimizer(lr=o["lr"], weight_decay=o["weight_decay"], steps_per_epoch=o["steps_per_epoch"],
                        warm_up_len=o["warm_up_len"], ramp_down_start=o["ramp_down_start"],
                        ramp_down_len=o["ramp_down_len"], last_lr_value=o["last_lr_value"],
                        moments_dtype=o["moments_dtype"])
    params = {k: v.detach() for k, v in net.named_parameters()}
    state = TrainState(params=cast_params_storage(params, p["param_dtype"]), opt_state=tx.init(params), step=0)
    dp = None
    if env.world > 1:
        from passt_tpu_torch.parallel.mesh import DataParallel

        dp = DataParallel(env.world, env.rank)
    s = p["step"]
    step = make_train_step(net, tx, program.mel_config(cell.config["mel"]), loss_type=s["loss_type"],
                           use_mixup=s["use_mixup"], mixup_alpha=m["mixup_alpha"], param_sr=s["param_sr"],
                           jit=True, data_parallel=dp)
    return net, state, step


def run(cell, env):
    phases = harness.Phases(env.t_start, env.marks)
    phases.mark("to_traffic")
    p, cfg = cell.params, cell.config
    dev = env.device
    b = p["batch_per_chip"]
    total = b * env.world
    k_pool = p["pool_batches"]
    checked = p["checked_steps"]
    w = Wt.make_weights(cfg, env.seed, dev)
    waves, targets = Wt.make_clips(env.seed, k_pool, total, p["clip_samples"], cfg["num_classes"],
                                   p["target_rate"], dev, cfg["mel"]["sr"])
    rows = slice(env.rank * b, (env.rank + 1) * b)
    batches = [{"wave": waves[k, rows], "target": targets[k, rows]} for k in range(k_pool)]
    step_seed = harness.sub_seed(env.seed, "steps")
    harness.reset_peak(dev)
    phases.mark("weights_and_clips")
    net, state, step = build(cell, w, env)
    phases.mark("build")
    names = list(state.params)

    # set-up: the first steps, through the window's own call, on distinct batches
    losses = []
    for s in range(checked):
        state, metrics = step(state, batches[s % k_pool], step_seed)
        losses.append(metrics["loss"])
        if s == 0:
            b1 = p["optimizer"]["b1"]
            grad1 = _norms([state.opt_state.mu[k] for k in names]) / (1.0 - b1)
        harness.synchronize(dev)
        phases.mark(f"step{s + 1}")
    change = _norms([state.params[k].float() - w[k] for k in names])
    harness.synchronize(dev)
    setup_s = time.time() - env.t_start

    # the window
    from passt_tpu_torch.ops import _build

    before = _build.launch_counts()
    spans, inflight, stamps = [], [], []
    n = checked
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        state, _ = step(state, batches[n % k_pool], step_seed)
        spans.append(time.perf_counter() - ts)
        if dev.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            inflight.append(ev)
            if len(inflight) > 2:
                inflight.pop(0).synchronize()
        n += 1
        stamps.append(time.perf_counter())
        if env.world > 1 and (n - checked) % AGREE_EVERY:
            continue
        if _agree(time.perf_counter() - t0 >= env.seconds, env):
            break
    harness.synchronize(dev)
    t1 = time.perf_counter()
    window_s = t1 - t0
    units = n - checked
    paths = _build.launch_delta(before)

    frames = Wt.mel_frames(cfg["mel"], p["clip_samples"])
    f, t = flops.grid(cfg, frames)
    tokens = flops.tokens(dict(cfg, **p["model"]), frames, True)
    readings = {"enqueue_s": spans, "window_s": window_s, "units": units, "chips": env.world,
                "model_flops_per_unit": 3.0 * total * flops.forward_flops(cfg, tokens, f * t),
                "attn": {"b": b, "n": tokens, "h": cfg["num_heads"], "d": cfg["embed_dim"] // cfg["num_heads"],
                         "calls_per_unit": cfg["depth"]}}
    tr = None
    busy = window = None
    if env.trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(T.WINDOW_SPAN):
                for i in range(p["trace_steps"]):
                    with record_function("bench.step"):  # names the host's share of the idle gaps
                        state, _ = step(state, batches[(n + i) % k_pool], step_seed)
                harness.synchronize(dev)
        tr = T.Trace.from_profiler(prof, p["trace_steps"])
        both = _gather((tr.busy_s, tr.window_s), env)
        busy = statistics.fmean(x for x, _ in both)
        window = statistics.fmean(y for _, y in both)
        readings["trace"] = tr
    peak = max(_gather(harness.memory_peak(dev), env))
    e2e = {"train_clips_per_s": units * total / window_s, "setup_s": setup_s}
    losses = [float(x) for x in losses]
    grad1 = grad1.cpu()
    change = change.cpu()
    storage = {k: state.params[k].dtype for k in names}
    del state, step, net, batches
    harness.release(dev)
    if env.rank != 0:
        return None
    t_ref = time.perf_counter()
    checks, shown = judge(cell, w, waves, targets, step_seed, losses, dict(zip(names, grad1.tolist())),
                          dict(zip(names, change.tolist())), storage, dev)
    shown["reference_s"] = time.perf_counter() - t_ref
    shown["setup_phases_s"] = phases.seconds()
    shown["steps_per_s_halves"] = harness.halves(stamps, t0, t1)
    return harness.Outcome(end_to_end=e2e, readings=readings, checks=checks, shown=shown, attempted=units,
                           failed=0, memory_peak_bytes=peak, trace=tr, busy_s=busy, window_s=window,
                           extra={"paths": paths})


def reference_steps(cell, w, waves, targets, step_seed, dev, low=False, loss_rows=None):
    """The reference's first steps: (losses, first gradient norms by leaf,
    updates by leaf, parameters after them). ``low`` and ``loss_rows`` are
    the control and a planted fault (``lib/control.py``)."""
    p, cfg = cell.params, cell.config
    rcfg = dict(cfg, **p["model"])
    frames = Wt.mel_frames(cfg["mel"], p["clip_samples"])
    total = waves.shape[1]
    params = {k: v.clone() for k, v in w.items()}
    m = {k: torch.zeros_like(v) for k, v in w.items()}
    v = {k: torch.zeros_like(x) for k, x in w.items()}
    losses, updates, grad1 = [], {k: [] for k in w}, None
    for s in range(p["checked_steps"]):
        dr = D.step_draws(step_seed, s, total, frames, cfg["mel"], rcfg, flops.grid(cfg, frames), dev)
        wave, target = waves[s % waves.shape[0]], targets[s % targets.shape[0]]
        loss, grads = reference.train_loss_and_grads(params, wave, target, dr, rcfg, cfg["mel"], low=low,
                                                     clips_per_pass=p["batch_per_chip"], loss_rows=loss_rows)
        if s == 0:
            grad1 = {k: float(g.norm()) for k, g in grads.items()}
        params, m, v, upd = reference.adamw(params, grads, m, v, s, p["optimizer"])
        for k in w:
            updates[k].append(upd[k])
        losses.append(loss)
        del grads
    return losses, grad1, updates, params


def gaps(w, storage, losses, grad1, change, ref_losses, ref_grad1, ref_updates, ref_params) -> dict:
    """The compared numbers: the worst step's relative loss gap; the worst
    leaf's gap of first-gradient norms, against the reference's norm of
    that leaf or of the median leaf, whichever is larger; and the relative
    gap of the change's norm pooled over every bf16-stored leaf
    (``change_gap_bf16``, against the root of the summed expected squared
    norms of SR stores) and over every fp32 leaf (``change_gap_fp32``).
    Shown beside them: the worst leaf's change gap, measured like the
    gradient's. Leaves whose reference gradient is under a thousandth of
    the median leaf's are left out of the change (they move by rounding
    alone)."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    med_g = statistics.median(ref_grad1.values())
    grad_gap = max(abs(grad1[k] - ref_grad1[k]) / max(ref_grad1[k], med_g) for k in ref_grad1)
    moved = [k for k in ref_grad1 if ref_grad1[k] >= 1e-3 * med_g]
    ref_change = {}
    for k in moved:
        if storage[k] == torch.bfloat16:
            ref_change[k] = reference.expected_sr_norm(w[k], ref_updates[k])
        else:
            ref_change[k] = float((ref_params[k] - w[k]).norm())
    med_c = statistics.median(ref_change.values())
    per_leaf = {k: abs(change[k] - ref_change[k]) / max(ref_change[k], med_c) for k in moved}
    worst = max(per_leaf, key=per_leaf.get)
    out = {"loss_gap": loss_gap, "grad_gap": grad_gap}
    for label, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        pool = [k for k in moved if storage[k] == dtype]
        if pool:
            a = math.sqrt(sum(change[k] ** 2 for k in pool))
            b = math.sqrt(sum(ref_change[k] ** 2 for k in pool))
            out[f"change_gap_{label}"] = abs(a - b) / b
            out[f"leaves_{label}"] = len(pool)
    out.update(change_gap=per_leaf[worst], change_worst_leaf=worst, left_out=len(ref_grad1) - len(moved))
    return out


def judge(cell, w, waves, targets, step_seed, losses, grad1, change, storage, dev):
    ref_losses, ref_grad1, ref_updates, ref_params = reference_steps(cell, w, waves, targets, step_seed, dev)
    g = gaps(w, storage, losses, grad1, change, ref_losses, ref_grad1, ref_updates, ref_params)
    limits = cell.limits
    checks = {k: (float(g[k]), float(limits[k])) for k in limits}
    shown = {k: v for k, v in g.items() if k not in limits}
    shown["losses"] = losses
    shown["ref_losses"] = ref_losses
    return checks, shown
