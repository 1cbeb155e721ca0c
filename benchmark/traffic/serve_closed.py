"""Traffic kind "serve_closed": one caller tags batches of clips through
the program's ``Predictor`` in a closed loop.

The set-up builds a graphed ``Predictor`` (``jit=True``) holding the
benchmark's weights and a pool of ``pool_batches`` distinct batches of
``batch`` clips, made on the card from the seed, and warms it with
``warmup_calls`` calls (the first eager, the second captures the graph).
The window issues a call on the pool's next batch, takes its logits to the
host, and issues the next, until ``--seconds`` have passed. A call's
latency runs from issuing it to its logits on the host.

``correct``: after the window the plain reference computes every pool
batch's logits in fp32, and every call of the window is compared with its
batch's: the widest gap of any logit, over the root mean square of the
reference logits less their mean over the batch's clips (the part of an
answer that differs between clips).
"""

from __future__ import annotations

import time

import numpy as np

from benchmark.lib import flops, harness, program, reference, trace as T, weights as Wt


def build(cell, weights, env):
    from passt_tpu_torch.hear import Predictor

    net = program.model(cell.config, weights, env.device)
    net.eval()
    return Predictor(model=net, mel_cfg=program.mel_config(cell.config["mel"]), jit=True)


def run(cell, env):
    phases = harness.Phases(env.t_start, env.marks)
    phases.mark("to_traffic")
    p, cfg = cell.params, cell.config
    dev = env.device
    b, k_pool = p["batch"], p["pool_batches"]
    w = Wt.make_weights(cfg, env.seed, dev)
    waves, _ = Wt.make_clips(env.seed, k_pool, b, p["clip_samples"], cfg["num_classes"], 0.0, dev,
                             cfg["mel"]["sr"])
    harness.reset_peak(dev)
    phases.mark("weights_and_clips")
    predictor = build(cell, w, env)
    phases.mark("build")
    for i in range(p["warmup_calls"]):
        predictor(waves[i % k_pool]).cpu()
        phases.mark(f"call{i + 1}")
    setup_s = time.time() - env.t_start

    from passt_tpu_torch.ops import _build

    before = _build.launch_counts()
    lat, spans, served, stamps = [], [], [], []
    n = 0
    t0 = time.perf_counter()
    while True:
        k = n % k_pool
        ts = time.perf_counter()
        out = predictor(waves[k])
        te = time.perf_counter()
        host = out.cpu()
        tc = time.perf_counter()
        lat.append(tc - ts)
        stamps.append(tc)
        spans.append(te - ts)
        served.append((k, host))
        n += 1
        if tc - t0 >= env.seconds:
            break
    t1 = time.perf_counter()
    window_s = t1 - t0
    paths = _build.launch_delta(before)

    frames = Wt.mel_frames(cfg["mel"], p["clip_samples"])
    f, t = flops.grid(cfg, frames)
    tokens = flops.tokens(cfg, frames, False)
    readings = {"enqueue_s": spans, "window_s": window_s, "units": n, "chips": 1,
                "model_flops_per_unit": b * flops.forward_flops(cfg, tokens, f * t),
                "attn": {"b": b, "n": tokens, "h": cfg["num_heads"], "d": cfg["embed_dim"] // cfg["num_heads"],
                         "calls_per_unit": cfg["depth"]}}
    tr = None
    if env.trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(T.WINDOW_SPAN):
                for i in range(p["trace_calls"]):
                    with record_function("bench.call"):  # names the host's share of the idle gaps
                        out = predictor(waves[(n + i) % k_pool])
                    with record_function("bench.to_host"):
                        out.cpu()
                harness.synchronize(dev)
        tr = T.Trace.from_profiler(prof, p["trace_calls"])
        readings["trace"] = tr
    peak = harness.memory_peak(dev)
    e2e = {"serve_clips_per_s": n * b / window_s,
           "serve_call_ms_p95": 1e3 * float(np.percentile(np.asarray(lat), 95)),
           "setup_s": setup_s}
    del predictor
    harness.release(dev)
    t_ref = time.perf_counter()
    refs = [reference.eval_logits(w, waves[k], cfg, cfg["mel"])
            for k in range(k_pool)]
    g = logit_gap(served, refs)
    checks = {k: (float(g[k]), float(cell.limits[k])) for k in cell.limits}
    shown = {k: v for k, v in g.items() if k not in cell.limits}
    shown["reference_s"] = time.perf_counter() - t_ref
    shown["setup_phases_s"] = phases.seconds()
    shown["calls_per_s_halves"] = harness.halves(stamps, t0, t1)
    return harness.Outcome(end_to_end=e2e, readings=readings, checks=checks, shown=shown, attempted=n, failed=0,
                           memory_peak_bytes=peak, trace=tr, busy_s=tr.busy_s if tr else None,
                           window_s=tr.window_s if tr else None, extra={"paths": paths})


def logit_gap(served, refs) -> dict:
    """The widest gap of a served logit from the reference's over every
    call, against the part of the reference logits that differs between
    clips: the root mean square of each batch's logits less their mean over
    its clips."""
    refs = [r.double().cpu() for r in refs]
    spread = [float((r - r.mean(0)).pow(2).mean().sqrt()) for r in refs]
    worst = 0.0
    for k, host in served:
        worst = max(worst, float((host.double() - refs[k]).abs().max()) / spread[k])
    return {"logit_gap": worst, "calls_compared": len(served)}
