"""Readings of the checks' control and of planted faults at a cell's own
size, for setting and testing the limits (``tests/test_bench_control.py``
runs them on the card).

The control is the reference put in the program's place at the nearest
precision below the configurations' bf16: float8 e4m3 products. The
faults are planted in the reference put in the program's place: the loss
taken over half the batch (a training cell), over one card's share (the
exchange between cards left out), the bf16 leaves stored with a
nearest-rounded add instead of SR, one served answer altered, and half of
a served batch left out.
"""

from __future__ import annotations

import torch

from benchmark.lib import harness, reference, weights as Wt


def train_readings(cell, seed: int, device) -> dict:
    """Each planted side's compared numbers against the fp32 reference:
    ``control``, ``half_batch``, ``nearest_apply`` and, on several cards,
    ``no_exchange``."""
    traffic = harness.traffic_module(cell)
    p, cfg = cell.params, cell.config
    total = p["batch_per_chip"] * cell.chips
    w = Wt.make_weights(cfg, seed, device)
    waves, targets = Wt.make_clips(seed, p["pool_batches"], total, p["clip_samples"], cfg["num_classes"],
                                   p["target_rate"], device, cfg["mel"]["sr"])
    step_seed = harness.sub_seed(seed, "steps")
    storage = {k: torch.bfloat16 if len(s) >= 2 and p["param_dtype"] == "bfloat16_sr" else torch.float32
               for k, s in reference.param_shapes(cfg).items()}
    ref = traffic.reference_steps(cell, w, waves, targets, step_seed, device)
    sides = {"control": dict(low=True), "half_batch": dict(loss_rows=total // 2)}
    if cell.chips > 1:
        sides["no_exchange"] = dict(loss_rows=p["batch_per_chip"])
    out = {}
    for name, kw in sides.items():
        losses, grad1, updates, params = traffic.reference_steps(cell, w, waves, targets, step_seed, device, **kw)
        change = {}
        for k in w:
            if storage[k] == torch.bfloat16:
                change[k] = reference.expected_sr_norm(w[k], updates[k])
            else:
                change[k] = float((params[k] - w[k]).norm())
        out[name] = traffic.gaps(w, storage, losses, grad1, change, *ref)
        del updates, params
    # the reference's own steps, each bf16 leaf's fp32 sum stored to nearest
    ref_losses, ref_grad1, ref_updates, ref_params = ref
    change = {}
    for k in w:
        if storage[k] == torch.bfloat16:
            p_k = w[k].float()
            for u in ref_updates[k]:
                p_k = (p_k + u).to(torch.bfloat16).float()
            change[k] = float((p_k - w[k]).norm())
        else:
            change[k] = float((ref_params[k] - w[k]).norm())
    out["nearest_apply"] = traffic.gaps(w, storage, ref_losses, ref_grad1, change, *ref)
    return out


def serve_readings(cell, seed: int, device) -> dict:
    """The control's logit gap, and the gaps of one answer altered (one
    clip's logits taken from another clip) and of half the batch left out
    (its second half's logits those of the first)."""
    traffic = harness.traffic_module(cell)
    p, cfg = cell.params, cell.config
    w = Wt.make_weights(cfg, seed, device)
    waves, _ = Wt.make_clips(seed, p["pool_batches"], p["batch"], p["clip_samples"], cfg["num_classes"], 0.0,
                             device, cfg["mel"]["sr"])
    ref = reference.eval_logits(w, waves[0], cfg, cfg["mel"]).cpu()
    low = reference.eval_logits(w, waves[0], cfg, cfg["mel"], low=True).cpu()
    altered = ref.clone()
    altered[0] = ref[1]
    half = ref.clone()
    h = ref.shape[0] // 2
    half[h: 2 * h] = ref[:h]
    return {name: traffic.logit_gap([(0, x)], [ref]) for name, x in
            (("control", low), ("answer_altered", altered), ("half_batch", half))}
