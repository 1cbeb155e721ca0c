"""The published fine-tune protocol as one command (port of
scripts/finetune_rehearsal.py), with synthetic stand-ins for the two
artifacts it needs (the ported AudioSet checkpoint and the ESC-50 audio):

  1. a "pretrained" checkpoint in the ``.npz`` format (random values at
     PaSST-S's shapes, written with ``save_params_npz``)
  2. ESC-50-shaped containers (50 classes, single-label, 5-s clips, one
     tone a class: a learnable layout)
  3. ``esc50 main`` with ``model.pretrained=true``: the real CLI, full
     PaSST-S geometry, SWA from epoch 2, best-metric retention on accuracy
  4. SIGTERM mid-run: a clean, resumable exit (preemption)
  5. ``esc50 main trainer.resume=true``: "resumed from epoch N", trained to
     the end
  6. ``esc50 evaluate_only`` restoring the best checkpoint (and its SWA
     average) from ``trainer.checkpoint_dir``

The chain a user of the reference runs for the ESC-50 0.967 protocol
(train from pretrained weights with SWA, keep the best model, evaluate),
as one run; ``transcript.json`` in the work directory records it::

    python -m passt_tpu_torch.tools.finetune_rehearsal [--workdir /tmp/ft_rehearsal]

The phases run ``python -m passt_tpu_torch.cli esc50`` on the card; ``main``
takes another command prefix in ``cli`` (a CPU run, a shim with other data
openers), and :func:`hold_after_epoch` lets such a shim wait for the
SIGTERM, so that the signal lands mid-run whatever the epoch's length.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import signal
import subprocess
import sys
import time

import numpy as np

#: the epoch lines the phases' logs are read for, as the parent reads them
EPOCH_LINE = re.compile(r"^epoch=(\d+) ", re.M)


def synth_items(n: int, seconds: float = 5.0, sr: int = 32000, seed: int = 0):
    """``n`` 50-class single-label clips, (name, float32 wave, class index):
    the tone of class ``i % 50`` plus noise (learnable)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    for i in range(n):
        c = i % 50
        f = 200.0 + 60.0 * c
        wave = (0.25 * np.sin(2 * np.pi * f * t) + 0.05 * rng.standard_normal(t.shape)).astype(np.float32)
        yield (f"clip{i}.wav", wave, np.asarray(c))


def synth_container(path: str, n: int, seconds: float = 5.0, sr: int = 32000, seed: int = 0) -> None:
    """:func:`synth_items` packed into one container."""
    from passt_tpu_torch.data.prepare import pack_waveform_hdf5

    pack_waveform_hdf5(path, synth_items(n, seconds, sr, seed), sr, packed_targets=False)


def synth_pretrained(path: str, pcfg, seed: int = 123) -> None:
    """A "pretrained" ``.npz`` at the shapes of PaSST ``pcfg``: each leaf
    ``standard_normal(shape) * 0.02`` from one generator seeded ``seed``,
    drawn in the order of the '/'-joined keys sorted (the order in which
    ``jax.tree.map`` walks the flax tree), written with
    :func:`save_params_npz`. The model is built on the meta device: only
    its shapes are read."""
    import torch

    from passt_tpu_torch.models.passt import PaSST
    from passt_tpu_torch.models.pretrained import flax_from_state_dict, save_params_npz, state_dict_from_flax

    with torch.device("meta"):
        model = PaSST(pcfg)
    shapes = {k: np.zeros(tuple(p.shape), np.float32) for k, p in model.named_parameters()}
    leaves = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                leaves[prefix + (k,)] = v

    tree = flax_from_state_dict(shapes)
    walk(tree, ())
    rng = np.random.default_rng(seed)
    for key in sorted(leaves, key="/".join):
        node = tree
        for part in key[:-1]:
            node = node[part]
        node[key[-1]] = (rng.standard_normal(leaves[key].shape) * 0.02).astype(leaves[key].dtype)
    save_params_npz(path, state_dict_from_flax(tree))


def hold_after_epoch(k: int, timeout: float = 60.0) -> None:
    """In a CLI process the rehearsal runs: after this process prints its
    first line that the parent's poll reads as epoch ``>= k``, hold until a
    SIGTERM has been handled, for at most ``timeout`` seconds. The SIGTERM
    handler a later ``signal.signal`` call installs is wrapped to note the
    signal; stdout is wrapped to watch its lines."""
    got = []
    install = signal.signal

    def signal_(signum, handler):
        if signum == signal.SIGTERM and callable(handler):
            inner = handler

            def handler(s, frame):
                got.append(s)
                inner(s, frame)
        return install(signum, handler)

    signal.signal = signal_

    class Watch:
        def __init__(self, out):
            self.out, self.tail, self.held = out, "", False

        def write(self, s):
            self.out.write(s)
            self.tail += s
            *lines, self.tail = self.tail.split("\n")
            for line in lines:
                m = EPOCH_LINE.match(line)
                if m and int(m.group(1)) >= k and not self.held:
                    self.held = True
                    self.out.flush()
                    deadline = time.monotonic() + timeout
                    while not got and time.monotonic() < deadline:
                        time.sleep(0.05)
            return len(s)

        def __getattr__(self, name):
            return getattr(self.out, name)

    sys.stdout = Watch(sys.stdout)


def run_phase(cmd, log_path, sigterm_after_epoch=None, timeout=1800):
    """Run a CLI phase; optionally SIGTERM once `epoch=<k>` (k >= threshold)
    appears in the log. Returns (rc, log_text)."""
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    sent = False
    t0 = time.time()
    while proc.poll() is None:
        time.sleep(2.0)
        if time.time() - t0 > timeout:
            proc.kill()
            raise TimeoutError(f"phase timed out: {' '.join(cmd)}")
        if sigterm_after_epoch is not None and not sent:
            with open(log_path) as f:
                epochs = EPOCH_LINE.findall(f.read())
            if epochs and int(epochs[-1]) >= sigterm_after_epoch:
                proc.send_signal(signal.SIGTERM)
                sent = True
    with open(log_path) as f:
        text = f.read()
    return proc.returncode, text


def main(argv=None, cli=None) -> int:
    """The rehearsal; ``cli`` is the command prefix of the phases (default
    ``python -m passt_tpu_torch.cli esc50``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default="/tmp/ft_rehearsal")
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--sigterm-after-epoch", type=int, default=2)
    ap.add_argument("--train-clips", type=int, default=240)
    ap.add_argument("--eval-clips", type=int, default=100)
    ap.add_argument("--reuse", action="store_true")
    args = ap.parse_args(argv)

    wd = os.path.abspath(args.workdir)
    os.makedirs(wd, exist_ok=True)
    train_h5 = os.path.join(wd, "esc_train.h5")
    eval_h5 = os.path.join(wd, "esc_eval.h5")
    npz = os.path.join(wd, "pretrained.npz")
    ckpt_dir = os.path.join(wd, "ckpt")

    # ---- 1. the "pretrained" artifact in the .npz format ----------------
    from passt_tpu_torch.experiments.esc50 import experiment

    if not (args.reuse and os.path.exists(npz)):
        synth_pretrained(npz, experiment.default_config.passt_config())
        print(f"synthesized pretrained npz: {npz} ({os.path.getsize(npz)/1e6:.0f} MB)", flush=True)

    # ---- 2. ESC-50-shaped containers -------------------------------------
    if not (args.reuse and os.path.exists(train_h5)):
        synth_container(train_h5, args.train_clips, seed=0)
        synth_container(eval_h5, args.eval_clips, seed=1)
        print(f"packed {args.train_clips}/{args.eval_clips} train/eval clips")

    overrides = [
        f"data.train_hdf5={train_h5}",
        f"data.eval_hdf5={eval_h5}",
        "model.pretrained=true",
        f"model.checkpoint_path={npz}",
        f"trainer.max_epochs={args.epochs}",
        f"trainer.checkpoint_dir={ckpt_dir}",
        "trainer.monitor=accuracy",
        "trainer.lr=1e-4",  # synthetic task converges visibly at this lr;
        # the published recipe's 1e-5 is for real ESC-50 audio
    ]
    cli = list(cli) if cli is not None else [sys.executable, "-m", "passt_tpu_torch.cli", "esc50"]

    # ---- 3+4. fine-tune, preempted mid-run --------------------------------
    print("phase A: fine-tune with SIGTERM preemption ...", flush=True)
    rc, log_a = run_phase(
        cli + ["main", "with"] + overrides,
        os.path.join(wd, "phase_a.log"),
        sigterm_after_epoch=args.sigterm_after_epoch,
    )
    assert rc == 0, f"phase A rc={rc}\n{log_a[-3000:]}"
    assert f"loaded pretrained checkpoint: {npz}" in log_a, "npz not loaded"
    assert "exiting cleanly" in log_a, "no clean-preemption line"
    a_epochs = re.findall(r"^epoch=(\d+) .*?accuracy=([0-9.]+)", log_a, re.M)
    assert a_epochs, "phase A logged no epochs"

    # ---- 5. resume to completion ------------------------------------------
    print("phase B: resume ...", flush=True)
    rc, log_b = run_phase(
        cli + ["main", "with", "trainer.resume=true"] + overrides,
        os.path.join(wd, "phase_b.log"),
    )
    assert rc == 0, f"phase B rc={rc}\n{log_b[-3000:]}"
    m = re.search(r"resumed from epoch (\d+)", log_b)
    assert m, "phase B did not resume"
    resumed_from = int(m.group(1))
    assert resumed_from == int(a_epochs[-1][0]), (
        f"resumed from {resumed_from}, phase A completed {a_epochs[-1][0]}"
    )
    b_epochs = re.findall(r"^epoch=(\d+) .*?accuracy=([0-9.]+)", log_b, re.M)
    all_epochs = a_epochs + b_epochs
    assert int(all_epochs[-1][0]) == args.epochs - 1, "did not reach max_epochs"

    # ---- 6. evaluate_only with the retained-best checkpoint ---------------
    print("phase C: evaluate_only (best by accuracy) ...", flush=True)
    rc, log_c = run_phase(
        cli + ["evaluate_only", "with"] + overrides,
        os.path.join(wd, "phase_c.log"),
    )
    assert rc == 0, f"phase C rc={rc}\n{log_c[-3000:]}"
    m = re.search(r"restored best by 'accuracy' checkpoint \(epoch (\d+)\)", log_c)
    assert m, f"evaluate_only did not restore the best checkpoint\n{log_c[-2000:]}"
    best_epoch = int(m.group(1))
    accs = {int(e): float(a) for e, a in all_epochs}
    # tie-tolerant: whichever of the tied epochs was kept
    assert accs[best_epoch] == max(accs.values()), (
        f"restored epoch {best_epoch} (acc {accs[best_epoch]}), but the "
        f"best accuracy was {max(accs.values())} ({accs})"
    )
    m = re.search(r"(?<!swa_)'accuracy': ([0-9.e-]+)", log_c)
    final_acc = float(m.group(1))
    # the retained-best eval must reproduce the training-time metric for
    # that epoch (same eval set, deterministic eval path)
    assert abs(final_acc - accs[best_epoch]) < 1e-6, (final_acc, accs[best_epoch])
    swa_evaluated = "'swa_accuracy'" in log_c

    transcript = {
        "epochs": [{"epoch": int(e), "accuracy": float(a)} for e, a in all_epochs],
        "preempted_after_epoch": int(a_epochs[-1][0]),
        "resumed_from": resumed_from,
        "best_epoch": best_epoch,
        "evaluate_only_accuracy": final_acc,
        "swa_evaluated": swa_evaluated,
        "chance_accuracy": 1.0 / 50,
    }
    with open(os.path.join(wd, "transcript.json"), "w") as f:
        json.dump(transcript, f, indent=1)
    print(json.dumps(transcript))
    print("REHEARSAL OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
