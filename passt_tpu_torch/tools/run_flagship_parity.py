"""One-command flagship / fine-tune checkpoint parity oracle (port of
scripts/run_flagship_parity.py).

The day the published checkpoints are on disk, each oracle is one
invocation::

    # AudioSet flagship: expect mAP 0.476 (reference README.md:307-326,
    # models/passt.py:175-178 — passt-s-f128-p16-s10-ap.476-swa.pt)
    python -m passt_tpu_torch.tools.run_flagship_parity passt-s-f128-p16-s10-ap.476-swa.pt \\
        audioset_eval.h5

    # Fine-tune oracles (reference esc50/README.md:25, fsd50k/README.md:54-55,
    # models/passt.py:235-242):
    python -m passt_tpu_torch.tools.run_flagship_parity --esc50   esc50-...-fold1-acc.967.pt esc50_fold1_test.h5
    python -m passt_tpu_torch.tools.run_flagship_parity --fsd50k  fsd50k-....pt              fsd50k_eval.h5
    python -m passt_tpu_torch.tools.run_flagship_parity --openmic openmic2008....pt          openmic_test.h5

A ``.pt`` is ported to the ``.npz`` tree with the port's own functions
(``load_torch_checkpoint``, ``adapt_state_dict``, ``save_params_npz``),
evaluated through the same ``evaluate_only`` a user runs, and one JSON line
``{"mode":…, "metric":…, "value":…, "expected":…, "delta":…, "pass":…}``
is printed; the exit code is 0 iff |value - expected| <= tol.

Extra dotted ``key=value`` tokens are forwarded to ``evaluate_only`` (e.g.
``data.eval_batch_size=10`` ``trainer.limit_eval_batches=5`` for a smoke
run; limiting batches also turns the pass/fail gate off unless --expect is
given, since a truncated eval cannot reproduce a published number). Runs on
the card; ``main(..., device="cpu")`` runs on the CPU.
"""

import argparse
import json
import os
import sys

#: mode -> published-oracle wiring. ``metric`` is the key evaluate_only
#: reports for a single eval set (unprefixed); ``expect`` the published
#: number; ``tol`` the acceptance band (AP reproduction noise across eval
#: container re-encodes is ~1e-3; the band is deliberately tight).
MODES = {
    "audioset": dict(
        experiment="audioset",
        arch="passt_s_swa_p16_128_ap476",
        n_classes=527,
        metric="ap",
        expect=0.476,
        tol=0.003,
        provenance="reference README.md:307-326 (evaluate_only -> 0.476)",
    ),
    "esc50": dict(
        experiment="esc50",
        arch="passt_s_swa_p16_128_ap476",
        n_classes=50,
        metric="accuracy",
        expect=0.967,
        tol=0.005,
        provenance="reference esc50/README.md:25 (fold-1 accuracy 0.967)",
    ),
    "fsd50k": dict(
        experiment="fsd50k",
        arch="passt_s_swa_p16_128_ap476",
        n_classes=200,
        metric="ap",
        expect=0.655,
        tol=0.005,
        provenance="reference fsd50k/README.md:54-55 (eval-set mAP 0.655)",
    ),
    "openmic": dict(
        experiment="openmic",
        arch="openmic2008_passt_u_f128_p16_s10_ap85_swa",
        n_classes=20,
        metric="ap",
        expect=0.85,
        tol=0.005,
        provenance="reference models/passt.py:235-242 (OpenMIC mAP 0.85)",
    ),
}


def port_checkpoint(pt_path: str, npz_path: str, arch: str, n_classes: int) -> None:
    """A reference ``.pt`` -> the ``.npz`` tree of ``arch``: the state dict
    adapted to the arch's model (an ImageNet checkpoint's position grid, the
    patch conv's channels) and written with ``save_params_npz``."""
    from passt_tpu_torch.models.pretrained import adapt_state_dict, load_torch_checkpoint, save_params_npz
    from passt_tpu_torch.models.registry import ARCHS, get_model_config

    if arch not in ARCHS:
        raise SystemExit(f"unknown --arch {arch!r}; known: {sorted(ARCHS)}")
    spec = ARCHS[arch]
    stride = spec.expected_stride or (10, 10)
    cfg = get_model_config(arch=arch, n_classes=n_classes, fstride=stride[0], tstride=stride[1],
                           input_fdim=128, input_tdim=spec.input_tdim)
    sd = adapt_state_dict(load_torch_checkpoint(pt_path), cfg)
    os.makedirs(os.path.dirname(os.path.abspath(npz_path)), exist_ok=True)
    save_params_npz(npz_path, sd)
    n = sum(v.numel() for v in sd.values())
    print(f"ported {pt_path} -> {npz_path} ({n:,} params, arch {arch})")


def main(argv=None, device="cuda"):
    p = argparse.ArgumentParser(
        description=__doc__.splitlines()[0],
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    p.add_argument("checkpoint", help=".pt torch checkpoint (or already-ported .npz)")
    p.add_argument("eval_hdf5", help="packed eval HDF5 (see passt_tpu_torch.data.prepare)")
    g = p.add_mutually_exclusive_group()
    for m in MODES:
        if m != "audioset":
            g.add_argument(f"--{m}", dest="mode", action="store_const", const=m)
    p.set_defaults(mode="audioset")
    p.add_argument("--arch", default=None, help="override the mode's registry arch")
    p.add_argument(
        "--expect", type=float, default=None, help="override the published number"
    )
    p.add_argument("--tol", type=float, default=None, help="override the acceptance band")
    p.add_argument(
        "--out-npz",
        default=None,
        help="where to keep the ported tree (default: alongside the .pt)",
    )
    p.add_argument(
        "overrides",
        nargs="*",
        help="extra dotted key=value overrides forwarded to evaluate_only",
    )
    args = p.parse_args(argv)
    spec = dict(MODES[args.mode])
    if args.arch:
        spec["arch"] = args.arch
    expect = args.expect if args.expect is not None else spec["expect"]
    tol = args.tol if args.tol is not None else spec["tol"]

    if not os.path.exists(args.checkpoint):
        raise SystemExit(f"checkpoint not found: {args.checkpoint}")
    if not os.path.exists(args.eval_hdf5):
        raise SystemExit(f"eval HDF5 not found: {args.eval_hdf5}")

    # 1. port (skipped when already handed a ported .npz)
    if args.checkpoint.endswith(".npz"):
        npz = args.checkpoint
    else:
        npz = args.out_npz or (os.path.splitext(args.checkpoint)[0] + ".ported.npz")
        port_checkpoint(args.checkpoint, npz, spec["arch"], spec["n_classes"])

    # 2. evaluate through the public command surface — the exact chain a
    # user of `python -m passt_tpu_torch.cli <exp> evaluate_only` runs.
    from passt_tpu_torch.experiments import EXPERIMENTS
    from passt_tpu_torch.experiments.common import run_command

    cmd = [
        "evaluate_only",
        f"model.arch={spec['arch']}",
        f"model.n_classes={spec['n_classes']}",
        "model.pretrained=true",
        f"model.checkpoint_path={npz}",
        f"data.eval_hdf5={args.eval_hdf5}",
    ] + list(args.overrides)
    metrics = run_command(EXPERIMENTS[spec["experiment"]], cmd, device=device)

    metric_key = spec["metric"]
    if metric_key not in metrics:
        raise SystemExit(
            f"evaluate_only reported no {metric_key!r} (got {sorted(metrics)})"
        )
    value = float(metrics[metric_key])

    # A truncated eval (limit_eval_batches) cannot reproduce a published
    # number — report but don't gate, unless the caller pinned --expect.
    truncated = any(o.startswith("trainer.limit_eval_batches=") for o in args.overrides)
    gated = args.expect is not None or not truncated
    ok = abs(value - expect) <= tol
    print(
        json.dumps(
            {
                "mode": args.mode,
                "metric": metric_key,
                "value": round(value, 5),
                "expected": expect,
                "delta": round(value - expect, 5),
                "tol": tol,
                "pass": bool(ok) if gated else None,
                "gated": gated,
                "provenance": spec["provenance"],
                "ported_npz": npz,
            }
        )
    )
    if gated and not ok:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
