"""Export a PaSST inference artifact (``torch.export``; port of
scripts/export_inference.py).

One ``.passt.pt2`` file, weights baked in, a symbolic batch, loadable with
``torch`` and the kernels' custom ops and no model code, beside its
``.passt.json`` manifest. The program is traced on the card unless
``--device cpu`` asks for a CPU artifact::

    python -m passt_tpu_torch.tools.export_inference --arch passt_s_swa_p16_128_ap476 \\
        --checkpoint ported/passt_s_swa_p16_128_ap476.npz --out serving/passt_s

    # consume:
    from passt_tpu_torch.export import load_exported
    logits, features = load_exported("serving/passt_s")(wave_batch)
"""

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--arch", default="passt_s_swa_p16_128_ap476")
    p.add_argument("--ensemble", default=None,
                   help="export a published logit-averaged ensemble (one of "
                        "passt_tpu_torch.models.registry.ENSEMBLES) instead of --arch")
    p.add_argument("--checkpoint", default=None, help=".npz/.pt weights; omit for random weights (smoke/debug)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="for --ensemble: directory of <arch>.npz member weights")
    p.add_argument("--out", required=True, help="output prefix; writes <out>.passt.pt2 + <out>.passt.json")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="the device the program is traced on and runs on (default: the card)")
    p.add_argument("--seconds", type=float, default=None,
                   help="clip length; default = the arch's trained geometry (input_tdim*hop/sr)")
    p.add_argument("--batch", default="b", help='symbolic dim name (default "b" = any batch) or a fixed positive int')
    p.add_argument("--input-tdim", type=int, default=None,
                   help="override the arch spec's time grid (rarely needed)")
    p.add_argument("--n-classes", type=int, default=None)
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--no-bake-weights", action="store_true",
                   help="export fn(params, wave) + <out>.params.npz instead of baking the weights into "
                        "the program (one artifact serves any checkpoint of the arch)")
    args = p.parse_args(argv)

    from passt_tpu_torch.export import export_ensemble, export_inference

    overrides = {}
    if args.n_classes is not None:
        overrides["n_classes"] = args.n_classes
    if args.input_tdim is not None:
        overrides["input_tdim"] = args.input_tdim
    try:
        batch = int(args.batch)
        if batch < 1:
            p.error(f"--batch must be a positive int or a dimension name, got {args.batch!r}")
    except ValueError:
        if not args.batch.isidentifier():
            p.error(f"--batch must be a positive int or a dimension name, got {args.batch!r}")
        batch = args.batch
    if args.ensemble is not None:
        artifact, manifest = export_ensemble(
            args.ensemble,
            args.out,
            checkpoint_dir=args.checkpoint_dir,
            device=args.device,
            seconds=args.seconds,
            dtype=args.dtype,
            batch=batch,
            **overrides,
        )
    else:
        artifact, manifest = export_inference(
            args.arch,
            args.out,
            checkpoint_path=args.checkpoint,
            device=args.device,
            seconds=args.seconds,
            dtype=args.dtype,
            batch=batch,
            bake_weights=not args.no_bake_weights,
            **overrides,
        )
    print(f"wrote {artifact} ({os.path.getsize(artifact) / 1e6:.1f} MB) and {manifest}")
    return artifact, manifest


if __name__ == "__main__":
    main()
