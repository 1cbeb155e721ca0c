"""CLI entry: ``python -m passt_tpu_torch.cli <experiment> [command] [overrides...]``

Commands (same surface as the reference CLIs, README.md:154-175):
  main              train the recipe
  evaluate_only     run evaluation (mAP / accuracy)
  model_speed_test  training-throughput benchmark (specs/second)
  test_loaders      pull one batch from each loader
  print_config      dump the resolved config

and evaluate_ensemble, predict, test_loaders_train_speed,
print_named_configs and preload.

Overrides are dotted ``key=value`` pairs (``trainer.lr=1e-5``,
``data.batch_size=24``); named presets like ``mini_train`` apply bundles
(see passt_tpu_torch.config.PRESETS). The token ``with`` is accepted and
ignored for reference-CLI compatibility. The commands that run the model
run on the CUDA card; without one they raise.
"""

import sys


def run(argv) -> dict:
    """``<experiment> [command] [overrides...]``: the command's result."""
    argv = list(argv)
    from passt_tpu_torch.experiments import EXPERIMENTS
    from passt_tpu_torch.experiments.common import run_command

    name = argv.pop(0)
    if name not in EXPERIMENTS:
        raise SystemExit(f"unknown experiment {name!r}; available: {list(EXPERIMENTS)}")
    return run_command(EXPERIMENTS[name], argv)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        from passt_tpu_torch.experiments import EXPERIMENTS

        print(__doc__)
        print("experiments:", ", ".join(EXPERIMENTS))
        return 0
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
