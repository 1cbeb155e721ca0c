"""Multi-seed quality check of the production defaults (port of
scripts/multiseed_quality.sh): 3 seeds x {production, fp32 moments + erf
GELU} of ``passt_tpu_torch.tools.fullsize_train_demo`` (full-size PaSST-S,
the AudioSet recipe, the 50-tone task, 12 epochs), each run cut at 1800 s;
the last 3 lines of each run's output are appended to ``$OUT`` (default
/tmp/multiseed_quality.log), then "ALL DONE"::

    OUT=/tmp/multiseed_quality.log python -m passt_tpu_torch.tools.multiseed_quality
"""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
SEEDS = (0, 1, 2)
#: each arm's overrides: the production defaults, and the reference's fp32
#: optimizer moments with erf GELU
ARMS = {"prod": [], "ref": ["trainer.opt_moments_dtype=null", "model.gelu=erf"]}


def runs() -> list:
    """(seed, arm, argument list) of the six runs, seed by seed, prod before ref."""
    return [(seed, arm, [sys.executable, "-m", "passt_tpu_torch.tools.fullsize_train_demo",
                         f"trainer.seed={seed}"] + ARMS[arm]) for seed in SEEDS for arm in ARMS]


def commands() -> list:
    """The six runs' argument lists."""
    return [cmd for _, _, cmd in runs()]


def main() -> int:
    out = os.environ.get("OUT", "/tmp/multiseed_quality.log")
    for seed, arm, cmd in runs():
        with open(out, "a") as f:
            f.write(f"=== seed={seed} arm={arm} ===\n")
        try:
            text = subprocess.run(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  timeout=1800).stdout
        except subprocess.TimeoutExpired as e:
            text = e.output or b""
        tail = text.decode(errors="replace").splitlines(keepends=True)[-3:]
        with open(out, "a") as f:
            f.writelines(tail)
    with open(out, "a") as f:
        f.write("ALL DONE\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
