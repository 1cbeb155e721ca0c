"""The recipes (port of passt_tpu/experiments): AudioSet, ESC-50, FSD50K and
OpenMIC, each an :class:`Experiment` with the JAX package's default config,
run by ``python -m passt_tpu_torch.cli <experiment> [command] [...]``."""

from passt_tpu_torch.experiments.common import Experiment, run_command

from passt_tpu_torch.experiments import audioset, esc50, fsd50k, openmic

EXPERIMENTS = {
    "audioset": audioset.experiment,
    "esc50": esc50.experiment,
    "fsd50k": fsd50k.experiment,
    "openmic": openmic.experiment,
}

__all__ = ["Experiment", "run_command", "EXPERIMENTS"]
