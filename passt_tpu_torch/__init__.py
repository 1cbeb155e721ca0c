"""passt_tpu_torch — the PyTorch/CUDA port of passt_tpu for NVIDIA Hopper.

It mirrors the JAX package's module names and keeps its numerics; every
Pallas kernel the JAX package runs on a TPU becomes a kernel written by hand
for Hopper (``csrc/``), built with ``nvcc`` at first use, with a plain
PyTorch version beside it that CPU tensors take. It imports ``torch`` and
never ``jax``.

Layout
------
- ``passt_tpu_torch.ops``    : STFT/mel frontend and attention, with the
  mel and attention kernels (``ops/_build.py`` builds and binds them)
- ``passt_tpu_torch.models`` : the PaSST transformer, arch registry, weights
- ``passt_tpu_torch.hear``   : the waveform-in ``Predictor`` and the HEAR API
- ``passt_tpu_torch.data``   : datasets, samplers, the loader and the
  pinned side-stream feed to the card
- ``passt_tpu_torch.train``  : the train and eval steps, losses, mixup,
  schedules, the AdamW variants, metrics, SWA and the loop (``evaluate``,
  ``fit``, checkpoints; the attention backward kernel runs under the train
  step)
- ``passt_tpu_torch.graphs`` : CUDA graphs of the train step, the eval
  step and the ``Predictor``, the counterpart of ``jax.jit``
- ``passt_tpu_torch.bench``  : training throughput on the card
  (``python3 -m passt_tpu_torch.bench``)
- ``passt_tpu_torch.config``, ``.experiments``, ``.cli`` : the typed
  experiment config, the recipes and their commands, and
  ``python -m passt_tpu_torch.cli <experiment> [command] [overrides]``
- ``passt_tpu_torch.utils``  : parameter counts

Entry points put their models on the card unless the caller asks for the
CPU (``device="cpu"``), and run there as CUDA graphs unless the caller asks
for ``jit=False``; ``fit``/``evaluate`` run where the state's tensors
live. DDP and export are queued in ROADMAP.md.
"""

__version__ = "0.1.0"


def __getattr__(name):
    if name in ("PaSST", "PaSSTConfig", "get_model"):
        from passt_tpu_torch import models

        return getattr(models, name)
    if name == "Predictor":
        from passt_tpu_torch.hear import Predictor

        return Predictor
    if name in ("MelConfig", "log_mel_spectrogram"):
        from passt_tpu_torch import ops

        return getattr(ops, name)
    raise AttributeError(f"module 'passt_tpu_torch' has no attribute {name!r}")
