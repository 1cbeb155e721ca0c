"""End-to-end training check on synthetic data (port of
scripts/convergence_demo.py): 50 log-spaced tones (100 Hz to 8 kHz, 1-s
clips at 32 kHz, 20 train and 4 test clips a class) through the ESC-50
recipe (CE + mixup + patchout + SpecAugment + warmup/rampdown schedule +
SWA) on a reduced PaSST (depth 4, dim 192, 6 heads) for 45 epochs. Chance
is 2%; it asserts a best accuracy above 0.9::

    python -m passt_tpu_torch.tools.convergence_demo [key=value ...]

Extra ``key=value`` arguments override the config. The reduced arch is set
in ``passt_tpu_torch.models.registry.ARCHS`` for the run only and put back
after. Runs on the card; ``run(..., device="cpu")`` runs on the CPU. Needs
h5py unless ``run`` is given the two containers (or wav folders).
"""

import contextlib
import dataclasses
import os
import sys
import tempfile
import time

import numpy as np

from passt_tpu_torch.config import apply_overrides

SR = 32000
FREQS = 100 * (8000 / 100) ** (np.arange(50) / 49)  # log-spaced 100..8000 Hz
ARCH = "passt_s_swa_p16_128_ap476"
#: the reduced PaSST the run trains (a registry override of ARCH)
REDUCED = dict(depth=4, embed_dim=192, num_heads=6)

#: the demo's config over the ESC-50 recipe's defaults (the containers'
#: paths are added by :func:`config`)
OVERRIDES = {
    "data.clip_length": "1",
    "data.batch_size": "25",
    "data.eval_batch_size": "50",
    "model.input_tdim": "98",
    "model.s_patchout_t": "2",
    "model.s_patchout_f": "1",
    "model.dtype": "bfloat16",
    "trainer.lr": "3e-4",
    "trainer.max_epochs": "45",
    "trainer.warm_up_len": "1",
    "trainer.ramp_down_start": "30",
    "trainer.ramp_down_len": "12",
    "trainer.swa_epoch_start": "30",
    "trainer.swa_freq": "1",
    "trainer.log_every_steps": "400",
    "mel.freqm": "8",
    "mel.timem": "8",
}


def make_split(n_per: int, seed: int) -> list:
    """``n_per`` clips of each of the 50 tones: (name, float32 wave, class
    index), a random phase and amplitude and 0.05 white noise each,
    shuffled; the draws of the script's ``make_split``, in its order."""
    r = np.random.default_rng(seed)
    items = []
    for c, f in enumerate(FREQS):
        for i in range(n_per):
            t = np.arange(SR) / SR
            phase = r.uniform(0, 2 * np.pi)
            amp = r.uniform(0.2, 0.8)
            wave = amp * np.sin(2 * np.pi * f * t + phase) + 0.05 * r.standard_normal(SR)
            items.append((f"c{c}_{i}.wav", wave.astype(np.float32), np.asarray(c)))
    r.shuffle(items)
    return items


def config(train: str, test: str, extra=()):
    """The ESC-50 recipe's config with :data:`OVERRIDES`, the two containers
    (or wav folders) and ``key=value`` strings ``extra``."""
    from passt_tpu_torch.experiments import EXPERIMENTS

    cfg = apply_overrides(EXPERIMENTS["esc50"].default_config,
                          dict(OVERRIDES, **{"data.train_hdf5": train, "data.eval_hdf5": test}))
    if extra:
        cfg = apply_overrides(cfg, dict(kv.split("=", 1) for kv in extra))
        print("extra overrides:", list(extra))
    return cfg


@contextlib.contextmanager
def reduced_arch():
    """:data:`REDUCED` in the registry's ARCH for the block's length."""
    from passt_tpu_torch.models import registry

    spec = registry.ARCHS[ARCH]
    registry.ARCHS[ARCH] = dataclasses.replace(spec, **REDUCED)
    try:
        yield
    finally:
        registry.ARCHS[ARCH] = spec


def run(extra=(), device="cuda", data=None) -> list:
    """Train the reduced PaSST on the tones; returns the epochs' records.
    ``data`` is (train, test): containers or wav folders of
    ``make_split(20, 1)`` and ``make_split(4, 2)`` already written; None
    packs them with ``pack_waveform_hdf5`` into a temporary directory."""
    from passt_tpu_torch.experiments import EXPERIMENTS

    with tempfile.TemporaryDirectory(prefix="convergence_demo_") as tmp:
        if data is None:
            from passt_tpu_torch.data.prepare import pack_waveform_hdf5

            data = (os.path.join(tmp, "train.h5"), os.path.join(tmp, "test.h5"))
            pack_waveform_hdf5(data[0], make_split(20, 1), packed_targets=False)
            pack_waveform_hdf5(data[1], make_split(4, 2), packed_targets=False)
        cfg = config(*data, extra)
        with reduced_arch():
            return EXPERIMENTS["esc50"].main(cfg, device=device)["history"]


def main(argv=None, device="cuda") -> list:
    argv = sys.argv[1:] if argv is None else argv
    t0 = time.time()
    h = run(argv, device=device)
    print(f"\nwall: {time.time() - t0:.0f}s")
    print("accuracy by epoch:", [round(r.get("accuracy", -1), 3) for r in h])
    print("swa accuracy final:", h[-1].get("swa_accuracy"))
    assert max(r.get("accuracy", 0) for r in h) > 0.9, "did not converge"
    print("CONVERGED")
    return h


if __name__ == "__main__":
    main()
