"""Full-size PaSST-S from-scratch training on a learnable task (port of
scripts/fullsize_train_demo.py): 50 log-spaced tones (100 Hz to 8 kHz,
1-s clips at 32 kHz, 10 train and 3 test clips a class) packed with
:func:`passt_tpu_torch.data.prepare.pack_waveform_hdf5`, then the complete
AudioSet recipe (class-balanced weighted sampler + wavmix + roll + gain +
batch mixup + SpecAugment + SWA + warmup/rampdown) for 12 epochs of 41
steps. Prints the ap of each epoch and the final SWA ap::

    python -m passt_tpu_torch.tools.fullsize_train_demo [key=value ...]

Extra ``key=value`` arguments override the config (e.g.
``trainer.opt_moments_dtype=bfloat16_sr``). Runs on the card; ``main(...,
device="cpu")`` runs on the CPU. Needs h5py.
"""

import os
import sys
import tempfile
import time

import numpy as np

from passt_tpu_torch.config import apply_overrides
from passt_tpu_torch.data.prepare import pack_waveform_hdf5

SR = 32000
FREQS = 100 * (8000 / 100) ** (np.arange(50) / 49)

#: the demo's config over the AudioSet recipe's defaults (the containers'
#: paths are added by :func:`config`)
OVERRIDES = {
    "model.n_classes": "50",
    "model.input_tdim": "98",
    "model.s_patchout_t": "2",
    "model.s_patchout_f": "1",
    "data.num_classes": "50",
    "data.clip_length": "1",
    "data.batch_size": "12",
    "data.eval_batch_size": "50",
    "data.epoch_len": "500",
    "data.weighted_sampler": "true",
    "mel.freqm": "8", "mel.timem": "8",
    "trainer.lr": "1e-4",
    "trainer.max_epochs": "12",
    "trainer.warm_up_len": "2",
    "trainer.ramp_down_start": "8",
    "trainer.ramp_down_len": "4",
    "trainer.swa_epoch_start": "8",
    "trainer.swa_freq": "1",
    "trainer.log_every_steps": "40",
}


def make_items(n_per: int, seed: int) -> list:
    """``n_per`` clips of each of the 50 tones: (name, float32 wave, one-hot
    target), a random amplitude and phase and 0.05 white noise each,
    shuffled; the draws of the script's ``split``."""
    r = np.random.default_rng(seed)
    items = []
    for c, f in enumerate(FREQS):
        for i in range(n_per):
            t = np.arange(SR) / SR
            w = r.uniform(0.2, 0.8) * np.sin(2 * np.pi * f * t + r.uniform(0, 2 * np.pi)) \
                + 0.05 * r.standard_normal(SR)
            y = np.zeros(50)
            y[c] = 1
            items.append((f"c{c}_{i}.wav", w.astype(np.float32), y))
    r.shuffle(items)
    return items


def config(train: str, test: str, extra=()):
    """The AudioSet recipe's config with :data:`OVERRIDES`, the two
    containers (or wav folders) and ``key=value`` strings ``extra``."""
    from passt_tpu_torch.experiments import EXPERIMENTS

    cfg = apply_overrides(EXPERIMENTS["audioset"].default_config,
                          dict(OVERRIDES, **{"data.train_hdf5": train, "data.eval_hdf5": test}))
    if extra:
        cfg = apply_overrides(cfg, dict(kv.split("=", 1) for kv in extra))
        print("extra overrides:", list(extra))
    return cfg


def main(argv=None, device="cuda") -> dict:
    """Pack the items, train and print the ap by epoch; returns the
    recipe's result (``history`` holds each epoch's record)."""
    from passt_tpu_torch.experiments import EXPERIMENTS

    argv = sys.argv[1:] if argv is None else argv
    with tempfile.TemporaryDirectory(prefix="fullsize_demo_") as tmp:
        train, test = os.path.join(tmp, "train.h5"), os.path.join(tmp, "test.h5")
        pack_waveform_hdf5(train, make_items(10, 1))
        pack_waveform_hdf5(test, make_items(3, 2))
        cfg = config(train, test, argv)
        t0 = time.time()
        res = EXPERIMENTS["audioset"].main(cfg, device=device)
    h = res["history"]
    print(f"wall {time.time() - t0:.0f}s; ap by epoch:", [round(r.get("ap", -1), 3) for r in h])
    print("final swa_ap:", h[-1].get("swa_ap"))
    return res


if __name__ == "__main__":
    main()
