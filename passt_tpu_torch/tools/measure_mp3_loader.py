"""mp3-container loader throughput through the worker pool (port of
scripts/measure_mp3_loader.py): ``test_loaders_train_speed`` on real 32 kHz
mono CBR mp3 containers (encoded in-process by libmp3lame), the AudioSet
recipe's two-container chain, with the native C++ batch plane and with the
numpy path::

    python -u -m passt_tpu_torch.tools.measure_mp3_loader [n_clips_per_container]

Needs h5py, libmp3lame and the native plane's libmpg123; runs on the host.
"""

import dataclasses
import os
import sys
import tempfile
import time

import numpy as np


def build_container(path, n_clips, seconds=10, rate=32000, seed=0):
    """``n_clips`` 527-class mp3 clips of white noise (one class each) in one
    container; a handful of distinct encodes, cycled: the decode cost per
    clip is the same, the encode time stays bounded."""
    from passt_tpu_torch.data.prepare import pack_bytes_hdf5
    from passt_tpu_torch.data.prepare.mp3enc import encode_mp3

    rng = np.random.default_rng(seed)
    items = []
    t0 = time.perf_counter()
    distinct = []
    for i in range(min(n_clips, 8)):
        wave = (rng.standard_normal(rate * seconds) * 0.1).astype(np.float32)
        distinct.append(encode_mp3(wave, rate))
    for i in range(n_clips):
        target = np.zeros(527)
        target[i % 527] = 1
        items.append((f"clip_{seed}_{i:04d}.mp3", distinct[i % len(distinct)], target))
    print(f"encoded {len(distinct)} x {seconds}s in {time.perf_counter()-t0:.1f}s")
    pack_bytes_hdf5(path, items, column="mp3", packed_targets=True, sample_rate=rate)


def main(argv=None) -> dict:
    """Both chains' two passes; returns {native: test_loaders_train_speed's result}."""
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else 64
    from passt_tpu_torch.experiments import EXPERIMENTS

    out = {}
    with tempfile.TemporaryDirectory() as td:
        bal, unbal = os.path.join(td, "bal.h5"), os.path.join(td, "unbal.h5")
        build_container(bal, n, seed=0)
        build_container(unbal, n, seed=1)

        base = EXPERIMENTS["audioset"].default_config
        for native_on in (True, False):
            data = dataclasses.replace(
                base.data,
                train_hdf5=bal,
                train_hdf5_extra=unbal,
                epoch_len=960,
                batch_size=12,
                native_loader=native_on,
                num_workers=os.cpu_count() or 1,
            )
            trainer = dataclasses.replace(base.trainer, limit_train_batches=None)
            cfg = dataclasses.replace(base, data=data, trainer=trainer)
            out[native_on] = EXPERIMENTS["audioset"].test_loaders_train_speed(cfg)
            print(f"native={native_on}: {out[native_on]}")
    return out


if __name__ == "__main__":
    main()
