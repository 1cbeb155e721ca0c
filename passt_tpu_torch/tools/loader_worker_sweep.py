"""Worker-count sweep of the AudioSet recipe's two-container loader chain
(port of scripts/loader_worker_sweep.py)::

    python -u -m passt_tpu_torch.tools.loader_worker_sweep [n_clips_per_container] [workers,...]

Prints clips/s and the parallel efficiency per worker count for the native
C++ plane and the numpy path, on real 32 kHz CBR mp3 two-container chains
(weighted sampler + mp3 decode + gain/roll + wavmix + packed targets: the
``audioset main`` path). The loader pool is threads (the native plane
releases the interpreter lock inside its decode, the numpy path does not),
so how it scales with workers is measured here, not assumed. Needs h5py,
libmp3lame and the native plane's libmpg123; runs on the host.
"""

import dataclasses
import os
import sys
import tempfile

from passt_tpu_torch.tools.measure_mp3_loader import build_container


def sweep(n_clips=64, worker_counts=None, native_modes=(True, False)) -> dict:
    """{native: {workers: the warm pass's clips/s}}, with the table printed."""
    from passt_tpu_torch.experiments import EXPERIMENTS

    cores = os.cpu_count() or 1
    if worker_counts is None:
        worker_counts = [w for w in (1, 2, 4, 8, 16) if w <= 2 * cores]
    results = {}
    with tempfile.TemporaryDirectory() as td:
        bal, unbal = os.path.join(td, "bal.h5"), os.path.join(td, "unbal.h5")
        build_container(bal, n_clips, seed=0)
        build_container(unbal, n_clips, seed=1)

        base = EXPERIMENTS["audioset"].default_config
        for native_on in native_modes:
            per_worker = {}
            for w in worker_counts:
                data = dataclasses.replace(
                    base.data,
                    train_hdf5=bal,
                    train_hdf5_extra=unbal,
                    epoch_len=8 * n_clips,
                    batch_size=12,
                    native_loader=native_on,
                    num_workers=w,
                )
                cfg = dataclasses.replace(
                    base,
                    data=data,
                    trainer=dataclasses.replace(base.trainer, limit_train_batches=None),
                )
                out = EXPERIMENTS["audioset"].test_loaders_train_speed(cfg)
                per_worker[w] = out["pass2_clips_per_s"]  # warm pass
            base_rate = per_worker[worker_counts[0]] / worker_counts[0]
            print(f"\nnative={native_on} ({cores} cores):")
            print("  workers  clips/s  efficiency-vs-linear")
            for w, rate in per_worker.items():
                eff = rate / (base_rate * w)
                print(f"  {w:7d}  {rate:7.1f}  {eff:.2f}")
            results[native_on] = per_worker
    return results


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if argv else 64
    ws = [int(x) for x in argv[1].split(",")] if len(argv) > 1 else None
    return sweep(n, ws)


if __name__ == "__main__":
    main()
