"""Worker for tests/test_torch_parallel.py: one rank of a two-process gloo
job on the CPU, started with torchrun's environment (WORLD_SIZE, RANK,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT).

Usage: python _torch_parallel_worker.py <outdir>

It runs, in one process group (``passt_tpu_torch.parallel``):
- "steps": two data-parallel train steps with the step's own draws (iid
  SpecAugment masks, mixup, dropout, drop-path), then the same under
  ``grad_accum=2``;
- "jax": two steps from the JAX package's initial weights
  (``<outdir>/jax_init.npz``) with the draws injected as the parent injects
  them into the JAX mesh step;
- "gather": the eval gather on unequal and on empty rank shards, and
  ``evaluate`` on rank slices;
- "sampler": the weighted sampler's rank slice;
- "fit": ``audioset main`` through ``run_command`` at ``trainer.n_data=2``
  on the parent's HDF5 containers (checkpoints, eval), a resume, and a run
  that rank 1 alone gets a SIGTERM in.

Results land in ``<outdir>/rank<r>.npz`` and ``<outdir>/rank<r>.json``.

Usage for tensor parallelism (tests/test_torch_tensor_parallel.py):
``python _torch_parallel_worker.py <outdir> tp <n_model>``, in a group of
``n_data * n_model`` processes. It runs:
- "steps": two train steps of each config of ``TP_CONFIGS`` through a
  ``DDPRuntime`` with the model axis, then gathers the full parameters;
  each rank's parameter bytes and names;
- "eval": ``evaluate`` of the step-0 parameters on rank slices (the model
  ranks of a data rank read the same rows);
- "fit" (world 2 only): ``audioset main`` through ``run_command`` at
  ``trainer.n_model=2`` on the parent's HDF5 containers, and a resume.

Nothing here imports jax.
"""

import dataclasses
import json
import os
import signal
import sys

import numpy as np
import torch

from passt_tpu_torch.parallel import DataParallel, init_process_group
from passt_tpu_torch.parallel.runtime import DDPRuntime

TINY = dict(input_fdim=32, input_tdim=50, embed_dim=64, depth=2, num_heads=4, num_classes=8,
            s_patchout_t=1, s_patchout_f=1)
GLOBAL_B = 4


def batch(world, rank):
    """Rows [rank * B, (rank + 1) * B) of the global batch of 4."""
    g = np.random.default_rng(7)
    wave = g.standard_normal((GLOBAL_B, 16000)).astype(np.float32)
    target = (g.uniform(size=(GLOBAL_B, 8)) < 0.3).astype(np.float32)
    b = GLOBAL_B // world
    return {"wave": torch.from_numpy(wave[rank * b:(rank + 1) * b]),
            "target": torch.from_numpy(target[rank * b:(rank + 1) * b])}


def run_steps(out, world, rank, cfg_kw, mel_kw, prefix, params=None, grad_accum=1, steps=2):
    from passt_tpu_torch.models.passt import PaSSTConfig
    from passt_tpu_torch.ops.frontend import MelConfig
    from passt_tpu_torch.train.steps import TrainState, create_train_state, make_optimizer, make_train_step

    tx = make_optimizer(lr=1e-3, steps_per_epoch=2, grad_accum=grad_accum)
    model, state = create_train_state(PaSSTConfig(**cfg_kw), tx, torch.Generator().manual_seed(0), device="cpu")
    if params is not None:
        state = TrainState(params=params, opt_state=tx.init(params), step=0)
    step = make_train_step(model, tx, MelConfig(**mel_kw), data_parallel=DataParallel(world, rank))
    for s in range(1, steps + 1):
        state, metrics = step(state, batch(world, rank), 42)
        out[f"{prefix}s{s}_loss"] = metrics["loss"].numpy()
        for k, p in state.params.items():
            out[f"{prefix}s{s}_{k}"] = p.numpy().copy()


class ShardLoader:
    """Rows of a global stream of batches (deterministic in epoch and
    step), rank r taking rows [r * B, (r + 1) * B); ``ragged_last`` cuts
    the last batch to a per-rank row count; ``sigterm_at`` = (epoch, batch)
    sends this process a SIGTERM there."""

    def __init__(self, n_batches, rank, world, ragged_last=None, sigterm_at=None):
        self.n_batches, self.rank, self.world = n_batches, rank, world
        self.ragged_last, self.sigterm_at = ragged_last, sigterm_at
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return self.n_batches

    def __iter__(self):
        b = GLOBAL_B // self.world
        for i in range(self.n_batches):
            if self.sigterm_at == (self.epoch, i):
                os.kill(os.getpid(), signal.SIGTERM)
            g = np.random.default_rng(1000 * self.epoch + i)
            wave = g.standard_normal((GLOBAL_B, 16000)).astype(np.float32)[self.rank * b:(self.rank + 1) * b]
            target = (g.uniform(size=(GLOBAL_B, 8)) < 0.3).astype(np.float32)[self.rank * b:(self.rank + 1) * b]
            if self.ragged_last is not None and i == self.n_batches - 1:
                k = self.ragged_last[self.rank]
                wave, target = wave[:k], target[:k]
            yield {"wave": wave, "target": target}


def main():
    outdir = sys.argv[1]
    world, rank, device = init_process_group("cpu", timeout_s=60)
    runtime = DDPRuntime(world, rank, device)
    out, info = {}, {"world": world, "rank": rank}

    # --- steps: the step's own draws, every per-example one on
    import passt_tpu_torch.models.passt as passt_mod
    import passt_tpu_torch.ops.frontend as frontend_mod
    import passt_tpu_torch.train.steps as steps_mod

    cfg_a = dict(TINY, drop_rate=0.1, drop_path_rate=0.1, attn_impl="fused")
    mel_a = dict(n_mels=32, freqm=4, timem=8, iid_masks=True)
    run_steps(out, world, rank, cfg_a, mel_a, "a_")
    run_steps(out, world, rank, cfg_a, mel_a, "acc_", grad_accum=2)

    # --- jax: injected draws, the JAX package's initial weights
    def np_mask(b, size, p, iid):
        rng = np.random.default_rng(size)
        n = b if iid else 1
        width = np.floor(rng.uniform(size=(n, 1)) * p)
        start = np.floor(rng.uniform(size=(n, 1)) * (size - width))
        idx = np.arange(size)[None, :]
        return np.broadcast_to((idx >= start) & (idx < start + width), (b, size)).copy()

    saved = frontend_mod._axis_mask, passt_mod._sorted_keep_indices, steps_mod.sample_mixup
    perm, lam = np.array([2, 0, 3, 1]), np.array([0.7, 0.55, 0.9, 0.62], np.float32)
    frontend_mod._axis_mask = lambda gen, b, size, p, iid: torch.from_numpy(np_mask(b, size, p, iid))
    passt_mod._sorted_keep_indices = lambda gen, size, keep: torch.from_numpy(
        np.sort(np.random.default_rng(1000 * size + keep).permutation(size)[:keep]))
    steps_mod.sample_mixup = lambda gen, b, a: (torch.from_numpy(perm[:b]), torch.from_numpy(lam[:b]))
    try:
        with np.load(os.path.join(outdir, "jax_init.npz")) as data:
            params = {k: torch.from_numpy(data[k]) for k in data.files}
        run_steps(out, world, rank, dict(TINY, attn_impl="fused"),
                  dict(n_mels=32, freqm=4, timem=8, iid_masks=True, fmin_aug_range=1, fmax_aug_range=1),
                  "j_", params=params)
    finally:
        frontend_mod._axis_mask, passt_mod._sorted_keep_indices, steps_mod.sample_mixup = saved

    # --- gather: unequal shards, an empty shard, and evaluate on rank slices
    from passt_tpu_torch.train.loop import _gather_across_processes, evaluate

    n = 7 if rank == 0 else 5
    rng = np.random.default_rng(100 + rank)
    local = (rng.standard_normal((n, 4)).astype(np.float32), (rng.uniform(size=(n, 4)) < 0.4).astype(np.float32),
             rng.standard_normal(n).astype(np.float32))
    out.update(out_local=local[0], target_local=local[1], loss_local=local[2])
    g = _gather_across_processes(*local, runtime)
    out.update(g_out=g[0], g_target=g[1], g_loss=g[2])
    empty = np.zeros((0,), np.float32)
    g = _gather_across_processes(*(local if rank == 0 else (empty, empty, empty)), runtime)
    out.update(ge_out=g[0], ge_target=g[1], ge_loss=g[2])

    from passt_tpu_torch.models.passt import PaSST, PaSSTConfig, init_weights
    from passt_tpu_torch.ops.frontend import MelConfig
    from passt_tpu_torch.train.steps import make_eval_step

    model = PaSST(PaSSTConfig(**TINY))
    init_weights(model, torch.Generator().manual_seed(0))
    eval_step = make_eval_step(model, MelConfig(n_mels=32))
    params = {k: p.detach() for k, p in model.named_parameters()}
    # 3 batches of a global 4, the last one ragged: 6 rows on rank 0, 5 on rank 1
    loader = ShardLoader(3, rank, world, ragged_last={0: 2, 1: 1})
    info["eval"] = evaluate(eval_step, params, loader, device_prefetch=0, runtime=runtime)
    # rank 1 with no rows at all
    info["eval_empty"] = evaluate(eval_step, params, loader if rank == 0 else [], device_prefetch=0,
                                  runtime=runtime)

    # --- sampler: the weighted sampler's rank slice
    from passt_tpu_torch.data.sampler import WeightedEpochSampler

    sampler = WeightedEpochSampler(np.linspace(0.5, 2.0, 40), epoch_len=20, num_replicas=world, rank=rank, seed=9)
    sampler.set_epoch(2)
    out["indices"] = np.asarray(list(sampler), np.int64)

    # --- fit: audioset main at n_data=2 through run_command, a resume, and
    # a SIGTERM on rank 1 alone
    import passt_tpu_torch.experiments.common as common
    import passt_tpu_torch.models.registry as registry
    import passt_tpu_torch.train.loop as loop_mod
    from passt_tpu_torch.experiments import EXPERIMENTS

    with open(os.path.join(outdir, "argv.json")) as f:
        argv = json.load(f)
    exp = EXPERIMENTS["audioset"]
    arch = exp.default_config.model.arch
    registry.ARCHS[arch] = dataclasses.replace(registry.ARCHS[arch], depth=2, embed_dim=64, num_heads=4)
    saves = []
    real_save = loop_mod._CheckpointManager.save
    loop_mod._CheckpointManager.save = lambda self, epoch, payload: saves.append(epoch) or real_save(
        self, epoch, payload)
    fits = []
    real_fit = common.fit
    common.fit = lambda **kw: fits.append(real_fit(**kw)) or fits[-1]
    first = common.run_command(exp, ["main", "with"] + argv, device="cpu")
    resumed = common.run_command(exp, ["main", "with"] + argv + ["trainer.resume=true", "trainer.max_epochs=3"],
                                 device="cpu")
    info["fit"] = {"history": first["history"], "resumed": resumed["history"], "saves": saves}
    for k, p in fits[-1].state.params.items():
        out[f"fit_{k}"] = p.numpy().copy()

    # SIGTERM on rank 1 alone, at epoch 1's second batch: both ranks stop
    # at the same batch boundary
    from passt_tpu_torch.train.loop import MetricsLogger, fit
    from passt_tpu_torch.train.steps import create_train_state, make_optimizer, make_train_step

    tx = make_optimizer(lr=1e-3, steps_per_epoch=3)
    model, state = create_train_state(PaSSTConfig(**TINY), tx, torch.Generator().manual_seed(0), device="cpu")
    step = make_train_step(model, tx, MelConfig(n_mels=32), data_parallel=DataParallel(world, rank))
    res = fit(train_step=step, eval_step=make_eval_step(model, MelConfig(n_mels=32)), state=state,
              train_loader=ShardLoader(3, rank, world, sigterm_at=(1, 1) if rank == 1 else None),
              max_epochs=3, seed=42, log_every_steps=1, logger=MetricsLogger(quiet=True), runtime=runtime,
              handle_sigterm=True)
    info["sigterm"] = {"interrupted": res.interrupted, "step": res.state.step, "epochs": len(res.history)}

    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(info, f)
    torch.distributed.destroy_process_group()
    print(f"rank {rank} done", flush=True)


#: name -> (config, moments dtype) of the tensor-parallel steps
TP_CONFIGS = {
    "loop": (dict(TINY, drop_rate=0.1, drop_path_rate=0.1, attn_impl="fused"), None),
    "scan": (dict(TINY, attn_impl="fused", blocks_impl="scan"), None),
    "stacked": (dict(TINY, attn_impl="fused", blocks_impl="stacked"), None),
    "sr": (dict(TINY, attn_impl="fused"), "bfloat16_sr"),
    "fuse": (dict(TINY, attn_impl="fused", fuse_ln_qkv=True), None),
}
TP_MEL = dict(n_mels=32, freqm=4, timem=8, iid_masks=True)


def main_tp(outdir, n_model):
    from passt_tpu_torch.models.passt import PaSSTConfig
    from passt_tpu_torch.ops.frontend import MelConfig
    from passt_tpu_torch.train.loop import evaluate
    from passt_tpu_torch.train.steps import create_train_state, make_eval_step, make_optimizer, make_train_step

    world, rank, device = init_process_group("cpu", timeout_s=60)
    runtime = DDPRuntime(world, rank, device, n_model=n_model)
    out, info = {}, {"world": world, "rank": rank, "data_rank": runtime.data_rank, "model_rank": runtime.model_rank}
    n_data, d = runtime.n_data, runtime.data_rank
    for name, (cfg_kw, moments) in TP_CONFIGS.items():
        if world > 2 and name in ("stacked", "sr", "fuse"):
            continue
        tx = make_optimizer(lr=1e-3, steps_per_epoch=2, moments_dtype=moments)
        model, state = create_train_state(PaSSTConfig(**cfg_kw), tx, torch.Generator().manual_seed(0), device="cpu",
                                          param_dtype=moments)
        state = runtime.replicate_state(state)
        info[f"{name}_bytes"] = {k: p.numel() * p.element_size() for k, p in state.params.items()}
        info[f"{name}_mu_bytes"] = {k: p.numel() * p.element_size() for k, p in state.opt_state.mu.items()}
        step = runtime.wrap_train_step(make_train_step(model, tx, MelConfig(**TP_MEL), log_grad_norm=True,
                                                       param_sr=moments is not None))
        b = GLOBAL_B // n_data
        for s in (1, 2):
            wave, target = (x[d * b:(d + 1) * b] for x in _global_batch())
            state, metrics = step(state, {"wave": torch.from_numpy(wave), "target": torch.from_numpy(target)}, 42)
            out[f"{name}_s{s}_loss"] = metrics["loss"].numpy()
            out[f"{name}_s{s}_norm"] = metrics["grad_norm"].numpy()
        for k, p in runtime.gather_state(state).params.items():
            out[f"{name}_{k}"] = p.float().numpy().copy()

    # eval: the model ranks of a data rank read the same rows; the gather
    # runs over the data group
    cfg_kw = dict(TINY, attn_impl="fused")
    model, state = create_train_state(PaSSTConfig(**cfg_kw), make_optimizer(), torch.Generator().manual_seed(0),
                                      device="cpu")
    state = runtime.replicate_state(state)
    eval_step = make_eval_step(model, MelConfig(n_mels=32), tensor_parallel=runtime.tensor_parallel)
    info["eval"] = evaluate(eval_step, state.params, ShardLoader(2, d, n_data), device_prefetch=0, runtime=runtime)

    if world == 2:
        import passt_tpu_torch.models.registry as registry
        import passt_tpu_torch.experiments.common as common
        from passt_tpu_torch.experiments import EXPERIMENTS

        with open(os.path.join(outdir, "argv.json")) as f:
            argv = json.load(f)
        exp = EXPERIMENTS["audioset"]
        arch = exp.default_config.model.arch
        registry.ARCHS[arch] = dataclasses.replace(registry.ARCHS[arch], depth=2, embed_dim=64, num_heads=4)
        first = common.run_command(exp, ["main", "with"] + argv, device="cpu")
        resumed = common.run_command(exp, ["main", "with"] + argv + ["trainer.resume=true", "trainer.max_epochs=3"],
                                     device="cpu")
        info["fit"] = {"history": first["history"], "resumed": resumed["history"]}

    np.savez(os.path.join(outdir, f"rank{rank}.npz"), **out)
    with open(os.path.join(outdir, f"rank{rank}.json"), "w") as f:
        json.dump(info, f)
    torch.distributed.destroy_process_group()
    print(f"rank {rank} done", flush=True)


def _global_batch():
    g = np.random.default_rng(7)
    wave = g.standard_normal((GLOBAL_B, 16000)).astype(np.float32)
    target = (g.uniform(size=(GLOBAL_B, 8)) < 0.3).astype(np.float32)
    return wave, target


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[2] == "tp":
        main_tp(sys.argv[1], int(sys.argv[3]))
    else:
        main()
