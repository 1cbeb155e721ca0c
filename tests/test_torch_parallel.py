"""The port's data parallelism across processes (passt_tpu_torch.parallel,
``fit``/``evaluate`` with a runtime, ``main`` at ``trainer.n_data=2``)
against the port's single-process step and the JAX package's mesh step,
on the CPU.

The counterpart of tests/test_parallel.py's data-parallel tests and of
tests/test_multihost.py with its two workers: a module fixture starts two
gloo processes of tests/_torch_parallel_worker.py with torchrun's
environment (a 120-s wait here, a 60-s group timeout there) on tiny
geometry (depth 2, width 64, 32 mels), and the tests read what they wrote.

Bounds: two ranks against one process on the concatenated batch, 1e-6 of
max(1, the leaf's max |value|) in fp32 (the all-reduce sums the two ranks'
gradients in another order than one process sums the batch); against the
JAX mesh step (``make_parallel_train_step`` over two of the conftest's
virtual CPU devices, the draws injected on both sides), 2e-5 of the same
scale, the bound and reason of tests/test_torch_experiments.py. Across
ranks: the same bits.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import passt_tpu.models.passt as jax_passt_mod
import passt_tpu.ops.frontend as jax_frontend_mod
import passt_tpu.train.steps as jax_steps_mod
from passt_tpu.data.prepare import pack_waveform_hdf5
from passt_tpu.models.passt import PaSSTConfig as JaxConfig
from passt_tpu.ops.frontend import MelConfig as JaxMelConfig
from passt_tpu.parallel.mesh import make_mesh, make_parallel_train_step, shard_batch, shard_params
from passt_tpu_torch.models.passt import PaSSTConfig
from passt_tpu_torch.models.pretrained import state_dict_from_flax
from passt_tpu_torch.ops.frontend import MelConfig
from passt_tpu_torch.parallel import DataParallel, runtime as rt
from passt_tpu_torch.train.steps import TrainState, create_train_state, make_optimizer, make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(input_fdim=32, input_tdim=50, embed_dim=64, depth=2, num_heads=4, num_classes=8,
            s_patchout_t=1, s_patchout_f=1)
WORLD = 2


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _global_batch():
    g = np.random.default_rng(7)
    wave = g.standard_normal((4, 16000)).astype(np.float32)
    target = (g.uniform(size=(4, 8)) < 0.3).astype(np.float32)
    return wave, target


def _container(path, seed, n=8):
    """n 1-s noise clips with 527-class multi-hot targets (the JAX packer)."""
    rng = np.random.default_rng(seed)
    items = []
    for i in range(n):
        target = np.zeros(527)
        target[rng.choice(12, int(rng.integers(1, 4)), replace=False)] = 1
        items.append((f"c{i:02d}.wav", (rng.standard_normal(32000) * 0.1).astype(np.float32), target))
    pack_waveform_hdf5(path, items, packed_targets=True)
    return path


@pytest.fixture(scope="module")
def ddp(tmp_path_factory):
    """Two gloo ranks' results: ({rank: npz}, {rank: json}, the JAX initial
    params, the work dir)."""
    out = tmp_path_factory.mktemp("ddp")
    _, jparams = jax_passt_mod.init_passt(JaxConfig(**TINY), jax.random.PRNGKey(0))
    sd = state_dict_from_flax(jax.tree.map(np.asarray, jparams))
    np.savez(out / "jax_init.npz", **{k: v.numpy() for k, v in sd.items()})
    argv = [
        "model.input_fdim=32", "mel.n_mels=32", "model.input_tdim=98", "model.dtype=float32",
        "data.clip_length=1", "data.batch_size=2", "data.eval_batch_size=2", "data.epoch_len=8",
        "data.num_workers=1", "trainer.max_epochs=2", "trainer.lr=1e-3", "trainer.log_every_steps=1000",
        "trainer.opt_moments_dtype=null", "trainer.keep_last_n=5", f"trainer.checkpoint_dir={out / 'ckpt'}",
        f"data.train_hdf5={_container(str(out / 'train.h5'), 0)}",
        f"data.eval_hdf5={_container(str(out / 'eval.h5'), 1)}",
        "trainer.n_data=2", "data.num_replicas=0",
    ]
    (out / "argv.json").write_text(json.dumps(argv))
    env = dict(os.environ, WORLD_SIZE=str(WORLD), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="2")
    worker = os.path.join(REPO, "tests", "_torch_parallel_worker.py")
    procs = [subprocess.Popen([sys.executable, worker, str(out)], env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=120)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-4000:]}"
    npz = {r: dict(np.load(out / f"rank{r}.npz")) for r in range(WORLD)}
    info = {r: json.loads((out / f"rank{r}.json").read_text()) for r in range(WORLD)}
    return npz, info, jparams, out


def _scale_close(got, ref, rel, what):
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(np.asarray(got, np.float64) - np.asarray(ref, np.float64)).max())
    assert err <= rel * scale, f"{what}: {err} > {rel} * {scale}"


def _single_process(cfg_kw, mel_kw, grad_accum=1, params=None, steps=2):
    """The port's step in one process on the concatenated batch: [(loss,
    params)] after each step."""
    tx = make_optimizer(lr=1e-3, steps_per_epoch=2, grad_accum=grad_accum)
    model, state = create_train_state(PaSSTConfig(**cfg_kw), tx, torch.Generator().manual_seed(0), device="cpu")
    if params is not None:
        state = TrainState(params=params, opt_state=tx.init(params), step=0)
    step = make_train_step(model, tx, MelConfig(**mel_kw))
    wave, target = _global_batch()
    got = []
    for _ in range(steps):
        state, m = step(state, {"wave": torch.from_numpy(wave), "target": torch.from_numpy(target)}, 42)
        got.append((float(m["loss"]), {k: p.numpy().copy() for k, p in state.params.items()}))
    return got


def _ranks_bit_equal(npz, prefix):
    keys = [k for k in npz[0] if k.startswith(prefix)]
    assert keys
    for k in keys:
        np.testing.assert_array_equal(npz[0][k], npz[1][k], err_msg=k)


CFG_A = dict(TINY, drop_rate=0.1, drop_path_rate=0.1, attn_impl="fused")
MEL_A = dict(n_mels=32, freqm=4, timem=8, iid_masks=True)


def test_two_ranks_equal_one_process_on_the_global_batch(ddp):
    """(a) Two data-parallel steps with the step's own draws (iid masks,
    the mixup permutation, dropout, drop-path: each drawn at the global
    batch) equal the single-process steps on the concatenated batch; the
    ranks' parameters are the same bits."""
    npz = ddp[0]
    _ranks_bit_equal(npz, "a_")
    for s, (loss, params) in enumerate(_single_process(CFG_A, MEL_A), start=1):
        _scale_close(npz[0][f"a_s{s}_loss"], loss, 1e-6, f"step {s} loss")
        for k, ref in params.items():
            _scale_close(npz[0][f"a_s{s}_{k}"], ref, 1e-6, f"step {s} {k}")


def test_grad_accum_reduces_once_an_update(ddp):
    """(f) ``grad_accum=2`` across ranks: micro-step 1 leaves the
    parameters as they were, micro-step 2 updates them on the all-reduced
    mean, equal to one process's accumulation over the global batch."""
    npz = ddp[0]
    _ranks_bit_equal(npz, "acc_")
    ref = _single_process(CFG_A, MEL_A, grad_accum=2)
    init = {k: p.numpy() for k, p in create_train_state(
        PaSSTConfig(**CFG_A), make_optimizer(lr=1e-3, grad_accum=2), torch.Generator().manual_seed(0),
        device="cpu")[1].params.items()}
    for k, p in init.items():
        np.testing.assert_array_equal(npz[0][f"acc_s1_{k}"], p, err_msg=k)
    moved = 0
    for k, p in ref[1][1].items():
        _scale_close(npz[0][f"acc_s2_{k}"], p, 1e-6, k)
        moved += not np.array_equal(npz[0][f"acc_s2_{k}"], init[k])
    assert moved >= len(init) - 2


def test_two_ranks_equal_the_jax_mesh_step(ddp, monkeypatch):
    """(b) The same two-rank steps from the JAX package's initial weights,
    every draw injected, against ``make_parallel_train_step`` with
    ``n_data=2`` over the conftest's virtual CPU devices."""
    npz, _, jparams, _ = ddp

    def np_mask(b, size, p, iid):
        rng = np.random.default_rng(size)
        n = b if iid else 1
        width = np.floor(rng.uniform(size=(n, 1)) * p)
        start = np.floor(rng.uniform(size=(n, 1)) * (size - width))
        idx = np.arange(size)[None, :]
        return np.broadcast_to((idx >= start) & (idx < start + width), (b, size))

    perm, lam = np.array([2, 0, 3, 1]), np.array([0.7, 0.55, 0.9, 0.62], np.float32)
    monkeypatch.setattr(jax_frontend_mod, "_axis_mask", lambda key, b, size, p, iid: jnp.asarray(np_mask(b, size, p, iid)))
    monkeypatch.setattr(jax_passt_mod, "_sorted_keep_indices", lambda key, size, keep: jnp.asarray(
        np.sort(np.random.default_rng(1000 * size + keep).permutation(size)[:keep])))
    monkeypatch.setattr(jax_steps_mod, "sample_mixup", lambda key, b, a: (jnp.asarray(perm[:b]), jnp.asarray(lam[:b])))

    cfg = JaxConfig(**TINY)
    tx = jax_steps_mod.make_optimizer(lr=1e-3, steps_per_epoch=2)
    model, state = jax_steps_mod.create_train_state(cfg, tx, jax.random.PRNGKey(0))
    state = state.replace(params=jparams, opt_state=tx.init(jparams))
    mesh = make_mesh(n_data=2, n_model=1)
    state = state.replace(params=shard_params(state.params, mesh), opt_state=shard_params(state.opt_state, mesh))
    mel = JaxMelConfig(n_mels=32, freqm=4, timem=8, iid_masks=True, fmin_aug_range=1, fmax_aug_range=1)
    raw = jax_steps_mod.make_train_step(model, tx, mel, use_mixup=True, jit=False)
    step = make_parallel_train_step(raw, mesh, jit=True)
    wave, target = _global_batch()
    batch = shard_batch({"wave": jnp.asarray(wave), "target": jnp.asarray(target)}, mesh)
    _ranks_bit_equal(npz, "j_")
    with mesh:
        for s in (1, 2):
            state, metrics = step(state, batch, jax.random.PRNGKey(42))
            _scale_close(npz[0][f"j_s{s}_loss"], np.asarray(metrics["loss"]), 2e-5, f"step {s} loss")
            ref = state_dict_from_flax(jax.tree.map(np.asarray, state.params))
            for k, p in ref.items():
                _scale_close(npz[0][f"j_s{s}_{k}"], p.numpy(), 2e-5, f"step {s} {k}")


def test_eval_gather_is_the_rank_order_concatenation(ddp):
    """(c) The eval gather: unequal shards come back as the rank-order
    concatenation on every rank, a rank with no rows takes the other's
    shapes; ``evaluate`` on rank slices (6 and 5 rows, then 6 and 0) gives
    every rank the same metrics, those of the whole set."""
    npz, info = ddp[0], ddp[1]
    want = {k: np.concatenate([npz[0][f"{k}_local"], npz[1][f"{k}_local"]]) for k in ("out", "target", "loss")}
    for r in range(WORLD):
        for k in ("out", "target", "loss"):
            np.testing.assert_array_equal(npz[r][f"g_{k}"], want[k])
            np.testing.assert_array_equal(npz[r][f"ge_{k}"], npz[0][f"{k}_local"])
    assert info[0]["eval"] == info[1]["eval"] and info[0]["eval"]["n_eval"] == 11
    assert info[0]["eval_empty"] == info[1]["eval_empty"] and info[0]["eval_empty"]["n_eval"] == 6
    assert info[0]["eval"]["allap"] == info[0]["eval"]["ap"]


def test_sampler_rank_slices_are_disjoint_and_cover_the_epoch(ddp):
    """(d) The weighted sampler's rank slices: disjoint, and merged round
    robin they are the one-process epoch."""
    from passt_tpu_torch.data.sampler import WeightedEpochSampler

    p0, p1 = list(ddp[0][0]["indices"]), list(ddp[0][1]["indices"])
    assert not (set(p0) & set(p1))
    merged = [int(p[i]) for i in range(max(len(p0), len(p1))) for p in (p0, p1) if i < len(p)]
    single = WeightedEpochSampler(np.linspace(0.5, 2.0, 40), epoch_len=20, seed=9)
    single.set_epoch(2)
    assert merged == list(single)


def test_main_trains_checkpoints_and_resumes_across_two_ranks(ddp):
    """(e) ``audioset main`` at ``trainer.n_data=2`` (``run_command``, the
    CLI's path): both ranks log the same epochs (losses and ``allap``
    agreed), rank 0 alone writes the checkpoints, a resume continues at
    epoch 2 on both, and the ranks end with the same parameters."""
    npz, info, _, out = ddp
    f0, f1 = info[0]["fit"], info[1]["fit"]
    assert f0["saves"] == [0, 1, 2] and f1["saves"] == []
    assert sorted(os.listdir(out / "ckpt")) == ["audioset_metrics.jsonl", "epoch_0.pt", "epoch_1.pt", "epoch_2.pt"]
    for key in ("history", "resumed"):
        strip = [[{k: v for k, v in rec.items() if k not in ("epoch_time_s", "it_per_s")} for rec in f[key]]
                 for f in (f0, f1)]
        assert strip[0] == strip[1]
    assert [r["epoch"] for r in f0["history"]] == [0, 1] and [r["epoch"] for r in f0["resumed"]] == [2]
    assert f0["history"][0]["n_eval"] == 8 and "allap" in f0["history"][0]
    assert f0["resumed"][0]["step"] == 6  # 2 steps an epoch on each rank: 8 clips, 2 ranks, batch 2
    _ranks_bit_equal(npz, "fit_")


def test_a_sigterm_on_one_rank_stops_both(ddp):
    """(e) SIGTERM reaches rank 1 alone in epoch 1: both ranks stop at the
    same batch boundary (the flag is agreed on every batch at
    log_every_steps=1), both report the interruption."""
    s0, s1 = ddp[1][0]["sigterm"], ddp[1][1]["sigterm"]
    assert s0 == s1 and s0["interrupted"]
    assert 3 <= s0["step"] < 9 and s0["epochs"] == 1


def test_maybe_ddp_runtime_validation_matches_jax(monkeypatch):
    """(g) ``maybe_ddp_runtime``'s checks and texts: those of the JAX
    package's ``maybe_mesh_runtime`` where the port keeps its rule
    (``n_data`` < 1; ``n_data`` beyond the devices, here the processes of
    the group; ``n_model`` beyond them); no config, no runtime; every check
    raises before a group is formed. (``n_model > 1`` raised here until
    tensor parallelism was ported.)"""
    from passt_tpu.parallel.runtime import maybe_mesh_runtime

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    Trainer = lambda **kw: type("T", (), dict(dict(n_data=None, n_model=1), **kw))()  # noqa: E731
    assert rt.maybe_ddp_runtime(Trainer(), device="cpu") is None and maybe_mesh_runtime(Trainer()) is None
    with pytest.raises(RuntimeError, match=r"^trainer.n_data must be >= 1, got 0$") as got:
        rt.maybe_ddp_runtime(Trainer(n_data=0), device="cpu")
    with pytest.raises(RuntimeError) as ref:
        maybe_mesh_runtime(Trainer(n_data=0))
    assert str(got.value) == str(ref.value)
    with pytest.raises(RuntimeError, match=r"^trainer.n_data=9 n_model=1 needs 9 devices, have 1 ") as got:
        rt.maybe_ddp_runtime(Trainer(n_data=9), device="cpu")
    with pytest.raises(RuntimeError, match=r"^trainer.n_data=9 n_model=1 needs 9 devices, have 8 "):
        maybe_mesh_runtime(Trainer(n_data=9))
    with pytest.raises(RuntimeError, match=r"^trainer.n_model=2 exceeds the 1 available devices$"):
        rt.maybe_ddp_runtime(Trainer(n_model=2), device="cpu")
    with pytest.raises(RuntimeError, match=r"^trainer.n_model=16 exceeds the 8 available devices$"):
        maybe_mesh_runtime(Trainer(n_model=16))
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(RuntimeError, match=r"^trainer.n_data=3 n_model=2 needs 6 devices, have 4 "):
        rt.maybe_ddp_runtime(Trainer(n_data=3, n_model=2), device="cpu")
    assert not torch.distributed.is_initialized()


def test_one_rank_group_is_bit_equal_to_no_group():
    """The data-parallel step in a one-rank gloo group (what chip_smoke
    runs through NCCL on the card) is the plain step, bit for bit: the
    global-batch draws, the gather, the all-reduce of one rank change
    nothing. The runtime's surface is the JAX one's at one process."""
    assert not torch.distributed.is_initialized()
    world, rank, device = rt.init_process_group("cpu", timeout_s=30)
    try:
        runtime = rt.DDPRuntime(world, rank, device)
        assert (runtime.n_data, runtime.n_model, runtime.spans_processes, runtime.local_batch_scale) == (1, 1, False, 1)
        got = _steps_with(runtime.data_parallel)
    finally:
        torch.distributed.destroy_process_group()
    ref = _steps_with(None)
    for (la, pa), (lb, pb) in zip(got, ref):
        assert la == lb
        for k in pb:
            np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)


def _steps_with(data_parallel):
    tx = make_optimizer(lr=1e-3, steps_per_epoch=2)
    model, state = create_train_state(PaSSTConfig(**CFG_A), tx, torch.Generator().manual_seed(0), device="cpu")
    step = make_train_step(model, tx, MelConfig(**MEL_A))
    if data_parallel is not None:
        from passt_tpu_torch.parallel import make_parallel_train_step as port_wrap

        step = port_wrap(step, data_parallel)
    wave, target = _global_batch()
    out = []
    for _ in range(2):
        state, m = step(state, {"wave": torch.from_numpy(wave), "target": torch.from_numpy(target)}, 42)
        out.append((float(m["loss"]), {k: p.numpy().copy() for k, p in state.params.items()}))
    return out


def test_shard_batch_and_rows():
    """``shard_batch`` takes a rank's rows in rank order and refuses an
    uneven split; ``rows`` and the global-batch draws it drives."""
    from passt_tpu_torch.models.passt import batch_rand
    from passt_tpu_torch.parallel import shard_batch as port_shard

    a = np.arange(12).reshape(6, 2)
    assert [port_shard({"x": a}, 3, r)["x"].tolist() for r in range(3)] == [a[:2].tolist(), a[2:4].tolist(),
                                                                             a[4:].tolist()]
    with pytest.raises(ValueError, match="does not split"):
        port_shard({"x": a}, 4, 0)
    assert DataParallel(3, 2).rows(5) == (10, 15)
    full = batch_rand((6, 3), torch.Generator().manual_seed(1), "cpu")
    part = batch_rand((2, 3), torch.Generator().manual_seed(1), "cpu", rows=(4, 6))
    assert torch.equal(full[4:], part)
