"""Tensor parallelism (the model axis of passt_tpu_torch.parallel) on the
CPU: gloo process groups of 2 (1 data x 2 model) and 4 (2 x 2) ranks,
started with torchrun's environment (``tests/_torch_parallel_worker.py``
in its ``tp`` mode), against the port's one-process step, and the
partition rules against the JAX package's.

Bounds (the JAX package's for its mesh step): loss rtol 2e-6, parameters
atol 2e-6; the layouts and per-rank bytes exactly.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from passt_tpu.models.passt import PaSSTConfig as JaxConfig
from passt_tpu.models.passt import init_passt
from passt_tpu.parallel.mesh import param_partition_spec as jax_spec
from passt_tpu_torch.models.passt import PaSSTConfig
from passt_tpu_torch.models.pretrained import state_dict_from_flax
from passt_tpu_torch.ops.frontend import MelConfig
from passt_tpu_torch.parallel.mesh import TensorParallel, jax_path, param_partition_spec, shard_layout
from passt_tpu_torch.train import optim
from passt_tpu_torch.train.steps import create_train_state, make_optimizer, make_train_step
from test_torch_parallel import _container

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
import _torch_parallel_worker as worker  # noqa: E402

TINY = worker.TINY


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(out, world, n_model):
    env = dict(os.environ, WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    script = os.path.join(REPO, "tests", "_torch_parallel_worker.py")
    procs = [subprocess.Popen([sys.executable, script, str(out), "tp", str(n_model)],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(world)]
    return procs


def _collect(procs, out, world):
    try:
        logs = [p.communicate(timeout=150)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-4000:]}"
    return ({r: dict(np.load(out / f"rank{r}.npz")) for r in range(world)},
            {r: json.loads((out / f"rank{r}.json").read_text()) for r in range(world)})


@pytest.fixture(scope="module")
def tp_runs(tmp_path_factory):
    """{world: (npz by rank, json by rank)} for a 1 x 2 and a 2 x 2 grid,
    the two groups run side by side."""
    out2, out4 = tmp_path_factory.mktemp("tp2"), tmp_path_factory.mktemp("tp4")
    argv = [
        "model.input_fdim=32", "mel.n_mels=32", "model.input_tdim=98", "model.dtype=float32",
        "data.clip_length=1", "data.batch_size=2", "data.eval_batch_size=2", "data.epoch_len=8",
        "data.num_workers=1", "trainer.max_epochs=2", "trainer.lr=1e-3", "trainer.log_every_steps=1000",
        "trainer.opt_moments_dtype=null", "trainer.keep_last_n=5", f"trainer.checkpoint_dir={out2 / 'ckpt'}",
        f"data.train_hdf5={_container(str(out2 / 'train.h5'), 0)}",
        f"data.eval_hdf5={_container(str(out2 / 'eval.h5'), 1)}",
        "trainer.n_model=2", "data.num_replicas=0",
    ]
    (out2 / "argv.json").write_text(json.dumps(argv))
    procs2, procs4 = _launch(out2, 2, 2), _launch(out4, 4, 2)
    runs = {2: _collect(procs2, out2, 2), 4: _collect(procs4, out4, 4)}
    runs["ckpt"] = out2 / "ckpt"
    return runs


def _one_process(name, steps=2):
    """The port's step in one process on the global batch: [(loss, norm,
    params)] after each step."""
    cfg_kw, moments = worker.TP_CONFIGS[name]
    tx = make_optimizer(lr=1e-3, steps_per_epoch=2, moments_dtype=moments)
    model, state = create_train_state(PaSSTConfig(**cfg_kw), tx, torch.Generator().manual_seed(0), device="cpu",
                                      param_dtype=moments)
    step = make_train_step(model, tx, MelConfig(**worker.TP_MEL), log_grad_norm=True, param_sr=moments is not None)
    wave, target = worker._global_batch()
    got = []
    for _ in range(steps):
        state, m = step(state, {"wave": torch.from_numpy(wave), "target": torch.from_numpy(target)}, 42)
        got.append((float(m["loss"]), float(m["grad_norm"]),
                    {k: p.float().numpy().copy() for k, p in state.params.items()}))
    return got


@pytest.mark.parametrize("world,name", [(2, "loop"), (2, "scan"), (2, "stacked"), (2, "fuse"),
                                        (4, "loop"), (4, "scan")])
def test_tp_step_matches_one_process(tp_runs, world, name):
    """Two steps of the 1 x 2 and 2 x 2 grids (loop with dropout and
    drop-path inside the split blocks, scan, stacked with its hand-written
    backward, loop with norm1 fused into the attention) against one process on the global batch: the loss and grad
    norm within rtol 2e-6, the gathered parameters within atol 2e-6; every
    rank holds the same full parameters."""
    npz = tp_runs[world][0]
    ref = _one_process(name)
    for s, (loss, norm, params) in enumerate(ref, start=1):
        np.testing.assert_allclose(npz[0][f"{name}_s{s}_loss"], loss, rtol=2e-6)
        np.testing.assert_allclose(npz[0][f"{name}_s{s}_norm"], norm, rtol=2e-6)
    for k, want in ref[-1][2].items():
        np.testing.assert_allclose(npz[0][f"{name}_{k}"], want, atol=2e-6, rtol=0, err_msg=k)
        for r in range(1, world):
            np.testing.assert_array_equal(npz[r][f"{name}_{k}"], npz[0][f"{name}_{k}"], err_msg=k)


def test_tp_bf16_sr_step_keeps_the_whole_leaf_draws(tp_runs):
    """Under bf16 storage with stochastic rounding (parameters and the
    second moment) the 1 x 2 step rounds each share with the whole leaf's
    draws: its bf16 parameters are the one-process step's, up to one bf16
    ulp where the fp32 sums before rounding differ in their last bits (in
    at most 1e-3 of the elements), its fp32 ones within atol 2e-6."""
    npz = tp_runs[2][0]
    ref = _one_process("sr")
    np.testing.assert_allclose(npz[0]["sr_s2_loss"], ref[-1][0], rtol=2e-6)
    n_diff = n = 0
    for k, want in ref[-1][2].items():
        got = npz[0][f"sr_{k}"]
        if optim.leaf_rank(k, want) < 2:  # stored fp32
            np.testing.assert_allclose(got, want, atol=2e-6, rtol=0, err_msg=k)
            continue
        assert (np.abs(got - want) <= np.abs(want) * 2.0 ** -7).all(), k
        n_diff += int((got != want).sum())
        n += want.size
    assert n_diff <= 1e-3 * n


def test_sr_of_shares_is_the_whole_leaf_sliced():
    """``_stochastic_round_many`` with shares: each rank's bits are the
    whole leaf's stochastic rounding, sliced (the draws do not depend on
    n_model), for qkv (split by heads) and fc2 (split on its input)."""
    rng = np.random.default_rng(0)
    full = {"blocks.0.attn.qkv.weight": torch.from_numpy(rng.standard_normal((192, 64)).astype(np.float32)),
            "blocks.0.norm1.weight": torch.from_numpy(rng.standard_normal(64).astype(np.float32)),
            "blocks.block.mlp.fc2.weight": torch.from_numpy(rng.standard_normal((2, 64, 256)).astype(np.float32))}
    whole = optim._stochastic_round_many(list(full.values()), torch.Generator().manual_seed(3))
    for size in (2, 4):
        for rank in range(size):
            tp = TensorParallel(size, rank)
            shares = tp.shard(full)
            fulls = tp.full_shapes(shares)
            got = optim._stochastic_round_many(list(shares.values()), torch.Generator().manual_seed(3),
                                               [fulls.get(k) for k in shares])
            for (k, w), g in zip(full.items(), got):
                assert torch.equal(g, tp.shard_one(k, whole[list(full).index(k)])), (size, rank, k)
                if k.endswith("norm1.weight"):
                    assert torch.equal(g, whole[1])


def test_tp_param_layouts_match_jax():
    """The partition rules are the JAX package's on every leaf of the
    per-block and the stacked trees (JAX ``tests/test_parallel.py`` and
    ``tests/test_scan_blocks.py``'s specs), and each split leaf's share is
    its spec's axis in torch orientation."""
    for impl in ("loop", "scan"):
        _, params = init_passt(JaxConfig(**dict(TINY, blocks_impl=impl)), jax.random.PRNGKey(0))
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            p = "/".join(str(getattr(k, "key", k)) for k in path)
            assert param_partition_spec(p, True, leaf.ndim) == tuple(jax_spec(p, True, leaf.ndim)), p
            assert param_partition_spec(p, False, leaf.ndim) == tuple(jax_spec(p, False, leaf.ndim)) == ()
    assert param_partition_spec("blocks/block/attn/qkv/kernel", True, 3) == (None, None, "model")
    assert param_partition_spec("blocks/block/mlp/fc2/kernel", True, 3) == (None, "model", None)
    assert param_partition_spec("blocks_0/attn/qkv/kernel", True, 2) == (None, "model")
    assert shard_layout("blocks.0.attn.qkv.weight", 2) == (0, 3)
    assert shard_layout("blocks.block.attn.qkv.weight", 3) == (1, 3)
    assert shard_layout("blocks.0.attn.proj.weight", 2) == (1, 1)
    assert shard_layout("blocks.block.mlp.fc2.weight", 3) == (2, 1)
    assert shard_layout("blocks.0.mlp.fc1.bias", 1) == (0, 1)
    assert shard_layout("blocks.0.attn.proj.bias", 1) is None
    assert shard_layout("cls_token", 3) is None
    assert jax_path("blocks.block.norm1.weight") == "blocks/block/norm1/scale"


@pytest.mark.parametrize("impl", ["loop", "scan"])
def test_tp_halves_per_rank_bytes(tp_runs, impl):
    """Per-rank bytes of the parameters and of AdamW's first moment at
    n_model=2, counted per leaf: each leaf a TP rule splits holds half its
    bytes, every other leaf all of them (the JAX package's accounting,
    ``tests/test_parallel.py``), on both model ranks."""
    name = "loop" if impl == "loop" else "scan"
    cfg_kw = worker.TP_CONFIGS[name][0]
    _, params = init_passt(JaxConfig(**{k: v for k, v in cfg_kw.items() if k in TINY or k == "blocks_impl"}),
                           jax.random.PRNGKey(0))
    full = state_dict_from_flax(jax.tree.map(np.asarray, params))
    info = tp_runs[2][1]
    for r in (0, 1):
        for what in ("bytes", "mu_bytes"):
            got = info[r][f"{name}_{what}"]
            assert set(got) == set(full)
            for k, t in full.items():
                split = param_partition_spec(jax_path(k), True, t.ndim)
                want = t.numel() * 4 // (2 if "model" in split else 1)
                assert got[k] == want, (r, what, k)
    assert sum(info[0][f"{name}_bytes"].values()) < sum(t.numel() * 4 for t in full.values())


def test_shard_and_gather_are_inverse_in_the_jax_layout():
    """A qkv share holds q, k and v of its heads, in the [3, H_local, D]
    column order the flat kernel reads; the shares put back together are
    the unsharded leaf (what ``gather`` does across the model group)."""
    w = torch.arange(3 * 4 * 8 * 5, dtype=torch.float32).reshape(3 * 4 * 8, 5)  # qkv, 4 heads of 8
    shares = [TensorParallel(2, r).shard_one("blocks.0.attn.qkv.weight", w) for r in range(2)]
    view = w.reshape(3, 4, 8, 5)
    for r, s in enumerate(shares):
        assert torch.equal(s, view[:, 2 * r:2 * r + 2].reshape(-1, 5))
    back = torch.cat([s.reshape(3, 2, 8, 5) for s in shares], dim=1).reshape(-1, 5)
    assert torch.equal(back, w)


def test_tp_raises_where_heads_or_hidden_do_not_divide():
    with pytest.raises(ValueError, match="num_heads=3 does not divide by n_model=2"):
        TensorParallel(2, 0).check_model(PaSSTConfig(embed_dim=192, num_heads=3))
    with pytest.raises(ValueError, match="mlp_hidden=96 does not divide by n_model=5"):
        TensorParallel(5, 0).check_model(PaSSTConfig(embed_dim=40, num_heads=5, mlp_ratio=2.4))


def test_tp_eval_gathers_over_the_data_group(tp_runs):
    """``evaluate`` under the model axis: every rank reports the metrics of
    the whole eval set (each data rank's rows once, not once per model
    rank), the same on every rank and grid."""
    ev2 = [tp_runs[2][1][r]["eval"] for r in (0, 1)]
    ev4 = [tp_runs[4][1][r]["eval"] for r in range(4)]
    assert ev2[0]["n_eval"] == 8 and all(e == ev2[0] for e in ev2)
    for e in ev4:
        assert e["n_eval"] == 8
        np.testing.assert_allclose(e["val_loss"], ev2[0]["val_loss"], rtol=1e-5)


def test_tp_main_writes_full_checkpoints_and_resumes(tp_runs):
    """``audioset main`` at ``trainer.n_model=2``: rank 0 writes each epoch's
    checkpoint in the full layout (the shapes of a model without the model
    axis, which the JAX converter reads), and the resumed run goes on from
    epoch 2 with its shares."""
    info = tp_runs[2][1]

    def untimed(h):
        return [{k: v for k, v in e.items() if k not in ("epoch_time_s", "it_per_s")} for e in h]

    for run in ("history", "resumed"):
        assert untimed(info[0]["fit"][run]) == untimed(info[1]["fit"][run])
    assert [h["epoch"] for h in info[0]["fit"]["history"]] == [0, 1]
    assert [h["epoch"] for h in info[0]["fit"]["resumed"]] == [2]
    ckpt = torch.load(os.path.join(tp_runs["ckpt"], "epoch_1.pt"), map_location="cpu", weights_only=True)
    cfg = JaxConfig(**dict(TINY, input_tdim=98, input_fdim=32, num_classes=527))
    _, params = init_passt(cfg, jax.random.PRNGKey(0))
    want = state_dict_from_flax(jax.tree.map(np.asarray, params))
    assert set(ckpt["params"]) == set(want)
    for k, t in want.items():
        assert tuple(ckpt["params"][k].shape) == tuple(t.shape), k
    from passt_tpu.models.pretrained import convert_torch_state_dict

    convert_torch_state_dict({k: v.numpy() for k, v in ckpt["params"].items()}, cfg)
