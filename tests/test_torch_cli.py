"""The port's typed config, CLI and the recipes' other commands
(passt_tpu_torch.config, passt_tpu_torch.cli, passt_tpu_torch.experiments,
with the registry's ensembles and surgery, the parameter counts,
``save_params_npz`` and ``maybe_native_builder``) against the JAX package,
on the CPU.

The configs, presets and command lines must mean the same thing to both
packages: the dataclasses compare equal field by field, ``parse_cli`` gives
the same command and config (and raises the same error) on each argv.
The commands that run a model run at the tiny geometry of
tests/test_torch_experiments.py, on weights carried across as ``.npz``
files (each package's ``save_params_npz``); ``evaluate_ensemble``'s mAP is
held within 1e-4 (observed: equal).
"""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import passt_tpu.experiments.common as jax_common
import passt_tpu.models.registry as jax_registry
import passt_tpu_torch.experiments.common as common
import passt_tpu_torch.models.registry as registry
from passt_tpu import config as jax_config
from passt_tpu.data import native as jax_native
from passt_tpu.data.native_loader import maybe_native_builder as jax_maybe_native_builder
from passt_tpu.experiments import EXPERIMENTS as JAX_EXPERIMENTS
from passt_tpu.models.passt import init_passt
from passt_tpu.models.pretrained import load_params_npz as jax_load_params_npz
from passt_tpu.models.pretrained import save_params_npz as jax_save_params_npz
from passt_tpu.utils import count_non_zero_params as jax_count_non_zero_params
from passt_tpu.utils import param_summary as jax_param_summary
from passt_tpu_torch import cli, config
from passt_tpu_torch.data import native
from passt_tpu_torch.data.native_loader import NativeBatchBuilder, maybe_native_builder
from passt_tpu_torch.experiments import EXPERIMENTS
from passt_tpu_torch.models.pretrained import flax_from_state_dict, save_params_npz, state_dict_from_flax
from passt_tpu_torch.utils import count_non_zero_params, count_params, param_summary
from test_torch_experiments import SHRINK, TINY, _container, _recipe_argv, _tiny_archs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPES = ["audioset", "esc50", "fsd50k", "openmic"]


# ---- the config ----------------------------------------------------------------------------------


@pytest.mark.parametrize("name", RECIPES)
def test_default_config_equals_jax(name):
    """Each recipe's default config, field by field, and its command
    surface (the commands, single_label, speed_test_batch_size)."""
    port, ref = EXPERIMENTS[name], JAX_EXPERIMENTS[name]
    assert dataclasses.asdict(port.default_config) == dataclasses.asdict(ref.default_config)
    assert port.COMMANDS == ref.COMMANDS
    assert (port.name, port.single_label, port.speed_test_batch_size) == (
        ref.name, ref.single_label, ref.speed_test_batch_size)
    assert port.default_config.resolved_param_dtype() == ref.default_config.resolved_param_dtype()
    assert port.default_config.pretty() == ref.default_config.pretty()


def test_presets_equal_jax():
    assert config.PRESETS == jax_config.PRESETS
    assert [f.name for f in dataclasses.fields(config.ExperimentConfig)] == [
        f.name for f in dataclasses.fields(jax_config.ExperimentConfig)]


ARGVS = [
    ["evaluate_only", "with", "trainer.lr=1e-4", "data.batch_size=24", "mini_train"],
    ["main", "passt_l_kd_p16_128_ap47"],
    ["passt_30sec"],
    ["with", "mixup", "model.checkpoint_path=null", "data.clip_length=none", "trainer.monitor=valid_allap"],
    ["model_speed_test", "passt_s_p16_s16_128_ap468", "trainer.n_data=2", "model.fuse_ln_qkv=on"],
    ["predict", "stfthop100", "trainer.opt_moments_dtype=null", "data.eval_pad_multiple_s=2.5", "mel.fmax=15000"],
    ["main", "model.pretrained=ture"],  # a bool typo raises
    ["main", "trainer.nope=1"],  # an unknown key raises
    ["main", "not_a_preset"],  # an unknown preset raises
]


@pytest.mark.parametrize("argv", ARGVS, ids=[" ".join(a) for a in ARGVS])
def test_parse_cli_matches_jax(argv):
    """The same command and config from both packages' ``parse_cli`` (or
    the same exception and message)."""
    for name in ("audioset", "esc50"):
        try:
            ref = jax_config.parse_cli(argv, JAX_EXPERIMENTS[name].default_config)
        except (ValueError, KeyError, SystemExit) as e:
            with pytest.raises(type(e)) as got:
                config.parse_cli(argv, EXPERIMENTS[name].default_config)
            assert str(got.value) == str(e)
            continue
        cmd, cfg = config.parse_cli(argv, EXPERIMENTS[name].default_config)
        assert cmd == ref[0]
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref[1])


@pytest.mark.parametrize("argv", [[], ["model.fuse_ln_qkv=true", "model.dtype=float32", "model.plus1_attn=true"],
                                  ["passt_s_swa_p16_s14_128_ap471", "model.input_tdim=500", "model.u_patchout=3"],
                                  ["passt_l_kd_p16_128_ap47", "model.ln_impl=fused", "model.gelu=erf"]])
def test_passt_config_matches_jax(argv):
    """``ExperimentConfig.passt_config()``: the port's PaSSTConfig has the
    JAX one's fields and values."""
    _, ref = jax_config.parse_cli(["with"] + argv, JAX_EXPERIMENTS["audioset"].default_config)
    _, cfg = config.parse_cli(["with"] + argv, EXPERIMENTS["audioset"].default_config)
    assert dataclasses.asdict(cfg.passt_config()) == dataclasses.asdict(ref.passt_config())


# ---- the CLI and its commands that run no model -----------------------------------------------------


def test_cli_help_print_config_and_errors(capsys):
    """``python -m passt_tpu_torch.cli``: the help lists the commands and
    the experiments; ``print_config`` and ``print_named_configs`` print
    what the JAX package prints, and ``cli.run`` returns the command's
    result; an unknown experiment or command exits."""
    assert cli.main([]) == 0
    out = capsys.readouterr().out
    assert "model_speed_test" in out and "experiments: audioset, esc50, fsd50k, openmic" in out
    for argv in (["audioset", "print_config", "with", "mini_train", "trainer.lr=3e-5"],
                 ["fsd50k", "print_named_configs"]):
        assert cli.main(list(argv)) == 0
        got = capsys.readouterr().out
        jax_common.run_command(JAX_EXPERIMENTS[argv[0]], argv[1:])
        assert got == capsys.readouterr().out
    assert cli.run(["fsd50k", "print_named_configs"]) == jax_common.run_command(
        JAX_EXPERIMENTS["fsd50k"], ["print_named_configs"])  # the result cli.main drops
    with pytest.raises(SystemExit, match="unknown experiment"):
        cli.main(["audioset2"])
    with pytest.raises(SystemExit, match="unknown command"):
        cli.main(["audioset", "train_fast"])


def test_cli_runs_on_the_card_and_one_device_only(capsys):
    """The CLI's model commands run on the card: without one they raise
    (nothing falls back to the CPU); one process drives one device, so
    ``trainer.n_data=2`` without a process group of two raises the
    runtime's world-size check before any work, as ``trainer.n_model=2``
    does (tensor parallelism needs two processes); ``model.blocks_impl``
    reaches the model, whose invalid combinations raise the JAX package's
    errors (these options raised as unported until they were ported);
    ``trainer.compilation_cache_dir`` prints one line and changes nothing."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["audioset", "model_speed_test"])
    exp = EXPERIMENTS["audioset"]
    for command in ("model_speed_test", "main", "evaluate_only"):
        with pytest.raises(RuntimeError, match="trainer.n_data=2 n_model=1 needs 2 devices, have 1 "):
            common.run_command(exp, [command, "trainer.n_data=2"], device="cpu")
        with pytest.raises(RuntimeError, match="trainer.n_model=2 exceeds the 1 available devices"):
            common.run_command(exp, [command, "trainer.n_model=2"], device="cpu")
    assert not torch.distributed.is_initialized()
    from passt_tpu.models.passt import PaSSTConfig as JaxConfig

    for argv, bad in ((["model.blocks_impl=bogus"], dict(blocks_impl="bogus")),
                      (["model.blocks_impl=stacked", "model.fuse_ln_qkv=true"],
                       dict(blocks_impl="stacked", fuse_ln_qkv=True))):
        with pytest.raises((ValueError, NotImplementedError)) as want:
            JaxConfig(**bad).use_scan_blocks
        with pytest.raises(type(want.value)) as got:
            common.run_command(exp, ["model_speed_test"] + argv, device="cpu")
        assert str(got.value) == str(want.value)
    capsys.readouterr()
    common.run_command(exp, ["print_config", "trainer.compilation_cache_dir=/tmp/xla"])
    out = capsys.readouterr().out
    assert out.splitlines()[0].startswith("trainer.compilation_cache_dir='/tmp/xla': the port compiles no XLA")
    assert sum("compilation_cache_dir" in line for line in out.splitlines()) == 2  # the note and the JSON key


def test_main_at_n_data_1_in_a_one_rank_group_equals_main_without(tmp_path):
    """``audioset main`` at ``trainer.n_data=1`` in a one-rank gloo group
    (the data-parallel step, its collectives over one rank, the eval
    gather, the rank-0 checkpoint) is ``main`` without a runtime, bit for
    bit: the same epoch records and checkpoints."""
    from passt_tpu_torch.parallel.runtime import init_process_group

    def run(name, extra):
        argv = ["main", "with"] + _recipe_argv("audioset", str(tmp_path)) + [
            "mel.freqm=8", "mel.timem=20", "trainer.use_mixup=true", "model.s_patchout_t=2",
            "trainer.max_epochs=1", f"trainer.checkpoint_dir={tmp_path / name}"] + extra
        res = common.run_command(EXPERIMENTS["audioset"], argv, device="cpu")
        return res["history"], torch.load(tmp_path / name / "epoch_0.pt", weights_only=True)

    with _tiny_archs("passt_s_swa_p16_128_ap476"):
        ref_hist, ref_ckpt = run("plain", [])
        init_process_group("cpu", timeout_s=30)
        try:
            hist, ckpt = run("ddp", ["trainer.n_data=1", "data.num_replicas=0"])
        finally:
            torch.distributed.destroy_process_group()
    drop = ("epoch_time_s", "it_per_s")
    assert [{k: v for k, v in r.items() if k not in drop} for r in hist] == \
        [{k: v for k, v in r.items() if k not in drop} for r in ref_hist]
    assert ckpt["step"] == ref_ckpt["step"] > 0
    for k, p in ref_ckpt["params"].items():
        assert torch.equal(ckpt["params"][k], p), k


def test_resolve_monitor_matches_jax():
    port, ref = common.Experiment._resolve_monitor, jax_common.Experiment._resolve_monitor
    for monitor in (None, "", "ap", "allap", "valid_allap", "eval_ap", "swa_ap", "valid_swa_ap"):
        for sets in ({}, {"eval": 1}, {"valid": 1, "eval": 2}):
            assert port(monitor, sets) == ref(monitor, sets), (monitor, sets)


def test_steps_per_epoch_matches_jax(tmp_path):
    """``_steps_per_epoch`` on the limit, the weighted sampler's epoch_len,
    the shuffled container's length (two containers), no containers, and
    an unreadable path (the loud fallback)."""
    h5 = _container(str(tmp_path / "a.h5"), "multilabel", 527, seed=3)
    h5b = _container(str(tmp_path / "b.h5"), "multilabel", 527, seed=4)
    cases = [["trainer.limit_train_batches=7"], ["data.epoch_len=1000", "data.batch_size=12"],
             ["data.weighted_sampler=false", f"data.train_hdf5={h5}", f"data.train_hdf5_extra={h5b}",
              "data.batch_size=3"],
             ["data.weighted_sampler=false", "data.epoch_len=96"],
             ["data.weighted_sampler=false", f"data.train_hdf5={tmp_path / 'missing.h5'}", "data.epoch_len=50"],
             ["data.num_replicas=2", "data.epoch_len=100", "data.batch_size=5"]]
    for argv in cases:
        _, cfg = config.parse_cli(["with"] + argv, EXPERIMENTS["audioset"].default_config)
        _, ref = jax_config.parse_cli(["with"] + argv, JAX_EXPERIMENTS["audioset"].default_config)
        port_exp = dataclasses.replace(EXPERIMENTS["audioset"], _len_cache={})
        jax_exp = dataclasses.replace(JAX_EXPERIMENTS["audioset"], _len_cache={})
        assert port_exp._steps_per_epoch(cfg) == jax_exp._steps_per_epoch(ref), argv


def test_test_loaders_and_the_weighted_sampler_match_jax(tmp_path, capsys):
    """``test_loaders`` pulls the same shapes; the class-balanced sampler
    built from :func:`train_target_chunks` (two containers) draws the same
    indices as the JAX recipe's; ``num_replicas=0`` is one process without
    a process group; ``test_loaders_train_speed`` reads the same loader
    (the native plane or not) twice."""
    h5 = _container(str(tmp_path / "a.h5"), "multilabel", 527, seed=3)
    h5b = _container(str(tmp_path / "b.h5"), "multilabel", 527, seed=4)
    argv = ["test_loaders", f"data.train_hdf5={h5}", f"data.train_hdf5_extra={h5b}", f"data.eval_hdf5={h5}",
            "data.clip_length=1", "data.batch_size=4", "data.epoch_len=12", "data.num_workers=2",
            "data.num_replicas=0"]
    got = common.run_command(EXPERIMENTS["audioset"], argv)
    ref = jax_common.run_command(JAX_EXPERIMENTS["audioset"], argv)
    assert got == ref == {"training": (4, 32000), "test": (8, 32000)}  # the eval batch: all 8 clips
    _, cfg = config.parse_cli(argv, EXPERIMENTS["audioset"].default_config)
    _, jcfg = jax_config.parse_cli(argv, JAX_EXPERIMENTS["audioset"].default_config)
    chunks = list(common.train_target_chunks(cfg, chunk_rows=5))
    assert [len(c) for c in chunks] == [5, 3, 5, 3] and all(c.shape[1] == 527 for c in chunks)
    loader, jloader = common.build_train_loader(cfg), jax_common.build_train_loader(jcfg)
    np.testing.assert_array_equal(loader.sampler.weights, jloader.sampler.weights)
    for epoch in (0, 1):
        loader.set_epoch(epoch)
        jloader.set_epoch(epoch)
        assert list(loader.sampler) == list(jloader.sampler)
    assert common._resolve_rank(cfg.data) == (1, 0)
    speed = common.run_command(EXPERIMENTS["audioset"], ["test_loaders_train_speed"] + argv[1:])
    ref = jax_common.run_command(JAX_EXPERIMENTS["audioset"], ["test_loaders_train_speed"] + argv[1:])
    assert set(speed) == set(ref) and (speed["native"], speed["num_workers"]) == (ref["native"], ref["num_workers"])
    assert speed["pass1_clips_per_s"] > 0 and "pass 2: 12 clips in" in capsys.readouterr().out


def test_maybe_native_builder_matches_jax(tmp_path, capsys):
    """The same verdicts as the JAX package's ``maybe_native_builder`` on
    eligible and ineligible recipe chains (each fallback printing its line),
    and bit-equal batches where eligible."""
    if not (native.available() and jax_native.available()):
        pytest.skip("native/libhostplane.so is not built on this machine")
    h5 = _container(str(tmp_path / "a.h5"), "multilabel", 527, seed=3)
    h5b = _container(str(tmp_path / "b.h5"), "multilabel", 527, seed=4)
    base = ["data.clip_length=1", f"data.train_hdf5={h5}", "data.num_workers=2"]
    cases = {
        "eligible": [],
        "two containers": [f"data.train_hdf5_extra={h5b}"],
        "off": ["data.native_loader=false"],
        "variable length": ["data.clip_length=null"],
        "resampled": ["data.sample_rate=16000"],
        "ir": ["data.ir_augment=0.5", f"data.ir_path={tmp_path}"],
    }
    for what, argv in cases.items():
        _, cfg = config.parse_cli(["with"] + base + argv, EXPERIMENTS["audioset"].default_config)
        _, jcfg = jax_config.parse_cli(["with"] + base + argv, JAX_EXPERIMENTS["audioset"].default_config)
        capsys.readouterr()
        got = maybe_native_builder(cfg, common.build_base_train_dataset)
        port_out = capsys.readouterr().out
        ref = jax_maybe_native_builder(jcfg)
        assert port_out == capsys.readouterr().out, what
        assert (got is None) == (ref is None), what
        if got is None:
            assert what in ("off", "variable length", "resampled", "ir")
            assert ("numpy loader path" in port_out) == (what != "off"), what
            continue
        assert isinstance(got, NativeBatchBuilder) and len(got.datasets) == len(ref.datasets)
        for epoch in (0, 1):
            got.set_epoch(epoch)
            ref.set_epoch(epoch)
            for idxs in ([0, 5, 7, 2], [3, 3, 1, 6]):
                a, b = got(idxs), ref(idxs)
                np.testing.assert_array_equal(a["wave"], b["wave"])
                np.testing.assert_array_equal(a["target"], b["target"])


# ---- the registry, the weights, the counts --------------------------------------------------------


def _jax_params(arch: str, seed: int, **overrides):
    """JAX init params of the (shrunk) arch at the tiny geometry."""
    cfg = jax_registry.get_model_config(arch, input_fdim=32, input_tdim=98, **overrides)
    return init_passt(cfg, jax.random.PRNGKey(seed))[1]


def test_save_params_npz_round_trips_through_jax(tmp_path):
    """The port's ``save_params_npz`` writes the JAX package's keys and
    arrays: JAX's ``load_params_npz`` reads back the JAX tree exactly, and
    the bridge back gives the port's tensors bit for bit (bf16 storage
    widened exactly)."""
    with _tiny_archs("passt_s_swa_p16_128_ap476"):
        params = jax.tree.map(np.asarray, _jax_params("passt_s_swa_p16_128_ap476", 1))
    sd = state_dict_from_flax(params)
    sd = {k: v.to(torch.bfloat16) if v.ndim >= 2 else v for k, v in sd.items()}  # bf16 storage
    path = str(tmp_path / "w.npz")
    save_params_npz(path, sd)
    ref = str(tmp_path / "ref.npz")
    jax_save_params_npz(ref, jax.tree.map(lambda x: np.asarray(x), flax_from_state_dict(sd)))
    with np.load(path) as a, np.load(ref) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == np.float32 and np.array_equal(a[k], b[k]), k
    back = state_dict_from_flax(jax.tree.map(np.asarray, jax_load_params_npz(path)))
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v.float()), k
    assert jax.tree.structure(jax_load_params_npz(path)) == jax.tree.structure(params)


@pytest.mark.parametrize("cut_depth", [0, 2, -3])
def test_lighten_params_matches_jax(cut_depth):
    """``lighten_params`` on the port's names keeps the JAX one's blocks,
    renumbered the same way."""
    arch = "passt_s_swa_p16_128_ap476"
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_registry.ARCHS, arch, dataclasses.replace(jax_registry.ARCHS[arch], **dict(TINY, depth=6)))
        params = jax.tree.map(np.asarray, _jax_params(arch, 2))
    ref, ref_depth = jax_registry.lighten_params(params, cut_depth)
    got, depth = registry.lighten_params(state_dict_from_flax(params), cut_depth)
    assert depth == ref_depth == {0: 6, 2: 4, -3: 4}[cut_depth]
    want = state_dict_from_flax(ref)
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    with pytest.raises(ValueError, match="between 1 and 4"):
        registry.lighten_params(state_dict_from_flax(params), 5)


def test_param_counts_match_jax():
    """``count_non_zero_params`` (description, total, non-zero) and
    ``param_summary``'s groups and total equal the JAX package's on the same
    weights (some zeroed)."""
    with _tiny_archs("passt_s_swa_p16_128_ap476"):
        params = jax.tree.map(np.array, _jax_params("passt_s_swa_p16_128_ap476", 3))
    params["blocks_1"]["mlp"]["fc1"]["kernel"][:5] = 0.0
    sd = state_dict_from_flax(params)
    assert count_non_zero_params(sd) == jax_count_non_zero_params(params)
    assert count_params(sd) == jax_count_non_zero_params(params)[1]
    assert param_summary(sd) == jax_param_summary(params, max_depth=1)
    assert param_summary(sd).splitlines()[-1].split() == ["TOTAL", f"{count_params(sd):,}"]


def test_fix_embedding_layer_and_ensembles_table():
    assert registry.ENSEMBLES == jax_registry.ENSEMBLES
    model = object()
    assert registry.fix_embedding_layer(model, None) == (model, None)
    with pytest.raises(NotImplementedError, match="not ported"):
        registry.fix_embedding_layer(model, None, embed="overlap")


ENSEMBLE = "ensemble_s16_14"


def test_evaluate_ensemble_matches_jax(tmp_path):
    """``evaluate_ensemble`` on two tiny members (stride 14 and 16), one
    written with the JAX package's ``save_params_npz``, one with the
    port's: the same mAP as the JAX command (within 1e-4), the published
    mAP beside it; each member at its own stride. Without
    ``model.ensemble_checkpoint_dir``, or with an unknown ensemble, the
    command exits."""
    (a14, _, _), (a16, _, _) = registry.ENSEMBLES[ENSEMBLE][0]
    ckpt = tmp_path / "members"
    ckpt.mkdir()
    with _tiny_archs(a14, a16, "passt_s_swa_p16_128_ap476"):
        argv = _recipe_argv("audioset", str(tmp_path))
        jax_save_params_npz(str(ckpt / f"{a14}.npz"), _jax_params(a14, 5, fstride=14, tstride=14))
        pairs = registry.get_ensemble_model([(a16, 16, 16)], seed=3, device="cpu", input_fdim=32, input_tdim=98)
        save_params_npz(str(ckpt / f"{a16}.npz"), pairs[0][1])
        cmd = ["evaluate_ensemble"] + argv + [f"model.ensemble={ENSEMBLE}",
                                              f"model.ensemble_checkpoint_dir={ckpt}"]
        got = common.run_command(EXPERIMENTS["audioset"], cmd, device="cpu")
        ref = jax_common.run_command(JAX_EXPERIMENTS["audioset"], cmd)
        members = registry.get_ensemble_model(registry.ENSEMBLES[ENSEMBLE][0], device="cpu", input_fdim=32,
                                              input_tdim=98)
        with pytest.raises(SystemExit, match="ensemble_checkpoint_dir is required"):
            common.run_command(EXPERIMENTS["audioset"], ["evaluate_ensemble", f"model.ensemble={ENSEMBLE}"],
                               device="cpu")
        with pytest.raises(SystemExit, match="model.ensemble must be one of"):
            common.run_command(EXPERIMENTS["audioset"], ["evaluate_ensemble"], device="cpu")
    assert got["published_map"] == ref["published_map"] == 0.48579
    assert np.isfinite(got["ap"]) and abs(got["ap"] - ref["ap"]) <= 1e-4
    assert [m.cfg.stride for m, _ in members] == [(14, 14), (16, 16)]
    assert [m.cfg.grid_size for m, _ in members] == [(2, 6), (2, 6)]
    x = torch.randn(2, 1, 32, 98)
    mean, same = registry.ensemble_apply(members, x)
    want = sum(m(x, train=False)[0] for m, _ in members) / 2
    assert mean is same and torch.allclose(mean, want, atol=1e-6)


def test_model_speed_test_runs_on_the_cpu(capsys):
    """``model_speed_test`` at depth 1 on the CPU (a resident ``ones`` mel
    batch; the CLI runs it on the card): specs/s > 0, printed as the JAX
    harness prints it; a single-label recipe feeds class indices."""
    arch = "passt_s_swa_p16_128_ap476"
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(registry.ARCHS, arch, dataclasses.replace(registry.ARCHS[arch], **dict(TINY, depth=1)))
        for name in ("audioset", "esc50"):
            _, cfg = config.parse_cli(["with"] + SHRINK, EXPERIMENTS[name].default_config)
            res = EXPERIMENTS[name].model_speed_test(cfg, speed_test_batch_size=2, test_length=2, device="cpu")
            assert set(res) == {"specs_per_second"} and res["specs_per_second"] > 0
            assert "average speed: " in capsys.readouterr().out


def test_build_loads_the_checkpoint_before_the_optimizer(tmp_path):
    """``build``: random weights from ``trainer.seed``, then the
    checkpoint, then the optimizer's init on those fp32 weights, then the
    bf16 storage cast: the state holds the checkpoint's values (cast), and
    under ``opt_moments_dtype=null`` the moments are fp32 zeros shaped like
    the fp32 weights even where storage is bf16."""
    with _tiny_archs("passt_s_swa_p16_128_ap476"):
        argv = _recipe_argv("audioset", str(tmp_path)) + ["model.dtype=bfloat16"]
        _, cfg = config.parse_cli(["with"] + argv, EXPERIMENTS["audioset"].default_config)
        model, state, step, ev, tx = EXPERIMENTS["audioset"].build(cfg, device="cpu")
        _, cfg0 = config.parse_cli(["with"] + argv[:-1] + ["model.pretrained=false"],
                                   EXPERIMENTS["audioset"].default_config)
        _, fresh, _, _, _ = EXPERIMENTS["audioset"].build(cfg0, device="cpu")
    ckpt = state_dict_from_flax(jax.tree.map(np.asarray, jax_load_params_npz(cfg.model.checkpoint_path)))
    assert cfg.resolved_param_dtype() == "bfloat16_sr" and callable(step) and callable(ev)
    for k, v in ckpt.items():
        want = v.to(torch.bfloat16) if v.ndim >= 2 else v
        assert torch.equal(state.params[k], want), k
    assert not all(torch.equal(fresh.params[k], state.params[k]) for k in ckpt)  # the seed's init differs
    mu = state.opt_state.mu
    assert all(mu[k].dtype == torch.float32 and not mu[k].any() for k in mu)


def test_port_front_door_imports_without_jax_or_h5py():
    """In a fresh interpreter with jax, flax, optax, the JAX package, h5py
    and sklearn blocked, the config, the CLI and the recipes import, and
    ``print_config``, ``print_named_configs`` and ``model_speed_test`` (on
    the CPU, tiny) run."""
    code = """
import dataclasses, importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split('.')[0] in ('jax', 'flax', 'optax', 'orbax', 'passt_tpu', 'h5py', 'sklearn'):
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
import passt_tpu_torch.cli, passt_tpu_torch.config, passt_tpu_torch.experiments
from passt_tpu_torch.experiments import EXPERIMENTS, common
import passt_tpu_torch.models.registry as R
passt_tpu_torch.cli.main(['audioset', 'print_config'])
passt_tpu_torch.cli.main(['audioset', 'print_named_configs'])
a = 'passt_s_swa_p16_128_ap476'
R.ARCHS[a] = dataclasses.replace(R.ARCHS[a], depth=1, embed_dim=64, num_heads=4)
import torch
torch.set_num_threads(1)
_, cfg = passt_tpu_torch.config.parse_cli(['model.input_fdim=32', 'model.input_tdim=98', 'model.dtype=float32'],
                                          EXPERIMENTS['openmic'].default_config)
EXPERIMENTS['openmic'].model_speed_test(cfg, speed_test_batch_size=2, test_length=2, device='cpu')
print('ok', sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'passt_tpu', 'h5py', 'sklearn')))
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "ok []"
    assert "average speed:" in res.stdout
