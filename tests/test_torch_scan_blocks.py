"""The port's ``blocks_impl="scan"``, ``remat`` and ``representation_size``
(passt_tpu_torch.models.passt) on the CPU.

Scan applies the loop's Block to each layer's slice of the stacked leaves,
and remat recomputes a block from the same inputs and the draws its forward
recorded, so both are held to the loop and to the plain step bit for bit;
the scan step and the pre-logits model are held to the JAX package.
Weights come from the JAX package's init through the bridge
(``state_dict_from_flax``); inputs from numpy seeds.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from passt_tpu.models.passt import PaSSTConfig as JaxConfig
from passt_tpu.models.passt import init_passt
from passt_tpu.train.optim import cast_params_storage as jax_cast
from passt_tpu_torch.models.passt import PaSST, PaSSTConfig
from passt_tpu_torch.models.pretrained import stack_block_params, state_dict_from_flax
from passt_tpu_torch.ops.frontend import MelConfig
from passt_tpu_torch.train.optim import cast_params_storage
from passt_tpu_torch.train.steps import TrainState, make_optimizer, make_train_step
from test_torch_train import _fp32_step_vs_jax, injected_draws  # noqa: F401  (a fixture)

SMALL = dict(input_fdim=64, input_tdim=50, embed_dim=192, depth=3, num_heads=3, num_classes=11)


@functools.lru_cache(maxsize=None)
def _init(arch: tuple, seed: int):
    """The JAX package's init of an architecture (the compute switches do
    not change the weights), bridged."""
    _, params = init_passt(JaxConfig(**dict(arch)), jax.random.PRNGKey(seed))
    return state_dict_from_flax(jax.tree.map(np.asarray, params))


def _loop_params(cfg_kw, seed=1):
    arch = {k: v for k, v in cfg_kw.items() if k in SMALL}
    return dict(_init(tuple(sorted(arch.items())), seed))


def _model(cfg_kw, sd):
    model = PaSST(PaSSTConfig(**cfg_kw))
    model.load_state_dict(sd)
    return model


def _x(b=2, seed=7):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal((b, 1, 64, 50)).astype(np.float32))


def _grads(model, x, train=False, gens=None):
    model.zero_grad()
    logits, _ = model(x, train=train, generators=gens)
    logits.float().square().mean().backward()
    return logits.detach(), {k: p.grad for k, p in model.named_parameters() if p.grad is not None}


@pytest.mark.parametrize("variant", [
    dict(dtype="float32", attn_impl="fused"),
    dict(dtype="bfloat16", attn_impl="fused"),
    dict(dtype="float32", attn_impl="xla"),
    dict(dtype="bfloat16", attn_impl="fused", fuse_ln_qkv=True),
    dict(dtype="float32", attn_impl="fused", ln_impl="fused"),
])
def test_scan_logits_and_grads_equal_loop_bit_for_bit(variant):
    """Scan runs the loop's Block on each layer's slice (taken by unbind):
    the logits, features and every gradient, restacked, are the loop's."""
    kw = dict(SMALL, **variant)
    sd = _loop_params(kw)
    loop, scan = _model(kw, sd), _model(dict(kw, blocks_impl="scan"), stack_block_params(sd))
    x = _x()
    lo_l, g_l = _grads(loop, x)
    lo_s, g_s = _grads(scan, x)
    assert torch.equal(lo_l, lo_s)
    g_l = stack_block_params(g_l)
    assert set(g_l) == set(g_s)
    for k in g_l:
        assert torch.equal(g_l[k], g_s[k]), k


def _step_state(kw, sd, moments=None):
    tx = make_optimizer(lr=1e-3, steps_per_epoch=2, moments_dtype=moments)
    params = cast_params_storage(sd, "bfloat16_sr" if moments else None)
    return tx, TrainState(params=params, opt_state=tx.init(sd), step=0)


@pytest.mark.parametrize("impl,moments", [("loop", None), ("scan", None), ("loop", "bfloat16_sr")])
def test_remat_step_equals_plain_step_bit_for_bit(impl, moments):
    """Two train steps with every draw the step makes (SpecAugment masks,
    mixup, patchout; in the loop dropout and drop-path inside the
    recomputed blocks): under remat the loss, every gradient (the first
    moment after one AdamW step is (1 - b1) g) and every updated parameter
    are the plain step's bits."""
    kw = dict(SMALL, dtype="float32", attn_impl="fused", s_patchout_t=1, s_patchout_f=1)
    if impl == "loop":
        kw.update(drop_rate=0.1, drop_path_rate=0.1)
    sd = _loop_params(kw)
    if impl == "scan":
        sd = stack_block_params(sd)
    rng = np.random.default_rng(3)
    batch = {"wave": torch.from_numpy(rng.standard_normal((2, 16000)).astype(np.float32)),
             "target": torch.from_numpy((rng.uniform(size=(2, 11)) < 0.3).astype(np.float32))}
    mel = MelConfig(n_mels=64, freqm=8, timem=8, iid_masks=True)
    runs = []
    for remat in (False, True):
        model = PaSST(PaSSTConfig(**dict(kw, blocks_impl=impl, remat=remat)))
        tx, state = _step_state(kw, sd, moments)
        step = make_train_step(model, tx, mel, log_grad_norm=True, param_sr=moments is not None)
        trace = []
        for _ in range(2):
            state, m = step(state, batch, 11)
            trace.append((m["loss"], m["grad_norm"], dict(state.params), dict(state.opt_state.mu)))
        runs.append(trace)
    for (l0, n0, p0, mu0), (l1, n1, p1, mu1) in zip(*runs):
        assert torch.equal(l0, l1) and torch.equal(n0, n1)
        for k in p0:
            assert torch.equal(p0[k], p1[k]), k
            assert torch.equal(mu0[k], mu1[k]), k


def test_scan_step_equals_loop_step_under_bf16_sr():
    """Under bf16 storage with stochastic rounding (the bench's step) the
    scan step's parameters and moments, restacked, are the loop step's bits
    over two steps: a stacked leaf draws its rounding bits block by block,
    as the per-block leaves do."""
    kw = dict(SMALL, dtype="bfloat16", attn_impl="fused", s_patchout_t=1, s_patchout_f=1)
    sd = _loop_params(kw)
    rng = np.random.default_rng(8)
    batch = {"wave": torch.from_numpy(rng.standard_normal((2, 16000)).astype(np.float32)),
             "target": torch.from_numpy((rng.uniform(size=(2, 11)) < 0.3).astype(np.float32))}
    out = []
    for impl, params in (("loop", sd), ("scan", stack_block_params(sd))):
        model = PaSST(PaSSTConfig(**dict(kw, blocks_impl=impl)))
        tx, state = _step_state(kw, params, "bfloat16_sr")
        step = make_train_step(model, tx, MelConfig(n_mels=64, freqm=8, timem=8), param_sr=True)
        for _ in range(2):
            state, m = step(state, batch, 3)
        out.append((m["loss"], state))
    (l0, s0), (l1, s1) = out
    assert torch.equal(l0, l1)
    for want, got in ((s0.params, s1.params), (s0.opt_state.mu, s1.opt_state.mu), (s0.opt_state.nu, s1.opt_state.nu)):
        want = stack_block_params(want)
        for k in want:
            assert torch.equal(want[k], got[k]), k


def test_remat_replays_the_draws_of_each_block():
    """Inside a recomputed block the dropout and drop-path masks are
    recorded by the forward and replayed by the recompute: the gradients
    equal the plain model's, with the generators in the same state after."""
    kw = dict(SMALL, dtype="float32", attn_impl="xla", drop_rate=0.2, attn_drop_rate=0.1, drop_path_rate=0.2)
    sd = _loop_params(kw)
    x = _x()
    out = []
    for remat in (False, True):
        model = _model(dict(kw, remat=remat), sd)
        gens = {k: torch.Generator().manual_seed(5) for k in ("patchout", "dropout", "droppath")}
        lo, g = _grads(model, x, train=True, gens=gens)
        out.append((lo, g, gens["dropout"].get_state(), gens["droppath"].get_state()))
    (lo0, g0, d0, p0), (lo1, g1, d1, p1) = out
    assert torch.equal(lo0, lo1) and torch.equal(d0, d1) and torch.equal(p0, p1)
    for k in g0:
        assert torch.equal(g0[k], g1[k]), k


def _saved_bytes(model, x):
    """Bytes of the tensors the training forward saves for its backward,
    parameters' storages left out (each storage counted once)."""
    params = {p.untyped_storage().data_ptr() for p in model.parameters()}
    storages = {}

    def pack(t):
        s = t.untyped_storage()
        if s.data_ptr() not in params:
            storages[s.data_ptr()] = s.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        model(x, train=True, generators={k: torch.Generator().manual_seed(5)
                                         for k in ("patchout", "dropout", "droppath")})
    return sum(storages.values())


@pytest.mark.parametrize("impl", ["loop", "scan"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_frees_the_block_activations(impl, dtype):
    """What remat is for: the blocks' activations are not kept for the
    backward, only each block's input, so the training forward saves under
    a quarter of the bytes the plain forward saves (at 3 blocks, B = 2)."""
    kw = dict(SMALL, dtype=dtype, attn_impl="fused", blocks_impl=impl)
    sd = _loop_params(kw)
    if impl == "scan":
        sd = stack_block_params(sd)
    x = _x()
    plain, kept = (_saved_bytes(_model(dict(kw, remat=remat), sd), x) for remat in (False, True))
    assert kept < plain / 4, (kept, plain)


def test_scan_logits_match_jax_scan():
    """The port's scan model against the JAX package's (``nn.scan``), fp32,
    from the JAX scan init: the model bound of tests/test_torch_model.py,
    2e-4."""
    kw = dict(SMALL, dtype="float32", attn_impl="xla", blocks_impl="scan")
    jmodel, jparams = init_passt(JaxConfig(**kw), jax.random.PRNGKey(2))
    model = _model(kw, state_dict_from_flax(jax.tree.map(np.asarray, jparams)))
    x = _x()
    jl, jf = jmodel.apply({"params": jparams}, jnp.asarray(x.numpy()), train=False)
    with torch.no_grad():
        lo, feat = model(x)
    np.testing.assert_allclose(lo.numpy(), np.asarray(jl), atol=2e-4, rtol=0)
    np.testing.assert_allclose(feat.numpy(), np.asarray(jf), atol=2e-4, rtol=0)


def test_fp32_scan_train_step_matches_jax(injected_draws, monkeypatch):  # noqa: F811
    """One whole fp32 scan step, every draw injected, against the JAX scan
    step: the bounds of tests/test_torch_train.py's step test."""
    _fp32_step_vs_jax(monkeypatch, dict(attn_impl="xla", blocks_impl="scan"),
                      dict(attn_impl="fused", blocks_impl="scan"))


def test_representation_size_matches_jax():
    """``representation_size`` without distillation: the pre-logits Linear
    + tanh before the head (JAX ``pre_logits``), fp32 logits and features
    within 2e-4."""
    kw = dict(SMALL, dtype="float32", attn_impl="xla", distilled=False, representation_size=96)
    jmodel, jparams = init_passt(JaxConfig(**kw), jax.random.PRNGKey(4))
    sd = state_dict_from_flax(jax.tree.map(np.asarray, jparams))
    assert sd["pre_logits.fc.weight"].shape == (96, 192) and sd["head.1.weight"].shape == (11, 96)
    model = _model(kw, sd)
    x = _x()
    jl, jf = jmodel.apply({"params": jparams}, jnp.asarray(x.numpy()), train=False)
    with torch.no_grad():
        lo, feat = model(x)
    assert tuple(feat.shape) == (2, 96)
    np.testing.assert_allclose(lo.numpy(), np.asarray(jl), atol=2e-4, rtol=0)
    np.testing.assert_allclose(feat.numpy(), np.asarray(jf), atol=2e-4, rtol=0)


def test_cast_params_storage_judges_stacked_leaves_per_block():
    """bf16 storage picks matrices by the per-block rank: a stacked
    ``[depth, C]`` LayerNorm scale or bias stays fp32, as the JAX package's
    ``cast_params_storage`` keeps it; every leaf's dtype is JAX's."""
    _, jparams = init_passt(JaxConfig(**dict(SMALL, blocks_impl="scan")), jax.random.PRNGKey(0))
    want = state_dict_from_flax(jax.tree.map(lambda p: np.asarray(p.astype(jnp.float32)), jparams))
    jdtypes = jax.tree.map(lambda p: str(p.dtype), jax_cast(jparams, "bfloat16_sr"))
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): v
            for path, v in jax.tree_util.tree_flatten_with_path(jdtypes)[0]}
    got = cast_params_storage(want, "bfloat16_sr")
    assert got["blocks.block.norm1.weight"].dtype == torch.float32
    assert got["blocks.block.attn.qkv.weight"].dtype == torch.bfloat16
    assert got["blocks.block.mlp.fc1.bias"].dtype == torch.float32
    from passt_tpu_torch.parallel.mesh import jax_path

    for k, t in got.items():
        assert str(t.dtype).replace("torch.", "") == flat[jax_path(k)], k


def test_checkpoint_resumes_under_another_blocks_impl(tmp_path):
    """A checkpoint written under the loop layout restores into a scan (and
    a stacked) train state and back: parameters, AdamW moments and SWA
    re-laid, the same values."""
    from passt_tpu_torch.train.loop import _CheckpointManager, restore_checkpoint
    from torch.utils import _pytree as pytree

    kw = dict(SMALL, dtype="float32")
    sd = _loop_params(kw)
    tx = make_optimizer(lr=1e-3, steps_per_epoch=2, moments_dtype="bfloat16_sr")
    opt = tx.init(sd)
    opt = opt._replace(count=3, mu={k: torch.randn_like(v, dtype=torch.float32).to(v.dtype) for k, v in opt.mu.items()})
    ckpt = _CheckpointManager(str(tmp_path), 2, None, "max")
    ckpt.save(0, {"epoch": 0, "step": 7, "params": sd, "opt_state": pytree.tree_flatten(opt)[0],
                  "swa_params": sd, "swa_n": 2, "metrics": {}})
    for impl in ("scan", "stacked"):
        tmpl_params = stack_block_params({k: torch.zeros_like(v) for k, v in sd.items()})
        tmpl = TrainState(params=tmpl_params, opt_state=tx.init(tmpl_params), step=0)
        state, swa, epoch = restore_checkpoint(str(tmp_path), tmpl)
        assert epoch == 0 and state.step == 7 and state.opt_state.count == 3 and swa[1] == 2
        for k, v in stack_block_params(sd).items():
            assert torch.equal(state.params[k], v) and torch.equal(swa[0][k], v), k
        for k, v in stack_block_params(opt.mu).items():
            assert torch.equal(state.opt_state.mu[k], v), k
    back_tmpl = TrainState(params={k: torch.zeros_like(v) for k, v in sd.items()}, opt_state=tx.init(sd), step=0)
    ckpt.save(1, {"epoch": 1, "step": 9, "params": stack_block_params(sd),
                  "opt_state": pytree.tree_flatten(tx.init(stack_block_params(sd)))[0], "swa_params": None,
                  "swa_n": 0, "metrics": {}})
    state, _, _ = restore_checkpoint(str(tmp_path), back_tmpl)
    for k, v in sd.items():
        assert torch.equal(state.params[k], v), k


def test_ab_tools_name_valid_forms_and_refuse_the_cpu():
    """The A/B tools' forms are valid model configs (remat under the loop;
    stacked refuses remat, as the JAX package does), and both tools time
    the card only: a CPU device raises before any work."""
    from passt_tpu_torch.tools import ab_batched_dw, ab_scan_blocks

    assert set(ab_scan_blocks.VARIANTS) == {"loop", "scan", "stacked", "loop+remat"}
    for overrides in ab_scan_blocks.VARIANTS.values():
        PaSSTConfig(**dict(SMALL, **overrides)).use_scan_blocks
    with pytest.raises(NotImplementedError, match="remat is not honored"):
        PaSSTConfig(**dict(SMALL, blocks_impl="stacked", remat=True)).use_scan_blocks
    for tool in (ab_scan_blocks, ab_batched_dw):
        with pytest.raises(RuntimeError, match="times the card"):
            tool.run("cpu")
