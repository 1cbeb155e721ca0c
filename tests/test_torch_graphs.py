"""The port's graphed entry points (passt_tpu_torch.graphs and the steps and
Predictor built on it) on the CPU.

There is no CUDA graph here, so the graph path runs through
:class:`RecordingGraph`, a stand-in for ``graphs.CudaGraph`` defined in this
file: its capture runs the function once (what the graph's first replay
computes) and keeps the outputs; each later replay runs the function again,
writes the results into those outputs, and puts the launch counters back,
since a replay runs no wrapper. The tests install it with
``monkeypatch.setattr(graphs, "graph_type", ...)``. Against the JAX package:
the whole step over several calls (its warm-up call, its capture and its
replays), with the draws injected on both sides as in
tests/test_torch_train.py and the tolerances stated there.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree

import passt_tpu.models.passt as jax_passt_mod
import passt_tpu.ops.frontend as jax_frontend_mod
import passt_tpu.train.steps as jax_steps_mod
import passt_tpu_torch.models.passt as passt_mod
import passt_tpu_torch.ops.frontend as frontend_mod
import passt_tpu_torch.train.steps as steps_mod
from passt_tpu.models.passt import PaSSTConfig as JaxConfig
from passt_tpu.ops.frontend import MelConfig as JaxMelConfig
from passt_tpu_torch import graphs
from passt_tpu_torch.hear import Predictor
from passt_tpu_torch.models.passt import PaSST, PaSSTConfig
from passt_tpu_torch.models.pretrained import state_dict_from_flax
from passt_tpu_torch.ops import _build
from passt_tpu_torch.ops.frontend import MelConfig
from passt_tpu_torch.train import optim
from passt_tpu_torch.train.steps import (
    StepInputs,
    TrainState,
    make_eval_step,
    make_optimizer,
    make_train_step,
    step_generators,
)


class RecordingGraph:
    """The stand-in for ``graphs.CudaGraph`` (module docstring). ``log``
    collects every instance, in capture order."""

    log: list = []

    def __init__(self, device, shared, generators):
        self.generators = list(generators)
        self.fn = self.out = None
        self.pending = False
        self.replays = 0

    @classmethod
    def side(cls, device, shared):
        return contextlib.nullcontext()

    def capture(self, fn):
        RecordingGraph.log.append(self)
        self.fn, self.out, self.pending = fn, fn(), True
        return self.out

    def replay(self):
        self.replays += 1
        if self.pending:  # the capture's run stands for the first replay
            self.pending = False
            return
        saved = _build.launch_counts()
        packed, _ = self.fn()
        for name, counts in saved.items():
            _build.COUNTERS[name].clear()
            _build.COUNTERS[name].update(counts)
        if packed is not None:
            self.out[0].copy_(packed)


@pytest.fixture
def recording(monkeypatch):
    """Graphs on the CPU through RecordingGraph; returns its log."""
    RecordingGraph.log = []
    monkeypatch.setattr(graphs, "graph_type", lambda device: RecordingGraph)
    return RecordingGraph.log


# ---- the draws of tests/test_torch_train.py, on both sides ------------------------------------


def _np_mask(batch, size, mask_param, iid):
    rng = np.random.default_rng(size)
    n = batch if iid else 1
    width = np.floor(rng.uniform(size=(n, 1)) * mask_param)
    start = np.floor(rng.uniform(size=(n, 1)) * (size - width))
    idx = np.arange(size)[None, :]
    return np.broadcast_to((idx >= start) & (idx < start + width), (batch, size))


def _np_keep(size, keep):
    return np.sort(np.random.default_rng(1000 * size + keep).permutation(size)[:keep])


@pytest.fixture
def injected_draws(monkeypatch):
    monkeypatch.setattr(jax_frontend_mod, "_axis_mask",
                        lambda key, b, size, p, iid: jnp.asarray(_np_mask(b, size, p, iid)))
    monkeypatch.setattr(frontend_mod, "_axis_mask",
                        lambda gen, b, size, p, iid: torch.from_numpy(_np_mask(b, size, p, iid).copy()))
    monkeypatch.setattr(jax_passt_mod, "_sorted_keep_indices",
                        lambda key, size, keep: jnp.asarray(_np_keep(size, keep)))
    monkeypatch.setattr(passt_mod, "_sorted_keep_indices",
                        lambda gen, size, keep: torch.from_numpy(_np_keep(size, keep)))
    perm, lam = np.array([2, 0, 1]), np.array([0.7, 0.55, 0.9], np.float32)
    monkeypatch.setattr(jax_steps_mod, "sample_mixup", lambda key, b, a: (jnp.asarray(perm), jnp.asarray(lam)))
    monkeypatch.setattr(steps_mod, "sample_mixup", lambda gen, b, a: (torch.from_numpy(perm), torch.from_numpy(lam)))


KW = dict(embed_dim=64, depth=2, num_heads=4, input_tdim=98, s_patchout_t=3, s_patchout_f=2, u_patchout=4)
MEL_KW = dict(fmin_aug_range=1, fmax_aug_range=1, freqm=16, timem=20)


def _both_steps(opt_kw, port_kw=None):
    """The JAX step (jit, donated) and the port's (jit, donated) on bridged
    fp32 weights."""
    jtx = jax_steps_mod.make_optimizer(**opt_kw)
    jmodel, jstate = jax_steps_mod.create_train_state(JaxConfig(**KW, attn_impl="xla"), jtx, jax.random.PRNGKey(1))
    jstep = jax_steps_mod.make_train_step(jmodel, jtx, JaxMelConfig(**MEL_KW), jit=True, donate=True)
    ttx = make_optimizer(**opt_kw)
    params = state_dict_from_flax(jax.tree.map(np.asarray, jstate.params))
    state = TrainState(params=params, opt_state=ttx.init(params), step=0)
    step = make_train_step(PaSST(PaSSTConfig(**KW, attn_impl="fused")), ttx, MelConfig(**MEL_KW), jit=True,
                           donate=True, **(port_kw or {}))
    return jstep, jstate, step, state


def _step_batches(n):
    rng = np.random.default_rng(28)
    return [(rng.standard_normal((3, 32000)).astype(np.float32),
             (rng.uniform(size=(3, 527)) < 0.1).astype(np.float32)) for _ in range(n)]


def _assert_close_to_jax(state, jstate, mu, jmu, steps=1):
    """The whole-step test's bounds: each leaf's mu 1e-4 of the leaf's max,
    parameters 2e-5. A bf16 mu rounds once a step, and fp32 sums that
    differ in their last digits may round either way: one bf16 ulp (at
    most 2**-7 of the leaf's max) a step, carried on by b1 < 1, so after
    ``steps`` steps ``steps`` such ulps (2**-7 is the bound
    tests/test_torch_train.py holds one bf16 moment to)."""
    jparams = state_dict_from_flax(jax.tree.map(np.asarray, jstate.params))
    for k, ref in jparams.items():
        np.testing.assert_allclose(state.params[k].numpy(), ref.numpy(), atol=2e-5, rtol=0, err_msg=k)
    if mu is not None:
        for k, ref in state_dict_from_flax(jax.tree.map(np.asarray, jmu)).items():
            ref = ref.float()
            scale = max(float(ref.abs().max()), 1e-30)
            ulps = steps * 2.0**-7 if mu[k].dtype == torch.bfloat16 else 0.0
            assert float((mu[k].float() - ref).abs().max()) <= (1e-4 + ulps) * scale, k


@pytest.mark.parametrize("moments_dtype", [None, "bfloat16"])
def test_graphed_steps_match_jax(injected_draws, recording, moments_dtype):
    """Three consecutive calls of the graphed, donated step (its eager
    warm-up, its capture and one replay) with the warm-up lr moving
    (counts 0, 1, 2) against the JAX step jitted with its state donated:
    the loss (1e-5), the first moment and the parameters after every
    step (tests/test_torch_train.py's bounds). The returned states hold the
    graph's own tensors."""
    opt_kw = dict(lr=1e-3, steps_per_epoch=1, warm_up_len=4, moments_dtype=moments_dtype)
    jstep, jstate, step, state = _both_steps(opt_kw)
    sched = steps_mod.make_schedule(lr=1e-3, steps_per_epoch=1, warm_up_len=4)
    assert len({sched(c) for c in range(3)}) == 3
    held = None
    for i, (wave, target) in enumerate(_step_batches(3)):
        jstate, jm = jstep(jstate, {"wave": jnp.asarray(wave), "target": jnp.asarray(target)},
                           jax.random.PRNGKey(5))
        state, m = step(state, {"wave": torch.from_numpy(wave), "target": torch.from_numpy(target)}, 5)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), atol=1e-5)
        assert state.step == int(jstate.step) == i + 1 and state.opt_state.count == i + 1
        assert state.opt_state.mu["head.1.weight"].dtype == (torch.bfloat16 if moments_dtype else torch.float32)
        _assert_close_to_jax(state, jstate, state.opt_state.mu, jstate.opt_state[0].mu, steps=i + 1)
        if held is not None:  # donated: the same tensors every call
            assert all(state.params[k] is held[k] for k in held)
        held = state.params
    assert len(recording) == 1 and recording[0].replays == 2


def test_graphed_grad_accum_matches_optax_multisteps(injected_draws, recording):
    """grad_accum=2 over 4 micro-steps through the graphed step: one graph
    per optimizer branch (accumulate, update), each warmed up once, then
    captured; losses, counts and parameters after each micro-step against
    optax.MultiSteps (the whole-step bounds)."""
    opt_kw = dict(lr=1e-3, steps_per_epoch=1, warm_up_len=4, grad_accum=2)
    jstep, jstate, step, state = _both_steps(opt_kw)
    for i, (wave, target) in enumerate(_step_batches(6)):
        jstate, jm = jstep(jstate, {"wave": jnp.asarray(wave), "target": jnp.asarray(target)},
                           jax.random.PRNGKey(5))
        state, m = step(state, {"wave": torch.from_numpy(wave), "target": torch.from_numpy(target)}, 5)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), atol=1e-5)
        assert state.opt_state.mini_step == int(jstate.opt_state.mini_step) == (i + 1) % 2
        assert state.opt_state.gradient_step == int(jstate.opt_state.gradient_step) == (i + 1) // 2
        _assert_close_to_jax(state, jstate, None, None)
    assert state.opt_state.inner_opt_state.count == 3
    # calls 0, 1 warm the two branches up; calls 2, 3 capture them
    assert len(recording) == 2 and [g.replays for g in recording] == [2, 2]


# ---- the optimizer's scalars and the step's generators -------------------------------------------


@pytest.mark.parametrize("kind", ["adamw", "adamw_bf16mu", "adamw_bf16sr", "multi_steps"])
def test_device_scalars_equal_host_floats(kind):
    """An update given its plan's scalars as 0-d fp32 tensors and its
    generators seeded (StepInputs) gives the same bits as the host-float
    path (inputs=None), over four updates."""
    sched = steps_mod.make_schedule(lr=1e-3, steps_per_epoch=1, warm_up_len=3)
    tx = {"adamw": lambda: optim.adamw(sched),
          "adamw_bf16mu": lambda: optim.adamw(sched, mu_dtype=torch.bfloat16),
          "adamw_bf16sr": lambda: optim.adamw_bf16sr(sched),
          "multi_steps": lambda: optim.multi_steps(optim.adamw_bf16sr(sched), 2)}[kind]()
    rng = np.random.default_rng(3)
    params = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for k, s in
              (("w", (16, 8)), ("b", (8,)))}
    host = dev = tx.init(params)
    inputs = StepInputs("cpu")
    for i in range(4):
        grads = {k: torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32)) for k, p in params.items()}
        plan = tx.plan(dev)
        assert all(np.float32(v) == v for v in plan.scalars.values())
        inputs.refresh(plan.scalars, plan.seeds)
        assert all(t.shape == () and t.dtype == torch.float32 for t in inputs.scalars.values())
        hu, host = tx.update(grads, host, params)
        du, dev = tx.update(grads, dev, params, inputs.optimizer())
        for k in params:
            assert torch.equal(hu[k], du[k]), (i, k)
        hl, hs = pytree.tree_flatten(host)
        dl, ds = pytree.tree_flatten(dev)
        assert hs == ds and pytree.tree_flatten(plan.after)[1] == ds
        for a, b, c in zip(hl, dl, pytree.tree_leaves(plan.after)):
            assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b == c


def test_persistent_generators_draw_as_step_generators():
    """StepInputs' generators, reseeded from (seed, step, stream) each call,
    draw what step_generators makes anew at steps 0, 1 and 5, and again
    after a resume at step 3 (a fresh StepInputs, or the same one going
    back)."""
    def draws(gens):
        return {name: torch.rand(5, generator=g) for name, g in gens.items()}

    ours = StepInputs("cpu")
    for step in (0, 1, 5, 3):
        ours.refresh({}, steps_mod._stream_seeds(7, step))
        got = draws({k: ours.generators[k] for k in steps_mod.STREAMS})
        ref = draws(step_generators(7, step, "cpu"))
        assert all(torch.equal(got[k], ref[k]) for k in steps_mod.STREAMS)
    fresh = StepInputs("cpu")
    fresh.refresh({}, steps_mod._stream_seeds(7, 3))
    again = draws({k: fresh.generators[k] for k in steps_mod.STREAMS})
    assert all(torch.equal(again[k], draws(step_generators(7, 3, "cpu"))[k]) for k in steps_mod.STREAMS)
    assert not torch.equal(again["mel"], draws(step_generators(7, 4, "cpu"))["mel"])


TINY = dict(input_fdim=32, input_tdim=50, embed_dim=32, depth=1, num_heads=2, num_classes=8)
TINY_MEL = dict(n_mels=32, freqm=4, timem=8)


def _tiny(seed=0, grad_accum=1, **step_kw):
    cfg = PaSSTConfig(**TINY, s_patchout_t=2, s_patchout_f=1)
    tx = make_optimizer(lr=1e-3, steps_per_epoch=2, moments_dtype="bfloat16_sr", grad_accum=grad_accum)
    model, state = steps_mod.create_train_state(cfg, tx, torch.Generator().manual_seed(seed),
                                                param_dtype="bfloat16_sr", device="cpu")
    return model, tx, state, MelConfig(**TINY_MEL)


def _tiny_batch(seed, b=4):
    rng = np.random.default_rng(seed)
    return {"wave": torch.from_numpy((rng.standard_normal((b, 16000)) * 0.3).astype(np.float32)),
            "target": torch.from_numpy((rng.uniform(size=(b, 8)) < 0.35).astype(np.float32))}


def _clone(state):
    return TrainState({k: v.clone() for k, v in state.params.items()},
                      pytree.tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x, state.opt_state),
                      state.step)


def _equal_states(a, b):
    la, sa = pytree.tree_flatten((a.params, a.opt_state, a.step))
    lb, sb = pytree.tree_flatten((b.params, b.opt_state, b.step))
    return sa == sb and all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y for x, y in zip(la, lb))


def test_graphed_step_equals_eager_and_resumes(recording):
    """Real draws (mel jitter, SpecAugment, mixup, patchout, SR of nu and
    of the bf16 params), bf16 SR storage: five calls of the graphed step
    equal five eager steps bit for bit (state and loss), and a graphed
    step built anew from the eager state at step 3 (a restore) continues
    bit-equal to the run that went on."""
    model, tx, state0, mcfg = _tiny()
    kw = dict(param_sr=True, log_grad_norm=True)
    eager = make_train_step(model, tx, mcfg, jit=False, **kw)
    graphed = make_train_step(model, tx, mcfg, **kw)
    batches = [_tiny_batch(i) for i in range(5)]
    e, g, at3 = state0, _clone(state0), None
    for i, batch in enumerate(batches):
        if i == 3:
            at3 = _clone(e)
        e, em = eager(e, batch, 11)
        g, gm = graphed(g, batch, 11)
        assert set(em) == set(gm) and all(torch.equal(em[k], gm[k]) for k in em), i
        assert _equal_states(e, g), i
    resumed = make_train_step(model, tx, mcfg, **kw)
    r = at3
    for batch in batches[3:]:
        r, _ = resumed(r, batch, 11)
    assert _equal_states(r, e)


# ---- the cache's bookkeeping ---------------------------------------------------------------------


def test_cache_keys_on_shape_dtype_identity_and_branch(recording):
    """One graph per argument shape, dtype, in-place tensor identity and
    host key; a call that matches reuses its graph (after one eager warm-up
    call per signature)."""
    runs = []

    def fn(x, w):
        runs.append(1)
        return {"y": x * w["a"]}

    cache = graphs.GraphCache(fn)
    w1, w2 = {"a": torch.tensor(2.0)}, {"a": torch.tensor(3.0)}
    x = torch.ones(4)
    calls = [(x, w1, ()), (x, w1, ()), (x, w1, ()),  # warm-up, capture, replay
             (torch.ones(5), w1, ()), (torch.ones(5), w1, ()),  # another shape
             (x.double(), w1, ()), (x.double(), w1, ()),  # another dtype
             (x, w2, ()), (x, w2, ()),  # another in-place tensor
             (x, w1, ("update",)), (x, w1, ("update",))]  # another branch
    for arg, w, key in calls:
        out, _ = cache(arg, graphs.InPlace(w), key=key)
        torch.testing.assert_close(out["y"], arg * w["a"], rtol=0, atol=0)
    assert len(cache) == len(recording) == 5
    assert [g.replays for g in recording] == [2, 1, 1, 1, 1]
    # a copy of w1 at other addresses is another identity
    cache(x, graphs.InPlace({"a": w1["a"].clone()}))
    assert len(cache) == 5


def test_cache_copies_arguments_in_and_outputs_out(recording):
    """Arguments are copied into the graph's buffers, so a batch is never a
    captured constant; an argument that is its buffer is not copied; the
    outputs a caller keeps do not change at the next call."""
    cache = graphs.GraphCache(lambda x: {"y": x * 2.0, "s": x.sum()})
    kept = []
    for v in (1.0, 2.0, 3.0, 4.0):
        out, (buf,) = cache(torch.full((3,), v))
        kept.append(out)
        assert torch.equal(buf, torch.full((3,), v))
    for v, out in zip((1.0, 2.0, 3.0, 4.0), kept):
        assert torch.equal(out["y"], torch.full((3,), 2 * v)) and float(out["s"]) == 3 * v
    out, (again,) = cache(buf)
    assert again is buf and torch.equal(out["y"], torch.full((3,), 8.0))


def test_launch_deltas_are_added_per_replay(recording):
    """A wrapper that counts 2 launches per call: the warm-up call counts
    them, the capture's count is taken back and added by its replay, and
    every later replay adds them although no wrapper runs."""
    _build.LAUNCHES["test_kernel"] = 0
    paths = _build.COUNTERS.setdefault("test_paths", {"fast": 0})

    def fn(x):
        _build.LAUNCHES["test_kernel"] += 2
        paths["fast"] += 1
        return {"y": x + 1}

    cache = graphs.GraphCache(fn)
    try:
        for n in range(1, 6):
            cache(torch.zeros(2))
            assert _build.LAUNCHES["test_kernel"] == 2 * n and paths["fast"] == n
        assert recording[0].replays == 4
    finally:
        del _build.LAUNCHES["test_kernel"], _build.COUNTERS["test_paths"]


def test_foreign_state_is_copied_in_and_donate_false_leaves_it(recording):
    """The donated step writes into its own tensors and returns them; a
    state that is not the graph's (a restore) is copied in first and left
    as it was, and the result equals the eager step on it. With
    donate=False every returned state is new and the caller's is
    untouched."""
    model, tx, state0, mcfg = _tiny(seed=1)
    eager = make_train_step(model, tx, mcfg, jit=False, param_sr=True)
    step = make_train_step(model, tx, mcfg, param_sr=True)
    batch = _tiny_batch(20)
    s = state0
    for _ in range(3):
        s, _ = step(s, batch, 3)
    own = s.params
    foreign = _clone(state0)
    foreign_copy = _clone(foreign)
    got, _ = step(foreign, batch, 3)
    assert all(got.params[k] is own[k] for k in own)  # the graph's tensors
    assert _equal_states(foreign, foreign_copy)  # copied in, not written
    ref, _ = eager(foreign_copy, batch, 3)
    assert _equal_states(got, ref)

    keep = make_train_step(model, tx, mcfg, param_sr=True, donate=False)
    s, before = _clone(state0), _clone(state0)
    outs = []
    for _ in range(3):
        new, _ = keep(s, batch, 3)
        assert _equal_states(s, before)
        assert not any(new.params[k] is p for k, p in s.params.items())
        outs.append(new)
        s, before = new, _clone(new)
    ref = state0
    for _ in range(3):
        ref, _ = eager(ref, batch, 3)
    assert _equal_states(outs[-1], ref)


def test_eval_step_and_predictor_graphs(recording):
    """The graphed eval step equals the eager one over calls (a tail batch
    of another size gets its own graph; a second params set its own), and
    its kept outputs survive later calls; the graphed Predictor equals the
    eager one at two batch sizes and on timestamp windows."""
    model, _, state, mcfg = _tiny(seed=2)
    eager = make_eval_step(model, mcfg, jit=False)
    graphed = make_eval_step(model, mcfg)
    other = {k: v * 0.5 for k, v in state.params.items()}
    kept = []
    for i, (params, b) in enumerate([(state.params, 4)] * 3 + [(state.params, 3)] * 2 + [(other, 4)] * 2):
        batch = _tiny_batch(30 + i, b)
        got = graphed(params, batch)
        kept.append((got, eager(params, batch)))
    for got, ref in kept:
        assert set(got) == set(ref) and all(torch.equal(got[k], ref[k]) for k in ref)
    assert len(recording) == 3

    cfg = dict(TINY, num_classes=8, distilled=True)
    pred = Predictor(model=passt_mod.init_weights(PaSST(PaSSTConfig(**cfg)), torch.Generator().manual_seed(4)),
                     mel_cfg=MelConfig(n_mels=32), timestamp_chunk=16)
    plain = Predictor(model=pred.model, mel_cfg=pred.mel_cfg, timestamp_chunk=16, jit=False)
    rng = np.random.default_rng(9)
    for b in (1, 2, 1, 2, 1, 2):
        wave = rng.standard_normal((b, 16000)).astype(np.float32)
        for a, r in zip(pred.logits_and_features(wave), plain.logits_and_features(wave)):
            assert torch.equal(a, r)
    wave = rng.standard_normal((1, 12000)).astype(np.float32)
    for _ in range(3):
        for a, r in zip(pred.timestamp_embeddings(wave), plain.timestamp_embeddings(wave)):
            assert torch.equal(a, r)


def test_capture_failure_raises_without_fallback(monkeypatch):
    """A capture that fails raises: no eager call stands in for it."""
    class Failing(RecordingGraph):
        def capture(self, fn):
            raise RuntimeError("capture refused")

    monkeypatch.setattr(graphs, "graph_type", lambda device: Failing)
    runs = []
    cache = graphs.GraphCache(lambda x: runs.append(1) or {"y": x})
    cache(torch.zeros(1))  # the warm-up call
    with pytest.raises(RuntimeError, match="capture refused"):
        cache(torch.zeros(1))
    assert len(runs) == 1


def test_cpu_runs_eagerly_without_graphs():
    """On the CPU (no stand-in) the cache calls the function on the
    caller's own tensors and captures nothing."""
    seen = []
    cache = graphs.GraphCache(lambda x, w: seen.append((x, w)) or {"y": x + w})
    x, w = torch.ones(2), torch.ones(2)
    for _ in range(3):
        out, (xr, wr) = cache(x, graphs.InPlace(w))
        assert xr is x and wr is w and torch.equal(out["y"], x + w)
    assert len(cache) == 0 and len(seen) == 3


def test_capture_collects_first_and_pauses_the_collector():
    """``graphs.no_collection`` (around every capture on the card): a
    reference cycle dropped before the capture is collected before it, the
    cyclic collector stays off during it (a dropped cache's graph destroyed
    mid-capture invalidates the capture) and is back on after it."""
    import gc
    import weakref

    class Node:
        pass

    node = Node()
    node.cycle = node
    ref = weakref.ref(node)
    del node
    enabled = gc.isenabled()
    with graphs.no_collection():
        assert ref() is None and not gc.isenabled()
    assert gc.isenabled() == enabled
    with pytest.raises(ValueError):
        with graphs.no_collection():
            raise ValueError("a failed capture")
    assert gc.isenabled() == enabled
