"""The train step's one-pass optimizer (passt_tpu_torch/train/optim.py
``adamw_sr``, ``csrc/adamw_sr.cu``): its plain version against the
``_foreach`` update and ``apply_updates_sr`` on the CPU, its Philox bits, its
segment table, the step's dispatch and its counter; and, marked ``card``, the
kernel against the plain version bit for bit on a CUDA card (they skip
without one: ``python -m pytest --noconftest -m card tests/test_torch_adamw_sr.py``
runs them there, where the repo's conftest, which imports jax, cannot load).

The plain version's mu and fp32 parameters are the ``_foreach`` path's bits;
its SR stores draw other bits (Philox counter bits keyed by the stream's
seed), so they are held to the ``_foreach`` path's fp32 values: each is one
of that value's two bf16 neighbours, and their mean over seeds is the value.
"""

import numpy as np
import pytest
import torch

import passt_tpu_torch.train.steps as steps_mod
from passt_tpu_torch.models.passt import PaSST, PaSSTConfig
from passt_tpu_torch.ops import _build
from passt_tpu_torch.ops.frontend import MelConfig
from passt_tpu_torch.parallel.mesh import TensorParallel
from passt_tpu_torch.train import optim
from passt_tpu_torch.train.steps import create_train_state, fused_optimizer, make_optimizer, make_train_step

HYPER = dict(b1=0.9, b2=0.999, eps=1e-8)
#: a layout with a run of stacked leaves (bf16 and fp32 interleaved) between
#: plain ones, sizes that are no multiple of 8
NAMES = ["patch.w", "patch.b", "blocks.block.n.s", "blocks.block.q.w", "blocks.block.q.b", "blocks.block.f.w",
         "head.w", "head.b"]
SHAPES = [(5, 7), (7,), (3, 6), (3, 4, 6), (3, 6), (3, 5, 3), (13, 9), (13,)]


def _leaves(seed, names=NAMES, shapes=SHAPES, grad_dtype=None, steps=2):
    """Parameters stored as bf16 SR storage stores them (matrices bf16,
    vectors fp32, by per-block rank), moments after ``steps`` updates of the
    ``_foreach`` path, and gradients (bf16 for bf16 leaves, or all
    ``grad_dtype``)."""
    g = torch.Generator().manual_seed(seed)
    params = {k: torch.randn(s, generator=g) for k, s in zip(names, shapes)}
    tx = optim.adamw_bf16sr(1e-3, weight_decay=1e-4)
    state = tx.init(params)
    params = optim.cast_params_storage(params, "bfloat16_sr")
    for i in range(steps):
        grads = {k: (torch.randn(p.shape, generator=g) * 1e-2).to(p.dtype) for k, p in params.items()}
        upd, state = tx.update(grads, state, params)
        params = optim.apply_updates_sr(params, upd, torch.Generator().manual_seed(100 + i))
    grads = {k: (torch.randn(p.shape, generator=g) * 1e-2).to(grad_dtype or p.dtype) for k, p in params.items()}
    return params, state, grads


def _lists(params, state, grads):
    keys = list(params)
    return ([grads[k] for k in keys], [state.mu[k] for k in keys], [state.nu[k] for k in keys],
            [params[k] for k in keys])


def _plain(params, state, grads, seeds=(11, 12), weight_decay=1e-4, lr=1e-3, c1=0.19, c2=0.001999, **kw):
    return optim.adamw_sr_plain(*_lists(params, state, grads), names=list(params), weight_decay=weight_decay,
                                lr=lr, c1=c1, c2=c2, seeds={"nu": seeds[0], "apply_updates_sr": seeds[1]},
                                **dict(HYPER, **kw))


def _foreach(params, state, grads, weight_decay=1e-4, lr=1e-3, c1=0.19, c2=0.001999):
    """The ``_foreach`` path's fp32 update, m and v, and the fp32 sums p + u."""
    upd, m, v = optim._adam_direction(*_lists(params, state, grads), c1=c1, c2=c2, lr=lr, optax_order=False,
                                      weight_decay=weight_decay, **HYPER)
    q = [p.float() + u for p, u in zip(params.values(), upd)]
    return upd, m, v, q


def _neighbours(x: torch.Tensor):
    bits = x.contiguous().view(torch.int32)
    lo = (bits & -65536).view(torch.float32)
    hi = ((bits & -65536) + 65536).view(torch.float32)
    return lo, hi


# ---- Philox ------------------------------------------------------------------------------------------


@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox4x32_known_answers(counter, key, want):
    """Philox4x32-10 gives Random123's known-answer vectors."""
    got = optim.philox4x32(*(torch.tensor([c], dtype=torch.int64) for c in counter), *key)
    assert [int(w) for w in got] == list(want)


def test_philox_draws_take_lanes_in_order():
    """Value d of a stream is lane d % 8 of the call at counter d // 8: the
    low half of word (d % 8) // 2 for an even lane, the high half for an
    odd one; a 0-d int64 seed draws as the int."""
    seed = 0x123456789ABCDEF
    got = optim.philox_draws(seed)(21, "cpu")
    for d in range(21):
        c = torch.tensor([d // 8], dtype=torch.int64)
        words = optim.philox4x32(c, c * 0, c * 0, c * 0, seed & 0xFFFFFFFF, seed >> 32)
        word = int(words[(d % 8) // 2])
        assert int(got[d]) == (word >> (16 * (d % 2))) & 0xFFFF
    assert torch.equal(got, optim.philox_draws(torch.tensor(seed))(21, "cpu"))


# ---- the plain version against the _foreach path -----------------------------------------------------------


@pytest.mark.parametrize("weight_decay", [0.0, 1e-4])
@pytest.mark.parametrize("scalars", ["floats", "tensors"])
def test_plain_mu_and_fp32_params_equal_foreach_bit_for_bit(weight_decay, scalars):
    """mu = bf16(m) rounded to nearest and the fp32 leaves' p + u are the
    ``_foreach`` update's and apply's bits, the scalars given as host floats
    or as 0-d fp32 tensors."""
    params, state, grads = _leaves(1)
    lr, c1, c2 = 1e-3, 0.19, 0.001999
    if scalars == "tensors":
        lr, c1, c2 = (torch.tensor(x, dtype=torch.float32) for x in (lr, c1, c2))
    new_p, mu, _ = _plain(params, state, grads, weight_decay=weight_decay, lr=lr, c1=c1, c2=c2)
    upd, state2 = optim.adamw_bf16sr(1e-3, weight_decay=weight_decay).update(
        grads, state, params, {"lr": lr, "c1": c1, "c2": c2, "nu": torch.Generator().manual_seed(0)})
    applied = optim.apply_updates_sr(params, upd, torch.Generator().manual_seed(0))
    for i, k in enumerate(params):
        assert torch.equal(mu[i], state2.mu[k]), k
        if params[k].dtype == torch.float32:
            assert new_p[i].dtype == torch.float32 and torch.equal(new_p[i], applied[k]), k


@pytest.mark.parametrize("store", ["nu", "params"])
def test_plain_sr_stores_are_bf16_neighbours_of_foreach(store):
    """Each SR store (nu; the bf16 parameters) is one of the two bf16
    neighbours of the ``_foreach`` path's fp32 value."""
    params, state, grads = _leaves(2)
    new_p, _, nu = _plain(params, state, grads)
    _, _, v, q = _foreach(params, state, grads)
    pairs = zip(nu, v) if store == "nu" else [(p, x) for p, x, old in zip(new_p, q, params.values())
                                              if old.dtype == torch.bfloat16]
    for got, ref in pairs:
        assert got.dtype == torch.bfloat16
        lo, hi = _neighbours(ref)
        got = got.float()
        assert bool(((got == lo) | (got == hi)).all())


@pytest.mark.parametrize("store", ["nu", "params"])
def test_plain_sr_is_unbiased_over_seeds(store):
    """Over 64 seeds, each SR store's error in units of its value's bf16
    spacing averages to 0 over a leaf of 4096: within five standard errors
    of the Bernoulli rounding (1 / 2 / sqrt(n) at worst). Truncation would
    read about -0.5."""
    params, state, grads = _leaves(3, ["w", "b"], [(64, 64), (64,)])
    _, _, v, q = _foreach(params, state, grads)
    ref = v[0] if store == "nu" else q[0]
    lo, hi = _neighbours(ref)
    seeds = range(64)
    total = 0.0
    for s in seeds:
        new_p, _, nu = _plain(params, state, grads, seeds=(1000 + s, 5000 + s))
        got = nu[0] if store == "nu" else new_p[0]
        total += float(((got.double() - ref.double()) / (hi - lo).double()).sum())
    n = len(seeds) * ref.numel()
    assert abs(total / n) < 5 * 0.5 / np.sqrt(n)


def test_plain_passes_nan_and_inf_through():
    """A NaN or infinite gradient gives NaN or infinite moments and
    parameters: SR stores them as bf16(x)."""
    params, state, grads = _leaves(4, ["w"], [(4, 8)])
    g = grads["w"].float()
    g[0, 0], g[1, 1], g[2, 2] = float("nan"), float("inf"), -float("inf")
    grads["w"] = g.to(torch.bfloat16)
    new_p, mu, nu = _plain(params, state, grads)
    _, m, v, q = _foreach(params, state, grads)
    for got, ref in ((mu[0], m[0]), (nu[0], v[0]), (new_p[0], q[0])):
        got = got.float()
        assert torch.equal(torch.isnan(got), torch.isnan(ref))
        assert torch.equal(torch.isposinf(got), torch.isposinf(ref))
        assert torch.equal(torch.isneginf(got), torch.isneginf(ref))
    assert bool(torch.isnan(nu[0].float()[0, 0])) and bool(torch.isinf(nu[0].float()[1, 1]))


def test_stacked_leaf_rounds_as_its_per_block_leaves():
    """A run of stacked ``blocks.block.*`` leaves gives, block by block, the
    bits of the per-block leaves ``blocks.{i}.*``: parameters and both
    moments."""
    depth = 3
    inner = [("n.s", (6,)), ("q.w", (4, 6)), ("q.b", (6,)), ("f.w", (5, 3))]
    per_block = ["patch.w"] + [f"blocks.{i}.{k}" for i in range(depth) for k, _ in inner] + ["head.b"]
    shapes = [(5, 7)] + [s for _ in range(depth) for _, s in inner] + [(13,)]
    params, state, grads = _leaves(5, per_block, shapes)
    loop = dict(zip(params, zip(*_plain(params, state, grads))))

    def stack(d):
        out = {"patch.w": d["patch.w"]}
        out.update({f"blocks.block.{k}": torch.stack([d[f"blocks.{i}.{k}"] for i in range(depth)]) for k, _ in inner})
        out["head.b"] = d["head.b"]
        return out

    sstate = optim.AdamState(state.count, stack(state.mu), stack(state.nu))
    stacked = dict(zip(stack(params), zip(*_plain(stack(params), sstate, stack(grads)))))
    for part in range(3):
        want = stack({k: v[part] for k, v in loop.items()})
        for k, got in stacked.items():
            assert torch.equal(got[part], want[k]), (part, k)


def test_plain_same_seed_same_bits_other_seed_other_bits():
    params, state, grads = _leaves(6)
    a, b, c = _plain(params, state, grads), _plain(params, state, grads), _plain(params, state, grads, seeds=(13, 14))
    assert all(torch.equal(x, y) for part in range(3) for x, y in zip(a[part], b[part]))
    assert not all(torch.equal(x, y) for x, y in zip(a[2], c[2]))
    assert not all(torch.equal(x, y) for x, y in zip(a[0], c[0]) if x.dtype == torch.bfloat16)


def test_plain_takes_fp32_gradients():
    """A fp32 gradient (gradient accumulation's mean) holding the same
    values as a bf16 one gives the same bits."""
    params, state, grads = _leaves(7)
    f32 = {k: g.float() for k, g in grads.items()}
    a, b = _plain(params, state, grads), _plain(params, state, f32)
    assert all(torch.equal(x, y) for part in range(3) for x, y in zip(a[part], b[part]))


def test_plain_refuses_what_the_kernel_does_not_take():
    params, state, grads = _leaves(8, ["w"], [(4, 8)])
    bad = optim.AdamState(state.count, {"w": state.mu["w"].float()}, state.nu)
    with pytest.raises(ValueError, match="bf16 moments"):
        _plain(params, bad, grads)
    with pytest.raises(ValueError, match="bf16 or fp32"):
        _plain(params, state, {"w": grads["w"].half()})


# ---- the kernel's segment table -----------------------------------------------------------------------


def test_segment_table_draws_as_the_plain_version():
    """Rounding each segment of ``_layout`` with its own run of the streams
    (draws d .. d + n - 1 from its first draw d, what the kernel does) gives
    the plain version's bits: the table's first draws follow the per-block
    order."""
    params, state, grads = _leaves(9)
    new_p, _, nu = _plain(params, state, grads)
    _, _, v, q = _foreach(params, state, grads)
    low = tuple(p.dtype == torch.bfloat16 for p in params.values())
    lay = optim._layout(tuple(params), tuple(tuple(p.shape) for p in params.values()), low)
    total = sum(p.numel() for p in params.values())
    streams = optim.philox_draws(11)(total, "cpu"), optim.philox_draws(12)(total, "cpu")
    covered = [0] * len(params)
    for leaf, first, n, nu_draw, p_draw in lay.segments.tolist():
        covered[leaf] += n
        for stream, draw, ref, got in ((streams[0], nu_draw, v, nu), (streams[1], p_draw, q, new_p)):
            if ref is q and not low[leaf]:
                continue
            x = ref[leaf].reshape(-1)[first:first + n]
            want = optim._sr_bits(x, stream[draw:draw + n])
            assert torch.equal(got[leaf].reshape(-1)[first:first + n], want), (leaf, first)
    assert covered == [p.numel() for p in params.values()]
    assert all(o % 8 == 0 for o in list(lay.out_offset) + list(lay.p_offset))


# ---- the step's dispatch -------------------------------------------------------------------------------


@pytest.mark.parametrize("case,want", [
    ("bf16sr", True), ("cpu", False), ("shares", False), ("adamw", False), ("sr_nu_off", False),
    ("param_sr_off", False), ("multi_steps", True), ("multi_steps_adamw", False),
])
def test_fused_optimizer_dispatch(case, want):
    """The one pass runs where the parameters are stored by SR, the
    transformation is adamw_bf16sr with sr_nu (alone or under multi_steps),
    there are no tensor-parallel shares, and the leaves lie on a CUDA
    device (no card needed to decide)."""
    tx = {"adamw": optim.adamw(1e-3), "sr_nu_off": optim.adamw_bf16sr(1e-3, sr_nu=False),
          "multi_steps": optim.multi_steps(optim.adamw_bf16sr(1e-3), 2),
          "multi_steps_adamw": optim.multi_steps(optim.adamw(1e-3), 2)}.get(case, optim.adamw_bf16sr(1e-3))
    tp = TensorParallel(2, 0) if case == "shares" else None
    device = torch.device("cpu") if case == "cpu" else torch.device("cuda", 0)
    assert fused_optimizer(tx, case != "param_sr_off", tp, device) is want


TINY = dict(input_fdim=32, input_tdim=50, embed_dim=32, depth=1, num_heads=2, num_classes=8, s_patchout_t=2,
            s_patchout_f=1)


def _tiny_step(moments_dtype="bfloat16_sr", grad_accum=1, param_sr=True, jit=False):
    tx = make_optimizer(lr=1e-3, steps_per_epoch=2, moments_dtype=moments_dtype, grad_accum=grad_accum)
    model, state = create_train_state(PaSSTConfig(**TINY), tx, torch.Generator().manual_seed(0),
                                      param_dtype="bfloat16_sr" if param_sr else None, device="cpu")
    step = make_train_step(model, tx, MelConfig(n_mels=32, freqm=4, timem=8), param_sr=param_sr, jit=jit)
    return step, state


def _batch(seed):
    rng = np.random.default_rng(seed)
    return {"wave": torch.from_numpy((rng.standard_normal((4, 16000)) * 0.3).astype(np.float32)),
            "target": torch.from_numpy((rng.uniform(size=(4, 8)) < 0.35).astype(np.float32))}


@pytest.mark.parametrize("kind", ["bf16sr", "adamw", "param_sr_off"])
def test_cpu_step_takes_foreach_and_counts_it(kind):
    """A step on the CPU runs the composition, one ``foreach`` a step, and
    launches nothing."""
    step, state = _tiny_step(moments_dtype=None if kind == "adamw" else "bfloat16_sr",
                             param_sr=kind != "param_sr_off")
    before = _build.launch_counts()
    for i in range(2):
        state, _ = step(state, _batch(i), 7)
    assert _build.launch_delta(before) == {"optim_paths": {"foreach": 2}}


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_fused_step_path_on_the_cpu(monkeypatch, grad_accum):
    """The step's fused path (forced on the CPU, where the wrapper runs its
    plain version): the first update's mu, fp32 leaves and loss equal the
    composition's bit for bit, its bf16 leaves lie within one bf16 ulp of
    them; a replayed run repeats its bits; gradient accumulation's
    accumulate branch counts ``foreach``."""
    batches = [_batch(i) for i in range(grad_accum)]
    step, state = _tiny_step(grad_accum=grad_accum)
    ref = state
    before = _build.launch_counts()
    for b in batches:
        ref, ref_m = step(ref, b, 3)
    assert _build.launch_delta(before) == {"optim_paths": {"foreach": grad_accum}}
    monkeypatch.setattr(steps_mod, "fused_optimizer", lambda tx, param_sr, tp, device: bool(param_sr))
    runs = []
    for _ in range(2):
        fstep, st = _tiny_step(grad_accum=grad_accum)
        before = _build.launch_counts()
        for b in batches:
            st, m = fstep(st, b, 3)
        assert _build.launch_delta(before) == ({"optim_paths": {"foreach": 1}} if grad_accum > 1 else {})
        runs.append((st, m))
    (st, m), (again, _) = runs
    inner = (lambda s: s.inner_opt_state) if grad_accum > 1 else (lambda s: s)
    assert torch.equal(m["loss"], ref_m["loss"])
    for k, p in st.params.items():
        assert torch.equal(p, again.params[k]) and torch.equal(inner(st.opt_state).nu[k], inner(again.opt_state).nu[k])
        assert torch.equal(inner(st.opt_state).mu[k], inner(ref.opt_state).mu[k]), k
        if p.dtype == torch.float32:
            assert torch.equal(p, ref.params[k]), k
        else:  # two SRs of one fp32 sum
            lo, hi = _neighbours(torch.maximum(p.float().abs(), ref.params[k].float().abs()))
            assert bool(((p.float() - ref.params[k].float()).abs() <= hi - lo).all()), k


def test_step_inputs_keep_device_seeds():
    """StepInputs keeps the named streams' seeds as 0-d int64 tensors,
    refreshed each call, and hands them to the optimizer under "seeds"."""
    inputs = steps_mod.StepInputs("cpu", steps_mod.SR_SEEDS)
    for step in (0, 4):
        seeds = {"nu": ("adamw_bf16sr.nu", step + 1), "apply_updates_sr": ("apply_updates_sr", step)}
        inputs.refresh({"lr": 1e-3}, seeds)
        got = inputs.optimizer()["seeds"]
        assert {k: int(t) for k, t in got.items()} == {k: optim.fold_seed(*p) for k, p in seeds.items()}
        assert all(t.dtype == torch.int64 and t.shape == () for t in got.values())
    assert "seeds" not in steps_mod.StepInputs("cpu").optimizer()


# ---- on the card ---------------------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel builds and runs only there")
    return torch.device("cuda", 0)


def _kernel_vs_plain(params, state, grads, dev, scalars="tensors"):
    """The kernel and the plain version on ``dev``, from the same leaves:
    lists of (kernel, plain) pairs for params, mu and nu."""
    lists = [[t.to(dev) for t in ts] for ts in _lists(params, state, grads)]
    lr, c1, c2, seeds = 1e-3, 0.19, 0.001999, {"nu": 2**62 + 12345, "apply_updates_sr": 987654321}
    kw = dict(names=list(params), weight_decay=1e-4, **HYPER)
    plain = optim.adamw_sr_plain(*lists, lr=lr, c1=c1, c2=c2, seeds=seeds, **kw)
    if scalars == "tensors":
        lr, c1, c2 = (torch.tensor(x, dtype=torch.float32, device=dev) for x in (lr, c1, c2))
        seeds = {k: torch.tensor(v, dtype=torch.int64, device=dev) for k, v in seeds.items()}
    before = _build.LAUNCHES["adamw_sr"]
    got = optim.adamw_sr(*lists, lr=lr, c1=c1, c2=c2, seeds=seeds, **kw)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["adamw_sr"] == before + 1
    return [list(zip(a, b)) for a, b in zip(got, plain)]


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t.view(torch.int32)


def _assert_bits(pairs):
    for part in pairs:
        for got, want in part:
            assert got.dtype == want.dtype and got.shape == want.shape
            assert torch.equal(_bits(got), _bits(want))


@pytest.mark.card
@pytest.mark.parametrize("scalars", ["tensors", "floats"])
def test_kernel_equals_plain_on_odd_sizes(card, scalars):
    """Leaves of 1 to 4099 values (no multiple of 8 among the odd ones), a
    stacked run, fp32 and bf16 gradients: bit for bit."""
    names = NAMES + ["odd.one", "odd.big"]
    shapes = SHAPES + [(1,), (4099,)]
    for grad_dtype in (None, torch.float32):
        _assert_bits(_kernel_vs_plain(*_leaves(20, names, shapes, grad_dtype), card, scalars))


@pytest.mark.card
def test_kernel_equals_plain_on_misaligned_tails(card):
    """Inputs that start one value off a 16-byte boundary take the scalar
    path: bit for bit."""
    params, state, grads = _leaves(21, ["a.w", "a.b"], [(37, 29), (29,)])

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        buf[1:] = t.reshape(-1)
        return buf[1:].view(t.shape)

    dev_lists = [[shifted(t.to(card)) for t in ts] for ts in _lists(params, state, grads)]
    assert all(t.data_ptr() % 16 for ts in dev_lists for t in ts)
    kw = dict(names=list(params), weight_decay=1e-4, lr=1e-3, c1=0.19, c2=0.001999,
              seeds={"nu": 5, "apply_updates_sr": 6}, **HYPER)
    got = optim.adamw_sr(*dev_lists, **kw)
    _assert_bits([list(zip(a, b)) for a, b in zip(got, optim.adamw_sr_plain(*dev_lists, **kw))])


@pytest.mark.card
def test_kernel_equals_plain_on_passt_s_leaves(card):
    """PaSST-S's 159 leaves in their storage dtypes: bit for bit."""
    with torch.device("meta"):
        net = PaSST(PaSSTConfig())
    shapes = {k: tuple(p.shape) for k, p in net.named_parameters()}
    assert len(shapes) == 159
    _assert_bits(_kernel_vs_plain(*_leaves(22, list(shapes), list(shapes.values()), steps=1), card))
