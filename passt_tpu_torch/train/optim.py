"""AdamW for the train step (port of passt_tpu/train/optim.py, plus the
optax ``adamw``/``adam`` the JAX package uses for fp32 moments).

An optimizer is a triple of functions: optax's ``init(params) -> state``
and ``update(grads, state, params, inputs=None) -> (updates, state)``, and
``plan(state) -> UpdatePlan``, which runs on the host alone. Parameters,
gradients, updates and moments are dicts of tensors keyed by parameter
name; the counts in the state are Python ints, so nothing waits on the
card. The plan says what the next update needs from the host: the branch it
takes, its scalars (the learning rate and the bias corrections, Welford's
divisor) in float32, the seeds of its generators, and the state's counts
after it. ``inputs`` carries them into ``update``: the scalars as 0-d fp32
tensors on the device and the generators seeded, so a CUDA graph of the
update reads them where they lie and its replays follow the host
(``train/steps.py``); ``inputs=None`` makes them from the plan, the scalars
as host floats (the same bits).

- :func:`adamw`: optax's AdamW (``mu_dtype`` stores the first moment in
  that dtype, the second stays in the parameters' init dtype).
- :func:`adamw_bf16sr`: both moments in bf16, the second stochastically
  rounded (SR: a uniform 16-bit value added below the bf16 mantissa, then
  truncated; unbiased, so the ~1e-3-relative EMA increments of ``nu`` still
  move it). Updates of bf16-stored leaves stay fp32, so
  :func:`apply_updates_sr` adds them in fp32 before its own SR store.
- :func:`cast_params_storage`: matrices and embeddings stored in bf16,
  vectors (biases, LayerNorm scales) in fp32, judged per block under a
  stacked layout (a ``blocks.block.*`` leaf has one more axis).
- :func:`multi_steps`: optax ``MultiSteps`` (gradient accumulation).

All arithmetic is fp32; only the storage is bf16. The SR bits come from a
Philox ``torch.Generator`` seeded from the update count. They are drawn in
the per-block layout's order whatever the layout (a stacked leaf rounds as
its per-block leaves would) and, under tensor parallelism, for whole
leaves. They differ from the JAX package's ``rng_bit_generator`` bits, so
SR is held to the JAX package statistically, not bit for bit. There is no TPU kernel
here; the moments update as ``torch._foreach_*`` ops over the leaf lists.
"""

from __future__ import annotations

import hashlib
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

Params = Dict[str, torch.Tensor]


class UpdatePlan(NamedTuple):
    """What an update needs from the host, from the state alone."""

    branch: tuple  # host values the update branches on (a graph cache keys on them)
    scalars: Dict[str, float]  # the update's scalars, each a float32 value
    seeds: Dict[str, tuple]  # generator name -> the parts of its seed (:func:`fold_seed`)
    after: object  # the state's counts after the update (its tensors are the input's)


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable
    plan: Callable


def host_inputs(plan: UpdatePlan, device) -> Dict[str, object]:
    """The ``inputs`` of an update from its plan: the scalars as host floats
    and a new generator per seed, on ``device``."""
    inputs: Dict[str, object] = dict(plan.scalars)
    inputs.update({name: seeded_generator(device, *parts) for name, parts in plan.seeds.items()})
    return inputs


def _device_of(params: Params) -> torch.device:
    return next(iter(params.values())).device


class AdamState(NamedTuple):
    count: int  # updates applied so far
    mu: Params
    nu: Params


def fold_seed(*parts) -> int:
    """A 63-bit generator seed from a tuple of ints and strings (the port's
    stand-in for ``jax.random.fold_in``): equal parts give equal seeds."""
    digest = hashlib.blake2b(repr(parts).encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") & ((1 << 63) - 1)


def seeded_generator(device, *parts) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(fold_seed(*parts))
    return gen


def _sr_bits(x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """fp32 -> bf16 by adding the uniform 16-bit values ``r`` below the bf16
    mantissa and truncating. NaN and inf pass through."""
    x = x.contiguous()
    # the int32 sum carries exactly like the unsigned one: two's complement
    truncated = ((x.view(torch.int32) + r) & -65536).view(torch.float32)
    return torch.where(torch.isfinite(x), truncated, x).to(torch.bfloat16)


def _stochastic_round_bf16(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """fp32 -> bf16 with unbiased stochastic rounding (:func:`_sr_bits` with
    values drawn from ``generator``)."""
    return _sr_bits(x, torch.randint(0, 1 << 16, x.shape, generator=generator, device=x.device, dtype=torch.int32))


#: name -> (the full leaf's shape, full -> this rank's share) for leaves a
#: tensor-parallel rank holds a share of (``TensorParallel.full_shapes``)
Shares = Optional[Dict[str, tuple]]


def _stochastic_round_many(xs: List[torch.Tensor], generator: torch.Generator,
                           shares: Optional[List[Optional[tuple]]] = None,
                           names: Optional[List[str]] = None) -> List[torch.Tensor]:
    """SR of several fp32 tensors in one pass over their concatenation;
    returns bf16 views of one buffer in the tensors' shapes.

    The bits are drawn in the per-block layout's order and put in the
    tensors' order, so that a leaf rounds alike in every layout and on every
    rank: ``names`` marks the stacked ``blocks.block.*`` leaves, whose draws
    are taken block by block as the per-block leaves of ``blocks.{i}.*``
    would take them; ``shares`` (per tensor: None, or a tensor-parallel
    share's ``(full shape, full -> share)``) draws for the full leaves, each
    share keeping its own. Where neither applies the draws are already in
    order and are used as drawn."""
    if not xs:
        return []
    shares = shares or [None] * len(xs)
    stacked = [bool(names) and names[i].startswith("blocks.block.") for i in range(len(xs))]
    full = [tuple(sh[0]) if sh else tuple(x.shape) for x, sh in zip(xs, shares)]
    r = torch.randint(0, 1 << 16, (sum(int(np.prod(f)) for f in full),), generator=generator,
                      device=xs[0].device, dtype=torch.int32)
    if any(stacked) or any(sh is not None for sh in shares):
        bits: List[torch.Tensor] = []
        at = i = 0
        while i < len(xs):
            j = i + 1
            while stacked[i] and j < len(xs) and stacked[j]:
                j += 1
            # a run of stacked leaves draws block-major, as the per-block layout does
            depth = full[i][0] if stacked[i] else 1
            per = [int(np.prod(f)) // depth for f in full[i:j]]
            rows = r[at: at + depth * sum(per)].view(depth, sum(per))
            bits += [part.reshape(f) for part, f in zip(rows.split(per, dim=1), full[i:j])]
            at, i = at + depth * sum(per), j
        r = torch.cat([(sh[1](b) if sh else b).reshape(-1) for b, sh in zip(bits, shares)])
    flat = _sr_bits(torch.cat([x.reshape(-1) for x in xs]), r)
    return [part.view(x.shape) for part, x in zip(flat.split([x.numel() for x in xs]), xs)]


def apply_updates(params: Params, updates: Params) -> Params:
    """optax ``apply_updates``: ``p + u`` in the promoted dtype, stored in
    the parameter's dtype."""
    return {k: (p + updates[k]).to(p.dtype) for k, p in params.items()}


def apply_updates_sr(params: Params, updates: Params, generator: torch.Generator, shares: Shares = None) -> Params:
    """:func:`apply_updates` with stochastically rounded stores for bf16
    leaves: the add runs in fp32 and SR puts it back in bf16, so updates far
    below the bf16 ulp at weight scale still move the weight in
    expectation. Other leaves follow :func:`apply_updates` exactly, with the
    update first cast to the parameter's dtype. ``shares``: the leaves a
    tensor-parallel rank holds a share of (:data:`Shares`)."""
    low = [k for k, p in params.items() if p.dtype == torch.bfloat16]
    sums = torch._foreach_add([params[k].float() for k in low], [updates[k].float() for k in low])
    out = dict(zip(low, _stochastic_round_many(sums, generator, [(shares or {}).get(k) for k in low], low)))
    for k, p in params.items():
        if k not in out:
            out[k] = (p + updates[k].to(p.dtype)).to(p.dtype)
    return {k: out[k] for k in params}


def leaf_rank(name: str, p: torch.Tensor) -> int:
    """A leaf's rank as one block sees it: a stacked ``blocks.block.*`` leaf
    carries a leading depth axis."""
    return p.ndim - 1 if name.startswith("blocks.block.") else p.ndim


def cast_params_storage(params: Params, param_dtype: Optional[str]) -> Params:
    """``param_dtype="bfloat16_sr"`` stores matrices and embeddings (a
    per-block rank >= 2, :func:`leaf_rank`) in bf16 and keeps vectors fp32;
    None / "float32" is the identity. Pair bf16 storage with
    :func:`apply_updates_sr` (a nearest-rounded bf16 add loses the update)."""
    if param_dtype in (None, "float32"):
        return dict(params)
    if param_dtype != "bfloat16_sr":
        raise ValueError(f"unknown param_dtype {param_dtype!r}; known: float32, bfloat16_sr")
    return {k: p.to(torch.bfloat16) if leaf_rank(k, p) >= 2 else p for k, p in params.items()}


def _schedule(learning_rate) -> Callable[[int], float]:
    if callable(learning_rate):
        return learning_rate
    return lambda _: float(np.float32(learning_rate))


def _scalars(**values) -> Dict[str, float]:
    """Each value rounded to float32, as a host float."""
    return {k: float(np.float32(v)) for k, v in values.items()}


def _in_dtype(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` (on the host)."""
    return float(torch.tensor(value, dtype=dtype))


def _adam_direction(grads, mu, nu, params, *, b1, b2, eps, weight_decay, c1, c2, lr, optax_order):
    """The fp32 AdamW update and moments over leaf lists (``c1``, ``c2`` and
    ``lr`` host floats or 0-d fp32 tensors: the same bits):
    ``m = b1 mu + (1 - b1) g``, ``v = b2 nu + (1 - b2) g^2``,
    ``u = -lr ((m / c1) / (sqrt(v / c2) + eps) + wd p)``. ``optax_order``
    rounds as optax does: ``b1 mu`` and ``b2 nu`` in the moments' storage
    dtype, with b1 and b2 themselves rounded to it first (JAX's weak-typed
    scalars: 0.9 is 0.8984375 against a bf16 moment), and
    ``(1 - b2) (g g)``; otherwise every product is fp32 and the increment is
    ``((1 - b2) g) g`` (the JAX package's ``adamw_bf16sr``)."""
    g32 = [g.float() for g in grads]
    if optax_order:
        decayed_mu = [(t * _in_dtype(b1, t.dtype)).float() for t in mu]
        decayed_nu = [(t * _in_dtype(b2, t.dtype)).float() for t in nu]
        inc = torch._foreach_mul(torch._foreach_mul(g32, g32), 1.0 - b2)
    else:
        decayed_mu = torch._foreach_mul([t.float() for t in mu], b1)
        decayed_nu = torch._foreach_mul([t.float() for t in nu], b2)
        inc = torch._foreach_mul(torch._foreach_mul(g32, 1.0 - b2), g32)
    m = torch._foreach_add(decayed_mu, torch._foreach_mul(g32, 1.0 - b1))
    v = torch._foreach_add(decayed_nu, inc)
    den = torch._foreach_div(v, c2)
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, eps)
    step = torch._foreach_div(m, c1)
    torch._foreach_div_(step, den)
    if weight_decay:
        torch._foreach_add_(step, torch._foreach_mul([p.float() for p in params], weight_decay))
    return torch._foreach_mul(step, -lr), m, v


def adamw(
    learning_rate,
    *,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 1e-4,
    mu_dtype: Optional[torch.dtype] = None,
) -> GradientTransformation:
    """optax ``adamw`` (``weight_decay=0`` is optax ``adam``): moments
    initialised as the parameters given to ``init`` (``mu`` in ``mu_dtype``
    when set), the rate evaluated at the pre-update count, fp32 updates."""
    sched = _schedule(learning_rate)

    def init(params: Params) -> AdamState:
        return AdamState(
            count=0,
            mu={k: torch.zeros_like(p, dtype=mu_dtype or p.dtype) for k, p in params.items()},
            nu={k: torch.zeros_like(p) for k, p in params.items()},
        )

    def plan(state: AdamState) -> UpdatePlan:
        count = state.count + 1
        c1 = np.float32(1.0) - np.float32(b1) ** np.float32(count)
        c2 = np.float32(1.0) - np.float32(b2) ** np.float32(count)
        return UpdatePlan((), _scalars(lr=sched(state.count), c1=c1, c2=c2), {}, state._replace(count=count))

    def update(grads: Params, state: AdamState, params: Params, inputs=None):
        keys = list(params)
        if inputs is None:
            inputs = host_inputs(plan(state), _device_of(params))
        upd, m, v = _adam_direction(
            [grads[k] for k in keys], [state.mu[k] for k in keys], [state.nu[k] for k in keys],
            [params[k] for k in keys], b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
            c1=inputs["c1"], c2=inputs["c2"], lr=inputs["lr"], optax_order=True,
        )
        mu = {k: t.to(mu_dtype or state.mu[k].dtype) for k, t in zip(keys, m)}
        nu = {k: t.to(state.nu[k].dtype) for k, t in zip(keys, v)}
        return dict(zip(keys, upd)), AdamState(count=state.count + 1, mu=mu, nu=nu)

    return GradientTransformation(init, update, plan)


def adamw_bf16sr(
    learning_rate,
    *,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 1e-4,
    sr_nu: bool = True,
) -> GradientTransformation:
    """AdamW with bf16 ``mu`` and stochastically rounded bf16 ``nu`` (see the
    module docstring). ``learning_rate`` is a float or a step schedule,
    evaluated at the pre-update count. Updates are fp32 for every leaf.
    ``inputs["shares"]`` (:data:`Shares`): a tensor-parallel rank's leaves,
    rounded as the whole leaves would be."""
    sched = _schedule(learning_rate)

    def init(params: Params) -> AdamState:
        zeros = {k: torch.zeros(p.shape, dtype=torch.bfloat16, device=p.device) for k, p in params.items()}
        return AdamState(count=0, mu=zeros, nu={k: z.clone() for k, z in zeros.items()})

    def plan(state: AdamState) -> UpdatePlan:
        count = state.count + 1
        t = np.float32(count)
        c1 = np.float32(1.0) - np.exp(t * np.log(np.float32(b1)))
        c2 = np.float32(1.0) - np.exp(t * np.log(np.float32(b2)))
        seeds = {"nu": ("adamw_bf16sr.nu", count)} if sr_nu else {}
        return UpdatePlan((), _scalars(lr=sched(state.count), c1=c1, c2=c2), seeds, state._replace(count=count))

    def update(grads: Params, state: AdamState, params: Params, inputs=None):
        keys = list(params)
        if inputs is None:
            inputs = host_inputs(plan(state), _device_of(params))
        upd, m, v = _adam_direction(
            [grads[k] for k in keys], [state.mu[k] for k in keys], [state.nu[k] for k in keys],
            [params[k] for k in keys], b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
            c1=inputs["c1"], c2=inputs["c2"], lr=inputs["lr"], optax_order=False,
        )
        mu = [x.to(torch.bfloat16) for x in m]
        shares = inputs.get("shares") or {}
        nu = (_stochastic_round_many(v, inputs["nu"], [shares.get(k) for k in keys], keys) if sr_nu
              else [x.to(torch.bfloat16) for x in v])
        return dict(zip(keys, upd)), AdamState(count=state.count + 1, mu=dict(zip(keys, mu)),
                                               nu=dict(zip(keys, nu)))

    return GradientTransformation(init, update, plan)


class MultiStepsState(NamedTuple):
    mini_step: int  # micro-steps accumulated since the last update
    gradient_step: int  # updates emitted so far
    inner_opt_state: object
    acc_grads: Params


def multi_steps(inner: GradientTransformation, every_k: int) -> GradientTransformation:
    """optax ``MultiSteps(inner, every_k_schedule=every_k)`` with the
    gradient mean: each micro-step folds its gradients into a running mean
    (``acc + (g - acc) / (n + 1)``, Welford's order, as optax); on the K-th
    the inner optimizer updates on the mean and the mean resets to zeros.
    The other micro-steps return zero updates and leave the inner state as
    it was. The accumulator starts in the dtype of the parameters given to
    ``init`` (fp32: the optimizer is initialised before the storage cast)
    and continues in the inner update's dtype after each update.

    The branch (accumulate or update) is taken on the host, from the
    state's ``mini_step``: a graph of the step is captured once per branch.
    The divisor ``n + 1`` is the scalar ``"div"``. ``inputs["reduce_grads"]``,
    where given, maps the accumulated mean before the inner update (the
    data-parallel step's all-reduce: once an update, not once a micro-step)."""

    def init(params: Params) -> MultiStepsState:
        return MultiStepsState(
            mini_step=0, gradient_step=0, inner_opt_state=inner.init(params),
            acc_grads={k: torch.zeros_like(p) for k, p in params.items()},
        )

    def plan(state: MultiStepsState) -> UpdatePlan:
        div = _scalars(div=state.mini_step + 1)
        if state.mini_step == every_k - 1:
            p = inner.plan(state.inner_opt_state)
            after = MultiStepsState(0, state.gradient_step + 1, p.after, state.acc_grads)
            return UpdatePlan(("update",) + p.branch, dict(div, **p.scalars), p.seeds, after)
        after = state._replace(mini_step=state.mini_step + 1)
        return UpdatePlan(("accumulate",), div, {}, after)

    def update(grads: Params, state: MultiStepsState, params: Params, inputs=None):
        if inputs is None:
            inputs = host_inputs(plan(state), _device_of(params))
        keys = list(state.acc_grads)
        acc = [state.acc_grads[k] for k in keys]
        g = [grads[k].to(torch.promote_types(grads[k].dtype, a.dtype)) for k, a in zip(keys, acc)]
        delta = torch._foreach_sub(g, acc)
        torch._foreach_div_(delta, inputs["div"])
        acc = dict(zip(keys, torch._foreach_add(acc, delta)))
        if state.mini_step == every_k - 1:
            if "reduce_grads" in inputs:
                acc = inputs["reduce_grads"](acc)
            updates, inner_state = inner.update(acc, state.inner_opt_state, params, inputs)
            zeros = {k: torch.zeros_like(u) for k, u in updates.items()}
            return updates, MultiStepsState(0, state.gradient_step + 1, inner_state, zeros)
        # optax returns emit * (the inner update): zeros in the update's dtype,
        # which is fp32 for every inner optimizer here
        updates = {k: torch.zeros_like(a, dtype=torch.float32) for k, a in acc.items()}
        return updates, MultiStepsState(state.mini_step + 1, state.gradient_step, state.inner_opt_state, acc)

    return GradientTransformation(init, update, plan)


def map_param_dicts(tree, names, fn):
    """``tree`` (an optimizer state: named tuples, tuples, lists, dicts)
    with ``fn`` applied to each dict keyed by the parameter ``names``."""
    if isinstance(tree, dict):
        if set(tree) == set(names):
            return fn(tree)
        return {k: map_param_dicts(v, names, fn) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(map_param_dicts(v, names, fn) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_param_dicts(v, names, fn) for v in tree)
    return tree


def global_norm(tensors) -> torch.Tensor:
    """optax ``global_norm``: the square root of the sum over tensors of
    each tensor's sum of squares (each sum in its tensor's dtype)."""
    return torch.sqrt(sum((t * t).sum() for t in tensors))
