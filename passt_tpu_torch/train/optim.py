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

All arithmetic is fp32; only the storage is bf16. SR bits are drawn in the
per-block layout's order whatever the layout (a stacked leaf rounds as its
per-block leaves would) and, under tensor parallelism, for whole leaves.
They differ from the JAX package's ``rng_bit_generator`` bits, so SR is held
to the JAX package statistically, not bit for bit.

Two paths run the optimizer phase of a train step with bf16-SR storage:

- :func:`adamw_sr`, one pass over every leaf (``csrc/adamw_sr.cu``, a
  hand-written kernel that replaces no TPU kernel: XLA fuses this on the
  TPU): the update of :func:`adamw_bf16sr` with ``sr_nu`` and the
  :func:`apply_updates_sr` that follows it, without materialising the
  updates. Its SR bits are Philox4x32-10 counter bits (:func:`philox_draws`)
  keyed by the stream's seed, at the value's place in the per-block order,
  so the kernel and its plain PyTorch version (:func:`adamw_sr_plain`, which
  a CPU tensor takes) give the same bits. The train step takes it where its
  leaves lie on a CUDA device, it stores bf16 parameters by SR, the
  transformation has :attr:`GradientTransformation.update_sr` and no
  tensor-parallel shares are given (``train/steps.py``).
- Everywhere else the update runs as ``torch._foreach_*`` ops over the leaf
  lists and the apply as :func:`apply_updates_sr` / :func:`apply_updates`,
  with SR bits from a Philox ``torch.Generator`` seeded from the update
  count (the apply's from the step).

``OPTIM_PATHS`` (``_build.COUNTERS["optim_paths"]``) counts the steps of
each: ``fused`` where :func:`adamw_sr` launches its kernel, ``foreach``
where a step takes the composition.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
from typing import Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from passt_tpu_torch.ops import _build

Params = Dict[str, torch.Tensor]

_KEY = "adamw_sr"
_build.LAUNCHES.setdefault(_KEY, 0)

#: the optimizer phase's path, counted once a step: ``fused`` (:func:`adamw_sr`
#: launched its kernel) or ``foreach`` (the ``_foreach`` update and the apply)
OPTIM_PATHS: Dict[str, int] = {"fused": 0, "foreach": 0}
_build.COUNTERS["optim_paths"] = OPTIM_PATHS


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
    #: ``update_sr(grads, state, params, inputs) -> (params, state)``: the
    #: update and :func:`apply_updates_sr` in one, through :func:`adamw_sr`;
    #: ``inputs`` as ``update``'s, plus ``inputs["seeds"]``: the ``"nu"`` and
    #: ``"apply_updates_sr"`` streams' seeds (ints or 0-d int64 tensors).
    #: None where the transformation has no such pass.
    update_sr: Optional[Callable] = None


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


#: ``draw(n, device)``: n uniform 16-bit values, int32, in a stream's order
Draw = Callable[[int, torch.device], torch.Tensor]


def _generator_draws(generator: torch.Generator) -> Draw:
    return lambda n, device: torch.randint(0, 1 << 16, (n,), generator=generator, device=device, dtype=torch.int32)


_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(a: torch.Tensor, m: int):
    """The high and low 32-bit words of ``a * m`` (``a`` uint32 values in
    int64), in 16-bit halves so that nothing overflows int64."""
    p0 = (a & 0xFFFF) * m
    p1 = (a >> 16) * m
    t = p0 + ((p1 & 0xFFFF) << 16)
    return (t >> 32) + (p1 >> 16), t & _MASK32


def philox4x32(c0, c1, c2, c3, k0, k1) -> List[torch.Tensor]:
    """Philox4x32-10 (Salmon et al., SC'11) of the counter words c0..c3
    under the key words k0, k1: int64 tensors (or ints) holding uint32
    values; returns the four output words, as ``csrc/adamw_sr.cu`` computes
    them."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W[0]) & _MASK32, (k1 + _PHILOX_W[1]) & _MASK32
    return [c0, c1, c2, c3]


def philox_draws(seed) -> Draw:
    """The stream of 16-bit values keyed by ``seed`` (an int, or a 0-d int64
    tensor on the device): value d is lane d % 8 of the Philox4x32-10 call at
    the counter (d // 8, 0, 0, 0), the low half of word (d % 8) // 2 for an
    even lane, the high half for an odd one."""

    def draw(n: int, device) -> torch.Tensor:
        counters = torch.arange((n + 7) // 8, dtype=torch.int64, device=device)
        zero = torch.zeros_like(counters)
        words = philox4x32(counters & _MASK32, counters >> 32, zero, zero, seed & _MASK32, seed >> 32)
        words = torch.stack(words, dim=1)  # [counters, 4]
        halves = torch.stack([words & 0xFFFF, words >> 16], dim=2)  # [counters, 4, 2]
        return halves.reshape(-1)[:n].to(torch.int32)

    return draw


#: name -> (the full leaf's shape, full -> this rank's share) for leaves a
#: tensor-parallel rank holds a share of (``TensorParallel.full_shapes``)
Shares = Optional[Dict[str, tuple]]


def _stochastic_round_many(xs: List[torch.Tensor], generator,
                           shares: Optional[List[Optional[tuple]]] = None,
                           names: Optional[List[str]] = None) -> List[torch.Tensor]:
    """SR of several fp32 tensors in one pass over their concatenation, with
    values drawn from ``generator`` (a ``torch.Generator``, or a
    :data:`Draw`); returns bf16 views of one buffer in the tensors' shapes.

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
    draw = _generator_draws(generator) if isinstance(generator, torch.Generator) else generator
    r = draw(sum(int(np.prod(f)) for f in full), xs[0].device)
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


#: leaf dtypes the one-pass update takes (``mu`` and ``nu`` are bf16)
_GRAD_DTYPES = (torch.bfloat16, torch.float32)
_PARAM_DTYPES = (torch.bfloat16, torch.float32)
#: the kernel's 16-byte accesses: outputs start each leaf at a multiple of 8 values
_ALIGN = 8


def _check_leaves(grads, mu, nu, params, names) -> None:
    if not (len(grads) == len(mu) == len(nu) == len(params) == len(names)) or not params:
        raise ValueError("adamw_sr takes one gradient, mu, nu and parameter per name, and at least one leaf")
    for k, g, m, v, p in zip(names, grads, mu, nu, params):
        if not (g.shape == m.shape == v.shape == p.shape):
            raise ValueError(f"{k}: shapes differ: g {tuple(g.shape)}, mu {tuple(m.shape)}, nu {tuple(v.shape)}, "
                             f"p {tuple(p.shape)}")
        if m.dtype != torch.bfloat16 or v.dtype != torch.bfloat16:
            raise ValueError(f"{k}: adamw_sr keeps bf16 moments, got mu {m.dtype}, nu {v.dtype}")
        if g.dtype not in _GRAD_DTYPES or p.dtype not in _PARAM_DTYPES:
            raise ValueError(f"{k}: adamw_sr takes bf16 or fp32 gradients and parameters, got {g.dtype}, {p.dtype}")
        if not (g.device == m.device == v.device == p.device == params[0].device):
            raise ValueError(f"{k}: leaves on more than one device")


def adamw_sr_plain(grads, mu, nu, params, *, names, b1, b2, eps, weight_decay, lr, c1, c2, seeds):
    """:func:`adamw_sr` in plain PyTorch, on any device: the kernel's
    arithmetic op by op (each a rounded fp32 op; the scalars as 0-d fp32
    tensors) and its SR bits (:func:`philox_draws` in the per-block order of
    :func:`_stochastic_round_many`). On a CUDA device every op rounds as the
    kernel's, so the two agree bit for bit there. On the CPU torch's fp32
    square root is not always correctly rounded (the ``_foreach`` update
    takes the same op), so there a value may differ from the kernel's by the
    rounding of one square root."""
    _check_leaves(grads, mu, nu, params, names)
    device = params[0].device

    def scalar(x):
        return x.to(device, torch.float32) if isinstance(x, torch.Tensor) else torch.tensor(x, dtype=torch.float32,
                                                                                           device=device)

    def seed(x):
        return x.to(device) if isinstance(x, torch.Tensor) else int(x)

    lr, c1, c2 = scalar(lr), scalar(c1), scalar(c2)
    ms, vs, qs = [], [], []
    for g, m0, v0, p in zip(grads, mu, nu, params):
        g, p32 = g.float(), p.float()
        m = m0.float() * b1 + g * (1.0 - b1)
        v = v0.float() * b2 + (g * (1.0 - b2)) * g
        step = (m / c1) / (torch.sqrt(v / c2) + eps)
        if weight_decay:
            step = step + p32 * weight_decay
        ms.append(m)
        vs.append(v)
        qs.append(p32 + step * -lr)
    new_nu = _stochastic_round_many(vs, philox_draws(seed(seeds["nu"])), names=list(names))
    low = [i for i, p in enumerate(params) if p.dtype == torch.bfloat16]
    rounded = _stochastic_round_many([qs[i] for i in low], philox_draws(seed(seeds["apply_updates_sr"])),
                                     names=[names[i] for i in low])
    for i, q in zip(low, rounded):
        qs[i] = q
    return qs, [m.to(torch.bfloat16) for m in ms], new_nu


def _block_draws(names, shapes) -> List[List[tuple]]:
    """Per leaf, its blocks as (first value in the leaf, values, first draw)
    in one SR stream over these leaves, in :func:`_stochastic_round_many`'s
    order: a run of stacked ``blocks.block.*`` leaves draws block-major, any
    other leaf in one block."""
    stacked = [k.startswith("blocks.block.") for k in names]
    out, at, i = [], 0, 0
    while i < len(names):
        j = i + 1
        while stacked[i] and j < len(names) and stacked[j]:
            j += 1
        depth = shapes[i][0] if stacked[i] else 1
        per = [int(np.prod(f)) // depth for f in shapes[i:j]]
        before = 0
        for n in per:
            out.append([(b * n, n, at + b * sum(per) + before) for b in range(depth)])
            before += n
        at, i = at + depth * sum(per), j
    return out


class _Layout(NamedTuple):
    """Where :func:`adamw_sr`'s kernel reads and writes, from the leaves'
    names, shapes and parameter dtypes alone."""

    segments: np.ndarray  # [S, 5] int64: leaf, first value in it, values, nu draw, apply draw
    out_offset: np.ndarray  # [L] a leaf's first value in the moments' buffers
    p_offset: np.ndarray  # [L] ... in its parameter dtype's buffer
    sizes: tuple  # values of the moments' buffers, the bf16 and the fp32 parameters' buffers


def _pad(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


@functools.lru_cache(maxsize=8)
def _layout(names: tuple, shapes: tuple, low: tuple) -> _Layout:
    nu_blocks = _block_draws(names, shapes)
    p_blocks = iter(_block_draws([k for k, b in zip(names, low) if b], [f for f, b in zip(shapes, low) if b]))
    rows = []
    for i, blocks in enumerate(nu_blocks):
        p_draws = [d for _, _, d in next(p_blocks)] if low[i] else [0] * len(blocks)
        rows += [(i, off, n, d, pd) for (off, n, d), pd in zip(blocks, p_draws) if n]
    numels = [_pad(int(np.prod(f))) for f in shapes]
    out_offset = np.cumsum([0] + numels)
    p_offset, sizes = np.zeros(len(names), np.int64), [0, 0]
    for i, n in enumerate(numels):
        p_offset[i] = sizes[0 if low[i] else 1]
        sizes[0 if low[i] else 1] += n
    return _Layout(np.array(rows, np.int64).reshape(-1, 5), out_offset[:-1], p_offset,
                   (int(out_offset[-1]), sizes[0], sizes[1]))


@functools.cache
def _lib():
    lib = _build.load("adamw_sr")
    vp = ctypes.c_void_p
    lib.passt_adamw_sr.argtypes = [vp, ctypes.c_int] + [vp] * 8
    lib.passt_adamw_sr.restype = ctypes.c_int
    return lib


def _view(buf: torch.Tensor, offset, shape: tuple) -> torch.Tensor:
    """The contiguous ``shape`` in ``buf`` from value ``offset`` on."""
    strides = np.cumprod((1,) + shape[:0:-1])[::-1] if shape else ()
    return buf.as_strided(shape, tuple(int(x) for x in strides), int(offset))


def adamw_sr(grads, mu, nu, params, *, names, b1, b2, eps, weight_decay, lr, c1, c2, seeds):
    """One pass of :func:`adamw_bf16sr`'s update (``sr_nu``) and
    :func:`apply_updates_sr` over leaf lists: returns (new parameters, new
    mu, new nu) as lists, the parameters in their dtypes (bf16 rounded by
    SR, fp32 as the fp32 sum), the moments in bf16 (mu rounded to nearest,
    nu by SR). ``names``: the leaves' names (the stacked layout's draw
    order); ``lr``, ``c1``, ``c2``: host floats or 0-d fp32 tensors on the
    leaves' device; ``seeds``: the ``"nu"`` and ``"apply_updates_sr"``
    streams' seeds, ints or 0-d int64 tensors there.

    On CUDA leaves it launches ``csrc/adamw_sr.cu`` (once, or once per 240
    segments) or raises; on CPU leaves it runs :func:`adamw_sr_plain`. Its
    mu and its fp32 parameters equal the ``_foreach`` update's and the
    apply's bit for bit; the SR stores draw other bits than theirs."""
    if params[0].device.type != "cuda":
        return adamw_sr_plain(grads, mu, nu, params, names=names, b1=b1, b2=b2, eps=eps,
                              weight_decay=weight_decay, lr=lr, c1=c1, c2=c2, seeds=seeds)
    _check_leaves(grads, mu, nu, params, names)
    device = params[0].device
    grads, mu, nu, params = ([t.contiguous() for t in ts] for ts in (grads, mu, nu, params))
    shapes = tuple(tuple(p.shape) for p in params)
    low = tuple(p.dtype == torch.bfloat16 for p in params)
    lay = _layout(tuple(names), shapes, low)
    mu_buf = torch.empty(lay.sizes[0], dtype=torch.bfloat16, device=device)
    nu_buf = torch.empty(lay.sizes[0], dtype=torch.bfloat16, device=device)
    p_bufs = (torch.empty(lay.sizes[1], dtype=torch.bfloat16, device=device),
              torch.empty(lay.sizes[2], dtype=torch.float32, device=device))

    # the segments' rows (csrc/adamw_sr.cu: seven pointers, two first draws, n | flags << 32)
    u64 = np.uint64
    leaf, first = lay.segments[:, 0], lay.segments[:, 1].astype(u64)
    sizes = np.array([[t.element_size() for t in ts] for ts in (grads, mu, nu, params)], u64)
    ptrs = np.array([[t.data_ptr() for t in ts] for ts in (grads, mu, nu, params)], u64)
    p_size = np.where(low, 2, 4).astype(u64)
    p_out = np.array([p_bufs[0 if b else 1].data_ptr() for b in low], u64) + lay.p_offset.astype(u64) * p_size
    out_first = lay.out_offset.astype(u64)[leaf] + first
    table = np.empty((len(leaf), 10), u64)
    table[:, :4] = (ptrs[:, leaf] + first * sizes[:, leaf]).T
    table[:, 4] = u64(mu_buf.data_ptr()) + u64(2) * out_first
    table[:, 5] = u64(nu_buf.data_ptr()) + u64(2) * out_first
    table[:, 6] = p_out[leaf] + first * p_size[leaf]
    table[:, 7:9] = lay.segments[:, 3:5].astype(u64)
    g32 = np.array([g.dtype == torch.float32 for g in grads])[leaf]
    aligned = np.all(table[:, :7] % u64(16) == 0, axis=1)
    flags = g32 | (~np.array(low)[leaf] << 1) | (aligned << 2)
    table[:, 9] = lay.segments[:, 2].astype(u64) | (flags.astype(u64) << u64(32))

    def operand(x, dtype):
        if isinstance(x, torch.Tensor):
            if x.device != device or x.dtype != dtype or x.numel() != 1:
                raise ValueError(f"adamw_sr: a device operand must be a 0-d {dtype} tensor on {device}, got "
                                 f"{x.dtype} {tuple(x.shape)} on {x.device}")
            return ctypes.c_void_p(x.data_ptr()), 0
        return None, x

    (lr_p, lr_v), (c1_p, c1_v), (c2_p, c2_v) = (operand(x, torch.float32) for x in (lr, c1, c2))
    (nu_p, nu_v), (ap_p, ap_v) = (operand(seeds[k], torch.int64) for k in ("nu", "apply_updates_sr"))
    consts = np.array([b1, 1.0 - b1, b2, 1.0 - b2, eps, weight_decay, lr_v, c1_v, c2_v], np.float32)
    seed_vals = np.array([int(nu_v) & (2**64 - 1), int(ap_v) & (2**64 - 1)], np.uint64)
    lib = _lib()
    code = lib.passt_adamw_sr(table.ctypes.data, len(table), consts.ctypes.data, seed_vals.ctypes.data,
                              lr_p, c1_p, c2_p, nu_p, ap_p, _build.stream_of(params[0]))
    _build.check(lib, code, "adamw_sr kernel launch")
    _build.LAUNCHES[_KEY] += 1
    OPTIM_PATHS["fused"] += 1
    return ([_view(p_bufs[0 if b else 1], o, f) for b, o, f in zip(low, lay.p_offset, shapes)],
            [_view(mu_buf, o, f) for o, f in zip(lay.out_offset, shapes)],
            [_view(nu_buf, o, f) for o, f in zip(lay.out_offset, shapes)])


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
    rounded as the whole leaves would be. With ``sr_nu``, ``update_sr``
    runs the update and the SR apply as :func:`adamw_sr` (no shares)."""
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

    def update_sr(grads: Params, state: AdamState, params: Params, inputs):
        keys = list(params)
        new_p, mu, nu = adamw_sr(
            [grads[k] for k in keys], [state.mu[k] for k in keys], [state.nu[k] for k in keys],
            [params[k] for k in keys], names=keys, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
            lr=inputs["lr"], c1=inputs["c1"], c2=inputs["c2"], seeds=inputs["seeds"],
        )
        return dict(zip(keys, new_p)), AdamState(count=state.count + 1, mu=dict(zip(keys, mu)),
                                                 nu=dict(zip(keys, nu)))

    return GradientTransformation(init, update, plan, update_sr if sr_nu else None)


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
    data-parallel step's all-reduce: once an update, not once a micro-step).
    ``update_sr``, where the inner optimizer has one, runs the update
    branch's inner update and apply as one pass and the accumulate branch
    as ``update`` and :func:`apply_updates_sr`."""

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

    def mean(grads: Params, state: MultiStepsState, inputs) -> Params:
        """The running mean with this micro-step's gradients folded in."""
        keys = list(state.acc_grads)
        acc = [state.acc_grads[k] for k in keys]
        g = [grads[k].to(torch.promote_types(grads[k].dtype, a.dtype)) for k, a in zip(keys, acc)]
        delta = torch._foreach_sub(g, acc)
        torch._foreach_div_(delta, inputs["div"])
        return dict(zip(keys, torch._foreach_add(acc, delta)))

    def update(grads: Params, state: MultiStepsState, params: Params, inputs=None):
        if inputs is None:
            inputs = host_inputs(plan(state), _device_of(params))
        acc = mean(grads, state, inputs)
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

    def update_sr(grads: Params, state: MultiStepsState, params: Params, inputs):
        if state.mini_step != every_k - 1:
            OPTIM_PATHS["foreach"] += 1
            updates, state = update(grads, state, params, inputs)
            return apply_updates_sr(params, updates, inputs["apply_updates_sr"]), state
        acc = mean(grads, state, inputs)
        if "reduce_grads" in inputs:
            acc = inputs["reduce_grads"](acc)
        params, inner_state = inner.update_sr(acc, state.inner_opt_state, params, inputs)
        # the inner update's dtype, fp32, as update's zeros
        zeros = {k: torch.zeros_like(a, dtype=torch.float32) for k, a in acc.items()}
        return params, MultiStepsState(0, state.gradient_step + 1, inner_state, zeros)

    return GradientTransformation(init, update, plan, update_sr if inner.update_sr is not None else None)


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
