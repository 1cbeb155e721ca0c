"""Samplers: class-balanced weighted epoch sampling with rank sharding
(port of passt_tpu/data/sampler.py; numpy, the same draws from the same
seed and epoch).

Reference semantics (audioset/dataset.py:257-306, 381-400):
- per-class frequency + offset 100 -> weight 1000/freq; a sample's weight is
  the sum (or max) of its labels' class weights,
- each epoch draws ``epoch_len=100000`` indices *without replacement* from
  those weights,
- the generator is reseeded with ``seed + epoch`` every epoch, then the
  index list is sliced ``indices[rank::num_replicas]`` per data-parallel
  rank — identical draws on every rank, disjoint slices.

Weighted sampling without replacement uses the exponential-race trick
(keys = exp(1)/w, take the ``epoch_len`` smallest), which draws from the
same distribution as torch's iterative WeightedRandomSampler.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional

import numpy as np


def class_balanced_sample_weights(
    targets: np.ndarray, offset: float = 100.0, sum_weights: bool = True
) -> np.ndarray:
    """targets: [N, C] multi-hot -> per-sample weight [N]
    (reference get_ft_cls_balanced_sample_weights, audioset/dataset.py:257-290)."""
    targets = np.asarray(targets, dtype=np.float64)
    per_class = offset + targets.sum(axis=0, keepdims=True)
    per_class_weights = 1000.0 / per_class
    all_weight = targets * per_class_weights
    if sum_weights:
        return all_weight.sum(axis=1)
    return all_weight.max(axis=1)


def class_balanced_sample_weights_streamed(
    chunk_iter_factory, num_classes: int, offset: float = 100.0
) -> np.ndarray:
    """Two-pass streamed :func:`class_balanced_sample_weights` for
    containers too large to unpack at once (AudioSet-2M's multi-hot matrix
    is ~4 GB fp32 and the in-memory path peaked at ~20 GB in fp64; the
    math needs only per-class counts plus one matvec per row).
    ``chunk_iter_factory()`` must yield the same ``[n, C]`` multi-hot
    chunks on both calls. Same float64 math as the in-memory function."""
    counts = np.zeros(num_classes, np.float64)
    n = 0
    for t in chunk_iter_factory():
        counts += np.asarray(t, np.float64).sum(axis=0)
        n += len(t)
    per_class_weights = 1000.0 / (offset + counts)
    out = np.empty(n, np.float64)
    lo = 0
    for t in chunk_iter_factory():
        out[lo : lo + len(t)] = np.asarray(t, np.float64) @ per_class_weights
        lo += len(t)
    return out


class WeightedEpochSampler:
    """Epoch-reseeded, rank-sliced weighted sampler
    (reference DistributedSamplerWrapper(WeightedRandomSampler),
    audioset/dataset.py:294-306, 381-400)."""

    def __init__(
        self,
        weights: np.ndarray,
        epoch_len: int = 100000,
        replacement: bool = False,
        num_replicas: int = 1,
        rank: int = 0,
        seed: int = 0,
    ):
        self.weights = np.asarray(weights, dtype=np.float64)
        self.epoch_len = epoch_len
        self.replacement = replacement
        self.num_replicas = num_replicas
        self.rank = rank
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    @property
    def _draw_len(self) -> int:
        if self.replacement:
            return self.epoch_len
        return min(self.epoch_len, len(self.weights))

    def __len__(self) -> int:
        # Every rank gets EXACTLY draw_len // num_replicas items: the raw
        # reference slice (openmic/dataset.py:316) lets ranks differ by
        # one, which under the collective train step means the longer rank
        # dispatches a step + stop-agreement all-gather the others never
        # join — a distributed hang. Trimming the
        # remainder (< num_replicas items/epoch) keeps per-rank batch
        # counts identical; eval's SequentialSampler stays ragged on
        # purpose (the eval gather pads unequal shards).
        return self._draw_len // self.num_replicas if self.num_replicas > 1 else self._draw_len

    def _draw(self, rng: np.random.Generator) -> np.ndarray:
        n = len(self.weights)
        k = self._draw_len
        if self.replacement:
            p = self.weights / self.weights.sum()
            return rng.choice(n, size=k, replace=True, p=p)
        # Exponential race: the k smallest exp(1)/w_i are a weighted sample
        # without replacement, ordered by draw.
        with np.errstate(divide="ignore"):
            keys = rng.exponential(size=n) / self.weights
        top = np.argpartition(keys, k - 1)[:k]
        return top[np.argsort(keys[top], kind="stable")]

    def __iter__(self) -> Iterator[int]:
        rng = np.random.default_rng(self.seed + self.epoch)
        indices = self._draw(rng)
        sl = indices[self.rank :: self.num_replicas]
        return iter(sl[: len(self)].tolist())


class SequentialSampler:
    def __init__(self, n: int, num_replicas: int = 1, rank: int = 0):
        self.n = n
        self.num_replicas = num_replicas
        self.rank = rank

    def set_epoch(self, epoch: int) -> None:
        pass

    def __len__(self):
        return (self.n - self.rank + self.num_replicas - 1) // self.num_replicas

    def __iter__(self):
        return iter(range(self.rank, self.n, self.num_replicas))


class ShuffleSampler:
    """Seed+epoch-reseeded shuffle with rank slicing (the non-AudioSet
    training loaders use shuffle=True with per-epoch reseeds)."""

    def __init__(self, n: int, num_replicas: int = 1, rank: int = 0, seed: int = 0):
        self.n = n
        self.num_replicas = num_replicas
        self.rank = rank
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self):
        # equal per-rank counts (see WeightedEpochSampler.__len__)
        return self.n // self.num_replicas if self.num_replicas > 1 else self.n

    def __iter__(self):
        rng = np.random.default_rng(self.seed + self.epoch)
        perm = rng.permutation(self.n)
        sl = perm[self.rank :: self.num_replicas]
        return iter(sl[: len(self)].tolist())


class LengthGroupedBatchSampler:
    """Batch sampler for EXACT variable-length eval: indices grouped by
    exact clip length, chunks of at most ``batch_size`` — batch boundaries
    never straddle two lengths, so no clip is ever padded and the numerics
    are bitwise the reference's batch_size=1 protocol
    (fsd50k/dataset.py:70-79) while FSD50K's ~10k-clip eval runs one
    batch shape per DISTINCT length instead of one call per clip, and
    identical-length clips batch onto the tensor cores together.

    Order is deterministic: ascending length, original index order within
    a length group (eval metrics are order-invariant; outputs are
    re-associated by index downstream through the loader's item order)."""

    def __init__(self, lengths, batch_size: int, num_replicas: int = 1, rank: int = 0):
        self.batch_size = int(batch_size)
        by_len: Dict[int, List[int]] = {}
        for i, n in enumerate(lengths):
            by_len.setdefault(int(n), []).append(i)
        self.batches: List[List[int]] = []
        for n in sorted(by_len):
            idxs = by_len[n]
            for k in range(0, len(idxs), self.batch_size):
                self.batches.append(idxs[k : k + self.batch_size])
        self.num_distinct_lengths = len(by_len)
        if num_replicas > 1:
            # round-robin over WHOLE batches: every shard stays length-pure
            self.batches = self.batches[rank::num_replicas]

    def set_epoch(self, epoch: int) -> None:  # deterministic eval order
        pass

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)
