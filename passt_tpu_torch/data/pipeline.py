"""Batching, prefetch and the host->card feed (port of
passt_tpu/data/pipeline.py).

A sampler drives dataset reads, items are collated to dense numpy batches,
and a background-thread prefetcher overlaps host IO and augmentation with
the card's steps. :class:`DeviceFeed` is the card's version of the JAX
package's transfer thread: each batch is staged in pinned host memory and
copied to the card on a side CUDA stream, so the copy of batch k+1 runs
under step k; the consumer's stream waits on the copy's event.
"""

from __future__ import annotations

import atexit
import queue
import threading
import weakref
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from passt_tpu_torch.data.datasets import AudioDataset, set_epoch_recursive


def default_collate(items, pad_to_multiple: int = 0) -> Dict[str, np.ndarray]:
    """(waveform, name, target) items -> {'wave': [B, T], 'target': [B, C],
    'name': list}. Variable-length waveforms are zero-padded to the batch
    max (clip_length=None variable-length eval; the reference uses
    batch_size=1 there, fsd50k/dataset.py). ``pad_to_multiple`` (samples)
    additionally rounds the batch length up so the number of distinct padded
    shapes stays bounded."""
    waves = [np.asarray(it[0]).reshape(-1) for it in items]
    names = [it[1] for it in items]
    targets = [np.asarray(it[2]) for it in items]
    t_max = max(len(w) for w in waves)
    if pad_to_multiple:
        t_max = -(-t_max // pad_to_multiple) * pad_to_multiple
    wave = np.zeros((len(waves), t_max), dtype=np.float32)
    for i, w in enumerate(waves):
        wave[i, : len(w)] = w
    return {
        "wave": wave,
        "target": np.stack(targets).astype(np.float32),
        "name": names,
    }


class DataLoader:
    """Sampler-driven batch iterator.

    ``set_epoch`` must be called per epoch: it reseeds epoch-dependent
    samplers AND the augmentation seeds down the dataset chain (the
    reference sets ``reload_dataloaders_every_epoch=True`` for exactly
    this purpose, ex_audioset.py:75).

    ``num_workers`` threads parallelize the per-item dataset reads inside
    each batch (the reference runs 16 decode worker *processes* per GPU,
    ex_audioset.py:42-48; here HDF5/decode releases the GIL and each worker
    thread holds its own HDF5 handle, so threads suffice and share memory
    with zero serialization cost). Item augmentation is a pure function of
    (epoch seed, index), so worker count and scheduling never change the
    produced batches.

    ``batch_builder`` (optional) replaces per-item reads + collate with a
    fused ``fn(indices) -> batch dict`` — the hook for the native C++
    batch assembler (passt_tpu_torch.data.native_loader).

    ``batch_sampler`` (optional, instead of ``sampler``+``batch_size``)
    yields whole index lists per batch — the hook for length-grouped exact
    eval where batch boundaries must align with clip-length groups.
    """

    def __init__(
        self,
        dataset: AudioDataset,
        batch_size: int = 1,
        sampler=None,
        collate: Callable = default_collate,
        drop_last: bool = False,
        prefetch: int = 2,
        num_workers: int = 0,
        batch_builder: Optional[Callable] = None,
        batch_sampler=None,
    ):
        if (sampler is None) == (batch_sampler is None):
            raise ValueError("provide exactly one of sampler or batch_sampler")
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler
        self.batch_sampler = batch_sampler
        self.collate = collate
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.num_workers = num_workers
        self.batch_builder = batch_builder
        self._pool = None

    def set_epoch(self, epoch: int) -> None:
        if self.sampler is not None and hasattr(self.sampler, "set_epoch"):
            self.sampler.set_epoch(epoch)
        if self.batch_sampler is not None and hasattr(self.batch_sampler, "set_epoch"):
            self.batch_sampler.set_epoch(epoch)
        set_epoch_recursive(self.dataset, epoch)
        if self.batch_builder is not None and hasattr(self.batch_builder, "set_epoch"):
            self.batch_builder.set_epoch(epoch)

    def __len__(self) -> int:
        if self.batch_sampler is not None:
            return len(self.batch_sampler)
        n = len(self.sampler)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _read_items(self, idxs):
        if self.num_workers > 0:
            if self._pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._pool = ThreadPoolExecutor(
                    max_workers=self.num_workers, thread_name_prefix="loader"
                )
            return list(self._pool.map(self.dataset.__getitem__, idxs))
        return [self.dataset[i] for i in idxs]

    def _iter_batches(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.batch_sampler is not None:
            for idxs in self.batch_sampler:
                yield self._build(list(idxs))
            return
        buf = []
        for idx in self.sampler:
            buf.append(idx)
            if len(buf) == self.batch_size:
                yield self._build(buf)
                buf = []
        if buf and not self.drop_last:
            yield self._build(buf)

    def _build(self, idxs):
        if self.batch_builder is not None:
            return self.batch_builder(idxs)
        return self.collate(self._read_items(idxs))

    def __iter__(self):
        it = self._iter_batches()
        if self.prefetch > 0:
            return Prefetcher(it, depth=self.prefetch)
        return it


#: Live prefetchers, stopped at interpreter exit: an abandoned worker
#: daemon thread killed mid-h5py-read at teardown can hang the process.
_LIVE_PREFETCHERS: "weakref.WeakSet" = weakref.WeakSet()


@atexit.register
def _stop_live_prefetchers() -> None:
    for p in list(_LIVE_PREFETCHERS):
        try:
            p.stop()
        except Exception:
            pass


class Prefetcher:
    """Background-thread prefetch with a bounded queue.

    ``convert`` (optional) maps each item on the worker thread before it is
    queued — :class:`DeviceFeed` uses this for the host->device transfer.

    Call :meth:`stop` (or break out via a ``closing``-style pattern) when
    abandoning the iterator early — otherwise the worker thread would stay
    blocked on the bounded queue holding batches and file handles
    (limit_train_batches/limit_eval_batches break mid-stream every epoch).
    ``stop`` also forwards to the wrapped iterator's own ``stop`` when it
    has one (a DeviceFeed wrapping a Prefetcher releases both threads)."""

    _DONE = object()

    def __init__(self, iterator: Iterator, depth: int = 2,
                 convert: Optional[Callable] = None, name: str = "prefetch"):
        self._inner = iterator
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.error: Optional[BaseException] = None
        self._stopped = False

        def worker():
            try:
                for item in iterator:
                    if convert is not None:
                        item = convert(item)
                    while not self._stopped:
                        try:
                            self.q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if self._stopped:
                        return
            except BaseException as e:  # propagate into consumer
                self.error = e
            finally:
                # The DONE sentinel must reach the consumer even when the
                # bounded queue is full at error time — a put_nowait here
                # would silently drop it and deadlock the consumer on
                # q.get(). Retry with the same bounded loop used for items.
                while not self._stopped:
                    try:
                        self.q.put(self._DONE, timeout=0.1)
                        break
                    except queue.Full:
                        continue

        self.thread = threading.Thread(target=worker, daemon=True, name=name)
        self.thread.start()
        _LIVE_PREFETCHERS.add(self)

    def stop(self) -> None:
        """Release the worker thread, drop queued batches, and stop the
        wrapped iterator (when it is stoppable)."""
        self._stopped = True
        while True:
            try:
                self.q.get_nowait()
            except queue.Empty:
                break
        if hasattr(self._inner, "stop"):
            self._inner.stop()
        # Let an in-flight read finish so the daemon thread is not killed
        # inside an h5py/C call at interpreter teardown (observed exit hang).
        self.thread.join(timeout=5.0)

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            try:
                item = self.q.get(timeout=5.0)
                break
            except queue.Empty:
                if not self.thread.is_alive():
                    # Worker exited without enqueueing DONE (can only happen
                    # if it was killed hard) — don't hang the consumer.
                    if self.error is not None:
                        raise self.error
                    raise StopIteration
        if item is self._DONE:
            # Join the worker before ending iteration. DONE is enqueued a
            # few bytecodes before the worker's frame actually unwinds; a
            # consumer that receives DONE and immediately exits the process
            # starts interpreter finalization while the daemon thread is
            # mid-teardown, and CPython then kills it at its next GIL
            # acquisition with whatever locks it holds — reproduced as a
            # deterministic futex deadlock in finalization whenever the
            # worker's dataset reads held an HDF5 handle (process hangs
            # after printing its last line; 3/3 without this join, 0/3
            # with). The worker has already finished producing, so the join
            # returns immediately in the non-broken case.
            self.thread.join(timeout=5.0)
            if self.error is not None:
                raise self.error
            raise StopIteration
        return item


class _PinnedSlot:
    """One pinned host staging buffer and the event of its last copy."""

    def __init__(self):
        self.host: Optional[torch.Tensor] = None
        self.event: Optional[torch.cuda.Event] = None

    def buffer(self, nbytes: int) -> torch.Tensor:
        if self.event is not None:
            # the previous copy out of this buffer may still be in flight:
            # refilling it before the copy completes would send the new
            # bytes under the old batch's name
            self.event.synchronize()
        if self.host is None or self.host.numel() < nbytes:
            self.host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        return self.host


_ALIGN = 256  # byte alignment of each array in a staged batch


def _layout(arrays: Dict[str, np.ndarray]) -> Tuple[List[Tuple[str, int, np.ndarray]], int]:
    """(name, byte offset, array) of each array in one staging buffer, and
    the buffer's size."""
    out, off = [], 0
    for name, a in arrays.items():
        a = np.ascontiguousarray(a)
        out.append((name, off, a))
        off += -(-a.nbytes // _ALIGN) * _ALIGN
    return out, max(off, _ALIGN)


class DeviceFeed(Prefetcher):
    """Host->device transfer pipelining: a background thread converts
    batch k+1 and copies it to ``device`` while the main thread's step k
    runs.

    ``convert(batch) -> (arrays, extra)`` runs on the feed thread: ``arrays``
    is a dict of numpy arrays to move (host-side casts and the int16
    quantization happen there), ``extra`` rides along unchanged. Iterating
    yields ``(tensors, extra)`` with ``tensors`` the same dict on
    ``device``.

    On a CUDA device each batch is packed into one pinned staging buffer
    from a ring of ``depth + 2`` and copied with one ``non_blocking`` copy
    on a side stream into one device buffer; the tensors are views of it.
    Three rules keep that safe:

    - the feed thread enters ``torch.cuda.device(device)`` and the side
      stream for every batch, so its allocations and copies land on the
      feed's card whatever the thread's current device is; the side stream
      is a high-priority one, which no CUDA-graph capture takes;
    - a staging buffer is refilled only after the event of its previous
      copy has completed (:class:`_PinnedSlot`);
    - the device buffer is allocated on the side stream and used on the
      consumer's: when the consumer takes a batch, its current stream waits
      on the copy's event and the buffer is ``record_stream``-ed on it, so
      the caching allocator cannot hand the memory to the next copy while
      the consumer's kernels still read it.

    On a CPU device the arrays become tensors with ``torch.from_numpy``
    (the tests' path). All the threading machinery (bounded queue, DONE
    sentinel, drain-then-join stop) is :class:`Prefetcher`'s.
    """

    def __init__(self, iterator, convert: Callable, device, depth: int = 2):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"DeviceFeed to {self.device}, but no CUDA device is available")
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
            # from the high-priority pool: PyTorch hands out each pool's
            # streams round robin, and the graphs capture on default-priority
            # ones (graphs.CudaGraph, tools.timing); a feed stream from that
            # pool is in time some capture's stream, and this thread's copy
            # and event then land inside the other thread's capture (the
            # consumer's wait on the event fails: cudaErrorInvalidValue)
            self._stream = torch.cuda.Stream(device=self.device, priority=-1)
            self._slots = [_PinnedSlot() for _ in range(depth + 2)]
            self._next_slot = 0
        super().__init__(iterator, depth=depth, convert=lambda b: self._transfer(*convert(b)),
                         name="device-feed")

    def _transfer(self, arrays: Dict[str, np.ndarray], extra: Any):
        if self.device.type != "cuda":
            return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in arrays.items()}, extra, None
        layout, nbytes = _layout(arrays)
        slot = self._slots[self._next_slot]
        self._next_slot = (self._next_slot + 1) % len(self._slots)
        host = slot.buffer(nbytes)
        staged = host.numpy()
        for _, off, a in layout:
            staged[off:off + a.nbytes] = a.reshape(-1).view(np.uint8)
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            dev = torch.empty(nbytes, dtype=torch.uint8, device=self.device)
            dev.copy_(host[:nbytes], non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        slot.event = event
        tensors = {
            name: dev[off:off + a.nbytes].view(torch.from_numpy(np.empty(0, a.dtype)).dtype).view(a.shape)
            for name, off, a in layout
        }
        return tensors, extra, (dev, event)

    def __next__(self):
        tensors, extra, ready = super().__next__()
        if ready is not None:
            dev, event = ready
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(event)
            dev.record_stream(consumer)
        return tensors, extra
