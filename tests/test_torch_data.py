"""The port's data layer (passt_tpu_torch.data) against the JAX package's
(passt_tpu.data), on the CPU.

Both layers are numpy, so the same files, seeds and epochs must give
bit-equal items, index streams and batches: every comparison here is exact
(``assert_array_equal``). The HDF5 containers are written with the JAX
package's packer, as tests/test_data.py writes them; the wav folders with
the stdlib ``wave`` module.
"""

import os
import subprocess
import sys
import wave as wavemod

import numpy as np
import pytest
import torch

import passt_tpu.data as J
import passt_tpu_torch.data as P
from passt_tpu.data import native as jax_native
from passt_tpu.data import native_loader as jax_native_loader
from passt_tpu.data import sampler as jax_sampler
from passt_tpu.data.prepare import pack_waveform_hdf5
from passt_tpu_torch.data import datasets as port_datasets
from passt_tpu_torch.data import native as port_native
from passt_tpu_torch.data import native_loader as port_native_loader
from passt_tpu_torch.data import pipeline as port_pipeline
from passt_tpu_torch.data import sampler as port_sampler

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _items_equal(a, b):
    (wa, na, ta), (wb, nb, tb) = a, b
    assert na == nb
    assert wa.dtype == wb.dtype and ta.dtype == tb.dtype
    np.testing.assert_array_equal(wa, wb)
    np.testing.assert_array_equal(ta, tb)


def _batches_equal(a, b):
    assert set(a) == set(b)
    assert a["name"] == b["name"]
    for k in ("wave", "target"):
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k])


@pytest.fixture(scope="module")
def h5(tmp_path_factory):
    """20 clips of 1-3 s, 16 classes, packed targets (tests/test_data.py's
    container), plus an OpenMIC-layout container with float targets."""
    rng = np.random.default_rng(1234)
    tmp = tmp_path_factory.mktemp("h5")
    items, items_mask = [], []
    for i in range(20):
        wave = (rng.standard_normal(int(32000 * rng.uniform(1.0, 3.0))) * 0.1).astype(np.float32)
        target = np.zeros(16)
        target[i % 16] = 1
        if i % 3 == 0:
            target[(i + 5) % 16] = 1
        items.append((f"clip_{i:03d}.wav", wave, target))
        labels = (rng.uniform(size=8) < 0.4).astype(np.float32)
        mask = (rng.uniform(size=8) < 0.7).astype(np.float32)
        items_mask.append((f"m_{i:03d}.wav", wave, np.concatenate([labels, mask])))
    path, path_mask = str(tmp / "train.h5"), str(tmp / "openmic.h5")
    pack_waveform_hdf5(path, items, packed_targets=True)
    pack_waveform_hdf5(path_mask, items_mask, packed_targets=False)
    return path, path_mask


HDF5_CASES = {
    "head": dict(clip_length=2),
    "random_crop_gain": dict(clip_length=2, crop="random", gain_augment_db=7, seed=3),
    "variable_length": dict(clip_length=None),
    "stride_16k": dict(clip_length=2, sample_rate=16000, gain_augment_db=3),
}


@pytest.mark.parametrize("case", sorted(HDF5_CASES))
def test_hdf5_items_bit_equal(h5, case):
    """Every item of an HDF5 container, before set_epoch and at epochs 0 and
    1: decode, gain, crop, stride resample, unpacked targets."""
    kw = dict(classes_num=16, **HDF5_CASES[case])
    jds, pds = J.HDF5AudioDataset(h5[0], **kw), P.HDF5AudioDataset(h5[0], **kw)
    assert len(jds) == len(pds) == 20 and pds.epoch_dependent == jds.epoch_dependent
    for epoch in (None, 0, 1):
        if epoch is not None:
            jds.set_epoch(epoch)
            pds.set_epoch(epoch)
        for i in range(len(jds)):
            _items_equal(pds[i], jds[i])
    np.testing.assert_array_equal(pds.item_lengths(), jds.item_lengths())
    jb, pb = jds.raw_batch([3, 1, 3]), pds.raw_batch([3, 1, 3])
    assert jb[1] == pb[1]
    np.testing.assert_array_equal(jb[2], pb[2])


def _write_wav(path, rate, n, rng, channels=1):
    x = (rng.standard_normal(n * channels) * 3000).astype(np.int16)
    with wavemod.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(x.tobytes())


def test_folder_dataset_with_foreign_rates_bit_equal(tmp_path):
    """wav files at 32, 16, 44.1, 48 and 64 kHz (stride, polyphase up and
    down; one stereo) resampled to 32 kHz, padded or cut to 1.5 s, with a
    labels dict: items bit-equal to the JAX FolderDataset's."""
    rng = np.random.default_rng(5)
    for name, rate, n, ch in (("a32k.wav", 32000, 40000, 1), ("b16k.wav", 16000, 16000, 1),
                              ("c44k.wav", 44100, 44100, 2), ("d48k.wav", 48000, 30000, 1),
                              ("e64k.wav", 64000, 64000, 1)):
        _write_wav(tmp_path / name, rate, n, rng, ch)
    labels = {"b16k.wav": np.eye(6)[2], "d48k.wav": np.eye(6)[4] + np.eye(6)[1]}
    for clip in (1.5, None):
        jds = J.FolderDataset(str(tmp_path), num_classes=6, clip_length=clip, labels=labels)
        pds = P.FolderDataset(str(tmp_path), num_classes=6, clip_length=clip, labels=labels)
        assert len(pds) == len(jds) == 5
        for i in range(5):
            _items_equal(pds[i], jds[i])
    with pytest.raises(FileNotFoundError):
        P.FolderDataset(str(tmp_path / "empty"))


def test_decode_wav_and_resample_bit_equal(tmp_path):
    """The port's own copy of the polyphase resampler and the wav decoders
    (column decoder with the container rate, 8/16/32-bit widths)."""
    from passt_tpu.data.datasets import _decode_wav, _decode_wav_column
    from passt_tpu.data.prepare.wavdec import resample

    rng = np.random.default_rng(6)
    x = rng.standard_normal(4410).astype(np.float32)
    for src, dst in ((44100, 32000), (16000, 32000), (64000, 32000), (32000, 32000), (22050, 16000)):
        np.testing.assert_array_equal(port_datasets.resample(x, src, dst), resample(x, src, dst))
    for width, dtype in ((1, np.uint8), (2, np.int16), (4, np.int32)):
        raw = rng.integers(0, 200, 3000).astype(dtype) if width == 1 else \
            (rng.standard_normal(3000) * 1000).astype(dtype)
        path = tmp_path / f"w{width}.wav"
        with wavemod.open(str(path), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(width)
            w.setframerate(44100)
            w.writeframes(raw.tobytes())
        buf = np.frombuffer(path.read_bytes(), np.uint8)
        np.testing.assert_array_equal(port_datasets._decode_wav(buf), _decode_wav(buf))
        np.testing.assert_array_equal(port_datasets._decode_wav_column(buf, expected_rate=32000),
                                      _decode_wav_column(buf, expected_rate=32000))
    assert port_datasets.DECODERS.keys() == J.datasets.DECODERS.keys()


@pytest.mark.parametrize("merge_masks", [False, True])
def test_roll_wavmix_chain_bit_equal(h5, merge_masks):
    """HDF5 -> RollDataset -> WavMixDataset (the AudioSet training chain;
    merge_masks: the OpenMIC mask-merging variant), at epochs 0 and 1, and
    the per-item mix plans."""
    path = h5[1] if merge_masks else h5[0]
    kw = dict(classes_num=16, clip_length=2, gain_augment_db=5, seed=1, packed_targets=not merge_masks)

    def chain(m):
        base = m.HDF5AudioDataset(path, **kw)
        return m.WavMixDataset(m.datasets.RollDataset(base, shift_range=50, seed=2),
                               merge_masks=merge_masks, seed=4)

    jds, pds = chain(J), chain(P)
    for epoch in (0, 1):
        port_datasets.set_epoch_recursive(pds, epoch)
        J.datasets.set_epoch_recursive(jds, epoch)
        for i in range(len(jds)):
            assert pds.mix_plan(i) == jds.mix_plan(i)
            _items_equal(pds[i], jds[i])


def test_concat_and_map_bit_equal(h5):
    kw = dict(classes_num=16, clip_length=1, gain_augment_db=4)

    def chain(m):
        a, b = m.HDF5AudioDataset(h5[0], seed=1, **kw), m.HDF5AudioDataset(h5[0], seed=2, **kw)
        cat = m.ConcatDataset([a, b])
        return m.MapDataset(cat, lambda item, i: (item[0] * (1 + i % 3), item[1], item[2]), with_index=True)

    jds, pds = chain(J), chain(P)
    assert len(pds) == len(jds) == 40
    J.datasets.set_epoch_recursive(jds, 2)
    port_datasets.set_epoch_recursive(pds, 2)
    for i in range(40):
        _items_equal(pds[i], jds[i])


def test_cached_dataset_epoch_keying_bit_equal(h5, tmp_path):
    """CachedDataset over an augmented chain keys its cache by epoch (and
    over a deterministic one does not): the same files, the same items."""
    for name, roll in (("aug", True), ("plain", False)):
        dirs, outs = [], []
        for m in (J, P):
            base = m.HDF5AudioDataset(h5[0], classes_num=16, clip_length=1)
            inner = m.datasets.RollDataset(base, shift_range=30, seed=5) if roll else base
            d = tmp_path / f"{name}_{m.__name__}"
            ds = m.CachedDataset(inner, str(d))
            got = []
            for epoch in (0, 1):
                m.datasets.set_epoch_recursive(ds, epoch)
                got += [ds[i] for i in (0, 4, 9)] + [ds[4]]
            dirs.append(sorted(os.listdir(d)))
            outs.append(got)
        assert dirs[0] == dirs[1]
        assert len(dirs[0]) == (6 if roll else 3)
        for a, b in zip(*outs):
            _items_equal(b, a)


def test_set_epoch_changes_augmentation_as_in_jax(h5):
    """Through the DataLoader's set_epoch (samplers and the whole chain):
    epochs differ from each other and equal the JAX loader's."""
    def loader(m):
        base = m.HDF5AudioDataset(h5[0], classes_num=16, clip_length=1, gain_augment_db=7, seed=9)
        ds = m.datasets.RollDataset(base, shift_range=100, seed=3)
        sampler = m.ShuffleSampler(len(ds), seed=11)
        return m.DataLoader(ds, batch_size=5, sampler=sampler, prefetch=0)

    jl, pl = loader(J), loader(P)
    epochs = []
    for epoch in (0, 1):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        jb, pb = list(jl), list(pl)
        for a, b in zip(pb, jb):
            _batches_equal(a, b)
        epochs.append(pb)
    assert epochs[0][0]["name"] != epochs[1][0]["name"]
    assert not np.array_equal(epochs[0][0]["wave"], epochs[1][0]["wave"])


def test_class_balanced_weights_bit_equal():
    rng = np.random.default_rng(7)
    targets = (rng.uniform(size=(300, 40)) < 0.05).astype(np.float32)
    for kw in (dict(), dict(offset=10.0), dict(sum_weights=False)):
        np.testing.assert_array_equal(port_sampler.class_balanced_sample_weights(targets, **kw),
                                      jax_sampler.class_balanced_sample_weights(targets, **kw))

    def chunks():
        return (targets[i:i + 64] for i in range(0, 300, 64))

    np.testing.assert_array_equal(port_sampler.class_balanced_sample_weights_streamed(chunks, 40),
                                  jax_sampler.class_balanced_sample_weights_streamed(chunks, 40))


SAMPLER_CASES = {
    "weighted": lambda m, w, r, n: m.WeightedEpochSampler(w, epoch_len=50, num_replicas=n, rank=r, seed=3),
    "weighted_replacement": lambda m, w, r, n: m.WeightedEpochSampler(
        w, epoch_len=80, replacement=True, num_replicas=n, rank=r, seed=4),
    "weighted_short": lambda m, w, r, n: m.WeightedEpochSampler(w, epoch_len=10_000, num_replicas=n, rank=r),
    "shuffle": lambda m, w, r, n: m.ShuffleSampler(len(w), num_replicas=n, rank=r, seed=5),
    "sequential": lambda m, w, r, n: m.SequentialSampler(len(w), num_replicas=n, rank=r),
}


@pytest.mark.parametrize("case", sorted(SAMPLER_CASES))
def test_samplers_bit_equal_with_equal_rank_counts(case):
    """The same index streams at epochs 0-2 on 1 and 3 ranks; the training
    samplers give every rank exactly the same count (the eval sampler
    stays ragged on purpose)."""
    rng = np.random.default_rng(8)
    weights = jax_sampler.class_balanced_sample_weights((rng.uniform(size=(103, 12)) < 0.1).astype(np.float32))
    weights[5] = 0.0  # a zero weight is never drawn without replacement
    for n in (1, 3):
        counts = []
        for r in range(n):
            js, ps = SAMPLER_CASES[case](jax_sampler, weights, r, n), SAMPLER_CASES[case](port_sampler, weights, r, n)
            for epoch in range(3):
                js.set_epoch(epoch)
                ps.set_epoch(epoch)
                got = list(ps)
                assert got == list(js) and len(got) == len(ps) == len(js)
            counts.append(len(ps))
        if case != "sequential":
            assert len(set(counts)) == 1, counts


def test_length_grouped_batch_sampler_equal():
    lengths = np.random.default_rng(9).choice([100, 250, 400], size=37)
    for n, r in ((1, 0), (2, 0), (2, 1)):
        jb = jax_sampler.LengthGroupedBatchSampler(lengths, 4, num_replicas=n, rank=r)
        pb = port_sampler.LengthGroupedBatchSampler(lengths, 4, num_replicas=n, rank=r)
        assert list(pb) == list(jb) and pb.num_distinct_lengths == jb.num_distinct_lengths == 3


@pytest.mark.parametrize("workers", [0, 3])
def test_dataloader_batches_bit_equal(h5, workers):
    """Weighted sampler + the augmented chain through the DataLoader with
    thread workers and the prefetcher: every batch of two epochs equal
    (and with drop_last, a batch_sampler, and the variable-length collate
    with pad_to_multiple)."""
    def make(m, **kw):
        base = m.HDF5AudioDataset(h5[0], classes_num=16, clip_length=2, gain_augment_db=6, seed=7)
        ds = m.WavMixDataset(m.datasets.RollDataset(base, seed=8), seed=9)
        w = m.class_balanced_sample_weights(np.stack([base[i][2] for i in range(len(base))]))
        return m.DataLoader(ds, batch_size=6, sampler=m.WeightedEpochSampler(w, epoch_len=17, seed=2),
                            num_workers=workers, **kw)

    for kw in (dict(), dict(drop_last=True, prefetch=0)):
        jl, pl = make(J, **kw), make(P, **kw)
        assert len(pl) == len(jl) == (2 if kw else 3)
        for epoch in (0, 1):
            jl.set_epoch(epoch)
            pl.set_epoch(epoch)
            jb, pb = list(jl), list(pl)
            assert len(jb) == len(pb) == len(pl)
            for a, b in zip(pb, jb):
                _batches_equal(a, b)

    lengths = J.HDF5AudioDataset(h5[0], classes_num=16, clip_length=None).item_lengths()

    def grouped(m):
        ds = m.HDF5AudioDataset(h5[0], classes_num=16, clip_length=None)
        return m.DataLoader(ds, batch_sampler=m.sampler.LengthGroupedBatchSampler(lengths, 3),
                            collate=lambda items: m.pipeline.default_collate(items, pad_to_multiple=320),
                            num_workers=workers)

    for a, b in zip(list(grouped(P)), list(grouped(J)), strict=True):
        _batches_equal(a, b)


def test_prefetcher_propagates_errors_and_stops():
    def bad():
        yield 1
        raise RuntimeError("boom")

    it = port_pipeline.Prefetcher(bad(), depth=1)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="boom"):
        next(it)

    # an abandoned prefetcher: stop drains the queue, releases and joins the
    # worker, and stops the wrapped (stoppable) iterator
    inner = port_pipeline.Prefetcher(iter(range(10_000)), depth=2)
    outer = port_pipeline.Prefetcher(inner, depth=2)
    assert next(outer) == 0
    outer.stop()
    assert not outer.thread.is_alive() and not inner.thread.is_alive()

    done = port_pipeline.Prefetcher(iter(range(3)), depth=2)
    assert list(done) == [0, 1, 2] and not done.thread.is_alive()
    with pytest.raises(ValueError, match="exactly one"):
        P.DataLoader([], batch_size=2)


def test_device_feed_on_the_cpu():
    """DeviceFeed's CPU path (the tests' device): each array of convert's
    dict arrives as a tensor with its values and dtype, extra unchanged,
    errors propagate, stop releases both threads."""
    rng = np.random.default_rng(10)
    batches = [{"wave": rng.standard_normal((3, 50)).astype(np.float32), "n": i} for i in range(5)]
    convert = lambda b: ({"wave": b["wave"], "q": (b["wave"] * 100).astype(np.int16)}, b["n"])  # noqa: E731
    feed = P.DeviceFeed(iter(batches), convert, "cpu", depth=2)
    got = list(feed)
    assert [e for _, e in got] == list(range(5))
    for (t, _), b in zip(got, batches):
        assert t["wave"].device.type == "cpu" and t["q"].dtype == torch.int16
        np.testing.assert_array_equal(t["wave"].numpy(), b["wave"])
        np.testing.assert_array_equal(t["q"].numpy(), (b["wave"] * 100).astype(np.int16))

    def bad():
        yield batches[0]
        raise OSError("disk")

    feed = P.DeviceFeed(bad(), convert, "cpu")
    next(feed)
    with pytest.raises(OSError, match="disk"):
        next(feed)
    inner = port_pipeline.Prefetcher(iter(batches * 100), depth=1)
    feed = P.DeviceFeed(inner, convert, "cpu", depth=1)
    next(feed)
    feed.stop()
    assert not feed.thread.is_alive() and not inner.thread.is_alive()


def test_device_feed_staging_layout():
    """The staging layout the card's path packs a batch into: each array at
    an offset aligned to 256 bytes, in order, no overlap."""
    arrays = {"wave": np.zeros((3, 101), np.float32), "q": np.zeros((3, 7), np.int16),
              "t": np.zeros((2,), np.int64)}
    layout, nbytes = port_pipeline._layout(arrays)
    assert [(n, off) for n, off, _ in layout] == [("wave", 0), ("q", 1280), ("t", 1536)]
    assert nbytes == 1792
    if not torch.cuda.is_available():  # no fallback to the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            P.DeviceFeed(iter([]), lambda b: ({}, None), "cuda")


# ---- the native host plane ---------------------------------------------------------


@pytest.fixture()
def native_lib():
    if not (jax_native.available() and port_native.available()):
        pytest.skip("native/libhostplane.so is not built on this machine")
    return port_native


def test_native_library_search_and_abi(native_lib, monkeypatch, tmp_path):
    """The port finds native/libhostplane.so at the repo root (the override
    first, and an override that does not exist raises), at the JAX
    binding's ABI version."""
    assert port_native._lib_path() == os.path.join(ROOT, "native", "libhostplane.so")
    assert port_native._ABI_VERSION == jax_native._ABI_VERSION == 2
    monkeypatch.setenv("PASST_TPU_HOSTPLANE", str(tmp_path / "missing.so"))
    with pytest.raises(FileNotFoundError):
        port_native._lib_path()


def test_native_calls_bit_equal(native_lib):
    """assemble_batch (pad, crop, gain, roll), wavmix and unpack_targets
    through the port's binding and the JAX binding on the same arrays."""
    rng = np.random.default_rng(11)
    pcm = [(rng.standard_normal(n) * 8000).astype(np.int16) for n in (3000, 5000, 4000, 800)]
    for kw in (dict(), dict(gain_db=6, roll_range=40, random_crop=True, seed=5, indices=[7, 1, 9, 3])):
        np.testing.assert_array_equal(native_lib.assemble_batch(pcm, 4000, **kw),
                                      jax_native.assemble_batch(pcm, 4000, **kw))
    out = rng.standard_normal((4, 300)).astype(np.float32)
    other = rng.standard_normal((4, 300)).astype(np.float32)
    lam = np.array([0.6, 0.9, 0.5, 0.7], np.float32)
    apply = np.array([1, 0, 1, 1], np.uint8)
    a, b = out.copy(), out.copy()
    native_lib.wavmix(a, other, lam, apply)
    jax_native.wavmix(b, other, lam, apply)
    np.testing.assert_array_equal(a, b)
    packed = rng.integers(0, 256, (5, 66)).astype(np.uint8)
    np.testing.assert_array_equal(native_lib.unpack_targets(packed, 527), jax_native.unpack_targets(packed, 527))
    with pytest.raises(ValueError):
        native_lib.wavmix(out.astype(np.float64), other, lam, apply)


@pytest.mark.parametrize("wavmix", [False, True])
def test_native_batch_builder_bit_equal(h5, native_lib, wavmix):
    """NativeBatchBuilder over one and two containers (roll, gain, random
    crop, wavmix): the port's batches equal the JAX builder's at two
    epochs."""
    def builder(m, data_mod):
        kw = dict(classes_num=16, clip_length=1.5, gain_augment_db=4, crop="random")
        dss = [data_mod.HDF5AudioDataset(h5[0], seed=1, **kw), data_mod.HDF5AudioDataset(h5[0], seed=2, **kw)]
        return m.NativeBatchBuilder(dss, roll_shift_range=30, wavmix=wavmix, seed=6, num_workers=2)

    jb, pb = builder(jax_native_loader, J), builder(port_native_loader, P)
    for epoch in (0, 1):
        jb.set_epoch(epoch)
        pb.set_epoch(epoch)
        for idxs in ([0, 5, 23, 39], [2, 2, 31]):
            _batches_equal(pb(idxs), jb(idxs))
    assert callable(port_native_loader.maybe_native_builder)  # the recipes' entry (tests/test_torch_cli.py)


def test_port_data_and_loop_import_nothing_of_jax():
    """In a fresh interpreter the port's data layer and loop load neither
    jax nor the JAX package, nor h5py, sklearn or wandb."""
    code = ("import sys; import passt_tpu_torch.data, passt_tpu_torch.train, passt_tpu_torch.bench; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'optax', 'orbax', 'passt_tpu', 'h5py', 'sklearn', 'wandb')); "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
