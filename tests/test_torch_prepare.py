"""The port's offline prep modules (passt_tpu_torch.data.prepare) against
the JAX package's (passt_tpu.data.prepare) on the same inputs, made from a
seed with numpy: metadata parsers on the same CSVs (lists and arrays equal,
dtypes included), ``decode_wav`` bit-equal with an equal rate for every
format the decoder takes and the same ``ValueError`` for what it rejects,
``resample`` bit-equal, HDF5 containers dataset-equal (datasets, dtypes,
values and attrs), ``encode_mp3`` bytes equal (the same libmp3lame on both
sides) and decoded by the port's native binding to the wave's length, and
``decode_ogg`` bit-equal."""

import importlib.util
import os
import struct

import h5py
import numpy as np
import pytest

from passt_tpu.data.prepare import metadata as J_meta
from passt_tpu.data.prepare import mp3enc as J_mp3
from passt_tpu.data.prepare import oggdec as J_ogg
from passt_tpu.data.prepare import pack_hdf5 as J_pack
from passt_tpu.data.prepare import wavdec as J_wav
from passt_tpu_torch.data import datasets as P_datasets
from passt_tpu_torch.data import native as P_native
from passt_tpu_torch.data.prepare import metadata as P_meta
from passt_tpu_torch.data.prepare import mp3enc as P_mp3
from passt_tpu_torch.data.prepare import oggdec as P_ogg
from passt_tpu_torch.data.prepare import pack_hdf5 as P_pack
from passt_tpu_torch.data.prepare import wavdec as P_wav

#: the sample ogg pygame ships, where pygame is installed (found without importing it)
_PYGAME = importlib.util.find_spec("pygame")
SAMPLE_OGG = os.path.join(os.path.dirname(_PYGAME.origin), "examples", "data", "house_lo.ogg") if _PYGAME else ""


def assert_same(got, want):
    """Equal values of equal types: lists element by element, arrays with
    their dtypes."""
    assert type(got) is type(want)
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_same(g, w)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


# ---- metadata --------------------------------------------------------------------------------------------------
@pytest.fixture(scope="module")
def csvs(tmp_path_factory):
    d = tmp_path_factory.mktemp("csv")
    (d / "class_labels_indices.csv").write_text(
        "index,mid,display_name\n0,/m/09x0r,Speech\n1,/m/05zppz,\"Male speech, man speaking\"\n2,/m/0ytgt,Child\n")
    (d / "segments.csv").write_text(
        "# Segments csv created Sun Mar  5 10:54:31 2017\n"
        "# num_ytids=3, num_segs=3, num_unique_labels=3, num_positive_labels=5\n"
        "# YTID, start_seconds, end_seconds, positive_labels\n"
        '--aE2O5G5WE, 0.000, 10.000, "/m/09x0r,/m/05zppz"\n'
        '--aaaaaaaaa, 1.500, 11.500, "/m/0ytgt,/m/unknown"\n'
        "\n"
        '-bbbbbbbbbb, 30.000, 40.000, "/m/unknown"\n')
    (d / "empty_segments.csv").write_text("# only a comment\n")
    (d / "vocabulary.csv").write_text("0,Bark,/m/05tny_\n1,Meow,/m/07qrkrw\n2,Chirp,/m/07pggtn\n")
    (d / "dev.csv").write_text(
        "fname,labels,mids,split\n"
        "1001,Bark,/m/05tny_,train\n"
        '1002,"Bark,Meow","/m/05tny_,/m/07qrkrw",val\n'
        '1003,"Chirp,Howl","/m/07pggtn,/m/07qf0zm",train\n')
    (d / "eval.csv").write_text("fname,labels,mids\n37199,Meow,/m/07qrkrw\n")
    rng = np.random.default_rng(0)
    rows = [f"{i}-{rng.integers(100000)}-A-{i % 7}.wav,{1 + i % 5},{rng.integers(50)},cat" for i in range(23)]
    (d / "esc50.csv").write_text("filename,fold,target,category\n" + "\n".join(rows) + "\n")
    return d


METADATA_CASES = {
    "audioset": lambda m, d: m.parse_audioset_segments_csv(
        str(d / "segments.csv"), m.load_class_labels_indices(str(d / "class_labels_indices.csv"))),
    "audioset_name_format": lambda m, d: m.parse_audioset_segments_csv(
        str(d / "segments.csv"), m.load_class_labels_indices(str(d / "class_labels_indices.csv")), num_classes=3,
        name_format="Y{ytid}.mp3"),
    "audioset_ms_format": lambda m, d: m.parse_audioset_segments_csv(
        str(d / "segments.csv"), {"/m/0ytgt": 1}, num_classes=2, name_format="{ytid}-{start_ms}-{end_ms}.flac"),
    "audioset_empty": lambda m, d: m.parse_audioset_segments_csv(str(d / "empty_segments.csv"), {}, num_classes=5),
    "class_labels": lambda m, d: m.load_class_labels_indices(str(d / "class_labels_indices.csv")),
    "fsd50k_vocabulary": lambda m, d: m.load_fsd50k_vocabulary(str(d / "vocabulary.csv")),
    "fsd50k_dev_all": lambda m, d: m.parse_fsd50k_csv(str(d / "dev.csv"), m.load_fsd50k_vocabulary(
        str(d / "vocabulary.csv"))),
    "fsd50k_train": lambda m, d: m.parse_fsd50k_csv(str(d / "dev.csv"), m.load_fsd50k_vocabulary(
        str(d / "vocabulary.csv")), split="train"),
    "fsd50k_val": lambda m, d: m.parse_fsd50k_csv(str(d / "dev.csv"), m.load_fsd50k_vocabulary(
        str(d / "vocabulary.csv")), split="val"),
    "fsd50k_eval": lambda m, d: m.parse_fsd50k_csv(str(d / "eval.csv"), m.load_fsd50k_vocabulary(
        str(d / "vocabulary.csv"))),
    "fsd50k_no_rows": lambda m, d: m.parse_fsd50k_csv(str(d / "eval.csv"), {"Meow": 0}, split="train"),
    "esc50_folds": lambda m, d: [m.parse_esc50_meta(str(d / "esc50.csv"), fold=k, train=t)
                                 for k in range(1, 6) for t in (True, False)],
    "openmic_targets": lambda m, d: m.openmic_targets(
        np.random.default_rng(1).uniform(size=(4, 20)), np.random.default_rng(2).uniform(size=(4, 20)) < 0.5),
}


@pytest.mark.parametrize("case", sorted(METADATA_CASES))
def test_metadata_equal(case, csvs):
    got, want = METADATA_CASES[case](P_meta, csvs), METADATA_CASES[case](J_meta, csvs)
    if isinstance(want, dict):
        assert got == want
    else:
        assert_same(got, want)


def test_metadata_fixture_covers_the_cases(csvs):
    """The fixture has what the cases claim: quoted and unknown mids, comment
    lines, a split filter, every fold on both sides."""
    files, y = P_meta.parse_audioset_segments_csv(
        str(csvs / "segments.csv"), P_meta.load_class_labels_indices(str(csvs / "class_labels_indices.csv")),
        num_classes=3)
    assert files == ["--aE2O5G5WE_0_10000.wav", "--aaaaaaaaa_1500_11500.wav", "-bbbbbbbbbb_30000_40000.wav"]
    np.testing.assert_array_equal(y, [[1, 1, 0], [0, 0, 1], [0, 0, 0]])
    for k in range(1, 6):
        train, _ = P_meta.parse_esc50_meta(str(csvs / "esc50.csv"), fold=k, train=True)
        test, _ = P_meta.parse_esc50_meta(str(csvs / "esc50.csv"), fold=k, train=False)
        assert test and train and not set(train) & set(test) and len(train) + len(test) == 23


# ---- wavdec ----------------------------------------------------------------------------------------------------
def write_riff(path, fmt_code, channels, rate, bits, data, extensible_code=None, pre_chunks=(), data_size=None):
    """A RIFF/WAVE file: fmt (WAVE_FORMAT_EXTENSIBLE carrying
    ``extensible_code`` when given), ``pre_chunks`` (id, payload) padded to
    even sizes, then data (its size field ``data_size`` when given)."""
    block = channels * bits // 8
    if extensible_code is None:
        fmt = struct.pack("<HHIIHH", fmt_code, channels, rate, rate * block, block, bits)
    else:
        guid_tail = b"\x00\x00\x00\x00\x10\x00\x80\x00\x00\xaa\x00\x38\x9b\x71"
        fmt = struct.pack("<HHIIHHHHI", 0xFFFE, channels, rate, rate * block, block, bits, 22, bits, 0)
        fmt += struct.pack("<H", extensible_code) + guid_tail
    body = b"fmt " + struct.pack("<I", len(fmt)) + fmt
    for cid, payload in pre_chunks:
        body += cid + struct.pack("<I", len(payload)) + payload + (b"\x00" if len(payload) & 1 else b"")
    body += b"data" + struct.pack("<I", len(data) if data_size is None else data_size) + data
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WAVE" + body)


def _pcm24(x):
    i32 = np.clip(np.rint(x * 8388607.0), -8388608, 8388607).astype("<i4")
    return i32.view(np.uint8).reshape(-1, 4)[:, :3].tobytes()


def _wave(n, channels, seed):
    return np.random.default_rng(seed).uniform(-1, 1, n * channels)


#: name -> (fmt code, channels, bits, data bytes, extensible code, pre chunks, data size field)
WAV_CASES = {
    "pcm16_mono": lambda: (1, 1, 16, (_wave(3001, 1, 0) * 32767).astype("<i2").tobytes()),
    "pcm16_stereo": lambda: (1, 2, 16, (_wave(3001, 2, 1) * 32767).astype("<i2").tobytes()),
    "pcm24": lambda: (1, 1, 24, _pcm24(_wave(2999, 1, 2))),
    "pcm24_stereo": lambda: (1, 2, 24, _pcm24(_wave(1999, 2, 3))),
    "pcm32": lambda: (1, 1, 32, (_wave(3000, 1, 4) * 2147483647).astype("<i4").tobytes()),
    "float32": lambda: (3, 1, 32, _wave(3000, 1, 5).astype("<f4").tobytes()),
    "float64_stereo": lambda: (3, 2, 64, _wave(1500, 2, 6).astype("<f8").tobytes()),
    "extensible_pcm16": lambda: (1, 2, 16, (_wave(2000, 2, 7) * 32767).astype("<i2").tobytes(), 1),
    "extensible_float32": lambda: (3, 1, 32, _wave(2000, 1, 8).astype("<f4").tobytes(), 3),
    "odd_list_chunk": lambda: (1, 1, 16, (_wave(2000, 1, 9) * 32767).astype("<i2").tobytes(), None,
                               [(b"LIST", b"INFOISFT\x05\x00\x00\x00Lavf\x00"), (b"fact", b"\x01\x02\x03")]),
    "truncated_frame": lambda: (1, 2, 16, (_wave(2000, 2, 10) * 32767).astype("<i2").tobytes()[:-3], None, (),
                                4000 * 2),
}


@pytest.mark.parametrize("case", sorted(WAV_CASES))
@pytest.mark.parametrize("rate", [44100, 32000])
def test_decode_wav_bit_equal(case, rate, tmp_path):
    spec = WAV_CASES[case]()
    fmt_code, channels, bits, data = spec[:4]
    ext, pre, size = list(spec[4:]) + [None, (), None][len(spec) - 4:]
    path = str(tmp_path / f"{case}.wav")
    write_riff(path, fmt_code, channels, rate, bits, data, extensible_code=ext, pre_chunks=pre or (), data_size=size)
    (got, got_rate), (want, want_rate) = P_wav.decode_wav(path), J_wav.decode_wav(path)
    assert got_rate == want_rate == rate
    assert got.dtype == want.dtype == np.float32 and got.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(got, want)
    assert len(got) == len(data) // (channels * bits // 8) and np.abs(got).max() > 0.5
    assert P_wav._read_chunks(path) == J_wav._read_chunks(path)


REJECTED = {
    "not_riff": lambda p: open(p, "wb").write(b"OggS" + bytes(40)),
    "short_file": lambda p: open(p, "wb").write(b"RIFF"),
    "alaw_16bit": lambda p: write_riff(p, 6, 1, 8000, 16, bytes(400)),
    "pcm8": lambda p: write_riff(p, 1, 1, 8000, 8, bytes(400)),
    "float16": lambda p: write_riff(p, 3, 1, 8000, 16, bytes(400)),
    "no_fmt": lambda p: open(p, "wb").write(b"RIFF" + struct.pack("<I", 12) + b"WAVEdata" + struct.pack("<I", 0)),
}


@pytest.mark.parametrize("case", sorted(REJECTED))
def test_decode_wav_rejects_as_jax_does(case, tmp_path):
    path = str(tmp_path / f"{case}.wav")
    REJECTED[case](path)
    with pytest.raises(ValueError) as want:
        J_wav.decode_wav(path)
    with pytest.raises(ValueError) as got:
        P_wav.decode_wav(path)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("src,dst", [(44100, 32000), (48000, 32000), (64000, 32000), (32000, 32000),
                                     (22050, 32000), (44100, 16000)])
def test_resample_bit_equal(src, dst):
    x = np.random.default_rng(src + dst).standard_normal(src // 10 + 7).astype(np.float32)
    got, want = P_wav.resample(x, src, dst), J_wav.resample(x, src, dst)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_one_resampler_in_the_port():
    """The data layer's ``resample`` is the prep module's, not a copy."""
    assert P_datasets.resample is P_wav.resample


# ---- pack_hdf5 -------------------------------------------------------------------------------------------------
def dump(path):
    """Every dataset of a container (dtype, shape, values; vlen rows one by
    one) and its attrs."""
    out = {}
    with h5py.File(path, "r") as f:
        for name in f:
            ds = f[name]
            base = h5py.check_vlen_dtype(ds.dtype)
            values = [np.asarray(r) for r in ds[:]] if base is not None else [ds[:]]
            out[name] = (str(ds.dtype), str(base), ds.shape, values)
        out["attrs"] = {k: f.attrs[k] for k in f.attrs}
    return out


def assert_dataset_equal(got_path, want_path):
    got, want = dump(got_path), dump(want_path)
    assert sorted(got) == sorted(want)
    assert got["attrs"] == want["attrs"]
    for name in want:
        if name == "attrs":
            continue
        assert got[name][:3] == want[name][:3], name
        assert_same(got[name][3], want[name][3])


def _wave_items(n, classes, seed, long_names=False):
    rng = np.random.default_rng(seed)
    items = []
    for i in range(n):
        name = ("x" * 70 if long_names and i % 2 else "") + f"clip{i}.wav"
        wave = (rng.uniform(-1.2, 1.2, int(rng.integers(100, 900)))).astype(np.float32)  # clipped at +-1
        target = (rng.uniform(size=classes) < 0.3).astype(np.float64)
        items.append((name, wave, target))
    return items


PACK_CASES = {
    "raw_packed": lambda m, p: m.pack_waveform_hdf5(p, _wave_items(7, 20, 0)),
    "raw_float": lambda m, p: m.pack_waveform_hdf5(p, _wave_items(5, 40, 1), sample_rate=16000,
                                                   packed_targets=False),
    "raw_long_names": lambda m, p: m.pack_waveform_hdf5(p, _wave_items(4, 9, 2, long_names=True)),
    "raw_empty": lambda m, p: m.pack_waveform_hdf5(p, []),
    "mp3_lengths": lambda m, p: m.pack_bytes_hdf5(
        p, [(n, w.tobytes(), t) for n, w, t in _wave_items(6, 527, 3)], lengths=[10, 20, 30, 40, 50, 60]),
    "mp3_no_lengths": lambda m, p: m.pack_bytes_hdf5(
        p, [(n.encode(), w.tobytes(), t) for n, w, t in _wave_items(3, 16, 4)], column="wav", sample_rate=44100,
        packed_targets=False),
    "streaming_partial_lengths": lambda m, p: _stream(m, p),
}


def _stream(m, path):
    with m.StreamingPacker(path, column="mp3") as packer:
        for i, (name, wave, target) in enumerate(_wave_items(3, 12, 5)):
            packer.add_bytes(name, wave.tobytes(), target, length_samples=None if i == 1 else len(wave))
    return 3


@pytest.mark.parametrize("case", sorted(PACK_CASES))
def test_containers_dataset_equal(case, tmp_path):
    got_path, want_path = str(tmp_path / "port.h5"), str(tmp_path / "jax.h5")
    assert PACK_CASES[case](P_pack, got_path) == PACK_CASES[case](J_pack, want_path)
    assert_dataset_equal(got_path, want_path)


def test_long_names_kept_whole(tmp_path):
    path = str(tmp_path / "long.h5")
    items = _wave_items(4, 9, 2, long_names=True)
    P_pack.pack_waveform_hdf5(path, items)
    with h5py.File(path, "r") as f:
        assert [n.decode() for n in f["audio_name"][:]] == [n for n, _, _ in items]
        assert f["audio_name"].dtype.itemsize == max(64, max(len(n) for n, _, _ in items))


def test_pack_guards_as_jax_does(tmp_path):
    """``add_waveform`` needs the raw_i16 column; ``lengths`` must match the
    items: the same ValueError in both."""
    for m, tag in ((J_pack, "jax"), (P_pack, "port")):
        with m.StreamingPacker(str(tmp_path / f"{tag}_guard.h5"), column="mp3") as packer:
            with pytest.raises(ValueError, match="add_waveform requires column='raw_i16'"):
                packer.add_waveform("a.wav", np.zeros(10, np.float32), np.zeros(3))
        with pytest.raises(ValueError, match="lengths must match items"):
            m.pack_bytes_hdf5(str(tmp_path / f"{tag}_len.h5"), [("a", b"x", np.zeros(2))], lengths=[1, 2])
    assert_dataset_equal(str(tmp_path / "port_guard.h5"), str(tmp_path / "jax_guard.h5"))


def test_error_inside_with_writes_no_metadata(tmp_path):
    """An exception in the ``with`` block closes the file without the
    metadata columns, and propagates, in both."""
    for m, tag in ((J_pack, "jax"), (P_pack, "port")):
        with pytest.raises(KeyError, match="boom"):
            with m.StreamingPacker(str(tmp_path / f"{tag}.h5"), column="raw_i16") as packer:
                for name, wave, target in _wave_items(2, 4, 6):
                    packer.add_waveform(name, wave, target)
                raise KeyError("boom")
    assert_dataset_equal(str(tmp_path / "port.h5"), str(tmp_path / "jax.h5"))
    with h5py.File(str(tmp_path / "port.h5"), "r") as f:
        assert list(f) == ["raw_i16"] and len(f["raw_i16"]) == 2 and not f.attrs


# ---- mp3enc / oggdec -------------------------------------------------------------------------------------------
@pytest.fixture(scope="module")
def lame():
    assert P_mp3.available() == J_mp3.available()
    if not P_mp3.available():
        pytest.skip("libmp3lame not on this machine")


@pytest.mark.parametrize("case", ["float_1s", "float_loud_odd", "int16_2s_64k"])
def test_encode_mp3_bytes_equal(case, lame):
    rng = np.random.default_rng(len(case))
    t = np.arange(64000) / 32000
    if case == "float_1s":
        wave, kw = (0.4 * np.sin(2 * np.pi * 440 * t[:32000]) + 0.05 * rng.standard_normal(32000)).astype(
            np.float32), {}
    elif case == "float_loud_odd":
        wave, kw = rng.uniform(-1.5, 1.5, 12345).astype(np.float32), dict(bitrate_kbps=96)
    else:
        wave, kw = (np.sin(2 * np.pi * 1000 * t) * 12000).astype(np.int16), dict(bitrate_kbps=64)
    got, want = P_mp3.encode_mp3(wave, 32000, **kw), J_mp3.encode_mp3(wave, 32000, **kw)
    assert isinstance(got, bytes) and got == want
    if P_native.mp3_available():  # the LAME tag trims the decode to the wave's length
        decoded, rate = P_native.decode_mp3(got)
        assert rate == 32000 and len(decoded) == len(wave)


@pytest.mark.parametrize("which", ["mp3enc", "oggdec"])
def test_missing_library_as_jax_does(which, monkeypatch, tmp_path):
    """Where the library does not load, ``available()`` is False and the
    call raises the same RuntimeError in both."""
    mods = (J_mp3, P_mp3) if which == "mp3enc" else (J_ogg, P_ogg)
    msgs = []
    for m in mods:
        monkeypatch.setattr(m, "_load", lambda: None)
        assert not m.available()
        with pytest.raises(RuntimeError) as e:
            if which == "mp3enc":
                m.encode_mp3(np.zeros(100, np.float32))
            else:
                m.decode_ogg(str(tmp_path / "a.ogg"))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_decode_ogg_bit_equal(tmp_path):
    assert P_ogg.available() == J_ogg.available()
    if not P_ogg.available():
        pytest.skip("libvorbisfile not on this machine")
    if not os.path.isfile(SAMPLE_OGG):
        pytest.skip("no sample ogg on this image")
    (got, got_rate), (want, want_rate) = P_ogg.decode_ogg(SAMPLE_OGG), J_ogg.decode_ogg(SAMPLE_OGG)
    assert got_rate == want_rate and got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    for m in (J_ogg, P_ogg):
        with pytest.raises(FileNotFoundError):
            m.decode_ogg(str(tmp_path / "missing.ogg"))
    bad = tmp_path / "bad.ogg"
    bad.write_bytes(b"OggS" + bytes(200))
    msgs = []
    for m in (J_ogg, P_ogg):
        with pytest.raises(ValueError) as e:
            m.decode_ogg(str(bad))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
