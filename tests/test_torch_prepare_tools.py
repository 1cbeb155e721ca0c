"""The port's prep tools (python -m passt_tpu_torch.tools.prepare_<dataset>,
transcode_to_mp3, fullsize_train_demo) against the JAX package's scripts
(imported from scripts/) on the same synthetic trees, made from a seed with
numpy: the containers dataset-equal (datasets, dtypes, values, attrs), and
the port's HDF5AudioDataset reading each one equal to what the JAX
package's dataset reads from the JAX container. The full-size demo's items
bit-equal to the script's and its config equal (the script runs at import,
so its ``freqs``, ``split`` and override dict are taken out with ``ast``),
and its ``main`` at a tiny width on the CPU. A fresh interpreter with jax,
flax, the JAX package and h5py blocked imports the prep package and every
tool."""

import ast
import csv
import os
import stat
import subprocess
import sys

import numpy as np
import pytest

from passt_tpu.config import apply_overrides as jax_apply_overrides
from passt_tpu.data import HDF5AudioDataset as JaxHDF5
from passt_tpu.data import native as jax_native
from passt_tpu.experiments import EXPERIMENTS as JAX_EXPERIMENTS
from passt_tpu_torch.data import HDF5AudioDataset as PortHDF5
from passt_tpu_torch.data import native as port_native
from passt_tpu_torch.data.prepare import mp3enc, oggdec
from passt_tpu_torch.tools import (
    fullsize_train_demo,
    prepare_audioset,
    prepare_esc50,
    prepare_fsd50k,
    prepare_openmic,
    transcode_to_mp3,
)
from test_torch_experiments import _tiny_archs
from test_torch_prepare import SAMPLE_OGG, assert_dataset_equal, write_riff

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(ROOT, "scripts")
if SCRIPTS not in sys.path:
    sys.path.insert(0, SCRIPTS)

import prepare_audioset as jax_prepare_audioset  # noqa: E402
import prepare_esc50 as jax_prepare_esc50  # noqa: E402
import prepare_fsd50k as jax_prepare_fsd50k  # noqa: E402
import prepare_openmic as jax_prepare_openmic  # noqa: E402
import transcode_to_mp3 as jax_transcode  # noqa: E402

TOOLS = ("prepare_esc50", "prepare_fsd50k", "prepare_audioset", "prepare_openmic", "transcode_to_mp3",
         "fullsize_train_demo")


def _codec_stack():
    """Skip where the mp3 chain's libraries are absent (libmp3lame to encode,
    the native plane's libmpg123 to read the container back)."""
    if not (mp3enc.available() and port_native.mp3_available() and jax_native.mp3_available()):
        pytest.skip("libmp3lame / the native plane with libmpg123 not on this machine")


def reads_equal(port_path, jax_path, **kw):
    """The port's dataset over the port's container reads every item equal
    to the JAX package's dataset over the JAX container."""
    port, jax = PortHDF5(port_path, **kw), JaxHDF5(jax_path, **kw)
    assert len(port) == len(jax) > 0
    for i in range(len(jax)):
        (wp, np_, tp), (wj, nj, tj) = port[i], jax[i]
        assert np_ == nj and wp.dtype == wj.dtype and tp.dtype == tj.dtype
        np.testing.assert_array_equal(wp, wj)
        np.testing.assert_array_equal(tp, tj)
    return len(jax)


def _clip(path, kind, seconds, rate, seed):
    """One wav clip in the decoder's formats: a tone plus noise."""
    rng = np.random.default_rng(seed)
    n = int(seconds * rate)
    t = np.arange(n) / rate
    x = 0.4 * np.sin(2 * np.pi * rng.uniform(200, 4000) * t) + 0.05 * rng.standard_normal(n)
    if kind == "pcm16":
        write_riff(path, 1, 1, rate, 16, (x * 32767).astype("<i2").tobytes())
    elif kind == "pcm16_stereo":
        write_riff(path, 1, 2, rate, 16, (np.repeat(x, 2) * 32767).astype("<i2").tobytes())
    elif kind == "pcm24":
        write_riff(path, 1, 1, rate, 24, (x * 8388607).astype("<i4").view(np.uint8).reshape(-1, 4)[:, :3].tobytes())
    elif kind == "float32":
        write_riff(path, 3, 1, rate, 32, x.astype("<f4").tobytes())
    else:
        write_riff(path, 1, 1, rate, 16, (x * 32767).astype("<i2").tobytes(), extensible_code=1)


KINDS = ("pcm16", "pcm16_stereo", "pcm24", "float32", "extensible")


# ---- ESC-50 ----------------------------------------------------------------------------------------------------
@pytest.fixture(scope="module")
def esc50_tree(tmp_path_factory):
    """ESC-50-master in miniature: 2 clips in each of the 5 folds, 0.3 s at
    44.1 kHz, and meta/esc50.csv."""
    root = tmp_path_factory.mktemp("ESC-50-master")
    (root / "audio").mkdir()
    (root / "meta").mkdir()
    rows = []
    for i in range(10):
        name = f"{1 + i % 5}-{1000 + i}-A-{i % 3}.wav"
        _clip(str(root / "audio" / name), KINDS[i % 5], 0.3, 44100, seed=i)
        rows.append([name, 1 + i % 5, i % 7, f"class{i % 7}", "False", 1000 + i, "A"])
    with open(root / "meta" / "esc50.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["filename", "fold", "target", "category", "esc10", "src_file", "take"])
        w.writerows(rows)
    return root


@pytest.mark.parametrize("fmt", ["raw", "mp3"])
def test_esc50_pack_fold(fmt, esc50_tree, tmp_path):
    if fmt == "mp3":
        _codec_stack()
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    port = prepare_esc50.pack_fold(str(esc50_tree), str(tmp_path / "port"), fold=2, fmt=fmt, workers=3)
    jax = jax_prepare_esc50.pack_fold(str(esc50_tree), str(tmp_path / "jax"), fold=2, fmt=fmt, workers=3)
    assert [os.path.basename(p) for p in port] == [os.path.basename(p) for p in jax] == [
        "esc50_fold2_train.h5", "esc50_fold2_test.h5"]
    counts = []
    for p, j in zip(port, jax):
        assert_dataset_equal(p, j)
        counts.append(reads_equal(p, j, classes_num=50, clip_length=0.5, packed_targets=False))
    assert counts == [8, 2]


def test_esc50_main_and_load_clip(esc50_tree, tmp_path, capsys):
    """``main`` over folds 1 and 3 writes both containers a fold and prints
    the port's follow-up command; ``_load_clip`` is the JAX script's."""
    out = tmp_path / "out"
    prepare_esc50.main([str(esc50_tree), "--out", str(out), "--folds", "1,3", "--workers", "2"])
    printed = capsys.readouterr().out
    assert sorted(os.listdir(out)) == [f"esc50_fold{k}_{s}.h5" for k in (1, 3) for s in ("test", "train")]
    assert "python -m passt_tpu_torch.cli esc50 main" in printed and "passt_tpu.cli" not in printed
    for name in sorted(os.listdir(esc50_tree / "audio")):
        got = prepare_esc50._load_clip(str(esc50_tree / "audio"), name)
        want = jax_prepare_esc50._load_clip(str(esc50_tree / "audio"), name)
        assert got.dtype == want.dtype and len(got) == int(np.ceil(0.3 * 44100 * 320 / 441))
        np.testing.assert_array_equal(got, want)


# ---- FSD50K ----------------------------------------------------------------------------------------------------
@pytest.fixture(scope="module")
def fsd50k_tree(tmp_path_factory):
    """FSD50K in miniature: dev clips of 0.2-0.5 s (train and val rows),
    eval clips with one file missing, the ground-truth CSVs."""
    root = tmp_path_factory.mktemp("FSD50K")
    gt = root / "FSD50K.ground_truth"
    for d in (gt, root / "FSD50K.dev_audio", root / "FSD50K.eval_audio"):
        d.mkdir()
    (gt / "vocabulary.csv").write_text("0,Bark,/m/05tny_\n1,Meow,/m/07qrkrw\n2,Chirp,/m/07pggtn\n")
    labels = ["Bark", "Bark,Meow", "Chirp", "Meow,Chirp", "Bark,Chirp,Meow", "Meow"]
    with open(gt / "dev.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["fname", "labels", "mids", "split"])
        for i, lab in enumerate(labels):
            w.writerow([100 + i, lab, "", "val" if i % 3 == 2 else "train"])
            _clip(str(root / "FSD50K.dev_audio" / f"{100 + i}.wav"), KINDS[i % 5], 0.2 + 0.05 * i, 44100, seed=20 + i)
    with open(gt / "eval.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["fname", "labels", "mids"])
        for i, lab in enumerate(labels[:3]):
            w.writerow([900 + i, lab, ""])
            if i != 1:  # 901.wav is missing
                _clip(str(root / "FSD50K.eval_audio" / f"{900 + i}.wav"), "pcm16", 0.25, 44100, seed=40 + i)
    return root


@pytest.mark.parametrize("split", ["train", "valid"])
def test_fsd50k_pack_split(split, fsd50k_tree, tmp_path):
    _codec_stack()
    port = prepare_fsd50k.pack_split(str(fsd50k_tree), str(tmp_path), split, workers=2)
    (tmp_path / "jax").mkdir()
    jax = jax_prepare_fsd50k.pack_split(str(fsd50k_tree), str(tmp_path / "jax"), split, workers=2)
    assert_dataset_equal(port, jax)
    n = reads_equal(port, jax, classes_num=3, clip_length=None, crop="random", seed=3)
    assert n == {"train": 4, "valid": 2}[split]


def test_fsd50k_missing_file_as_jax(fsd50k_tree, tmp_path):
    """A listed clip missing from disk: the JAX script raises
    FileNotFoundError from the packer's ``with`` (so the container gets no
    metadata), and so does the port."""
    _codec_stack()
    (tmp_path / "jax").mkdir()
    with pytest.raises(FileNotFoundError, match="901.wav"):
        jax_prepare_fsd50k.pack_split(str(fsd50k_tree), str(tmp_path / "jax"), "eval", workers=2)
    with pytest.raises(FileNotFoundError, match="901.wav"):
        prepare_fsd50k.pack_split(str(fsd50k_tree), str(tmp_path), "eval", workers=2)
    assert_dataset_equal(str(tmp_path / "fsd50k_eval.h5"), str(tmp_path / "jax" / "fsd50k_eval.h5"))
    with pytest.raises(SystemExit, match="unknown split"):
        prepare_fsd50k.main([str(fsd50k_tree), "--out", str(tmp_path / "o"), "--splits", "dev"])


# ---- AudioSet --------------------------------------------------------------------------------------------------
@pytest.fixture(scope="module")
def audioset_tree(tmp_path_factory):
    """Segment CSVs for two splits, a per-split mp3 folder for one and the
    flat pool for the other (mp3s of 0.2-0.6 s), with clips not found on
    disk."""
    _codec_stack()
    root = tmp_path_factory.mktemp("audioset")
    meta, mp3s = root / "meta", root / "mp3"
    meta.mkdir()
    (mp3s / "balanced_train_segments").mkdir(parents=True)
    (meta / "class_labels_indices.csv").write_text(
        "index,mid,display_name\n" + "".join(f"{i},/m/{i:04d},c{i}\n" for i in range(12)))
    rng = np.random.default_rng(5)
    for split, folder in (("balanced_train_segments", mp3s / "balanced_train_segments"), ("eval_segments", mp3s)):
        lines = ["# Segments csv", "# YTID, start_seconds, end_seconds, positive_labels"]
        for i in range(7):
            ytid = f"{split[:2]}{i:09d}"
            mids = ",".join(f"/m/{k:04d}" for k in rng.choice(12, int(rng.integers(1, 4)), replace=False))
            lines.append(f'{ytid}, {10.0 * i:.3f}, {10.0 * i + 10:.3f}, "{mids}"')
            if i % 3 != 1:  # every third clip is not found
                wave = rng.uniform(-0.5, 0.5, int(rng.integers(6400, 19200))).astype(np.float32)
                (folder / f"Y{ytid}.mp3").write_bytes(mp3enc.encode_mp3(wave))
        (meta / f"{split}.csv").write_text("\n".join(lines) + "\n")
    return root


@pytest.mark.parametrize("limit", [None, 3])
@pytest.mark.parametrize("split", ["balanced_train_segments", "eval_segments"])
def test_audioset_pack_split(split, limit, audioset_tree, tmp_path, capsys):
    (tmp_path / "jax").mkdir()
    args = (str(audioset_tree / "mp3"), str(audioset_tree / "meta"), split)
    port = prepare_audioset.pack_split(*args, str(tmp_path), limit=limit)
    port_out = capsys.readouterr().out
    jax = jax_prepare_audioset.pack_split(*args, str(tmp_path / "jax"), limit=limit)
    jax_out = capsys.readouterr().out
    assert port_out.replace(str(tmp_path), "") == jax_out.replace(str(tmp_path / "jax"), "")
    assert ("found 3, not found 1" if limit else "found 5, not found 2") in port_out
    assert_dataset_equal(port, jax)
    assert reads_equal(port, jax, classes_num=12, clip_length=0.5) == (3 if limit else 5)


def test_audioset_main(audioset_tree, tmp_path, capsys):
    prepare_audioset.main([str(audioset_tree / "mp3"), str(audioset_tree / "meta"), "--out", str(tmp_path),
                           "--splits", "eval_segments,balanced_train_segments", "--name-format", "Y{ytid}.mp3"])
    assert sorted(os.listdir(tmp_path)) == ["balanced_train_segments_mp3.hdf", "eval_segments_mp3.hdf"]
    assert capsys.readouterr().out.count("found 5, not found 2") == 2


# ---- OpenMIC ---------------------------------------------------------------------------------------------------
@pytest.fixture(scope="module")
def openmic_tree(tmp_path_factory):
    if not (oggdec.available() and os.path.isfile(SAMPLE_OGG)):
        pytest.skip("libvorbisfile or the sample ogg not on this machine")
    import shutil

    root = tmp_path_factory.mktemp("work") / "openmic-2018-v1.0.0" / "openmic-2018"
    keys = ["aaa001", "bbb002", "ccc003", "ddd004"]
    rng = np.random.default_rng(9)
    for k in keys[:3]:  # ddd004 has no audio
        (root / "audio" / k[:3]).mkdir(parents=True)
        shutil.copy(SAMPLE_OGG, root / "audio" / k[:3] / f"{k}.ogg")
    np.savez(root / "openmic-2018.npz", sample_key=np.array(keys), Y_true=rng.uniform(size=(4, 20)).astype(np.float32),
             Y_mask=rng.uniform(size=(4, 20)) < 0.5)
    (root / "partitions").mkdir()
    (root / "partitions" / "split01_train.csv").write_text("aaa001\nccc003\nddd004\nzzz999\n")
    (root / "partitions" / "split01_test.csv").write_text("bbb002\n")
    return root


def test_openmic_pack_split(openmic_tree, tmp_path, capsys):
    _codec_stack()
    csv_path = str(openmic_tree / "partitions" / "split01_train.csv")
    port, jax = str(tmp_path / "port.h5"), str(tmp_path / "jax.h5")
    assert prepare_openmic.pack_split(str(openmic_tree), csv_path, port) == 2
    assert jax_prepare_openmic.pack_split(str(openmic_tree), csv_path, jax) == 2
    assert "2 of 4 clips found" in capsys.readouterr().out
    assert_dataset_equal(port, jax)
    reads_equal(port, jax, classes_num=40, clip_length=2, packed_targets=False)
    assert prepare_openmic.ogg_to_mp3_bytes(SAMPLE_OGG) == jax_prepare_openmic.ogg_to_mp3_bytes(SAMPLE_OGG)
    for rate in (32000, 64000, 44100):
        w = np.random.default_rng(rate).standard_normal(4410).astype(np.float32)
        np.testing.assert_array_equal(prepare_openmic._resample(w, rate), jax_prepare_openmic._resample(w, rate))


def test_openmic_main_skip_download(openmic_tree, tmp_path):
    """``--skip-download`` on an extracted tree: both splits packed, no
    network touched."""
    _codec_stack()
    work = openmic_tree.parent.parent
    out = tmp_path / "out"
    prepare_openmic.main(["--workdir", str(work), "--out", str(out), "--skip-download"])
    assert sorted(os.listdir(out)) == ["openmic_test.h5", "openmic_train.h5"]
    assert len(PortHDF5(str(out / "openmic_test.h5"), classes_num=40, packed_targets=False)) == 1


# ---- transcode_to_mp3 ------------------------------------------------------------------------------------------
def test_transcode_with_stub_ffmpeg(tmp_path, monkeypatch):
    """The same ffmpeg command as the JAX script, the same folder layout
    and naming, and a rerun skips the files already done."""
    assert transcode_to_mp3.ffmpeg_cmd("/a/x.wav", "/b/x.mp3", 32000) == jax_transcode.ffmpeg_cmd(
        "/a/x.wav", "/b/x.mp3", 32000)
    bindir = tmp_path / "bin"
    bindir.mkdir()
    stub = bindir / "ffmpeg"
    stub.write_text(f'#!/bin/sh\necho "$@" >> {tmp_path}/calls.txt\nfor last; do :; done\necho fake > "$last"\n')
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")
    for folder in ("balanced_train_segments", "eval_segments"):
        src = tmp_path / "audios" / folder
        src.mkdir(parents=True)
        for name in ("a.wav", "b.wav", "notes.txt"):
            (src / name).write_bytes(b"RIFF")
    made = {}
    for tag, mod in (("port", transcode_to_mp3), ("jax", jax_transcode)):
        rc = mod.transcode_tree(str(tmp_path / "audios"), str(tmp_path / tag),
                                ["balanced_train_segments", "eval_segments"], workers=2, sample_rate=32000)
        assert rc == 0
        made[tag] = sorted(str(p.relative_to(tmp_path / tag)) for p in (tmp_path / tag).rglob("*"))
    assert made["port"] == made["jax"] == ["balanced_train_segments", "balanced_train_segments/a.mp3",
                                           "balanced_train_segments/b.mp3", "eval_segments", "eval_segments/a.mp3",
                                           "eval_segments/b.mp3"]
    calls = (tmp_path / "calls.txt").read_text().splitlines()
    assert len(calls) == 8 and all("-codec:a mp3 -ar 32000" in c for c in calls)
    with pytest.raises(SystemExit) as e:  # a rerun: everything done, nothing failed
        transcode_to_mp3.main(["--source", str(tmp_path / "audios"), "--out", str(tmp_path / "port"),
                               "--folders", "balanced_train_segments", "eval_segments", "--workers", "1"])
    assert e.value.code == 0 and len((tmp_path / "calls.txt").read_text().splitlines()) == 8


def test_transcode_missing_ffmpeg(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))  # nothing on PATH
    msgs = []
    for mod in (jax_transcode, transcode_to_mp3):
        with pytest.raises(SystemExit, match="ffmpeg not found on PATH") as e:
            mod.transcode_tree(str(tmp_path), str(tmp_path / "o"), [""], 1, 32000)
        msgs.append(str(e.value))
    assert msgs[1] == msgs[0].replace("passt_tpu.data.prepare", "passt_tpu_torch.data.prepare")


# ---- the full-size demo ----------------------------------------------------------------------------------------
def _demo_script():
    """The script's ``sr``, ``freqs`` and ``split``, and its override dict
    (evaluated with ``tmp`` bound), taken out with ``ast``: the script runs
    at import."""
    tree = ast.parse(open(os.path.join(SCRIPTS, "fullsize_train_demo.py")).read())
    keep = [n for n in tree.body if (isinstance(n, ast.Assign) and n.targets[0].id in ("sr", "freqs"))
            or (isinstance(n, ast.FunctionDef) and n.name == "split")]
    ns = {"np": np}
    exec(compile(ast.Module(body=keep, type_ignores=[]), "fullsize_train_demo.py", "exec"), ns)
    call = next(n.value for n in tree.body if isinstance(n, ast.Assign) and n.targets[0].id == "cfg")
    ns["overrides"] = eval(compile(ast.Expression(call.args[1]), "fullsize_train_demo.py", "eval"), {"tmp": "/x"})
    return ns


@pytest.mark.parametrize("n_per,seed", [(10, 1), (3, 2), (1, 7)])
def test_demo_items_bit_equal(n_per, seed):
    script = _demo_script()
    assert script["sr"] == fullsize_train_demo.SR
    np.testing.assert_array_equal(script["freqs"], fullsize_train_demo.FREQS)
    got, want = fullsize_train_demo.make_items(n_per, seed), script["split"](n_per, seed)
    assert len(got) == len(want) == 50 * n_per
    for (gn, gw, gy), (wn, ww, wy) in zip(got, want):
        assert gn == wn and gw.dtype == ww.dtype and gy.dtype == wy.dtype
        np.testing.assert_array_equal(gw, ww)
        np.testing.assert_array_equal(gy, wy)


def test_demo_config_equal():
    want = jax_apply_overrides(JAX_EXPERIMENTS["audioset"].default_config, _demo_script()["overrides"])
    got = fullsize_train_demo.config("/x/train.h5", "/x/test.h5")
    assert got.pretty() == want.pretty()
    extra = ["trainer.opt_moments_dtype=bfloat16_sr", "trainer.lr=2e-4"]
    want = jax_apply_overrides(want, dict(kv.split("=", 1) for kv in extra))
    assert fullsize_train_demo.config("/x/train.h5", "/x/test.h5", extra).pretty() == want.pretty()


def test_demo_main_on_the_cpu(capsys):
    """``main`` at a tiny width (2 blocks of 64, 32 mels, fp32) for one short
    epoch: the packed containers, the recipe and the printed ap."""
    with _tiny_archs("passt_s_swa_p16_128_ap476"):
        res = fullsize_train_demo.main(["model.input_fdim=32", "mel.n_mels=32", "model.dtype=float32",
                                        "trainer.max_epochs=1", "data.epoch_len=24", "data.num_workers=2"],
                                       device="cpu")
    (rec,) = res["history"]
    assert np.isfinite(rec["train_loss"]) and np.isfinite(rec["ap"]) and rec["n_eval"] == 150
    out = capsys.readouterr().out
    assert "ap by epoch: [" in out and "final swa_ap: None" in out


# ---- imports ---------------------------------------------------------------------------------------------------
def test_tools_import_without_jax_or_h5py():
    """In a fresh interpreter with jax, flax, the JAX package and h5py
    blocked, the prep package and every tool import."""
    code = f"""
import importlib, importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split('.')[0] in ('jax', 'flax', 'optax', 'passt_tpu', 'h5py'):
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
import passt_tpu_torch.data.prepare
for m in ('metadata', 'wavdec', 'pack_hdf5', 'mp3enc', 'oggdec'):
    importlib.import_module('passt_tpu_torch.data.prepare.' + m)
for t in {TOOLS!r}:
    importlib.import_module('passt_tpu_torch.tools.' + t)
print('ok', sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'passt_tpu', 'h5py')))
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "ok []"
