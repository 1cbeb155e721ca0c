"""The port's serving artifacts (passt_tpu_torch.export, the custom ops of
passt_tpu_torch.ops.library, passt_tpu_torch.tools.export_inference and
.serve) against the live models and the JAX package's artifacts, on the
CPU: the counterparts of tests/test_export.py's eight tests, plus the
custom ops' fake versions.

Both packages export the same tiny net (the JAX package's random weights,
carried across by ``state_dict_from_flax``): the JAX artifact with its
portable matmul frontend, the port's with its default ``stft_method`` —
the mel kernel as a custom op of the program, its plain version on the
CPU — and the fused attention (the attention custom ops, plain here).
Bounds: the loaded port artifact against the live port model it was
traced from, the same bits (one function, the same ops); against the JAX
package's live model and loaded artifact, fp32, 1e-5 of max|ref| (the two
frontends' STFT formulations round differently).
"""

import dataclasses
import json
import os
import subprocess
import sys
import wave as wavemod

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import passt_tpu.export as jax_export
import passt_tpu.models.registry as jax_registry
import passt_tpu_torch.models.registry as registry
from passt_tpu.hear import make_inference_fn as jax_make_inference_fn
from passt_tpu.models.passt import PaSSTConfig as JaxConfig
from passt_tpu.models.passt import init_passt
from passt_tpu.ops.frontend import MelConfig as JaxMelConfig
from passt_tpu_torch import export
from passt_tpu_torch.hear import Predictor
from passt_tpu_torch.models.passt import PaSST, PaSSTConfig
from passt_tpu_torch.models.pretrained import state_dict_from_flax
from passt_tpu_torch.ops import library
from passt_tpu_torch.ops.frontend import MelConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# patchout configured on purpose: it must not enter the eval program
TINY = dict(input_fdim=64, input_tdim=48, embed_dim=64, depth=2, num_heads=4, num_classes=11,
            s_patchout_t=2, s_patchout_f=1)
AUG = dict(n_mels=64, fmin_aug_range=10, fmax_aug_range=2000)
JAX_MEL = JaxMelConfig(stft_method="matmul", **AUG)
PORT_MEL = MelConfig(**AUG)  # "auto": the mel kernel's custom op
SECONDS = 0.5


def _rel_close(got, ref, rel=1e-5, what=""):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    bound = rel * float(np.abs(ref).max())
    assert float(np.abs(got - ref).max()) <= bound, f"{what}: {np.abs(got - ref).max()} > {bound}"


def _port_model(params, **overrides):
    model = PaSST(PaSSTConfig(**dict(TINY, attn_impl="fused", **overrides)))
    model.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, params)))
    return model.eval()


def _wave(seed, b, n=int(SECONDS * 32000)):
    return np.random.default_rng(seed).standard_normal((b, n)).astype(np.float32)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """(port artifact prefix, JAX artifact prefix, port model, JAX model, JAX params)."""
    root = tmp_path_factory.mktemp("export")
    jmodel, params = init_passt(JaxConfig(**TINY), jax.random.PRNGKey(0))
    jax_export.export_model(jmodel, params, JaxConfig(**TINY), str(root / "jax"), platforms=("cpu",),
                            seconds=SECONDS, batch="b", mel_cfg=JAX_MEL)
    model = _port_model(params)
    export.export_model(model, str(root / "port"), seconds=SECONDS, batch="b", mel_cfg=PORT_MEL)
    return str(root / "port"), str(root / "jax"), model, jmodel, params


def test_export_roundtrip_matches_live_models(tiny):
    """One symbolic-batch artifact at B = 1 and 3: the live port
    ``Predictor`` of the same model, bit for bit; the JAX package's live
    model and its own artifact, within 1e-5 of max|ref|. The program holds
    the mel and attention custom ops and no patchout."""
    out, jout, model, jmodel, params = tiny
    fn = export.load_exported(out)
    live = Predictor(model=model, mel_cfg=PORT_MEL)
    jinfer = jax_make_inference_fn(jmodel, JAX_MEL, TINY["input_tdim"])
    jfn = jax_export.load_exported(jout)
    for b in (1, 3):
        wave = _wave(b, b)
        logits, feats = fn(wave)
        assert tuple(logits.shape) == (b, TINY["num_classes"]) and tuple(feats.shape) == (b, TINY["embed_dim"])
        ref_logits, ref_feats = live.logits_and_features(wave)
        assert torch.equal(logits, ref_logits) and torch.equal(feats, ref_feats)
        jl, jf = jinfer(params, jnp.asarray(wave))
        _rel_close(logits, jl, what="logits vs JAX live")
        _rel_close(feats, jf, what="features vs JAX live")
        _rel_close(logits, jfn(wave)[0], what="logits vs JAX artifact")
    targets = {str(n.target) for n in torch.export.load(out + export.ARTIFACT_SUFFIX).graph.nodes}
    assert {"passt.log_mel.default", "passt.attention_qkv.default"} <= targets


def test_export_manifest_contract(tiny):
    """The manifest has the JAX manifest's keys and values, but for the
    version keys (``jax_version`` and ``calling_convention_version`` become
    ``torch_version``) and the platform name."""
    out, jout = tiny[0], tiny[1]
    m, jm = export.read_manifest(out), jax_export.read_manifest(jout)
    renamed = {"jax_version", "calling_convention_version"}
    assert set(m) == set(jm) - renamed | {"torch_version"}
    assert m["torch_version"] == torch.__version__
    assert m["platforms"] == jm["platforms"] == ["cpu"]
    for k in set(jm) - renamed:
        assert m[k] == jm[k], k
    assert m["input"]["shape"] == [None, int(SECONDS * 32000)]
    assert m["outputs"] == {"logits": TINY["num_classes"], "features": TINY["embed_dim"]}
    assert export.read_manifest(out + export.ARTIFACT_SUFFIX) == m == export.read_manifest(
        out + export.MANIFEST_SUFFIX)


def test_export_fixed_batch(tmp_path):
    """An int batch is fixed: the manifest says so, the program takes that
    batch and refuses another; the JAX package's fixed-batch artifact of
    the same weights agrees."""
    cfg = dict(TINY, s_patchout_t=0, s_patchout_f=0)
    jmodel, params = init_passt(JaxConfig(**cfg), jax.random.PRNGKey(1))
    model = _port_model(params, s_patchout_t=0, s_patchout_f=0)
    out = str(tmp_path / "fixed")
    export.export_model(model, out, seconds=SECONDS, batch=2, mel_cfg=PORT_MEL)
    jax_export.export_model(jmodel, params, JaxConfig(**cfg), str(tmp_path / "jfixed"), platforms=("cpu",),
                            seconds=SECONDS, batch=2, mel_cfg=JAX_MEL)
    assert export.read_manifest(out)["input"]["shape"][0] == 2
    fn = export.load_exported(out)
    wave = _wave(5, 2)
    logits, _ = fn(wave)
    assert tuple(logits.shape) == (2, TINY["num_classes"])
    _rel_close(logits, jax_export.load_exported(str(tmp_path / "jfixed"))(wave)[0], what="fixed batch vs JAX")
    with pytest.raises(Exception):
        fn(np.zeros((3, 16000), np.float32))


@pytest.mark.slow
def test_export_full_arch_cli(tmp_path):
    """``python -m passt_tpu_torch.tools.export_inference`` on the flagship
    arch (86M parameters, random weights) for the CPU, as the JAX package's
    CLI test (slow there too)."""
    from passt_tpu_torch.tools import export_inference as cli

    out = str(tmp_path / "flagship")
    cli.main(["--arch", "passt_s_swa_p16_128_ap476", "--out", out, "--device", "cpu", "--seconds", "1.0"])
    m = export.read_manifest(out)
    assert m["arch"] == "passt_s_swa_p16_128_ap476" and m["pretrained"] is False
    logits, feats = export.load_exported(out)(np.zeros((2, 32000), np.float32))
    assert tuple(logits.shape) == (2, 527) and tuple(feats.shape) == (2, 768)


def test_export_ensemble_roundtrip(tmp_path):
    """An ensemble as one program (the mel once, the members, the logit
    mean), members shrunk in both registries and their weights the JAX
    package's (``<arch>.npz`` in ``checkpoint_dir``): the manifest is the
    JAX package's but for the version keys; the logits are the mean of the
    live members' on the shared mel, bit for bit, and within 1e-5 of max|ref|
    of the JAX package's artifact."""
    from passt_tpu.models.pretrained import save_params_npz as jax_save_params_npz
    from passt_tpu_torch.models.registry import ENSEMBLES, ensemble_apply, get_ensemble_model
    from passt_tpu_torch.ops.frontend import log_mel_spectrogram

    name = "ensemble_s16_14"
    members = ENSEMBLES[name][0]
    over = dict(n_classes=7, input_fdim=64, input_tdim=48)
    ckpts = tmp_path / "members"
    ckpts.mkdir()
    out, jout = str(tmp_path / "ens"), str(tmp_path / "jens")
    with pytest.MonkeyPatch.context() as mp:
        for reg in (registry, jax_registry):
            for arch, _, _ in members:
                mp.setitem(reg.ARCHS, arch, dataclasses.replace(reg.ARCHS[arch], depth=1, embed_dim=64, num_heads=4))
        for (arch, _, _), (_, params) in zip(members, jax_registry.get_ensemble_model(
                members, rng=jax.random.PRNGKey(0), **over)):
            jax_save_params_npz(str(ckpts / f"{arch}.npz"), params)
        export.export_ensemble(name, out, checkpoint_dir=str(ckpts), device="cpu", seconds=SECONDS, **over)
        jax_export.export_ensemble(name, jout, checkpoint_dir=str(ckpts), platforms=("cpu",), seconds=SECONDS,
                                   **over)
        pairs = get_ensemble_model(members, checkpoint_paths=[str(ckpts / f"{a}.npz") for a, _, _ in members],
                                   device="cpu", **over)
    m, jm = export.read_manifest(out), jax_export.read_manifest(jout)
    assert m["ensemble"] == name and [tuple(x) for x in m["members"]] == members and m["outputs"] == {"logits": 7}
    assert {k: v for k, v in m.items() if k != "torch_version"} == {
        k: v for k, v in jm.items() if k not in ("jax_version", "calling_convention_version")}
    wave = _wave(3, 2)
    logits = export.load_exported(out)(wave)
    assert tuple(logits.shape) == (2, 7)
    mel_cfg = MelConfig(n_mels=64, fmin_aug_range=10, fmax_aug_range=2000)
    with torch.inference_mode():
        ref, _ = ensemble_apply(pairs, log_mel_spectrogram(torch.from_numpy(wave), mel_cfg)[:, None, :, :48])
    assert torch.equal(logits, ref)
    _rel_close(logits, jax_export.load_exported(jout)(wave), what="ensemble vs JAX")


def test_export_external_weights_roundtrip(tiny, tmp_path):
    """``bake_weights=False``: the weights go to ``<out>.params.npz``, the
    program is smaller than the baked one and holds none of them, and
    ``load_exported`` passes them in: the same bits as the baked artifact."""
    out, _, model, _, _ = tiny
    ext = str(tmp_path / "ext")
    export.export_model(model, ext, seconds=SECONDS, batch="b", mel_cfg=PORT_MEL, bake_weights=False)
    assert os.path.exists(ext + export.PARAMS_SUFFIX)
    assert os.path.getsize(ext + export.ARTIFACT_SUFFIX) < os.path.getsize(out + export.ARTIFACT_SUFFIX)
    assert export.read_manifest(ext)["weights"] == "external" and export.read_manifest(out)["weights"] == "baked"
    assert not torch.export.load(ext + export.ARTIFACT_SUFFIX).state_dict
    wave = _wave(1, 2)
    lb, fb = export.load_exported(out)(wave)
    le, fe = export.load_exported(ext)(wave)
    assert torch.equal(lb, le) and torch.equal(fb, fe)


def _write_wavs(wav_dir, rng):
    wav_dir.mkdir()
    for i, (n, rate) in enumerate([(16000, 32000), (8000, 32000), (8000, 16000)]):
        x = (rng.standard_normal(n) * 3000).astype(np.int16)
        with wavemod.open(str(wav_dir / f"c{i}.wav"), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(rate)
            w.writeframes(x.tobytes())


def test_serve_cli_end_to_end(tiny, tmp_path, rng_np):
    """``python -m passt_tpu_torch.tools.serve``: a folder of wav files
    (padded, truncated and resampled to the manifest's contract, a ragged
    last batch) -> ``.npz``, the same names and, within 1e-5 of max|ref|,
    the same probabilities as the JAX package's serve script on its
    artifact."""
    import importlib.util

    from passt_tpu_torch.tools import serve

    out, jout = tiny[0], tiny[1]
    _write_wavs(tmp_path / "wavs", rng_np)
    got_npz, ref_npz = str(tmp_path / "pred.npz"), str(tmp_path / "jpred.npz")
    serve.main(["--artifact", out, "--wav-dir", str(tmp_path / "wavs"), "--out", got_npz, "--batch", "2", "--probs"])
    spec = importlib.util.spec_from_file_location("serve_cli", os.path.join(ROOT, "scripts", "serve.py"))
    jserve = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jserve)
    jserve.main(["--artifact", jout, "--wav-dir", str(tmp_path / "wavs"), "--out", ref_npz, "--batch", "2",
                 "--probs"])
    got, ref = np.load(got_npz), np.load(ref_npz)
    assert list(got["names"]) == list(ref["names"]) == ["c0.wav", "c1.wav", "c2.wav"]
    assert got["out"].shape == (3, TINY["num_classes"])
    assert ((got["out"] >= 0) & (got["out"] <= 1)).all()
    _rel_close(got["out"], ref["out"], what="served probabilities")


def test_load_exported_needs_only_torch_and_the_ops(tiny):
    """The serving contract: in a fresh interpreter where jax, flax, the
    JAX package and the port's ``models`` and ``train`` cannot be imported,
    the artifact loads and runs (through the custom ops' registration)."""
    out = tiny[0]
    code = f"""
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        top = name.split('.')[0]
        if top in ('jax', 'flax', 'optax', 'orbax', 'passt_tpu') or name.startswith(
                ('passt_tpu_torch.models', 'passt_tpu_torch.train')):
            raise ImportError('blocked: ' + name)
sys.meta_path.insert(0, Block())
import numpy as np
from passt_tpu_torch.export import load_exported, read_manifest
m = read_manifest({out!r} + '.passt.pt2')
logits, feats = load_exported({out!r})(np.zeros((2, m['input']['shape'][1]), np.float32))
assert tuple(logits.shape) == (2, m['outputs']['logits'])
print('torch-only load OK', sorted(k for k in sys.modules if k.startswith(('passt_tpu_torch.models',
      'passt_tpu_torch.train', 'jax'))))
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "torch-only load OK []"


def _op_args(op, b):
    """(arguments of ``op`` at batch ``b``, how many lead with the batch)."""
    g = torch.Generator().manual_seed(0)
    r = lambda *s, dtype=torch.float32: torch.randn(*s, generator=g).to(dtype)  # noqa: E731
    if op == "passt::log_mel":
        from passt_tpu_torch.ops.mel import kaldi_mel_banks

        return (r(b, 8000), kaldi_mel_banks(64, 1024, 32000, 0.0, 15000.0), 1024, 320, 800, 1e-5, 4.5, 5.0), 1
    if op == "passt::attention":
        return (r(b, 20, 4, 16), r(b, 20, 4, 16), r(b, 20, 4, 16), 0.25, False), 3
    if op == "passt::attention_qkv":
        return (r(b, 20, 192, dtype=torch.bfloat16), 4, 16, 0.25, True), 1
    return (r(b, 20, 64), r(64), r(64), r(192, 64), r(192), 1e-6), 1


@pytest.mark.parametrize("op", library.OPS)
def test_custom_op_fakes_match_the_plain_versions(op):
    """Each custom op's fake version gives the shape, dtype and strides of
    its plain version (``torch.library.opcheck`` on CPU tensors), and a
    program traced through it at a symbolic batch gives, at other batches,
    what the op gives."""
    packet = getattr(torch.ops.passt, op.split("::")[1])
    args, n_batched = _op_args(op, 3)
    torch.library.opcheck(packet.default, args)

    class Call(torch.nn.Module):
        def forward(self, *tensors):
            return packet(*tensors, *args[n_batched:])

    dim = torch.export.Dim("b")
    program = torch.export.export(Call(), args[:n_batched],
                                  dynamic_shapes={"tensors": tuple({0: dim} for _ in range(n_batched))})
    for b in (1, 5):
        at_b = _op_args(op, b)[0]
        got, want = program.module()(*at_b[:n_batched]), packet(*at_b[:n_batched], *args[n_batched:])
        assert got.shape == want.shape and got.dtype == want.dtype and got.stride() == want.stride()
        assert torch.equal(got, want)


def test_export_inference_cli_defaults_follow_the_arch(tmp_path, monkeypatch):
    """``python -m passt_tpu_torch.tools.export_inference`` (through
    ``export_inference``) with the arch's defaults: its time grid and hop,
    the recipe's augmentation ranges, ``seconds`` rounded up to the clip
    length (10 s for 998 frames), as the JAX package's (a shrunk arch, a
    fixed batch, the CPU)."""
    from passt_tpu_torch.tools import export_inference as cli

    arch = "passt_s_swa_p16_128_ap476"
    monkeypatch.setitem(registry.ARCHS, arch, dataclasses.replace(registry.ARCHS[arch], depth=1, embed_dim=64,
                                                                  num_heads=4))
    out = str(tmp_path / "arch")
    artifact, _ = cli.main(["--arch", arch, "--out", out, "--device", "cpu", "--batch", "1"])
    assert artifact == out + export.ARTIFACT_SUFFIX
    m = export.read_manifest(out)
    assert m["seconds"] == 10.0 and m["input"]["shape"] == [1, 320000]
    assert m["mel"] == {"n_mels": 128, "hopsize": 320, "fmin_aug_range": 10, "fmax_aug_range": 2000}
    assert m["arch"] == arch and m["pretrained"] is False and m["dtype"] == "float32"
    assert m["weights"] == "baked" and json.loads(json.dumps(m)) == m
    with pytest.raises(SystemExit):
        cli.main(["--arch", arch, "--out", out, "--device", "cpu", "--batch", "0"])
