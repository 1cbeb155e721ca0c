"""Smoke run of the PyTorch/CUDA port (passt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one line; the first failure exits non-zero):

1. a CUDA device is present; its name and power limit (nvidia-smi);
2. the Hopper kernels build from ``passt_tpu_torch/csrc`` (one nvcc per
   source, started together);
3. each kernel against its plain PyTorch version on the card, at the
   shapes the serving path gives it, with its time and the plain time;
4. the serving path at full PaSST-S width (12 x 768, 12 heads, 527 classes,
   N = 1190, random weights from a seeded generator): Predictor calls at
   B = 1 and B = 20 (10-s clips), scene embeddings and timestamp embeddings
   on a 2-s clip; the kernel launch counts of exactly that run; clips/s;
5. correctness: the same Predictor in fp32 with the kernels against one
   with the plain versions, and the repo's golden fixtures (reference mel
   and reference model outputs) through the kernels.

fp32 is compared with TF32 off: ``torch.backends.cuda.matmul.allow_tf32``
and ``torch.backends.cudnn.allow_tf32`` are set False for the whole run.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the kernels' JSON record.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

ARCH = "passt_s_swa_p16_128_ap476"
CLIP = 320000  # 10 s at 32 kHz
# attention kernel vs plain: fp32 differs in summation order only; in bf16 /
# fp16 a p may round the other way and the output may round the other way:
# one output ulp at |o| < 2
TOL_ATTN = {torch.float32: 5e-5, torch.bfloat16: 2.0**-7, torch.float16: 2.0**-10}


def say(line: str) -> None:
    print(line, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def mel_strong_check(got: torch.Tensor, ref: torch.Tensor, what: str) -> float:
    """The bound tests/test_pallas_mel.py holds the TPU kernel to: 1e-3 in
    near-empty mel bins (the log is steep there), 2e-4 wherever the mel
    energy exceeds 1e-2 (normalised log-mel scale)."""
    err = max_err(got, ref)
    strong = torch.exp(5.0 * ref - 4.5) > 1e-2
    strong_err = float((got - ref)[strong].abs().max())
    check(err < 1e-3 and strong_err < 2e-4, f"{what}: max err {err:.3g}, strong-bin err {strong_err:.3g}")
    return err


def ptxas_summary(log: str) -> str:
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", log)]
    if not regs:
        return log.strip()[:200]
    return f"{len(regs)} functions, max {max(regs)} registers, max spill stores {max(spills or [0])} B"


def phase_kernels(gpu: str, dev: torch.device) -> dict:
    from passt_tpu_torch.ops.attention import attention_plain, fused_attention, fused_attention_qkv
    from passt_tpu_torch.ops.mel import kaldi_mel_banks
    from passt_tpu_torch.ops.mel_kernel import fused_log_mel, fused_log_mel_plain

    rng = np.random.default_rng(0)
    rec = {}

    # mel: hop 320 at the slice's batch, hop 100 and 160 at a small one
    bank = kaldi_mel_banks(128, 1024, 32000, 0.0, 15000.0, device=dev)
    mel_err = 0.0
    for hop, b in ((320, 20), (100, 2), (160, 2)):
        wave = torch.from_numpy(rng.standard_normal((b, CLIP)).astype(np.float32)).to(dev)
        got = fused_log_mel(wave, bank, hop=hop)
        ref = fused_log_mel_plain(wave, bank, hop=hop)
        torch.cuda.synchronize()
        check(got.shape == ref.shape, f"mel hop {hop}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
        mel_err = max(mel_err, mel_strong_check(got, ref, f"mel hop {hop}"))
        if hop == 320:
            ms = cuda_ms(lambda: fused_log_mel(wave, bank))
            plain_ms = cuda_ms(lambda: fused_log_mel_plain(wave, bank))
    say(f"[3] mel kernel vs plain: max err {mel_err:.3g}; B=20x10s hop 320: "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms ({gpu})")
    rec["fused_log_mel"] = dict(max_abs_err=mel_err, ms=ms, plain_ms=plain_ms)

    # attention: both entries, bf16 and fp32 (and fp16), plus1 on and off,
    # N in {14, 474, 1190} at the model's heads; then other head dims (the
    # tensor-core path takes D % 16 == 0, the FMA path the rest)
    heads, hd = 12, 64
    errs = {"fused_attention": 0.0, "fused_attention_qkv": 0.0}
    cases = [(dtype, n, plus1, heads, hd)
             for dtype in (torch.bfloat16, torch.float32, torch.float16)
             for n in (14, 474, 1190) for plus1 in (False, True)]
    cases += [(torch.bfloat16, 97, True, h_, d_) for h_, d_ in ((4, 16), (2, 24), (2, 128))]
    for dtype, n, plus1, h_, d_ in cases:
        qkv = torch.from_numpy(rng.standard_normal((2, n, 3 * h_ * d_)).astype(np.float32))
        qkv = qkv.to(dev, dtype)
        q, k, v = qkv.reshape(2, n, 3, h_, d_).unbind(2)
        ref = attention_plain(q, k, v, scale=d_ ** -0.5, plus1=plus1)
        got_b = fused_attention(q, k, v, scale=d_ ** -0.5, plus1=plus1)
        got_f = fused_attention_qkv(qkv, heads=h_, head_dim=d_, scale=d_ ** -0.5, plus1=plus1)
        torch.cuda.synchronize()
        for name, got in (("fused_attention", got_b), ("fused_attention_qkv", got_f.view(ref.shape))):
            err = max_err(got, ref)
            check(got.dtype == dtype and bool(torch.isfinite(got).all()), f"{name}: dtype/finite")
            check(err <= TOL_ATTN[dtype], f"{name} {dtype} N={n} H={h_} D={d_} plus1={plus1}: "
                  f"max err {err:.3g} > {TOL_ATTN[dtype]:.3g}")
            errs[name] = max(errs[name], err)

    def timings(b, n, entry):
        qkv = torch.randn((b, n, 3 * heads * hd), device=dev, dtype=torch.bfloat16)
        q, k, v = qkv.reshape(b, n, 3, heads, hd).unbind(2)
        if entry == "fused_attention":
            kern = lambda: fused_attention(q, k, v, scale=hd ** -0.5)
        else:
            kern = lambda: fused_attention_qkv(qkv, heads=heads, head_dim=hd, scale=hd ** -0.5)
        plain = lambda: attention_plain(q, k, v, scale=hd ** -0.5)
        return cuda_ms(kern), cuda_ms(plain)

    for name, (b, n) in (("fused_attention", (20, 1190)), ("fused_attention_qkv", (256, 14))):
        ms, plain_ms = timings(b, n, name)
        say(f"[3] {name} vs plain: max err {errs[name]:.3g} (bf16/fp32/fp16, plus1 on/off, "
            f"N 14/474/1190 at D=64; D 16/24/128 at N=97); bf16 B={b} H=12 N={n} D=64: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms ({gpu})")
        rec[name] = dict(max_abs_err=errs[name], ms=ms, plain_ms=plain_ms)
    return rec


def phase_serving(gpu: str, dev: torch.device) -> dict:
    from passt_tpu_torch.hear import Predictor
    from passt_tpu_torch.ops import _build

    pred = Predictor.create(arch=ARCH, dtype="bfloat16", device=dev,
                            generator=torch.Generator().manual_seed(0))
    cfg = pred.model.cfg
    check((cfg.embed_dim, cfg.depth, cfg.num_heads, cfg.num_classes) == (768, 12, 12, 527),
          f"not PaSST-S width: {cfg}")
    rng = np.random.default_rng(1)
    w20 = torch.from_numpy(rng.standard_normal((20, CLIP)).astype(np.float32) * 0.1).to(dev)
    w2s = torch.from_numpy(rng.standard_normal((1, 64000)).astype(np.float32) * 0.1).to(dev)

    _build.reset_launches()
    logits1 = pred(w20[:1])
    logits20, feats20 = pred.logits_and_features(w20)
    scene = pred.scene_embeddings(w20)
    ts_emb, ts = pred.timestamp_embeddings(w2s)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)

    check(tuple(logits1.shape) == (1, 527) and tuple(logits20.shape) == (20, 527), "logits shape")
    check(tuple(scene.shape) == (20, 527 + 768), f"scene shape {tuple(scene.shape)}")
    check(tuple(ts_emb.shape) == (1, 40, 527 + 768) and tuple(ts.shape) == (1, 40),
          f"timestamp shapes {tuple(ts_emb.shape)}, {tuple(ts.shape)}")
    for name, t in (("logits1", logits1), ("logits20", logits20), ("scene", scene), ("timestamps", ts_emb)):
        check(bool(torch.isfinite(t).all()), f"{name} not finite")
    # the same clip alone and in a batch of 20 (bf16: cuBLAS may pick other
    # GEMM tilings per batch, so the bf16 rounding differs a little)
    b1_err = max_err(logits1[0], logits20[0])
    check(b1_err < 5e-2, f"B=1 vs B=20 row 0: {b1_err:.3g}")
    # 3 clip-level calls + 1 timestamp chunk: one mel launch each; 12 blocks
    # per forward at N = 1190 on the [B, N, H, D] entry, at N = 14 on qkv
    want = {"fused_log_mel": 4, "fused_attention": 36, "fused_attention_qkv": 12}
    check(launches == want, f"launches {launches} != {want}")
    say(f"[4] serving PaSST-S bf16 (random weights, seed 0): B=1, B=20 logits, scene "
        f"[20, 1295], timestamps [1, 40, 1295]; launches {launches}")

    ms20 = cuda_ms(lambda: pred(w20), reps=5, warmup=1)
    ms1 = cuda_ms(lambda: pred(w20[:1]), reps=10, warmup=2)
    say(f"[4] Predictor bf16 B=20 x 10 s: {ms20:.3f} ms/call = {20000.0 / ms20:.2f} clips/s; "
        f"B=1: {ms1:.3f} ms/call ({gpu})")
    return launches


def phase_correctness(dev: torch.device) -> None:
    from passt_tpu_torch.hear import Predictor
    from passt_tpu_torch.models.passt import PaSST, PaSSTConfig
    from passt_tpu_torch.ops.frontend import MelConfig, log_mel_spectrogram

    fix_dir = os.path.join(ROOT, "tests", "fixtures")

    # full width fp32: kernels vs plain versions on the same weights
    kern = Predictor.create(arch=ARCH, dtype="float32", device=dev,
                            generator=torch.Generator().manual_seed(0))
    plain = Predictor.create(arch=ARCH, dtype="float32", device=dev, attn_impl="xla",
                             mel_cfg=dataclasses.replace(kern.mel_cfg, stft_method="matmul"))
    plain.model.load_state_dict(kern.model.state_dict())
    wave = torch.from_numpy(
        np.random.default_rng(2).standard_normal((2, CLIP)).astype(np.float32) * 0.1
    ).to(dev)
    lk, fk = kern.logits_and_features(wave)
    lp, fp = plain.logits_and_features(wave)
    # fp32 on both sides; the kernels sum in another order (800-sample DFT
    # sums, 1190-key softmax sums) and near-empty mel bins move by up to 1e-3
    # through the log, which 12 blocks carry into the outputs
    l_err, f_err = max_err(lk, lp), max_err(fk, fp)
    check(l_err < 5e-3 and f_err < 5e-3, f"fp32 kernels vs plain: logits {l_err:.3g}, features {f_err:.3g}")
    say(f"[5] fp32 PaSST-S, kernels vs plain versions: logits err {l_err:.3g}, features err "
        f"{f_err:.3g} (tol 5e-3)")

    # the repo's golden fixtures (reference torch outputs), through the kernels
    fix = np.load(os.path.join(fix_dir, "mel_flagship.npz"))
    mel = log_mel_spectrogram(torch.from_numpy(fix["wave"]).to(dev),
                              MelConfig(fmin_aug_range=10, fmax_aug_range=2000))
    mel_err = mel_strong_check(mel.cpu(), torch.from_numpy(fix["mel"]), "golden mel")
    fix = np.load(os.path.join(fix_dir, "model_fullgeom.npz"))
    model = PaSST(PaSSTConfig(embed_dim=128, depth=3, num_heads=2, attn_impl="fused"))
    model.load_state_dict({k[3:]: torch.from_numpy(fix[k]) for k in fix.files if k.startswith("sd.")})
    with torch.inference_mode():
        logits, features = model.eval().to(dev)(torch.from_numpy(fix["x"]).to(dev))
    l_err = max_err(logits.cpu(), torch.from_numpy(fix["logits"]))
    f_err = max_err(features.cpu(), torch.from_numpy(fix["features"]))
    check(l_err < 2e-4 and f_err < 2e-4, f"golden model: logits {l_err:.3g}, features {f_err:.3g}")
    say(f"[5] golden fixtures through the kernels: mel err {mel_err:.3g}; N=1190 model "
        f"logits err {l_err:.3g}, features err {f_err:.3g} (tol 2e-4)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    from passt_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gpu = gpu_line()
    say(f"[1] device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"nvidia-smi: {gpu}; torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    logs = _build.build()
    seconds = time.perf_counter() - t0
    say(f"[2] built {', '.join(_build.KERNELS)} in {seconds:.1f} s: "
        + "; ".join(f"{k}: {ptxas_summary(v)}" for k, v in logs.items()))

    rec = phase_kernels(gpu, dev)
    launches = phase_serving(gpu, dev)
    phase_correctness(dev)

    sources = {
        "fused_log_mel": ("passt_tpu_torch/csrc/mel_kernel.cu", "passt_tpu/ops/pallas/mel_kernel.py:65"),
        "fused_attention": ("passt_tpu_torch/csrc/attention_fwd.cu", "passt_tpu/ops/pallas/attention.py:171"),
        "fused_attention_qkv": ("passt_tpu_torch/csrc/attention_fwd.cu", "passt_tpu/ops/pallas/attention.py:373"),
    }
    kernels = [
        dict(name=name, route="cuda", source=src, replaces=rep, launches=launches[name], **rec[name])
        for name, (src, rep) in sources.items()
    ]
    say(gpu)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
