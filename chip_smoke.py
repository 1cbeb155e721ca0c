"""Smoke run of the PyTorch/CUDA port (passt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one line or more; the first failure exits non-zero):

1. a CUDA device is present; its name and power limit (nvidia-smi);
2. the Hopper kernels build from ``passt_tpu_torch/csrc`` (one nvcc per
   source, all started together);
3. each forward kernel against its plain PyTorch version on the card, at
   the shapes the serving and training paths give it, with its time, the
   plain time, one library call's time where one computes the function,
   and the bound;
3b. the attention backward kernel through both entries against its plain
   version (bf16/fp16/fp32, plus1 on and off, ragged N, other head dims),
   timed at the training step's shapes beside SDPA's backward;
4. the serving path at full PaSST-S width (12 x 768, 12 heads, 527 classes,
   N = 1190, random weights from a seeded generator): Predictor calls at
   B = 1 and B = 20 (10-s clips), scene embeddings and timestamp embeddings
   on a 2-s clip; the kernel launch counts of exactly that run; clips/s;
5. correctness: the same Predictor in fp32 with the kernels against one
   with the plain versions, and the repo's golden fixtures (reference mel
   and reference model outputs) through the kernels;
6. the training step of ``passt_tpu_torch.bench`` at full PaSST-S width
   (bf16, B = 12, patchout 40/4 -> N = 474, mixup, AdamW with bf16 SR
   moments and bf16 SR parameters): 2 warm-up and 10 timed steps, ms/step
   and specs/s, the loss finite, the parameters moved, the step counter
   advanced, and the exact launch counts per step;
7. one fp32 training step at full width (B = 2) with the kernels against
   the same step on the plain versions, from the same weights and the same
   draws: the loss, every leaf's gradient and the updated parameters.

Launch counts: each main-path run (phases 4, 6 and the kernel side of 7)
starts with every count at 0 and reads the counts right after; the
``launches`` of the kernels' record sum those runs. The comparisons of
phases 3 and 3b are outside them.

fp32 is compared with TF32 off: ``torch.backends.cuda.matmul.allow_tf32``
and ``torch.backends.cudnn.allow_tf32`` are set False for the whole run.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the kernels' JSON record.
"""

from __future__ import annotations

import dataclasses
import json
import math
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
# backward kernel vs plain, max error relative to max|ref| of each gradient:
# fp32 differs in summation order only; in bf16 / fp16 the kernel rounds
# P_norm for dV's product (the plain version keeps fp32 there), a dS may
# round the other way, and the output rounds once: one output ulp at the
# largest gradient (2**-7 bf16, 2**-10 fp16) plus the P_norm rounding
TOL_BWD = {torch.float32: 5e-5, torch.bfloat16: 2.0**-6, torch.float16: 2.0**-9}
# peak rates of one H100 SXM (dense, 700 W) for the bounds
PEAK_BF16, PEAK_FP32, HBM_BYTES_PER_S = 989e12, 67e12, 3.35e12
TRAIN_B, TRAIN_N = 12, 474  # the bench step: (12 - 4) x (99 - 40) + 2 tokens
# fp32 training step, kernels vs plain (phase 7): the loss and each leaf's
# gradient (max error over the leaf's max |g|) move only by summation order,
# which the near-empty mel bins (up to 1e-3 through the log) and 12 blocks
# amplify. A first AdamW update is -lr (g / (|g| + eps) + wd p): where the
# plain |g| exceeds 10x the leaf's gradient error d, the two g share a sign
# and the updates differ by at most lr eps d / (9d + eps)^2 <= lr / 36, so
# they are held to TOL_STEP_UPDATE of lr there; elsewhere a sign may flip
# and they differ by less than 2 lr. An updated parameter differs by at most
# the updates' difference plus one ulp of the parameter (each add rounds).
TOL_STEP_LOSS, TOL_STEP_GRAD, TOL_STEP_UPDATE = 1e-4, 1e-3, 0.05


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


def bound(flops: float, nbytes: float, peak: float) -> dict:
    """The least time the card could take: the larger of the operations over
    the peak rate of their type and the bytes over the memory rate."""
    ops_ms, bytes_ms = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return dict(bound_ms=max(ops_ms, bytes_ms), bound_by="operations" if ops_ms >= bytes_ms else "bytes")


def sdpa(q, k, v, scale):
    """One PyTorch call computing the attention function on [B, N, H, D]
    (plus1 off): the library yardstick, never called by the port."""
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale=scale).transpose(1, 2)


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
            # the function's least work, not the kernel's dense DFT: the
            # pre-emphasis per sample; per frame the window, a real FFT of
            # n_fft = 1024 (2.5 n log2 n FLOP), the power of each bin, the
            # bank's non-zero taps only (Kaldi triangles) and the log and
            # normalisation of each mel; the wave and the bank read once, the
            # mel written once
            frames, n_mels, n_freq = b * got.shape[-1], bank.shape[0], bank.shape[1]
            per_frame = 2.5 * 1024 * math.log2(1024) + 800 + 3 * n_freq + 2 * int((bank != 0).sum()) + 3 * n_mels
            mel_bound = bound(2 * wave.numel() + frames * per_frame,
                              (wave.numel() + bank.numel() + got.numel()) * 4, PEAK_FP32)
    say(f"[3] mel kernel vs plain: max err {mel_err:.3g}; B=20x10s hop 320: "
        f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {mel_bound['bound_ms']:.4f} ms "
        f"({mel_bound['bound_by']}), no single library call ({gpu})")
    rec["fused_log_mel"] = dict(max_abs_err=mel_err, ms=ms, plain_ms=plain_ms, library_ms=None, **mel_bound)

    # attention: both entries, bf16 and fp32 (and fp16), plus1 on and off,
    # N in {14, 474, 1190} at the model's heads; then other head dims (the
    # tensor-core path takes D % 16 == 0, the FMA path the rest)
    heads, hd = 12, 64
    errs = {"fused_attention": 0.0, "fused_attention_qkv": 0.0}
    cases = [(dtype, n, plus1, heads, hd)
             for dtype in (torch.bfloat16, torch.float32, torch.float16)
             for n in (14, 474, 1190) for plus1 in (False, True)]
    cases += [(torch.bfloat16, 97, True, h_, d_) for h_, d_ in ((4, 16), (2, 24), (2, 128))]
    with torch.no_grad():
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

    def main_shape(b, n, entry):
        """The kernel against its plain version on the bf16 inputs of a main
        path's shape; returns the kernel call and the plain call on them."""
        qkv = torch.randn((b, n, 3 * heads * hd), device=dev, dtype=torch.bfloat16)
        q, k, v = qkv.reshape(b, n, 3, heads, hd).unbind(2)
        if entry == "fused_attention":
            kern = lambda: fused_attention(q, k, v, scale=hd ** -0.5)
        else:
            kern = lambda: fused_attention_qkv(qkv, heads=heads, head_dim=hd, scale=hd ** -0.5)
        plain = lambda: attention_plain(q, k, v, scale=hd ** -0.5)
        with torch.no_grad():
            err = max_err(kern().reshape(b, n, heads, hd), plain())
        check(err <= TOL_ATTN[torch.bfloat16], f"{entry} bf16 B={b} N={n}: max err {err:.3g}")
        errs[entry] = max(errs[entry], err)
        return kern, plain, (q, k, v)

    # the bf16 training step's forward (qkv entry, B = 12, N = 474)
    main_shape(TRAIN_B, TRAIN_N, "fused_attention_qkv")

    def timings(b, n, entry):
        kern, plain, (q, k, v) = main_shape(b, n, entry)
        with torch.no_grad():
            return dict(ms=cuda_ms(kern), plain_ms=cuda_ms(plain),
                        library_ms=cuda_ms(lambda: sdpa(q, k, v, hd ** -0.5)),
                        **bound(4 * n * n * hd * b * heads, 4 * b * n * heads * hd * 2, PEAK_BF16))

    for name, (b, n) in (("fused_attention", (20, 1190)), ("fused_attention_qkv", (256, 14))):
        t = timings(b, n, name)
        say(f"[3] {name} vs plain: max err {errs[name]:.3g} (bf16/fp32/fp16, plus1 on/off, "
            f"N 14/474/1190 at D=64; D 16/24/128 at N=97; bf16 at the serving and training "
            f"shapes); bf16 B={b} H=12 N={n} D=64: kernel "
            f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, SDPA {t['library_ms']:.4f} ms, bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}) ({gpu})")
        rec[name] = dict(max_abs_err=errs[name], **t)
    return rec


def phase_backward(gpu: str, dev: torch.device) -> dict:
    """[3b] the backward kernel through both entries against its plain
    version, then its times at the shapes the training paths give it."""
    from passt_tpu_torch.ops.attention import (
        attention_bwd_plain,
        fused_attention_bwd,
        fused_attention_qkv_bwd,
    )

    rng = np.random.default_rng(3)
    heads, hd = 12, 64
    worst = {"fused_attention_bwd": 0.0, "fused_attention_qkv_bwd": 0.0}  # of max|ref|
    worst_abs = dict(worst)
    cases = [(dtype, n, plus1, heads, hd)
             for dtype in (torch.bfloat16, torch.float16, torch.float32)
             for n in (14, 474, 1190) for plus1 in (False, True)]
    cases += [(dtype, 97, True, h_, d_) for dtype in (torch.bfloat16, torch.float32)
              for h_, d_ in ((4, 16), (2, 24), (2, 128))]
    for dtype, n, plus1, h_, d_ in cases:
        qkv = torch.from_numpy(rng.standard_normal((2, n, 3 * h_ * d_)).astype(np.float32)).to(dev, dtype)
        do = torch.from_numpy(rng.standard_normal((2, n, h_, d_)).astype(np.float32)).to(dev, dtype)
        q, k, v = qkv.reshape(2, n, 3, h_, d_).unbind(2)
        scale = d_ ** -0.5
        ref = attention_bwd_plain(q, k, v, do, scale=scale, plus1=plus1)
        got_b = fused_attention_bwd(q, k, v, do, scale=scale, plus1=plus1)
        got_f = fused_attention_qkv_bwd(qkv, do.reshape(2, n, h_ * d_), heads=h_, head_dim=d_,
                                        scale=scale, plus1=plus1).reshape(2, n, 3, h_, d_).unbind(2)
        torch.cuda.synchronize()
        for name, got in (("fused_attention_bwd", got_b), ("fused_attention_qkv_bwd", got_f)):
            for what, g, r in zip(("dq", "dk", "dv"), got, ref):
                check(g.dtype == dtype and bool(torch.isfinite(g).all()), f"{name} {what}: dtype/finite")
                err = max_err(g, r)
                rel = err / max(float(r.float().abs().max()), 1e-30)
                check(rel <= TOL_BWD[dtype], f"{name} {what} {dtype} N={n} H={h_} D={d_} plus1={plus1}: "
                      f"max err {rel:.3g} of max|ref| > {TOL_BWD[dtype]:.3g}")
                worst[name] = max(worst[name], rel)
                worst_abs[name] = max(worst_abs[name], err)

    # autograd through views: the [B, N, H, D] entry on unbind views of qkv
    # gets its d(qkv) assembled by autograd from three view gradients; the
    # qkv entry's kernel writes d(qkv) itself. The same kernel math on the
    # same inputs, so the same bits.
    from passt_tpu_torch.ops.attention import fused_attention, fused_attention_qkv

    for dtype in (torch.bfloat16, torch.float32):
        b, n = 2, TRAIN_N
        qkv = torch.from_numpy(rng.standard_normal((b, n, 3 * heads * hd)).astype(np.float32)).to(dev, dtype)
        do = torch.from_numpy(rng.standard_normal((b, n, heads * hd)).astype(np.float32)).to(dev, dtype)
        x1, x2 = qkv.clone().requires_grad_(), qkv.clone().requires_grad_()
        q, k, v = x1.reshape(b, n, 3, heads, hd).unbind(2)
        (g1,) = torch.autograd.grad(fused_attention(q, k, v, scale=hd ** -0.5).reshape(b, n, -1), x1, do)
        (g2,) = torch.autograd.grad(fused_attention_qkv(x2, heads=heads, head_dim=hd, scale=hd ** -0.5), x2, do)
        check(torch.equal(g1, g2), f"{dtype}: d(qkv) through the unbind views != the qkv entry's d(qkv) "
              f"(max err {max_err(g1, g2):.3g})")
    say(f"[3b] d(qkv) assembled by autograd from the [B, N, H, D] entry's view gradients equals the "
        f"qkv entry's d(qkv) bit for bit (bf16 and fp32, B=2 N={TRAIN_N})")

    rec = {}
    # the qkv entry at the bf16 training step's shape; the [B, N, H, D] entry
    # at the fp32 correctness step's (phase 7)
    for name, dtype, b, peak in (("fused_attention_qkv_bwd", torch.bfloat16, TRAIN_B, PEAK_BF16),
                                 ("fused_attention_bwd", torch.float32, 2, PEAK_FP32)):
        n, scale = TRAIN_N, hd ** -0.5
        qkv = torch.randn((b, n, 3 * heads * hd), device=dev, dtype=dtype)
        do = torch.randn((b, n, heads * hd), device=dev, dtype=dtype)
        q, k, v = qkv.reshape(b, n, 3, heads, hd).unbind(2)
        do4 = do.view(b, n, heads, hd)
        if name == "fused_attention_qkv_bwd":
            kern = lambda: fused_attention_qkv_bwd(qkv, do, heads=heads, head_dim=hd, scale=scale)
            got = kern().reshape(b, n, 3, heads, hd).unbind(2)
        else:
            kern = lambda: fused_attention_bwd(q, k, v, do4, scale=scale)
            got = kern()
        # the timed inputs, at the training path's shape, against the plain version
        for what, g, r in zip(("dq", "dk", "dv"), got, attention_bwd_plain(q, k, v, do4, scale=scale)):
            err = max_err(g, r)
            rel = err / max(float(r.float().abs().max()), 1e-30)
            check(rel <= TOL_BWD[dtype], f"{name} {what} {dtype} B={b} N={n}: max err {rel:.3g} of max|ref| "
                  f"> {TOL_BWD[dtype]:.3g}")
            worst[name] = max(worst[name], rel)
            worst_abs[name] = max(worst_abs[name], err)
        ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
        out = sdpa(ql, kl, vl, scale)
        lib = lambda: torch.autograd.grad(out, (ql, kl, vl), do4, retain_graph=True)
        t = dict(ms=cuda_ms(kern), plain_ms=cuda_ms(lambda: attention_bwd_plain(q, k, v, do4, scale=scale)),
                 library_ms=cuda_ms(lib),
                 # five N x N x D products per head; q, k, v, dO read, dq, dk, dv written
                 **bound(10 * n * n * hd * b * heads, 7 * b * n * heads * hd * qkv.element_size(), peak))
        say(f"[3b] {name} vs plain: max err {worst[name]:.3g} of max|ref|, {worst_abs[name]:.3g} absolute "
            f"(bf16/fp16/fp32, plus1 on/off, "
            f"N 14/474/1190 at D=64; D 16/24/128 at N=97; the timed inputs); {str(dtype)[6:]} B={b} H=12 N={n} D=64: kernel "
            f"{t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, SDPA backward {t['library_ms']:.4f} ms, "
            f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}) ({gpu})")
        rec[name] = dict(max_abs_err=worst_abs[name], **t)
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
    want = {"fused_log_mel": 4, "fused_attention": 36, "fused_attention_qkv": 12,
            "fused_attention_bwd": 0, "fused_attention_qkv_bwd": 0}
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


def phase_training(gpu: str, dev: torch.device) -> dict:
    """[6] the bench's training step at full width, through the port's own
    entry points (passt_tpu_torch.bench)."""
    from passt_tpu_torch import bench
    from passt_tpu_torch.ops import _build

    model, state, step, batch = bench.setup(dev)
    cfg = model.cfg
    check((cfg.embed_dim, cfg.depth, cfg.num_heads, cfg.num_classes) == (768, 12, 12, 527),
          f"not PaSST-S width: {cfg}")
    check(cfg.seq_len(train=True) == TRAIN_N, f"train sequence {cfg.seq_len(train=True)} != {TRAIN_N}")
    before = {k: v.clone() for k, v in state.params.items()}
    warmup, steps = 2, 10
    _build.reset_launches()
    state, ms, loss = bench.timed_steps(step, state, batch, steps, warmup)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)

    n = warmup + steps
    check(state.step == n, f"step counter {state.step} != {n}")
    check(bool(torch.isfinite(loss)), f"loss {float(loss)} not finite")
    still = {k for k, v in state.params.items() if torch.equal(before[k], v)}
    moved = len(before) - len(still)
    # every leaf in the forward moves; head_dist is in the checkpoint only,
    # so its gradient is 0 and weight decay alone (lr * wd * p, ~1e-12) can
    # only move its bf16 weight by a rare stochastic rounding
    check(still <= {"head_dist.weight", "head_dist.bias"}, f"parameter leaves that did not move: {sorted(still)}")
    per_step = {"fused_log_mel": 1, "fused_attention": 0, "fused_attention_qkv": 12,
                "fused_attention_bwd": 0, "fused_attention_qkv_bwd": 12}
    want = {k: v * n for k, v in per_step.items()}
    check(launches == want, f"training launches {launches} != {want} ({n} steps)")
    say(f"[6] training step PaSST-S bf16 B={TRAIN_B} N={TRAIN_N} (mixup, bf16 SR AdamW and params): "
        f"{ms:.3f} ms/step = {TRAIN_B * 1000.0 / ms:.2f} specs/s over {steps} steps after {warmup}; "
        f"mean loss {float(loss):.5f}; {moved}/{len(before)} leaves moved; launches {launches} ({gpu})")
    return launches


def phase_train_correctness(dev: torch.device) -> dict:
    """[7] one fp32 training step at full width with the kernels against the
    same step on the plain versions: same weights, same seeds, so the same
    draws."""
    from passt_tpu_torch import bench
    from passt_tpu_torch.models.passt import PaSSTConfig
    from passt_tpu_torch.ops import _build
    from passt_tpu_torch.ops.frontend import MelConfig
    from passt_tpu_torch.train.optim import GradientTransformation
    from passt_tpu_torch.train.steps import create_train_state, make_optimizer, make_schedule, make_train_step

    lr0 = make_schedule(lr=2e-5, steps_per_epoch=1000)(0)  # the rate of this first step
    runs = {}
    for name, attn_impl, stft_method in (("kernels", "fused", "auto"), ("plain", "xla", "matmul")):
        cfg = PaSSTConfig(dtype="float32", s_patchout_t=40, s_patchout_f=4, attn_impl=attn_impl)
        tx = make_optimizer(lr=2e-5, steps_per_epoch=1000)
        grads, updates = {}, {}

        def update(g, opt_state, params, tx=tx, grads=grads, updates=updates):
            grads.update(g)  # the step's gradients, on their way to the optimizer
            u, opt_state = tx.update(g, opt_state, params)
            updates.update(u)  # and the optimizer's updates, before the apply
            return u, opt_state

        recorder = GradientTransformation(tx.init, update)
        model, state = create_train_state(cfg, recorder, torch.Generator().manual_seed(0), device=dev)
        step = make_train_step(model, recorder,
                               MelConfig(fmin_aug_range=10, fmax_aug_range=2000, stft_method=stft_method))
        rng = np.random.default_rng(5)
        batch = {
            "wave": torch.from_numpy(rng.standard_normal((2, CLIP)).astype(np.float32) * 0.1).to(dev),
            "target": torch.from_numpy((rng.uniform(size=(2, 527)) < 0.05).astype(np.float32)).to(dev),
        }
        _build.reset_launches()
        new_state, metrics = step(state, batch, bench.SEED)
        torch.cuda.synchronize()
        runs[name] = dict(loss=float(metrics["loss"]), grads=grads, updates=updates, params=new_state.params,
                          launches=dict(_build.LAUNCHES))

    k, p = runs["kernels"], runs["plain"]
    want = {"fused_log_mel": 1, "fused_attention": 12, "fused_attention_qkv": 0,
            "fused_attention_bwd": 12, "fused_attention_qkv_bwd": 0}
    check(k["launches"] == want, f"fp32 step launches {k['launches']} != {want}")
    check(not any(p["launches"].values()), f"plain step launched kernels: {p['launches']}")
    loss_err = abs(k["loss"] - p["loss"])
    check(np.isfinite(k["loss"]) and loss_err <= TOL_STEP_LOSS,
          f"fp32 step loss {k['loss']} vs plain {p['loss']}")
    grad_err = max(max_err(k["grads"][n], g) / max(float(g.abs().max()), 1e-30)
                   for n, g in p["grads"].items() if float(g.abs().max()) > 0)
    check(grad_err <= TOL_STEP_GRAD, f"fp32 step gradients: max err {grad_err:.3g} of the leaf's max")
    # the updates, relative to this step's lr, where the gradients' sign is
    # sure (see TOL_STEP_UPDATE) and elsewhere; the parameters against them
    upd_sure = upd_rest = param_excess = 0.0
    n_sure = n_all = 0
    for n, g in p["grads"].items():
        sure = g.abs() > 10 * (k["grads"][n] - g).abs().max()
        du = (k["updates"][n] - p["updates"][n]).abs() / lr0
        if bool(sure.any()):
            upd_sure = max(upd_sure, float(du[sure].max()))
        if not bool(sure.all()):
            upd_rest = max(upd_rest, float(du[~sure].max()))
        n_sure, n_all = n_sure + int(sure.sum()), n_all + g.numel()
        new_k, new_p = k["params"][n], p["params"][n]
        top = torch.maximum(new_k.abs(), new_p.abs())
        ulp = torch.nextafter(top, torch.full_like(top, math.inf)) - top
        # (1 + 1e-6): the updates' fp32 difference may itself round
        param_excess = max(param_excess, float(((new_k - new_p).abs() - du * lr0 * (1 + 1e-6) - ulp).max()))
    check(upd_sure <= TOL_STEP_UPDATE, f"fp32 step updates where the gradient's sign is sure: max err "
          f"{upd_sure:.3g} lr > {TOL_STEP_UPDATE:g} lr")
    check(upd_rest < 2.0, f"fp32 step updates elsewhere: max err {upd_rest:.3g} lr >= 2 lr")
    check(param_excess <= 0.0, f"fp32 step parameters differ by {param_excess:.3g} more than their "
          f"updates' difference plus one ulp")
    say(f"[7] fp32 training step PaSST-S B=2 N={TRAIN_N}, kernels vs plain versions: loss "
        f"{k['loss']:.6f} vs {p['loss']:.6f} (err {loss_err:.3g}, tol {TOL_STEP_LOSS:g}); gradients "
        f"{len(p['grads'])} leaves, max err {grad_err:.3g} of the leaf's max (tol {TOL_STEP_GRAD:g}); "
        f"updates (lr {lr0:.4g}) max err {upd_sure:.3g} lr on the {n_sure}/{n_all} elements whose "
        f"gradient sign is sure (tol {TOL_STEP_UPDATE:g} lr), {upd_rest:.3g} lr on the rest (tol 2 lr); "
        f"updated parameters within the updates' difference plus one ulp; launches {k['launches']}")
    return k["launches"]


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
    rec.update(phase_backward(gpu, dev))
    runs = [phase_serving(gpu, dev)]
    phase_correctness(dev)
    runs.append(phase_training(gpu, dev))
    runs.append(phase_train_correctness(dev))
    launches = {name: sum(run.get(name, 0) for run in runs) for name in rec}

    sources = {
        "fused_log_mel": ("passt_tpu_torch/csrc/mel_kernel.cu", "passt_tpu/ops/pallas/mel_kernel.py:65"),
        "fused_attention": ("passt_tpu_torch/csrc/attention_fwd.cu", "passt_tpu/ops/pallas/attention.py:171"),
        "fused_attention_qkv": ("passt_tpu_torch/csrc/attention_fwd.cu", "passt_tpu/ops/pallas/attention.py:373"),
        "fused_attention_bwd": ("passt_tpu_torch/csrc/attention_bwd.cu", "passt_tpu/ops/pallas/attention.py:188"),
        "fused_attention_qkv_bwd": ("passt_tpu_torch/csrc/attention_bwd.cu",
                                    "passt_tpu/ops/pallas/attention.py:388"),
    }
    for name in sources:
        check(launches[name] > 0, f"{name} was launched no time on the main paths")
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
