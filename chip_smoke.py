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
   draws: the loss, every leaf's gradient and the updated parameters;
8. the bf16 training step of phase 6 under the JAX config's two LayerNorm
   variants, ``fuse_ln_qkv=True`` (the F1 and B2 kernels around the
   attention kernels) and ``ln_impl="fused"`` (the LayerNorm-backward
   kernel in all 25 norms), with phase 6's checks and exact launch counts;
9. one fp32 full-width step (B = 2) under each variant with its kernels
   against the default config's step on the plain versions, under phase
   7's tolerances (``fuse_ln_qkv`` at patchout 80/4, N = 154, where its
   fp32 gate holds), and an fp32 ``Predictor(fuse_ln_qkv=True)``'s
   timestamp embeddings (F1 at N = 14) against the plain default one;
10. the int8 PaSST-S MLP (``python3 -m passt_tpu_torch.tools.ab_int8_mlp``:
   fc1 768 -> 3072 with the fused GELU, fc2 3072 -> 768) against the bf16
   MLP at M = 5688 and 14280, forward and forward + backward, with exact
   launch counts and each int8 layer's quantization error within
   0.02 mean|exact| + 1e-3;
11. the int8 / bf16 matmul micro-benchmark (``python3 -m
   passt_tpu_torch.tools.int8_matmul_micro``) at the model's matmul shapes
   and 8192^3, its JSON block printed;
12. the fused-MLP A/B (``python3 -m passt_tpu_torch.tools.proto_mlp_fused``:
   the prototype's xla composition, fuse_f, fuse and fuse2) at M = 5688 and
   14280, with exact launch counts, the variants' errors against xla, and
   fuse_f's peak memory growth below one [M, 3072] bf16 tensor.

Phase 3c holds the LayerNorm-backward, F1 and B2 kernels against their
plain versions and times them at the training step's shapes. Phase 3d holds
the int8 GEMM kernel's three epilogues (int8_dense, int8_dense_gelu,
int8_matmul) against their plain versions (int32 outputs bit-equal) at the
int8 MLP's shapes (M = 5688 and 14280), ragged shapes and the
micro-benchmark's four shapes, and times them beside ``torch._int_mm`` and
the bf16 cuBLAS GEMM. Phase 3e holds the fused MLP's forward (residuals off
and on) and backward kernels against their plain versions in bf16 and fp32
at M = 5688 and 14280 (C = 768, H = 3072) and at ragged M with small C and
H, and times them beside the bare cuBLAS pair of the same products.

Launch counts: each main-path run (phases 4, 6, 8, 10, 11, 12 and the
kernel sides of 7 and 9) starts with every count at 0 and reads the counts
right after; the ``launches`` of the kernels' record (thirteen entries) sum
those runs. The comparisons of phases 3, 3b, 3c, 3d and 3e are outside them. A count
is of wrapper calls: phase 11 times with CUDA-graph replays, so its
int8_matmul count includes the calls captured into the graphs, and the
replays run the kernel more times than that without the wrapper.

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
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from passt_tpu_torch.tools.timing import cuda_ms, gpu_line, graph_ms  # noqa: E402

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
# LayerNorm backward kernel vs plain, max error relative to max|ref|: dx in
# fp32 differs by summation order only (the row means); in bf16 / fp16 it
# rounds once, and a summation-order change may move a value across a
# rounding boundary: one output ulp at the largest dx. dscale / dbias are
# fp32 sums over the M rows in another order (per-block partials).
TOL_LN_DX = {torch.float32: 1e-5, torch.bfloat16: 2.0**-7, torch.float16: 2.0**-10}
TOL_LN_SUMS = 1e-4
# F1 / B2 vs plain, relative to max|ref|: the products accumulate over K =
# C or 3C in another order; in bf16 / fp16 F1 rounds the sum, then adds the
# bias in the dtype (two roundings, one ulp each) and B2 rounds dx and xn
# once (a flipped xn rounding moves the statistics-free xn by one ulp); fp32
# keeps ~1e-6 of summation order, amplified by the LayerNorm backward's
# cancellation in dx
TOL_QKV = {torch.float32: 1e-4, torch.bfloat16: 2.0**-7, torch.float16: 2.0**-9}
# int8 GEMM kernel vs plain, max error relative to max|ref|: the dense and
# GELU epilogues repeat the plain version's fp32 roundings on the same exact
# int32 sums, so they differ at most where tanh does (fp32: an ulp), and in
# bf16 an fp32 ulp may flip the rounding; the bf16 product sums over K in
# another order than cuBLAS's fp32 product, so a value may round the other
# way: in bf16 one ulp of the largest value. int32 (and int32 -> bf16) must
# be bit-equal.
TOL_INT8 = {torch.float32: 1e-6, torch.bfloat16: 2.0**-7}
# fused MLP kernels vs plain, max error relative to max|ref|: the same fp32
# roundings in another summation order (and tanhf against torch's tanh, an
# fp32 ulp), so fp32 to 1e-5; in bf16 such an ulp may flip the rounding of
# y, g, d or dh: one bf16 ulp of the largest value, 2**-7; dx rounds twice
# (dh, then its own sum): 2**-6
TOL_MLP = {torch.float32: 1e-5, torch.bfloat16: 2.0**-7}
TOL_MLP_DX = {torch.float32: 1e-5, torch.bfloat16: 2.0**-6}
# [12] the fused variants against the prototype's xla composition, which
# rounds h to bf16 before the GELU: a few bf16 ulps of y (forward, relative
# to max|y|) and of each gradient (relative to its max)
TOL_PROTO_MLP = 2.0**-5
# peak rates of one H100 SXM (dense, 700 W) for the bounds
PEAK_BF16, PEAK_INT8, PEAK_FP32, HBM_BYTES_PER_S = 989e12, 1979e12, 67e12, 3.35e12
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


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Max error relative to max|ref|."""
    return max_err(got, ref) / max(float(ref.float().abs().max()), 1e-30)


def phase_layernorm(gpu: str, dev: torch.device) -> dict:
    """[3c] the LayerNorm-backward, F1 and B2 kernels against their plain
    versions, then their times at the training step's shapes."""
    from passt_tpu_torch.ops.layernorm import layer_norm_bwd, layer_norm_bwd_plain, ln_forward
    from passt_tpu_torch.ops.ln_qkv import ln_qkv_b2, ln_qkv_b2_plain, ln_qkv_f1, ln_qkv_f1_plain

    rng = np.random.default_rng(4)
    c0 = 768

    def arr(shape, scale=1.0, offset=0.0, dtype=torch.float32):
        return (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) * scale + offset).to(dev, dtype)

    worst = {"layer_norm_bwd": 0.0, "ln_qkv_f1": 0.0, "ln_qkv_b2": 0.0}  # of max|ref|
    worst_abs = dict(worst)

    def hold(name, what, got, ref, tol):
        check(got.dtype == ref.dtype and got.shape == ref.shape and bool(torch.isfinite(got).all()),
              f"{name} {what}: dtype/shape/finite")
        rel = rel_err(got, ref)
        check(rel <= tol, f"{name} {what}: max err {rel:.3g} of max|ref| > {tol:.3g}")
        worst[name] = max(worst[name], rel)
        worst_abs[name] = max(worst_abs[name], max_err(got, ref))

    def ln_case(m, c, dtype):
        x = arr((m, c), dtype=dtype)
        dy = arr((m, c))
        scale, bias = arr((c,), 0.1, 1.0), arr((c,), 0.1)
        _, mu, rstd = ln_forward(x, scale, bias, 1e-6)
        return x, dy, mu, rstd, scale

    # the LayerNorm backward: the training step's rows (bf16 x with f32 dy,
    # and f32 x), ragged M, other C
    for m, c, dtype in ((TRAIN_B * TRAIN_N, c0, torch.bfloat16), (TRAIN_B * TRAIN_N, c0, torch.float32),
                        (1000, 64, torch.bfloat16), (77, 384, torch.float32), (333, 8, torch.float16),
                        (41, 1024, torch.float32)):
        args = ln_case(m, c, dtype)
        got, ref = layer_norm_bwd(*args), layer_norm_bwd_plain(*args)
        torch.cuda.synchronize()
        for what, g, r in zip(("dx", "dscale", "dbias"), got, ref):
            tol = TOL_LN_DX[dtype] if what == "dx" else TOL_LN_SUMS
            hold("layer_norm_bwd", f"{what} {str(dtype)[6:]} M={m} C={c}", g, r, tol)

    # F1 and B2: bf16 at the training step's and the timestamp windows'
    # shapes, fp32 at the fp32 step's (patchout 80/4: N = 154), fp16 small
    def qkv_case(b, n, dtype, c=c0):
        x = arr((b, n, c), dtype=dtype)
        s, bb = arr((c,), 0.1, 1.0), arr((c,), 0.1)
        w, wb = arr((3 * c, c), 0.02, dtype=dtype), arr((3 * c,), 0.02, dtype=dtype)
        return x, s, bb, w, wb

    f1_cases = ((TRAIN_B, TRAIN_N, torch.bfloat16), (256, 14, torch.bfloat16), (2, 154, torch.float32),
                (3, 47, torch.float16))
    for b, n, dtype in f1_cases:
        x, s, bb, w, wb = qkv_case(b, n, dtype)
        got, ref = ln_qkv_f1(x, s, bb, w, wb), ln_qkv_f1_plain(x, s, bb, w, wb)
        torch.cuda.synchronize()
        hold("ln_qkv_f1", f"{str(dtype)[6:]} B={b} N={n}", got, ref, TOL_QKV[dtype])
        if (b, n) != (TRAIN_B, TRAIN_N):
            continue
        dqkv = arr((b, n, 3 * c0), dtype=dtype)
        got, ref = ln_qkv_b2(x, dqkv, w, s, bb), ln_qkv_b2_plain(x, dqkv, w, s, bb)
        torch.cuda.synchronize()
        for what, g, r in zip(("dx", "xn", "dscale", "dbias"), got, ref):
            hold("ln_qkv_b2", f"{what} {str(dtype)[6:]} B={b} N={n}", g, r,
                 TOL_QKV[dtype] if what in ("dx", "xn") else TOL_LN_SUMS)
    # B2 at the fp32 step's shape; both kernels at other widths (C not a
    # multiple of 128 takes F1's 64 x 64 tiles; B2's warps hold C / 32 n8
    # tiles), ragged in the rows
    for b, n, dtype, c in ((2, 154, torch.float32, c0), (3, 47, torch.float16, c0), (2, 47, torch.bfloat16, 192),
                           (2, 33, torch.bfloat16, 1024), (2, 20, torch.float16, 320), (1, 9, torch.float32, 64)):
        x, s, bb, w, wb = qkv_case(b, n, dtype, c)
        if c != c0:
            got, ref = ln_qkv_f1(x, s, bb, w, wb), ln_qkv_f1_plain(x, s, bb, w, wb)
            torch.cuda.synchronize()
            hold("ln_qkv_f1", f"{str(dtype)[6:]} B={b} N={n} C={c}", got, ref, TOL_QKV[dtype])
        dqkv = arr((b, n, 3 * c), dtype=dtype)
        got, ref = ln_qkv_b2(x, dqkv, w, s, bb), ln_qkv_b2_plain(x, dqkv, w, s, bb)
        torch.cuda.synchronize()
        for what, g, r in zip(("dx", "xn", "dscale", "dbias"), got, ref):
            hold("ln_qkv_b2", f"{what} {str(dtype)[6:]} B={b} N={n} C={c}", g, r,
                 TOL_QKV[dtype] if what in ("dx", "xn") else TOL_LN_SUMS)

    rec = {}
    # times: CUDA-graph replays (graph_ms), so the wrappers' host work (a
    # ctypes launch, allocations, the partials' sum) does not hide the
    # device time of these short calls.
    # the LayerNorm backward at the training step's rows, bf16 x, f32 dy;
    # the library yardstick is ATen's LayerNorm backward on the same x and
    # statistics (it takes dy and the weight in x's dtype)
    m = TRAIN_B * TRAIN_N
    x, dy, mu, rstd, scale = ln_case(m, c0, torch.bfloat16)
    dy_x, w_x, b_x = dy.to(x.dtype), scale.to(x.dtype), torch.zeros_like(scale, dtype=x.dtype)
    lib = lambda: torch.ops.aten.native_layer_norm_backward(dy_x, x, [c0], mu, rstd, w_x, b_x,
                                                            [True, True, True])
    t = dict(ms=graph_ms(lambda: layer_norm_bwd(x, dy, mu, rstd, scale)),
             plain_ms=graph_ms(lambda: layer_norm_bwd_plain(x, dy, mu, rstd, scale)),
             library_ms=graph_ms(lib),
             # ~10 FLOP an element; x (bf16) and dy (f32) read, dx (bf16) written
             **bound(10 * m * c0, m * c0 * (2 + 4 + 2), PEAK_FP32))
    say(f"[3c] layer_norm_bwd vs plain: max err {worst['layer_norm_bwd']:.3g} of max|ref| (dx, dscale, "
        f"dbias; bf16/fp32/fp16 x, M 5688/1000/77/333/41, C 768/64/384/8/1024); bf16 M={m} C={c0}: "
        f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, ATen LN backward {t['library_ms']:.4f} ms, "
        f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}) ({gpu})")
    rec["layer_norm_bwd"] = dict(max_abs_err=worst_abs["layer_norm_bwd"], **t)

    # F1 and B2: no single library call computes either; beside them, the
    # bare cuBLAS product of the same shape
    for name, b, n, dtype in (("ln_qkv_f1", TRAIN_B, TRAIN_N, torch.bfloat16),
                              ("ln_qkv_f1", 256, 14, torch.bfloat16),
                              ("ln_qkv_f1", 2, 154, torch.float32),
                              ("ln_qkv_b2", TRAIN_B, TRAIN_N, torch.bfloat16),
                              ("ln_qkv_b2", 2, 154, torch.float32)):
        x, s, bb, w, wb = qkv_case(b, n, dtype)
        mrows, esize = b * n, x.element_size()
        peak = PEAK_FP32 if dtype == torch.float32 else PEAK_BF16
        if name == "ln_qkv_f1":
            kern = lambda: ln_qkv_f1(x, s, bb, w, wb)
            plain = lambda: ln_qkv_f1_plain(x, s, bb, w, wb)
            gemm = lambda: torch.matmul(x, w.t())
            nbytes = (mrows * c0 + 3 * c0 * c0 + 3 * c0 + mrows * 3 * c0) * esize + 2 * c0 * 4
        else:
            dqkv = arr((b, n, 3 * c0), dtype=dtype)
            kern = lambda: ln_qkv_b2(x, dqkv, w, s, bb)
            plain = lambda: ln_qkv_b2_plain(x, dqkv, w, s, bb)
            gemm = lambda: torch.matmul(dqkv, w)
            # x, dqkv, W read; dx, xn written; s, b read and dscale, dbias written in fp32
            nbytes = (mrows * c0 * 3 + mrows * 3 * c0 + 3 * c0 * c0) * esize + 4 * c0 * 4
        t = dict(ms=graph_ms(kern), plain_ms=graph_ms(plain), library_ms=None,
                 **bound(2 * mrows * c0 * 3 * c0, nbytes, peak))
        gemm_ms = graph_ms(gemm)
        say(f"[3c] {name} vs plain: max err {worst[name]:.3g} of max|ref| (bf16/fp32/fp16; C 768/192/1024/"
            f"320/64; the shapes below); {str(dtype)[6:]} B={b} N={n} "
            f"C={c0}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, no single library call "
            f"(the bare cuBLAS product of the same shape {gemm_ms:.4f} ms), bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}) ({gpu})")
        if name not in rec:  # the record keeps the training step's shape
            rec[name] = dict(max_abs_err=worst_abs[name], **t)
    return rec


def phase_int8(gpu: str, dev: torch.device) -> dict:
    """[3d] the int8 GEMM kernel's three epilogues against their plain
    versions, then their times at the int8 MLP's and the micro-benchmark's
    shapes."""
    from passt_tpu_torch.ops.int8 import (
        int8_dense_forward,
        int8_dense_plain,
        int8_matmul,
        int8_matmul_plain,
        quantize_rows,
        quantized_dense,
        quantized_dense_plain,
    )
    from passt_tpu_torch.tools.int8_matmul_micro import SHAPES

    gen = torch.Generator(device=dev).manual_seed(8)
    m0 = TRAIN_B * TRAIN_N
    worst = {"int8_dense": 0.0, "int8_dense_gelu": 0.0, "int8_matmul": 0.0}  # absolute

    def hold(name, what, got, ref, tol):
        check(got.dtype == ref.dtype and got.shape == ref.shape and bool(torch.isfinite(got.float()).all()),
              f"{name} {what}: dtype/shape/finite")
        if tol == 0:
            check(torch.equal(got, ref), f"{name} {what}: not bit-equal (max err {max_err(got, ref):.3g})")
        else:
            check(rel_err(got, ref) <= tol, f"{name} {what}: max err {rel_err(got, ref):.3g} of max|ref| > {tol:.3g}")
        worst[name] = max(worst[name], max_err(got, ref))

    # the dense epilogues: fc1 (GELU) and fc2 of the int8 MLP at the training
    # token count (bf16 and fp32) and the eval count (bf16, as phase [10]
    # runs it: 14280 = 111 x 128 + 72 rows), ragged M, K and N; a zero row of
    # x and a zero weight column
    m_eval = TRAIN_B * 1190
    exact = []
    for m, k, n, dtypes in ((m0, 768, 3072, (torch.bfloat16, torch.float32)),
                            (m0, 3072, 768, (torch.bfloat16, torch.float32)),
                            (m_eval, 768, 3072, (torch.bfloat16,)), (m_eval, 3072, 768, (torch.bfloat16,)),
                            (130, 40, 96, (torch.bfloat16, torch.float32)),
                            (130, 64, 96, (torch.bfloat16, torch.float32))):
        for dtype in dtypes:
            x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
            w = (torch.randn((k, n), generator=gen, device=dev) * 0.02).to(dtype)
            b = torch.randn(n, generator=gen, device=dev) * 0.01
            x[3], w[:, 5] = 0, 0
            for gelu in ((True, False) if k != 3072 else (False,)):
                got, ref = int8_dense_forward(x, w, b, gelu), int8_dense_plain(x, w, b, gelu)
                torch.cuda.synchronize()
                what = f"{str(dtype)[6:]} {m}x{k}->{n}"
                if gelu:
                    hold("int8_dense_gelu", f"h {what}", got[0], ref[0], TOL_INT8[dtype])
                    hold("int8_dense_gelu", f"d {what}", got[1], ref[1], TOL_INT8[dtype])
                    exact.append(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]))
                else:
                    hold("int8_dense", what, got, ref, TOL_INT8[dtype])
                    exact.append(torch.equal(got, ref))
    # the RAW epilogue: the micro-benchmark's four shapes and a ragged one;
    # rows and columns of 127s push the int32 sums past 2**24
    for m, k, n in (*SHAPES.values(), (130, 40, 96)):
        a = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
        bt = torch.randint(-127, 128, (n, k), generator=gen, device=dev, dtype=torch.int8)
        a[0], bt[0] = 127, 127
        for out in (torch.int32, torch.bfloat16):
            hold("int8_matmul", f"int8 -> {str(out)[6:]} {m}x{k}x{n}", int8_matmul(a, bt.t(), out),
                 int8_matmul_plain(a, bt.t(), out), 0)
        af = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        bf = torch.randn((n, k), generator=gen, device=dev).to(torch.bfloat16)
        hold("int8_matmul", f"bf16 {m}x{k}x{n}", int8_matmul(af, bf.t(), torch.bfloat16),
             int8_matmul_plain(af, bf.t(), torch.bfloat16), TOL_INT8[torch.bfloat16])
    say(f"[3d] int8 GEMM vs plain: dense/GELU (bf16, fp32; {m0}x768->3072, {m0}x3072->768, 130x40/64->96; bf16 "
        f"{m_eval}x768->3072, {m_eval}x3072->768; a zero row and column) max err {worst['int8_dense']:.3g} / {worst['int8_dense_gelu']:.3g}, bit-equal in "
        f"{sum(exact)}/{len(exact)} cases; int8 -> int32 and -> bf16 bit-equal at {', '.join(SHAPES)} and "
        f"130x40x96; bf16 -> bf16 within {TOL_INT8[torch.bfloat16]:g} of max|ref|")

    rec = {}
    # the dense epilogues on quantized operands (the kernel's function), bf16
    # out; CUDA-graph replays, the events time beside them
    for name, k, n, gelu in (("int8_dense_gelu", 768, 3072, True), ("int8_dense", 3072, 768, False)):
        x = torch.randn((m0, k), generator=gen, device=dev).to(torch.bfloat16)
        w = (torch.randn((k, n), generator=gen, device=dev) * 0.02).to(torch.bfloat16)
        b = torch.zeros(n, device=dev)
        qx, sx = quantize_rows(x)
        qwt, sw = quantize_rows(w.t())
        qwt = qwt.contiguous()
        kern = lambda: quantized_dense(qx, sx, qwt, sw, b, out_dtype=torch.bfloat16, gelu=gelu)
        plain = lambda: quantized_dense_plain(qx, sx, qwt, sw, b, out_dtype=torch.bfloat16, gelu=gelu)
        # qx, qwt read; sx, sw, b read in fp32; y (or h and d) written in bf16
        nbytes = m0 * k + n * k + 4 * (m0 + 2 * n) + (2 if gelu else 1) * m0 * n * 2
        t = dict(ms=graph_ms(kern), plain_ms=graph_ms(plain), library_ms=None,
                 **bound(2 * m0 * k * n, nbytes, PEAK_INT8))
        events, int_mm = cuda_ms(kern), graph_ms(lambda: torch._int_mm(qx, qwt.t()))
        bf16_mm = graph_ms(lambda: torch.matmul(x, w))
        say(f"[3d] {name} bf16 {m0}x{k}->{n}: kernel {t['ms']:.4f} ms (graph; {events:.4f} ms under events), "
            f"plain {t['plain_ms']:.4f} ms, no single library call (the bare torch._int_mm product {int_mm:.4f} ms, "
            f"the bf16 cuBLAS GEMM {bf16_mm:.4f} ms), bound {t['bound_ms']:.4f} ms ({t['bound_by']}) ({gpu})")
        rec[name] = dict(max_abs_err=worst[name], **t)

    # the RAW epilogue at 8192^3, int8 -> int32, beside torch._int_mm
    m, k, n = SHAPES["square_8192"]
    a = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
    bt = torch.randint(-127, 128, (n, k), generator=gen, device=dev, dtype=torch.int8)
    t = dict(ms=cuda_ms(lambda: int8_matmul(a, bt.t(), torch.int32), reps=5),
             plain_ms=cuda_ms(lambda: int8_matmul_plain(a, bt.t(), torch.int32), reps=5),
             library_ms=cuda_ms(lambda: torch._int_mm(a, bt.t()), reps=5),
             **bound(2 * m * k * n, m * k + n * k + 4 * m * n, PEAK_INT8))
    say(f"[3d] int8_matmul int8 -> int32 {m}x{k}x{n}: kernel {t['ms']:.4f} ms = {2 * m * k * n / t['ms'] / 1e9:.1f} TOP/s, "
        f"plain (float64) {t['plain_ms']:.4f} ms, torch._int_mm {t['library_ms']:.4f} ms, bound {t['bound_ms']:.4f} "
        f"ms ({t['bound_by']}) ({gpu})")
    rec["int8_matmul"] = dict(max_abs_err=worst["int8_matmul"], **t)
    return rec


def phase_fused_mlp(gpu: str, dev: torch.device) -> dict:
    """[3e] the fused MLP's forward (with and without residuals) and backward
    kernels against their plain versions, then their times at the A/B's
    shapes beside the bare cuBLAS pair of products."""
    from passt_tpu_torch.ops.fused_mlp import (
        fused_mlp_bwd,
        fused_mlp_bwd_plain,
        fused_mlp_fwd,
        fused_mlp_fwd_plain,
        row_block,
    )

    gen = torch.Generator(device=dev).manual_seed(12)
    m0, m_eval = TRAIN_B * TRAIN_N, TRAIN_B * 1190
    worst = {"fused_mlp_fwd": 0.0, "fused_mlp_bwd": 0.0}  # of max|ref|
    worst_abs = dict(worst)

    def hold(name, what, got, ref, tol):
        check(got.dtype == ref.dtype and got.shape == ref.shape and bool(torch.isfinite(got.float()).all()),
              f"{name} {what}: dtype/shape/finite")
        rel = rel_err(got, ref)
        check(rel <= tol, f"{name} {what}: max err {rel:.3g} of max|ref| > {tol:.3g}")
        worst[name] = max(worst[name], rel)
        worst_abs[name] = max(worst_abs[name], max_err(got, ref))

    def randn(shape, scale, dtype):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def case(m, c, h, dtype):
        """x (a zero row), w1, b1, w2, b2 as the A/B draws them, with small
        non-zero biases."""
        x = randn((m, c), 1.0, dtype)
        x[3] = 0
        return x, randn((c, h), 0.02, dtype), randn((h,), 0.1, dtype), randn((h, c), 0.02, dtype), \
            randn((c,), 0.1, dtype)

    # the A/B's token counts at PaSST-S width (bf16 and fp32), ragged M with
    # small C and H; residuals off and on; the backward on each case's d
    cases = [(m0, 768, 3072, torch.bfloat16), (m0, 768, 3072, torch.float32), (m_eval, 768, 3072, torch.bfloat16),
             (m_eval, 768, 3072, torch.float32), (130, 64, 256, torch.bfloat16), (130, 64, 256, torch.float32),
             (77, 192, 128, torch.bfloat16), (77, 192, 128, torch.float32)]
    for m, c, h, dtype in cases:
        args = case(m, c, h, dtype)
        what = f"{str(dtype)[6:]} M={m} C={c} H={h}"
        ref = fused_mlp_fwd_plain(*args, residuals=True)
        got = fused_mlp_fwd(*args, residuals=True)
        y_only = fused_mlp_fwd(*args, residuals=False)
        torch.cuda.synchronize()
        for part, g, r in zip(("y", "g", "d"), got, ref):
            hold("fused_mlp_fwd", f"{part} {what}", g, r, TOL_MLP[dtype])
        check(torch.equal(y_only, got[0]), f"fused_mlp_fwd {what}: y without residuals != y with them")
        dy = randn((m, c), 1.0, dtype)
        got = fused_mlp_bwd(dy, ref[2], args[1], args[3])
        want = fused_mlp_bwd_plain(dy, ref[2], args[1], args[3])
        torch.cuda.synchronize()
        hold("fused_mlp_bwd", f"dx {what}", got[0], want[0], TOL_MLP_DX[dtype])
        hold("fused_mlp_bwd", f"dh {what}", got[1], want[1], TOL_MLP[dtype])
    say(f"[3e] fused MLP vs plain (bf16, fp32; M {m0}/{m_eval} at 768/3072, M 130 at 64/256, M 77 at 192/128; "
        f"a zero row; residuals off and on): forward max err {worst['fused_mlp_fwd']:.3g}, backward "
        f"{worst['fused_mlp_bwd']:.3g} of max|ref|; y bit-equal with and without residuals")

    rec = {}
    # times by CUDA-graph replay; beside them the bare cuBLAS pair of the
    # same products (no single library call computes either function)
    c, h = 768, 3072
    for m in (m0, m_eval):
        x, w1, b1, w2, b2 = case(m, c, h, torch.bfloat16)
        gh = randn((m, h), 1.0, torch.bfloat16)
        dy, d = randn((m, c), 1.0, torch.bfloat16), randn((m, h), 1.0, torch.bfloat16)
        flops, wbytes = 4 * m * c * h, (2 * c * h + h + c) * 2
        fwd = dict(ms=graph_ms(lambda: fused_mlp_fwd(x, w1, b1, w2, b2, residuals=False)),
                   plain_ms=graph_ms(lambda: fused_mlp_fwd_plain(x, w1, b1, w2, b2, residuals=False)),
                   library_ms=None, **bound(flops, wbytes + 2 * m * c * 2, PEAK_BF16))
        res_ms = graph_ms(lambda: fused_mlp_fwd(x, w1, b1, w2, b2, residuals=True))
        pair_f = graph_ms(lambda: (torch.matmul(x, w1), torch.matmul(gh, w2)))
        bwd = dict(ms=graph_ms(lambda: fused_mlp_bwd(dy, d, w1, w2)),
                   plain_ms=graph_ms(lambda: fused_mlp_bwd_plain(dy, d, w1, w2)),
                   library_ms=None, **bound(flops, 2 * c * h * 2 + 2 * m * (c + h) * 2, PEAK_BF16))
        pair_b = graph_ms(lambda: (torch.matmul(dy, w2.t()), torch.matmul(gh, w1.t())))
        say(f"[3e] fused_mlp_fwd bf16 M={m} C={c} H={h} (row block {row_block(m)}): kernel {fwd['ms']:.4f} ms "
            f"({res_ms:.4f} with residuals), plain {fwd['plain_ms']:.4f} ms, no single library call (the bare "
            f"cuBLAS pair x.W1, g.W2 {pair_f:.4f} ms), bound {fwd['bound_ms']:.4f} ms ({fwd['bound_by']}) ({gpu})")
        say(f"[3e] fused_mlp_bwd bf16 M={m} C={c} H={h}: kernel {bwd['ms']:.4f} ms, plain {bwd['plain_ms']:.4f} ms, "
            f"no single library call (the bare cuBLAS pair dy.W2^T, dh.W1^T {pair_b:.4f} ms), bound "
            f"{bwd['bound_ms']:.4f} ms ({bwd['bound_by']}) ({gpu})")
        if m == m0:  # the record keeps the training token count
            rec["fused_mlp_fwd"] = dict(max_abs_err=worst_abs["fused_mlp_fwd"], **fwd)
            rec["fused_mlp_bwd"] = dict(max_abs_err=worst_abs["fused_mlp_bwd"], **bwd)
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
    want = want_launches(fused_log_mel=4, fused_attention=36, fused_attention_qkv=12)
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


#: every kernel wrapper's count; a main path's want lists the ones it launches
KERNEL_NAMES = ("fused_log_mel", "fused_attention", "fused_attention_qkv", "fused_attention_bwd",
                "fused_attention_qkv_bwd", "layer_norm_bwd", "ln_qkv_f1", "ln_qkv_b2", "int8_dense",
                "int8_dense_gelu", "int8_matmul", "fused_mlp_fwd", "fused_mlp_bwd")


def want_launches(**counts) -> dict:
    """The exact launch counts of a run: the named ones, 0 for the rest."""
    return {name: counts.get(name, 0) for name in KERNEL_NAMES}


#: the bench step's launches per step, by the model overrides of each variant
STEP_LAUNCHES = {
    "default": want_launches(fused_log_mel=1, fused_attention_qkv=12, fused_attention_qkv_bwd=12),
    "fuse_ln_qkv": want_launches(fused_log_mel=1, ln_qkv_f1=12, fused_attention_qkv=12,
                                 fused_attention_qkv_bwd=12, ln_qkv_b2=12),
    "ln_impl=fused": want_launches(fused_log_mel=1, fused_attention_qkv=12, fused_attention_qkv_bwd=12,
                                   layer_norm_bwd=25),
}
VARIANTS = {"default": {}, "fuse_ln_qkv": dict(fuse_ln_qkv=True), "ln_impl=fused": dict(ln_impl="fused")}


def train_steps(gpu: str, dev: torch.device, variant: str) -> dict:
    """The bench's bf16 training step at full width under one variant of
    its model config, through the port's own entry points
    (passt_tpu_torch.bench): 2 warm-up and 10 timed steps."""
    from passt_tpu_torch import bench
    from passt_tpu_torch.ops import _build

    model, state, step, batch = bench.setup(dev, **VARIANTS[variant])
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
    check(state.step == n, f"{variant}: step counter {state.step} != {n}")
    check(bool(torch.isfinite(loss)), f"{variant}: loss {float(loss)} not finite")
    still = {k for k, v in state.params.items() if torch.equal(before[k], v)}
    moved = len(before) - len(still)
    # every leaf in the forward moves; head_dist is in the checkpoint only,
    # so its gradient is 0 and weight decay alone (lr * wd * p, ~1e-12) can
    # only move its bf16 weight by a rare stochastic rounding
    check(still <= {"head_dist.weight", "head_dist.bias"},
          f"{variant}: parameter leaves that did not move: {sorted(still)}")
    want = {k: v * n for k, v in STEP_LAUNCHES[variant].items()}
    check(launches == want, f"{variant}: training launches {launches} != {want} ({n} steps)")
    phase = "[6]" if variant == "default" else "[8]"
    say(f"{phase} training step PaSST-S bf16 B={TRAIN_B} N={TRAIN_N} ({variant}; mixup, bf16 SR AdamW and "
        f"params): {ms:.3f} ms/step = {TRAIN_B * 1000.0 / ms:.2f} specs/s over {steps} steps after {warmup}; "
        f"mean loss {float(loss):.5f}; {moved}/{len(before)} leaves moved; launches per step "
        f"{ {k: v // n for k, v in launches.items() if v} } ({gpu})")
    return launches


def fp32_step(dev: torch.device, cfg_kwargs: dict, stft_method: str) -> dict:
    """One fp32 training step at full width (B = 2) from seed-0 weights and
    the bench's seed, recording the gradients and the optimizer's updates;
    returns the loss, gradients, updates, new parameters and launches."""
    from passt_tpu_torch import bench
    from passt_tpu_torch.models.passt import PaSSTConfig
    from passt_tpu_torch.ops import _build
    from passt_tpu_torch.ops.frontend import MelConfig
    from passt_tpu_torch.train.optim import GradientTransformation
    from passt_tpu_torch.train.steps import create_train_state, make_optimizer, make_train_step

    cfg = PaSSTConfig(dtype="float32", **cfg_kwargs)
    tx = make_optimizer(lr=2e-5, steps_per_epoch=1000)
    grads, updates = {}, {}

    def update(g, opt_state, params):
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
    return dict(loss=float(metrics["loss"]), grads=grads, updates=updates, params=new_state.params,
                launches=dict(_build.LAUNCHES), n=cfg.seq_len(train=True))


def hold_fp32_step(k: dict, p: dict, what: str) -> str:
    """Hold a kernel step against a plain one (see TOL_STEP_*); returns the
    summary."""
    from passt_tpu_torch.train.steps import make_schedule

    lr0 = make_schedule(lr=2e-5, steps_per_epoch=1000)(0)  # the rate of this first step
    check(not any(p["launches"].values()), f"{what}: plain step launched kernels: {p['launches']}")
    loss_err = abs(k["loss"] - p["loss"])
    check(np.isfinite(k["loss"]) and loss_err <= TOL_STEP_LOSS, f"{what}: loss {k['loss']} vs plain {p['loss']}")
    grad_err = max(max_err(k["grads"][n], g) / max(float(g.abs().max()), 1e-30)
                   for n, g in p["grads"].items() if float(g.abs().max()) > 0)
    check(grad_err <= TOL_STEP_GRAD, f"{what}: gradients: max err {grad_err:.3g} of the leaf's max")
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
    check(upd_sure <= TOL_STEP_UPDATE, f"{what}: updates where the gradient's sign is sure: max err "
          f"{upd_sure:.3g} lr > {TOL_STEP_UPDATE:g} lr")
    check(upd_rest < 2.0, f"{what}: updates elsewhere: max err {upd_rest:.3g} lr >= 2 lr")
    check(param_excess <= 0.0, f"{what}: parameters differ by {param_excess:.3g} more than their "
          f"updates' difference plus one ulp")
    return (f"loss {k['loss']:.6f} vs {p['loss']:.6f} (err {loss_err:.3g}, tol {TOL_STEP_LOSS:g}); gradients "
            f"{len(p['grads'])} leaves, max err {grad_err:.3g} of the leaf's max (tol {TOL_STEP_GRAD:g}); "
            f"updates (lr {lr0:.4g}) max err {upd_sure:.3g} lr on the {n_sure}/{n_all} elements whose "
            f"gradient sign is sure (tol {TOL_STEP_UPDATE:g} lr), {upd_rest:.3g} lr on the rest (tol 2 lr); "
            f"updated parameters within the updates' difference plus one ulp; launches "
            f"{ {n: v for n, v in k['launches'].items() if v} }")


def phase_train_correctness(dev: torch.device) -> dict:
    """[7] one fp32 training step at full width with the kernels against the
    same step on the plain versions: same weights, same seeds, so the same
    draws."""
    patchout = dict(s_patchout_t=40, s_patchout_f=4)
    k = fp32_step(dev, dict(attn_impl="fused", **patchout), "auto")
    p = fp32_step(dev, dict(attn_impl="xla", **patchout), "matmul")
    want = want_launches(fused_log_mel=1, fused_attention=12, fused_attention_bwd=12)
    check(k["launches"] == want, f"fp32 step launches {k['launches']} != {want}")
    say(f"[7] fp32 training step PaSST-S B=2 N={TRAIN_N}, kernels vs plain versions: {hold_fp32_step(k, p, '[7]')}")
    return k["launches"]


def phase_variant_correctness(dev: torch.device) -> list:
    """[9] one fp32 training step at full width (B = 2) under each variant
    with its kernels against the default config's step on the plain
    versions, from the same weights and draws; and an fp32 Predictor under
    fuse_ln_qkv (F1 at N = 14 in its timestamp windows) against the plain
    default one. fuse_ln_qkv runs at patchout 80/4 (N = 154), where the F1
    and B2 gate holds in fp32; at N = 474 it does not."""
    from passt_tpu_torch.hear import Predictor
    from passt_tpu_torch.ops import _build

    runs = []
    cases = (("fuse_ln_qkv", dict(s_patchout_t=80, s_patchout_f=4), 154,
              want_launches(fused_log_mel=1, ln_qkv_f1=12, fused_attention_qkv=12, fused_attention_qkv_bwd=12,
                            ln_qkv_b2=12)),
             ("ln_impl=fused", dict(s_patchout_t=40, s_patchout_f=4), TRAIN_N,
              want_launches(fused_log_mel=1, fused_attention=12, fused_attention_bwd=12, layer_norm_bwd=25)))
    for variant, patchout, n, want in cases:
        k = fp32_step(dev, dict(attn_impl="fused", **patchout, **VARIANTS[variant]), "auto")
        p = fp32_step(dev, dict(attn_impl="xla", **patchout), "matmul")
        check(k["n"] == n, f"{variant}: sequence {k['n']} != {n}")
        check(k["launches"] == want, f"[9] {variant} fp32 step launches {k['launches']} != {want}")
        say(f"[9] fp32 training step PaSST-S B=2 N={n} under {variant}, kernels vs the default config on "
            f"plain versions: {hold_fp32_step(k, p, f'[9] {variant}')}")
        runs.append(k["launches"])

    kern = Predictor.create(arch=ARCH, dtype="float32", device=dev, fuse_ln_qkv=True,
                            generator=torch.Generator().manual_seed(0))
    plain = Predictor.create(arch=ARCH, dtype="float32", device=dev, attn_impl="xla",
                             mel_cfg=dataclasses.replace(kern.mel_cfg, stft_method="matmul"))
    plain.model.load_state_dict(kern.model.state_dict())
    wave = torch.from_numpy(np.random.default_rng(6).standard_normal((1, 64000)).astype(np.float32) * 0.1).to(dev)
    _build.reset_launches()
    ek, tk = kern.timestamp_embeddings(wave)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    ep, tp = plain.timestamp_embeddings(wave)
    want = want_launches(fused_log_mel=1, ln_qkv_f1=12, fused_attention_qkv=12)
    check(launches == want, f"[9] fuse_ln_qkv Predictor launches {launches} != {want}")
    err = max_err(ek, ep)
    # fp32 on both sides, as [5]: summation order, carried through 12 blocks
    check(torch.equal(tk, tp) and err < 5e-3, f"[9] fuse_ln_qkv timestamp embeddings: err {err:.3g}")
    say(f"[9] fp32 Predictor(fuse_ln_qkv=True) timestamp embeddings [1, 40, 1295] (B=256 windows, N=14) vs the "
        f"plain default: max err {err:.3g} (tol 5e-3); launches { {k: v for k, v in launches.items() if v} }")
    runs.append(launches)
    return runs


def phase_int8_mlp(gpu: str, dev: torch.device) -> dict:
    """[10] the int8 PaSST-S MLP against the bf16 one (tools/ab_int8_mlp) at
    M = 5688 and 14280, with exact launch counts and each int8 layer's
    quantization error within tests/test_int8_dense.py's limit."""
    from passt_tpu_torch.ops import _build
    from passt_tpu_torch.tools import ab_int8_mlp

    _build.reset_launches()
    results = ab_int8_mlp.run(dev)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    check([r["M"] for r in results] == [TRAIN_B * TRAIN_N, TRAIN_B * 1190], "[10] token counts")
    n = sum(r["int8_forwards"] for r in results)
    want = want_launches(int8_dense=n, int8_dense_gelu=n)
    check(launches == want, f"[10] launches {launches} != {want}")
    for r in results:
        for layer in ("fc1", "fc2"):
            check(r[f"{layer}_err"] < r[f"{layer}_limit"], f"[10] M={r['M']} {layer}: mean|int8 - exact| "
                  f"{r[f'{layer}_err']:.4g} >= {r[f'{layer}_limit']:.4g}")
        check(all(isinstance(r[f"{p}_ms_{t}"], float) for p in ("fwd", "fwdbwd") for t in ("bf16", "int8")),
              f"[10] M={r['M']}: times")
    say(f"[10] int8 MLP (int8_dense_gelu -> int8_dense) vs bf16 at M = "
        f"{', '.join(str(r['M']) for r in results)}: layer errors within 0.02 mean|exact| + 1e-3; launches "
        f"{ {k: v for k, v in launches.items() if v} } ({gpu})")
    return launches


def phase_int8_micro(gpu: str, dev: torch.device) -> dict:
    """[11] the int8 / bf16 matmul micro-benchmark (tools/int8_matmul_micro)
    at the model's shapes and 8192^3; it checks the int8 product bit-equal
    first and prints its JSON."""
    from passt_tpu_torch.ops import _build
    from passt_tpu_torch.tools import int8_matmul_micro

    _build.reset_launches()
    res = int8_matmul_micro.run(dev)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    check(launches["int8_matmul"] > 0 and sum(launches.values()) == launches["int8_matmul"],
          f"[11] launches {launches}")
    say(f"[11] int8_matmul micro-benchmark: int8 kernel {res['square_8192_kernel_int8_tops']:.1f} TOP/s at 8192^3 "
        f"({res['square_8192_int8_vs_best_bf16']:.2f}x the best bf16), torch._int_mm "
        f"{res['square_8192_torch_int8_tops']:.1f}; {launches['int8_matmul']} launches ({gpu})")
    return launches


def phase_proto_mlp(gpu: str, dev: torch.device) -> dict:
    """[12] the fused-MLP A/B (tools/proto_mlp_fused) at M = 5688 and 14280,
    with exact launch counts, the variants' errors against the xla
    composition, and fuse_f's peak memory growth below one [M, H] bf16
    tensor: the hidden activation never reached device memory."""
    from passt_tpu_torch.ops import _build
    from passt_tpu_torch.tools import proto_mlp_fused

    _build.reset_launches()
    results = proto_mlp_fused.run(dev)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    check([r["M"] for r in results] == [TRAIN_B * TRAIN_N, TRAIN_B * 1190], "[12] token counts")
    want = want_launches(fused_mlp_fwd=sum(r["fwd_calls"] for r in results),
                         fused_mlp_bwd=sum(r["bwd_calls"] for r in results))
    check(launches == want, f"[12] launches {launches} != {want}")
    for r in results:
        for key in ("fwd_err_fuse_f", "fwd_err_fuse"):
            check(r[key] <= TOL_PROTO_MLP * r["y_max"], f"[12] M={r['M']} {key} {r[key]:.4g} > "
                  f"{TOL_PROTO_MLP:g} max|y| ({r['y_max']:.4g})")
        for key in ("grad_rel_fuse", "grad_rel_fuse2"):
            check(r[key] <= TOL_PROTO_MLP, f"[12] M={r['M']} {key} {r[key]:.3g} > {TOL_PROTO_MLP:g}")
        check(r["fuse_f_peak_growth"] < r["hidden_bytes"], f"[12] M={r['M']}: fuse_f grew the peak memory by "
              f"{r['fuse_f_peak_growth']} B >= one [M, 3072] bf16 tensor ({r['hidden_bytes']} B)")
        check(all(isinstance(r[k], float) for k in ("fwd_ms_xla", "fwd_ms_fuse_f", "fwdbwd_ms_xla",
                                                     "fwdbwd_ms_fuse", "fwdbwd_ms_fuse2")), f"[12] M={r['M']}: times")
    say(f"[12] fused-MLP A/B (xla, fuse_f, fuse, fuse2) at M = {', '.join(str(r['M']) for r in results)}: errors "
        f"within {TOL_PROTO_MLP:g}; fuse_f peak growth "
        f"{', '.join(str(r['fuse_f_peak_growth']) for r in results)} B < one [M, 3072] bf16 tensor; launches "
        f"{ {k: v for k, v in launches.items() if v} } ({gpu})")
    return launches


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
    rec.update(phase_layernorm(gpu, dev))
    rec.update(phase_int8(gpu, dev))
    rec.update(phase_fused_mlp(gpu, dev))
    runs = [phase_serving(gpu, dev)]
    phase_correctness(dev)
    runs.append(train_steps(gpu, dev, "default"))
    runs.append(phase_train_correctness(dev))
    runs += [train_steps(gpu, dev, variant) for variant in ("fuse_ln_qkv", "ln_impl=fused")]
    runs += phase_variant_correctness(dev)
    runs += [phase_int8_mlp(gpu, dev), phase_int8_micro(gpu, dev), phase_proto_mlp(gpu, dev)]
    launches = {name: sum(run.get(name, 0) for run in runs) for name in rec}

    sources = {
        "fused_log_mel": ("passt_tpu_torch/csrc/mel_kernel.cu", "passt_tpu/ops/pallas/mel_kernel.py:65"),
        "fused_attention": ("passt_tpu_torch/csrc/attention_fwd.cu", "passt_tpu/ops/pallas/attention.py:171"),
        "fused_attention_qkv": ("passt_tpu_torch/csrc/attention_fwd.cu",
                                "passt_tpu/ops/pallas/attention.py:373, scripts/proto_attn_qkv.py:63"),
        "fused_attention_bwd": ("passt_tpu_torch/csrc/attention_bwd.cu", "passt_tpu/ops/pallas/attention.py:188"),
        "fused_attention_qkv_bwd": ("passt_tpu_torch/csrc/attention_bwd.cu",
                                    "passt_tpu/ops/pallas/attention.py:388, scripts/proto_attn_qkv.py:78"),
        "layer_norm_bwd": ("passt_tpu_torch/csrc/layernorm_bwd.cu", "passt_tpu/ops/pallas/layernorm.py:58"),
        "ln_qkv_f1": ("passt_tpu_torch/csrc/ln_qkv.cu", "passt_tpu/ops/pallas/ln_qkv.py:120"),
        "ln_qkv_b2": ("passt_tpu_torch/csrc/ln_qkv.cu", "passt_tpu/ops/pallas/ln_qkv.py:144"),
        "int8_dense": ("passt_tpu_torch/csrc/int8_dense.cu", "passt_tpu/ops/pallas/int8_dense.py:68"),
        "int8_dense_gelu": ("passt_tpu_torch/csrc/int8_dense.cu", "passt_tpu/ops/pallas/int8_dense.py:74"),
        "int8_matmul": ("passt_tpu_torch/csrc/int8_dense.cu", "scripts/int8_matmul_micro.py:71"),
        "fused_mlp_fwd": ("passt_tpu_torch/csrc/fused_mlp.cu", "scripts/proto_mlp_fused.py:78"),
        "fused_mlp_bwd": ("passt_tpu_torch/csrc/fused_mlp.cu", "scripts/proto_mlp_fused.py:92"),
    }
    check(set(sources) == set(KERNEL_NAMES) == set(rec), "every kernel has a source and a record")
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
