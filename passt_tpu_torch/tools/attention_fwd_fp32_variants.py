"""Time text variants of ``csrc/attention_fwd_fp32.cu`` (the attention
forward's fp32 "simt" path) on the card, all in one process, to find what
sets its time.

    python3 -m passt_tpu_torch.tools.attention_fwd_fp32_variants [VARIANTS.json]

VARIANTS.json (default: ``attention_fwd_fp32_variants.json`` beside this
file) maps a variant name to a list of ``[old, new]`` text edits of
``attention_fwd_fp32.cu``; an empty list is the source as it is. Each
variant is written with the other kernel sources to
``build/attention_fwd_fp32_variants/<name>/`` and built (one ``nvcc`` per
variant, all started together). Each is then held against the plain version
(max abs error; a variant that removes work is wrong on purpose) and timed
through the ``[B, N, H, D]`` entry on the q, k, v views of one fp32 qkv
tensor at B = 20, N = 1190 (the fp32 ``Predictor``'s and exported
program's call) and B = 2, N = 474 (the fp32 training step's; H = 12,
D = 64): by CUDA-graph replay and by the kernel's profiled time, with the
blocks an SM holds (the occupancy query), registers and spill stores.
Beside them, from the source as it is: the old "fma" kernel on the same
call (the private path override, graph replay) and SDPA's EFFICIENT backend
(CUDA events), with the bound. Prints the card (nvidia-smi name and power
limit), then one line per variant.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

from passt_tpu_torch.ops import attention as A
from passt_tpu_torch.tools import variants as V
from passt_tpu_torch.tools.timing import cuda_ms, gpu_line, graph_ms, kernel_times

HEADS, HEAD_DIM = 12, 64
SHAPES = ((20, 1190), (2, 474))  # (B, N): the fp32 Predictor's, the fp32 training step's
PEAK_FP32 = 67e12  # FMA FLOP/s of one H100 SXM at 700 W


def _fma(q, k, v, scale):
    """The old "fma" kernel on the same call, through the private path
    override."""
    out = torch.empty(q.shape, device=q.device)
    A._launch(q, k, v, out, scale, False, path="fma")
    return out


def _sdpa(q, k, v, scale):
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale=scale).transpose(1, 2)


def main(argv=None) -> int:
    variants = V.load(sys.argv[1:] if argv is None else argv,
                      Path(__file__).with_name("attention_fwd_fp32_variants.json"))
    if not torch.cuda.is_available():
        raise SystemExit("attention_fwd_fp32_variants: no CUDA device; the variants run on the card only")
    from torch.nn.attention import SDPBackend, sdpa_kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    scale = HEAD_DIM ** -0.5
    cases = []
    print(gpu_line(), flush=True)
    with torch.no_grad():
        for b, n in SHAPES:
            qkv = torch.randn((b, n, 3 * HEADS * HEAD_DIM), device=dev, generator=gen)
            q, k, v = qkv.reshape(b, n, 3, HEADS, HEAD_DIM).unbind(2)
            ref = A.attention_plain(q, k, v, scale=scale)
            cases.append((b, n, q, k, v, ref))
            with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
                sdpa_ms = cuda_ms(lambda: _sdpa(q, k, v, scale), reps=10)
            bound_ms = 4.0 * n * n * HEAD_DIM * b * HEADS / PEAK_FP32 * 1e3
            print(f"B={b} N={n}: old fma path {graph_ms(lambda: _fma(q, k, v, scale)):.4f} ms "
                  f"(err {float((_fma(q, k, v, scale) - ref).abs().max()):.3g}); SDPA EFFICIENT {sdpa_ms:.4f} ms "
                  f"(events); bound {bound_ms:.4f} ms (fp32 FMA)", flush=True)

        for name, log in V.builds("attention_fwd_fp32", variants, A._fwd32_lib):
            times = []
            for b, n, q, k, v, ref in cases:
                run = lambda: A.fused_attention(q, k, v, scale=scale)
                A.reset_path_launches()
                err = float((run() - ref).abs().max())
                torch.cuda.synchronize()
                paths = [p for p, c in A.FWD_PATH_LAUNCHES.items() if c]
                kern = sum(ms for kn, ms in kernel_times(run).items() if "attn32_fwd_kernel" in kn)
                times.append(f"B={b} N={n} {graph_ms(run):.4f} ms (kernel {kern:.4f} profiled; err {err:.3g}, "
                             f"path {paths})")
            regs, spills = V.registers(log, "attn32_fwd_kernel")
            print(f"{name}: " + "; ".join(times) + f"; {A.simt_forward_blocks_per_sm()} blocks an SM, {regs} "
                  f"registers, {spills} B spill stores", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
