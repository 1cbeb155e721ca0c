"""Time text variants of ``csrc/attention_bwd.cu`` (the attention backward's
"wgmma" path at D = 64 and at the padded head dim DP = 128, and its
"resident" path at D = 32) on the card, all in one process, to find what
sets their time.

    python3 -m passt_tpu_torch.tools.attention_bwd_variants [VARIANTS.json] [NAME ...]

VARIANTS.json (default: ``attention_bwd_variants.json`` beside this file)
maps a variant name to a list of ``[old, new]`` text edits of
``attention_bwd.cu``; an empty list is the source as it is; NAMEs keep only
those variants. Each variant is written with the other kernel sources to
``build/attention_bwd_variants/<name>/`` and built (one ``nvcc`` per
variant, all started together). Each is then held against the plain version
(the largest error over dq, dk and dv relative to that gradient's max|ref|;
a variant that removes work is wrong on purpose), checked to give the same
bits twice, and timed through the qkv entry at the training shape (bf16
B = 12, N = 474) and at B = 2, N = 1190 (H = 12, D = 64) by CUDA-graph
replay, and at the convergence demo's shapes (bf16, 6 heads of D = 32:
B = 25, N = 79 and B = 50, N = 110; the "resident" path), and on the
"wgmma" path's DP = 128 instances at 6 heads of D = 128 (B = 12, N = 474)
and at the demo's shapes over 2 heads of D = 96, by graph replay and by
profiled kernel time. Beside them, from the source as it is: the old
"mma" path at the same shapes and SDPA's backward (the profiled kernel time
of its forward and backward less its forward's). Prints the card
(nvidia-smi name and power limit), then one line per variant with its
registers and ptxas's "Performance Loss" notes.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

from passt_tpu_torch.ops import attention as A
from passt_tpu_torch.tools import variants as V
from passt_tpu_torch.tools.timing import gpu_line, graph_ms, kernel_ms

HEADS, HEAD_DIM = 12, 64
# (B, N, H, D): the training step's, a long sequence, the convergence
# demo's training and eval shapes (the "resident" path), and the DP = 128
# instances at the training step's width over 6 heads and at the demo's
# shapes over 2 heads
SHAPES = ((12, 474, HEADS, HEAD_DIM), (2, 1190, HEADS, HEAD_DIM), (25, 79, 6, 32), (50, 110, 6, 32),
          (12, 474, 6, 128), (25, 79, 2, 96), (50, 110, 2, 96))


def _inputs(dev, gen, b, n, h, d):
    qkv = torch.randn((b, n, 3 * h * d), device=dev, generator=gen).to(torch.bfloat16)
    do = torch.randn((b, n, h * d), device=dev, generator=gen).to(torch.bfloat16)
    return qkv, do


def _mma(qkv, do, h, d):
    """The old "mma" kernel pair on the same call, through the private
    path override."""
    b, n, _ = qkv.shape
    dqkv = torch.empty_like(qkv)
    A._launch_bwd(*A._head_views(qkv, h, d), do.view(b, n, h, d), *A._head_views(dqkv, h, d), d ** -0.5, False,
                  path="mma")
    return dqkv


def _sdpa_bwd_ms(qkv, do, h, d) -> float:
    b, n, _ = qkv.shape
    scale = d ** -0.5
    q, k, v = (t.detach().clone().transpose(1, 2).requires_grad_() for t in qkv.reshape(b, n, 3, h, d).unbind(2))
    do4 = do.view(b, n, h, d).transpose(1, 2)
    fwd = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, scale=scale)
    fwd_bwd = lambda: torch.autograd.grad(fwd(), (q, k, v), do4)
    return kernel_ms(fwd_bwd) - kernel_ms(fwd)


def main(argv=None) -> int:
    variants = V.load(sys.argv[1:] if argv is None else argv,
                      Path(__file__).with_name("attention_bwd_variants.json"))
    if not torch.cuda.is_available():
        raise SystemExit("attention_bwd_variants: no CUDA device; the variants run on the card only")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = []
    for b, n, h, d in SHAPES:
        qkv, do = _inputs(dev, gen, b, n, h, d)
        q, k, v = qkv.reshape(b, n, 3, h, d).unbind(2)
        ref = A.attention_bwd_plain(q, k, v, do.view(b, n, h, d), scale=d ** -0.5)
        cases.append((b, n, h, d, qkv, do, ref))
    print(gpu_line(), flush=True)
    for b, n, h, d, qkv, do, ref in cases:
        mma = _mma(qkv, do, h, d).reshape(b, n, 3, h, d).unbind(2)
        err = max(float((g.float() - r.float()).abs().max() / r.float().abs().max()) for g, r in zip(mma, ref))
        old = lambda: _mma(qkv, do, h, d)
        print(f"B={b} N={n} H={h} D={d}: old mma path {graph_ms(old):.4f} ms graph-replayed, {kernel_ms(old):.4f} of "
              f"kernels (err {err:.3g}); SDPA backward {_sdpa_bwd_ms(qkv, do, h, d):.4f} ms of kernels", flush=True)

    for name, log in V.builds("attention_bwd", variants, A._bwd_lib):
        times = []
        for b, n, h, d, qkv, do, ref in cases:
            run = lambda: A.fused_attention_qkv_bwd(qkv, do, heads=h, head_dim=d, scale=d ** -0.5)
            A.reset_path_launches()
            got = run()
            again = run()
            torch.cuda.synchronize()
            paths = [p for p, c in A.BWD_PATH_LAUNCHES.items() if c]
            grads = got.reshape(b, n, 3, h, d).unbind(2)
            err = max(float((g.float() - r.float()).abs().max() / r.float().abs().max()) for g, r in zip(grads, ref))
            profiled = f", {kernel_ms(run):.4f} of kernels" if d != HEAD_DIM else ""
            times.append(f"B={b} N={n} D={d} {graph_ms(run):.4f} ms{profiled} (err {err:.3g}, "
                         f"{'same bits' if torch.equal(got, again) else 'BITS DIFFER'}, path {paths})")
        regs = {f"{k} DP={dp}": V.registers(log, k, f"Li{dp}E") for k in ("stats_kernel", "kv_kernel", "dq_sum_kernel")
                for dp in (64, 128)}
        regs["resident_kernel"] = V.registers(log, "resident_kernel")
        print(f"{name}: " + "; ".join(times) + "; registers, spill stores (B): "
              + ", ".join(f"{k} {v}" for k, v in regs.items() if v != (0, 0)), flush=True)
        for note in sorted({ln.split(":", 1)[-1].strip() for ln in log.splitlines() if "Performance Loss" in ln}):
            print(f"  ptxas: {note}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
