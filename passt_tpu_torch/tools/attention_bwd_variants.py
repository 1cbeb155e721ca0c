"""Time text variants of ``csrc/attention_bwd.cu`` (the attention backward's
"wgmma" path) on the card, all in one process, to find what sets its time.

    python3 -m passt_tpu_torch.tools.attention_bwd_variants [VARIANTS.json]

VARIANTS.json (default: ``attention_bwd_variants.json`` beside this file)
maps a variant name to a list of ``[old, new]`` text edits of
``attention_bwd.cu``; an empty list is the source as it is. Each variant is
written with the other kernel sources to
``build/attention_bwd_variants/<name>/`` and built (one ``nvcc`` per
variant, all started together). Each is then held against the plain version
(the largest error over dq, dk and dv relative to that gradient's max|ref|;
a variant that removes work is wrong on purpose), checked to give the same
bits twice, and timed by CUDA-graph replay through the qkv entry at the
training shape (bf16 B = 12, N = 474) and at B = 2, N = 1190 (H = 12,
D = 64). Beside them, from the source as it is: the old "mma" path at the
same shapes (graph replay) and SDPA's backward (the profiled kernel time of
its forward and backward less its forward's). Prints the card (nvidia-smi
name and power limit), then one line per variant with its registers and
ptxas's "Performance Loss" notes.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

from passt_tpu_torch.ops import attention as A
from passt_tpu_torch.tools import variants as V
from passt_tpu_torch.tools.timing import gpu_line, graph_ms, kernel_ms

HEADS, HEAD_DIM = 12, 64
SHAPES = ((12, 474), (2, 1190))  # (B, N): the training step's, and a long sequence


def _inputs(dev, gen, b, n):
    qkv = torch.randn((b, n, 3 * HEADS * HEAD_DIM), device=dev, generator=gen).to(torch.bfloat16)
    do = torch.randn((b, n, HEADS * HEAD_DIM), device=dev, generator=gen).to(torch.bfloat16)
    return qkv, do


def _mma(qkv, do, scale):
    """The old "mma" kernel pair on the same call, through the private
    path override."""
    b, n, _ = qkv.shape
    dqkv = torch.empty_like(qkv)
    A._launch_bwd(*A._head_views(qkv, HEADS, HEAD_DIM), do.view(b, n, HEADS, HEAD_DIM),
                  *A._head_views(dqkv, HEADS, HEAD_DIM), scale, False, path="mma")
    return dqkv


def _sdpa_bwd_ms(qkv, do, scale) -> float:
    b, n, _ = qkv.shape
    q, k, v = (t.detach().clone().transpose(1, 2).requires_grad_()
               for t in qkv.reshape(b, n, 3, HEADS, HEAD_DIM).unbind(2))
    do4 = do.view(b, n, HEADS, HEAD_DIM).transpose(1, 2)
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
    scale = HEAD_DIM ** -0.5
    cases = []
    for b, n in SHAPES:
        qkv, do = _inputs(dev, gen, b, n)
        q, k, v = qkv.reshape(b, n, 3, HEADS, HEAD_DIM).unbind(2)
        ref = A.attention_bwd_plain(q, k, v, do.view(b, n, HEADS, HEAD_DIM), scale=scale)
        cases.append((b, n, qkv, do, ref))
    print(gpu_line(), flush=True)
    for b, n, qkv, do, ref in cases:
        mma = _mma(qkv, do, scale).reshape(b, n, 3, HEADS, HEAD_DIM).unbind(2)
        err = max(float((g.float() - r.float()).abs().max() / r.float().abs().max()) for g, r in zip(mma, ref))
        print(f"B={b} N={n}: old mma path {graph_ms(lambda: _mma(qkv, do, scale)):.4f} ms (err {err:.3g}); "
              f"SDPA backward {_sdpa_bwd_ms(qkv, do, scale):.4f} ms of kernels", flush=True)

    for name, log in V.builds("attention_bwd", variants, A._bwd_lib):
        times = []
        for b, n, qkv, do, ref in cases:
            run = lambda: A.fused_attention_qkv_bwd(qkv, do, heads=HEADS, head_dim=HEAD_DIM, scale=scale)
            A.reset_path_launches()
            got = run()
            again = run()
            torch.cuda.synchronize()
            paths = [p for p, c in A.BWD_PATH_LAUNCHES.items() if c]
            grads = got.reshape(b, n, 3, HEADS, HEAD_DIM).unbind(2)
            err = max(float((g.float() - r.float()).abs().max() / r.float().abs().max()) for g, r in zip(grads, ref))
            times.append(f"B={b} N={n} {graph_ms(run):.4f} ms (err {err:.3g}, "
                         f"{'same bits' if torch.equal(got, again) else 'BITS DIFFER'}, path {paths})")
        regs = {k: V.registers(log, k) for k in ("stats_kernel", "kv_kernel", "dq_sum_kernel")}
        print(f"{name}: " + "; ".join(times) + "; registers, spill stores (B): "
              + ", ".join(f"{k} {v}" for k, v in regs.items() if v != (0, 0)), flush=True)
        for note in sorted({ln.split(":", 1)[-1].strip() for ln in log.splitlines() if "Performance Loss" in ln}):
            print(f"  ptxas: {note}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
