"""Time text variants of ``csrc/attention_bwd_fp32.cu`` (the attention
backward's fp32 "simt" path) on the card, all in one process, to find what
sets its time.

    python3 -m passt_tpu_torch.tools.attention_bwd_fp32_variants [VARIANTS.json]

VARIANTS.json (default: ``attention_bwd_fp32_variants.json`` beside this
file) maps a variant name to a list of ``[old, new]`` text edits of
``attention_bwd_fp32.cu``; an empty list is the source as it is. Each
variant is written with the other kernel sources to
``build/attention_bwd_fp32_variants/<name>/`` and built (one ``nvcc`` per
variant, all started together). Each is then held against the plain version
(the largest error over dq, dk and dv relative to that gradient's max|ref|;
a variant that removes work is wrong on purpose), checked to give the same
bits twice, and timed through the ``[B, N, H, D]`` entry at fp32 B = 2,
N = 474 (the fp32 training step's call) and B = 2, N = 1190 (H = 12,
D = 64): by CUDA-graph replay, and each kernel's profiled time. Beside them,
from the source as it is: the old "fma" pair at the same shapes (graph
replay) and SDPA's backward (the profiled kernel time of its forward and
backward less its forward's). Prints the card (nvidia-smi name and power
limit), then one line per variant with its registers.
"""

from __future__ import annotations

import re
import sys
from pathlib import Path

import torch

from passt_tpu_torch.ops import attention as A
from passt_tpu_torch.tools import variants as V
from passt_tpu_torch.tools.timing import gpu_line, graph_ms, kernel_ms, kernel_times

HEADS, HEAD_DIM = 12, 64
SHAPES = ((2, 474), (2, 1190))  # (B, N): the fp32 training step's, and a long sequence


def _fma(q, k, v, do, scale):
    """The old "fma" kernel pair on the same call, through the private path
    override."""
    grads = [torch.empty(q.shape, device=q.device) for _ in range(3)]
    A._launch_bwd(q, k, v, do, *grads, scale, False, path="fma")
    return grads


def _sdpa_bwd_ms(q, k, v, do, scale) -> float:
    q, k, v = (t.detach().clone().transpose(1, 2).requires_grad_() for t in (q, k, v))
    fwd = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, scale=scale)
    fwd_bwd = lambda: torch.autograd.grad(fwd(), (q, k, v), do.transpose(1, 2))
    return kernel_ms(fwd_bwd) - kernel_ms(fwd)


def _err(got, ref) -> float:
    return max(float((g - r).abs().max() / r.abs().max()) for g, r in zip(got, ref))


def main(argv=None) -> int:
    variants = V.load(sys.argv[1:] if argv is None else argv,
                      Path(__file__).with_name("attention_bwd_fp32_variants.json"))
    if not torch.cuda.is_available():
        raise SystemExit("attention_bwd_fp32_variants: no CUDA device; the variants run on the card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    scale = HEAD_DIM ** -0.5
    cases = []
    for b, n in SHAPES:
        qkv = torch.randn((b, n, 3 * HEADS * HEAD_DIM), device=dev, generator=gen)
        q, k, v = qkv.reshape(b, n, 3, HEADS, HEAD_DIM).unbind(2)
        do = torch.randn((b, n, HEADS, HEAD_DIM), device=dev, generator=gen)
        cases.append((b, n, q, k, v, do, A.attention_bwd_plain(q, k, v, do, scale=scale)))
    print(gpu_line(), flush=True)
    for b, n, q, k, v, do, ref in cases:
        print(f"B={b} N={n}: old fma path {graph_ms(lambda: _fma(q, k, v, do, scale)):.4f} ms "
              f"(err {_err(_fma(q, k, v, do, scale), ref):.3g}); SDPA backward "
              f"{_sdpa_bwd_ms(q, k, v, do, scale):.4f} ms of kernels", flush=True)

    for name, log in V.builds("attention_bwd_fp32", variants, A._bwd32_lib):
        times = []
        for b, n, q, k, v, do, ref in cases:
            run = lambda: A.fused_attention_bwd(q, k, v, do, scale=scale)
            A.reset_path_launches()
            got = run()
            again = run()
            torch.cuda.synchronize()
            paths = [p for p, c in A.BWD_PATH_LAUNCHES.items() if c]
            same = all(torch.equal(x, y) for x, y in zip(got, again))
            split = ", ".join(f"{re.search(r'bwd32_[a-z]+_kernel', kn).group(0)} {ms:.4f}"
                              for kn, ms in kernel_times(run).items() if "bwd32" in kn)
            times.append(f"B={b} N={n} {graph_ms(run):.4f} ms ({split}; err {_err(got, ref):.3g}, "
                         f"{'same bits' if same else 'BITS DIFFER'}, path {paths})")
        regs = {k_: V.registers(log, k_) for k_ in ("bwd32_stats_kernel", "bwd32_kv_kernel")}
        print(f"{name}: " + "; ".join(times) + "; registers, spill stores (B): "
              + ", ".join(f"{k_} {v_}" for k_, v_ in regs.items()), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
