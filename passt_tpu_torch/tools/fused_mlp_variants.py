"""Time text variants of ``csrc/fused_mlp.cu`` (the fused MLP's bf16 forward
and backward kernels) on the card, all in one process: the cluster split,
the row block, the TMA multicast of x (the whole path is the variant's
text: the source loads x into each CTA on its own), the producer, the ring
depth, and variants that remove work to show what sets the time.

    python3 -m passt_tpu_torch.tools.fused_mlp_variants [VARIANTS.json]

VARIANTS.json (default: ``fused_mlp_variants.json`` beside this file) maps a
variant name to a list of ``[old, new]`` text edits of ``fused_mlp.cu``; an
empty list is the source as it is. Each variant is written with the other
kernel sources to ``build/fused_mlp_variants/<name>/``, built (the library
name hashes the source, so each gets its own), held against the plain
versions in bf16 at M = 5688 (max error relative to max|ref|; a variant that
removes work is wrong on purpose) and timed by CUDA-graph replay at the
A/B's shapes (bf16, C = 768, H = 3072, M = 5688 and 14280; the forward
without residuals). Prints the card (nvidia-smi name and power limit), then
one line per variant with ptxas's registers and spill stores of the
``mlp_kernel`` instances and its "Performance Loss" notes; a variant that
does not build or whose launch is refused is reported and skipped.
"""

from __future__ import annotations

import re
import sys
from pathlib import Path

import torch

from passt_tpu_torch.ops import fused_mlp as F
from passt_tpu_torch.tools import variants as V
from passt_tpu_torch.tools.timing import gpu_line, graph_ms

SIZES = (5688, 14280)


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got.float() - ref.float()).abs().max() / ref.float().abs().max().clamp_min(1e-30))


def main(argv=None) -> int:
    variants = V.load(sys.argv[1:] if argv is None else argv, Path(__file__).with_name("fused_mlp_variants.json"))
    if not torch.cuda.is_available():
        raise SystemExit("fused_mlp_variants: no CUDA device; the variants run on the card only")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    c, h = 768, 3072

    def rand(*shape, scale=1.0):
        return (torch.randn(*shape, device=dev, generator=gen) * scale).to(torch.bfloat16)

    w1, b1, w2, b2 = rand(c, h, scale=0.02), rand(h, scale=0.1), rand(h, c, scale=0.02), rand(c, scale=0.1)
    inputs = {m: (rand(m, c), rand(m, c), rand(m, h)) for m in SIZES}  # x, dy, d
    x, dy, d = inputs[SIZES[0]]
    ref_f = F.fused_mlp_fwd_plain(x, w1, b1, w2, b2, residuals=True)
    ref_b = F.fused_mlp_bwd_plain(dy, d, w1, w2)
    print(gpu_line(), flush=True)

    for name, log in V.builds("fused_mlp", variants, F._lib):
        regs = {f"{'bwd' if bwd else 'fwd'} W={w} NB={nb}": V.registers(log, f"mlp_kernelILb{bwd}ELi{w}ELi{nb}E")
                for bwd in (0, 1) for w in (2, 3) for nb in (1, 2, 3)}
        losses = len(re.findall(r"Potential Performance Loss", log))
        try:
            got_f = F.fused_mlp_fwd(x, w1, b1, w2, b2, residuals=True)
            got_b = F.fused_mlp_bwd(dy, d, w1, w2)
            torch.cuda.synchronize()
        except RuntimeError as err:  # a refused launch (shared memory, cluster): reported, the others still run
            print(f"{name}: does not run: {err}", flush=True)
            continue
        ef = max(rel_err(g, r) for g, r in zip(got_f, ref_f))
        eb = max(rel_err(g, r) for g, r in zip(got_b, ref_b))
        times = []
        for m in SIZES:
            xm, dym, dm = inputs[m]
            tf = graph_ms(lambda: F.fused_mlp_fwd(xm, w1, b1, w2, b2, residuals=False))
            tb = graph_ms(lambda: F.fused_mlp_bwd(dym, dm, w1, w2))
            times.append(f"M={m} fwd {tf:.4f} ms, bwd {tb:.4f} ms")
        print(f"{name}: {'; '.join(times)} (err fwd {ef:.3g}, bwd {eb:.3g}); registers, spill stores (B): "
              + ", ".join(f"{k} {v}" for k, v in regs.items() if v != (0, 0))
              + f"; {losses} performance-loss notes", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
