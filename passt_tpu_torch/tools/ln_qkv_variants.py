"""Time text variants of ``csrc/ln_qkv.cu`` (the F1 and B2 kernels) on the
card, all in one process, to find what sets their time.

    python3 -m passt_tpu_torch.tools.ln_qkv_variants [VARIANTS.json]

VARIANTS.json (default: ``ln_qkv_variants.json`` beside this file) maps a
variant name to a list of ``[old, new]`` text edits of ``ln_qkv.cu``; an
empty list is the source as it is. Each variant is written with the other
kernel sources to ``build/ln_qkv_variants/<name>/``, built (the library name
hashes the source, so each gets its own), held against the plain versions
(max error relative to max|ref|; a variant that removes work is wrong on
purpose) and timed by CUDA-graph replay at the shapes the main paths give
the kernels (C = 768): F1 and B2 in bf16 at the training step's B = 12,
N = 474, F1 in bf16 and fp32 at the timestamp windows' B = 256, N = 14,
and F1 and B2 in fp32 at the fp32 step's B = 2, N = 154. Prints the card (nvidia-smi
name and power limit), then one line per variant.
"""

from __future__ import annotations

import re
import sys
from pathlib import Path

import torch

from passt_tpu_torch.ops import ln_qkv as L
from passt_tpu_torch.tools import variants as V
from passt_tpu_torch.tools.timing import gpu_line, graph_ms


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got.float() - ref.float()).abs().max() / ref.float().abs().max().clamp_min(1e-30))


def main(argv=None) -> int:
    variants = V.load(sys.argv[1:] if argv is None else argv, Path(__file__).with_name("ln_qkv_variants.json"))
    if not torch.cuda.is_available():
        raise SystemExit("ln_qkv_variants: no CUDA device; the variants run on the card only")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    c = 768

    def rand(*shape, dtype=torch.bfloat16, scale=1.0, offset=0.0):
        return (torch.randn(*shape, device=dev, generator=gen) * scale + offset).to(dtype)

    s, b = rand(c, dtype=torch.float32, scale=0.1, offset=1.0), rand(c, dtype=torch.float32, scale=0.1)
    # (kernel, dtype, B, N): the main paths' calls
    calls = (("F1", torch.bfloat16, 12, 474), ("F1", torch.bfloat16, 256, 14), ("B2", torch.bfloat16, 12, 474),
             ("F1", torch.float32, 2, 154), ("F1", torch.float32, 256, 14), ("B2", torch.float32, 2, 154))
    cases = []
    for kernel, dtype, bsz, n in calls:
        x, w = rand(bsz, n, c, dtype=dtype), rand(3 * c, c, dtype=dtype, scale=0.02)
        if kernel == "F1":
            wb = rand(3 * c, dtype=dtype, scale=0.02)
            fn = (lambda x=x, w=w, wb=wb: L.ln_qkv_f1(x, s, b, w, wb))
            ref = (L.ln_qkv_f1_plain(x, s, b, w, wb),)
        else:
            dqkv = rand(bsz, n, 3 * c, dtype=dtype)
            fn = (lambda x=x, w=w, dqkv=dqkv: L.ln_qkv_b2(x, dqkv, w, s, b))
            ref = L.ln_qkv_b2_plain(x, dqkv, w, s, b)
        cases.append((f"{kernel} {str(dtype)[6:]} B={bsz} N={n}", fn, ref))
    print(gpu_line(), flush=True)

    for name, log in V.builds("ln_qkv", variants, L._lib):
        regs = re.findall(r"Used (\d+) registers", log)
        parts = []
        for label, fn, ref in cases:
            got = fn()
            got = got if isinstance(got, tuple) else (got,)
            torch.cuda.synchronize()
            err = max(rel_err(g, r) for g, r in zip(got, ref))
            parts.append(f"{label} {graph_ms(fn):.4f} ms (err {err:.3g})")
        print(f"{name}: " + "; ".join(parts) + f"; registers per kernel {regs}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
