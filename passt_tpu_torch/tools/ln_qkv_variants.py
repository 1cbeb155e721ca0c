"""Time text variants of ``csrc/ln_qkv.cu`` (the F1 and B2 kernels) on the
card, all in one process, to find what sets their time.

    python3 -m passt_tpu_torch.tools.ln_qkv_variants [VARIANTS.json]

VARIANTS.json (default: ``ln_qkv_variants.json`` beside this file) maps a
variant name to a list of ``[old, new]`` text edits of ``ln_qkv.cu``; an
empty list is the source as it is. Each variant is written with the other
kernel sources to ``build/ln_qkv_variants/<name>/``, built (the library name
hashes the source, so each gets its own), held against the plain versions
(max error relative to max|ref|; a variant that removes work is wrong on
purpose) and timed by CUDA-graph replay at the bf16 training step's shape
(B = 12, N = 474, C = 768). Prints the card (nvidia-smi name and power
limit), then one line per variant.
"""

from __future__ import annotations

import json
import re
import shutil
import sys
from pathlib import Path

import torch

from passt_tpu_torch.ops import _build
from passt_tpu_torch.ops import ln_qkv as L
from passt_tpu_torch.tools.timing import gpu_line, graph_ms


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    return float((got.float() - ref.float()).abs().max() / ref.float().abs().max().clamp_min(1e-30))


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    path = Path(args[0]) if args else Path(__file__).with_name("ln_qkv_variants.json")
    variants = json.loads(path.read_text())
    if not torch.cuda.is_available():
        raise SystemExit("ln_qkv_variants: no CUDA device; the variants run on the card only")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    c = 768

    def rand(*shape, dtype=torch.bfloat16, scale=1.0, offset=0.0):
        return (torch.randn(*shape, device=dev, generator=gen) * scale + offset).to(dtype)

    x, dqkv = rand(12, 474, c), rand(12, 474, 3 * c)
    s, b = rand(c, dtype=torch.float32, scale=0.1, offset=1.0), rand(c, dtype=torch.float32, scale=0.1)
    w, wb = rand(3 * c, c, scale=0.02), rand(3 * c, scale=0.02)
    ref_f1, ref_b2 = L.ln_qkv_f1_plain(x, s, b, w, wb), L.ln_qkv_b2_plain(x, dqkv, w, s, b)
    print(gpu_line(), flush=True)

    csrc = _build.CSRC
    try:
        for name, edits in variants.items():
            where = _build.BUILD_DIR.parent / "ln_qkv_variants" / name
            shutil.rmtree(where, ignore_errors=True)
            shutil.copytree(csrc, where)
            src = (where / "ln_qkv.cu").read_text()
            for old, new in edits:
                if old not in src:
                    raise SystemExit(f"variant {name}: text not found in ln_qkv.cu: {old!r}")
                src = src.replace(old, new)
            (where / "ln_qkv.cu").write_text(src)
            _build.CSRC = where
            L._lib.cache_clear()
            regs = re.findall(r"Used (\d+) registers", _build.build(["ln_qkv"])["ln_qkv"])
            f1, b2 = L.ln_qkv_f1(x, s, b, w, wb), L.ln_qkv_b2(x, dqkv, w, s, b)
            torch.cuda.synchronize()
            e1, e2 = rel_err(f1, ref_f1), max(rel_err(g, r) for g, r in zip(b2, ref_b2))
            t1 = graph_ms(lambda: L.ln_qkv_f1(x, s, b, w, wb))
            t2 = graph_ms(lambda: L.ln_qkv_b2(x, dqkv, w, s, b))
            print(f"{name}: F1 {t1:.4f} ms (err {e1:.3g}), B2 {t2:.4f} ms (err {e2:.3g}); "
                  f"registers per kernel {regs}", flush=True)
    finally:
        _build.CSRC = csrc
        L._lib.cache_clear()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
