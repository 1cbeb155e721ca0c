"""Time text variants of ``csrc/attention_fwd.cu`` (the attention forward
kernel's "wgmma" path) on the card, all in one process, to find what sets
its time.

    python3 -m passt_tpu_torch.tools.attention_variants [VARIANTS.json]

VARIANTS.json (default: ``attention_variants.json`` beside this file) maps a
variant name to a list of ``[old, new]`` text edits of ``attention_fwd.cu``;
an empty list is the source as it is. Each variant is written with the other
kernel sources to ``build/attention_fwd_variants/<name>/`` and built (one
``nvcc`` per variant, all started together; the library name hashes the
source, so each gets its own). Each is then held against the plain version
at the serving shape (max abs error; a variant that removes work is wrong on
purpose) and timed by CUDA-graph replay at the serving shape ([B, N, H, D]
entry, bf16 B = 20, H = 12, N = 1190, D = 64) and the training shape (qkv
entry, bf16 B = 12, N = 474), beside SDPA at the serving shape. Prints the
card (nvidia-smi name and power limit), then one line per variant.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

from passt_tpu_torch.ops import attention as A
from passt_tpu_torch.tools import variants as V
from passt_tpu_torch.tools.timing import gpu_line, graph_ms

HEADS, HEAD_DIM = 12, 64


def main(argv=None) -> int:
    variants = V.load(sys.argv[1:] if argv is None else argv, Path(__file__).with_name("attention_variants.json"))
    if not torch.cuda.is_available():
        raise SystemExit("attention_variants: no CUDA device; the variants run on the card only")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    scale = HEAD_DIM ** -0.5

    def qkv(b, n):
        return torch.randn((b, n, 3 * HEADS * HEAD_DIM), device=dev, generator=gen).to(torch.bfloat16)

    serve, train = qkv(20, 1190), qkv(12, 474)
    q, k, v = serve.reshape(20, 1190, 3, HEADS, HEAD_DIM).unbind(2)
    with torch.no_grad():
        ref = A.attention_plain(q, k, v, scale=scale)
        sdpa_ms = graph_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale=scale))
    print(gpu_line(), flush=True)
    print(f"SDPA, serving shape: {sdpa_ms:.4f} ms", flush=True)

    for name, log in V.builds("attention_fwd", variants, A._lib):
        regs, spills = V.registers(log, "wgmma_kernel")
        with torch.no_grad():
            A.reset_path_launches()
            err = float((A.fused_attention(q, k, v, scale=scale).float() - ref.float()).abs().max())
            torch.cuda.synchronize()
            path = [p for p, c in A.FWD_PATH_LAUNCHES.items() if c]
            t_serve = graph_ms(lambda: A.fused_attention(q, k, v, scale=scale))
            t_train = graph_ms(lambda: A.fused_attention_qkv(train, heads=HEADS, head_dim=HEAD_DIM, scale=scale))
        print(f"{name}: serving {t_serve:.4f} ms, training {t_train:.4f} ms (path {path}, err {err:.3g}); "
              f"wgmma kernel {regs} registers, {spills} B spill stores", flush=True)
        for note in sorted({ln.split(":", 1)[-1].strip() for ln in log.splitlines() if "Performance Loss" in ln}):
            print(f"  ptxas: {note}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
