"""Time text variants of ``csrc/attention_fwd.cu`` (the attention forward
kernel's "wgmma" path, its DP = 64, 32 and 128 instances) on the card, all
in one process, to find what sets its time.

    python3 -m passt_tpu_torch.tools.attention_variants [VARIANTS.json] [NAME ...]

VARIANTS.json (default: ``attention_variants.json`` beside this file) maps a
variant name to a list of ``[old, new]`` text edits of ``attention_fwd.cu``;
an empty list is the source as it is; NAMEs keep only those variants. Each
variant is written with the other kernel sources to
``build/attention_fwd_variants/<name>/`` and built (one ``nvcc`` per
variant, all started together; the library name hashes the source, so each
gets its own). Each is then held against the plain version at the serving
shape and at the convergence demo's training shape (max abs error; a
variant that removes work is wrong on purpose) and timed by CUDA-graph
replay at the serving shape ([B, N, H, D] entry, bf16 B = 20, H = 12,
N = 1190, D = 64), the training shape (qkv entry, bf16 B = 12, N = 474) and
the convergence demo's two (qkv entry, bf16, 6 heads of D = 32: B = 25,
N = 79 and B = 50, N = 110), and the DP = 128 instance's (qkv entry, bf16:
6 heads of D = 128 at B = 12, N = 474; the demo's two shapes over 2 heads
of D = 96), beside SDPA at each shape and, at the demo's and the DP = 128
ones, the old "mma" kernel. Prints the card (nvidia-smi name and power
limit), then one line per variant with each instance's registers and spill
stores.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

from passt_tpu_torch.ops import attention as A
from passt_tpu_torch.tools import variants as V
from passt_tpu_torch.tools.timing import gpu_line, graph_ms

HEADS, HEAD_DIM = 12, 64
#: the convergence demo's attention: its heads, head dim and (B, N) in
#: training and in eval
DEMO_HEADS, DEMO_HEAD_DIM, DEMO_SHAPES = 6, 32, ((25, 79), (50, 110))
#: the DP = 128 instance's shapes, (B, N, H, D)
WIDE_SHAPES = ((12, 474, 6, 128), (25, 79, 2, 96), (50, 110, 2, 96))


def _sdpa(q, k, v, scale):
    return torch.nn.functional.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                                            scale=scale)


def main(argv=None) -> int:
    variants = V.load(sys.argv[1:] if argv is None else argv, Path(__file__).with_name("attention_variants.json"))
    if not torch.cuda.is_available():
        raise SystemExit("attention_variants: no CUDA device; the variants run on the card only")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    scale = HEAD_DIM ** -0.5

    def qkv(b, n, h=HEADS, d=HEAD_DIM):
        return torch.randn((b, n, 3 * h * d), device=dev, generator=gen).to(torch.bfloat16)

    serve, train = qkv(20, 1190), qkv(12, 474)
    demo = [(b, n, qkv(b, n, DEMO_HEADS, DEMO_HEAD_DIM)) for b, n in DEMO_SHAPES]
    wide = [(b, n, h, d, qkv(b, n, h, d)) for b, n, h, d in WIDE_SHAPES]
    demo_scale = DEMO_HEAD_DIM ** -0.5
    q, k, v = serve.reshape(20, 1190, 3, HEADS, HEAD_DIM).unbind(2)
    b0, n0, x0 = demo[0]
    demo_views = x0.reshape(b0, n0, 3, DEMO_HEADS, DEMO_HEAD_DIM).unbind(2)
    with torch.no_grad():
        ref = A.attention_plain(q, k, v, scale=scale)
        demo_ref = A.attention_plain(*demo_views, scale=demo_scale)
        sdpa_ms = graph_ms(lambda: _sdpa(q, k, v, scale))
    print(gpu_line(), flush=True)
    print(f"SDPA, serving shape: {sdpa_ms:.4f} ms", flush=True)
    for b, n, x in demo:
        views = x.reshape(b, n, 3, DEMO_HEADS, DEMO_HEAD_DIM).unbind(2)
        out = torch.empty((b, n, DEMO_HEADS, DEMO_HEAD_DIM), device=dev, dtype=torch.bfloat16)
        with torch.no_grad():
            t_sdpa = graph_ms(lambda: _sdpa(*views, demo_scale))
            t_mma = graph_ms(lambda: A._launch(*A._head_views(x, DEMO_HEADS, DEMO_HEAD_DIM), out, demo_scale, False,
                                               path="mma"))
        print(f"the convergence demo's B={b} N={n} H={DEMO_HEADS} D={DEMO_HEAD_DIM}: SDPA {t_sdpa:.4f} ms, the old mma "
              f"kernel {t_mma:.4f} ms", flush=True)
    for b, n, h, d, x in wide:
        views = x.reshape(b, n, 3, h, d).unbind(2)
        out = torch.empty((b, n, h, d), device=dev, dtype=torch.bfloat16)
        with torch.no_grad():
            t_sdpa = graph_ms(lambda: _sdpa(*views, d ** -0.5))
            t_mma = graph_ms(lambda: A._launch(*A._head_views(x, h, d), out, d ** -0.5, False, path="mma"))
        print(f"B={b} N={n} H={h} D={d} (DP = 128): SDPA {t_sdpa:.4f} ms, the old mma kernel {t_mma:.4f} ms",
              flush=True)

    for name, log in V.builds("attention_fwd", variants, A._lib):
        regs = {d: V.registers(log, "wgmma_kernel", f"Li{d}E") for d in (64, 32, 128)}
        with torch.no_grad():
            A.reset_path_launches()
            err = float((A.fused_attention(q, k, v, scale=scale).float() - ref.float()).abs().max())
            demo_err = float((A.fused_attention(*demo_views, scale=demo_scale).float() - demo_ref.float()).abs().max())
            torch.cuda.synchronize()
            path = [p for p, c in A.FWD_PATH_LAUNCHES.items() if c]
            t_serve = graph_ms(lambda: A.fused_attention(q, k, v, scale=scale))
            t_train = graph_ms(lambda: A.fused_attention_qkv(train, heads=HEADS, head_dim=HEAD_DIM, scale=scale))
            t_demo = [graph_ms(lambda: A.fused_attention_qkv(x, heads=DEMO_HEADS, head_dim=DEMO_HEAD_DIM,
                                                             scale=demo_scale)) for _, _, x in demo]
            t_wide = [graph_ms(lambda: A.fused_attention_qkv(x, heads=h, head_dim=d, scale=d ** -0.5))
                      for _, _, h, d, x in wide]
            b1, n1, h1, d1, x1 = wide[0]
            v1 = x1.reshape(b1, n1, 3, h1, d1).unbind(2)
            wide_err = float((A.fused_attention(*v1, scale=d1 ** -0.5).float()
                              - A.attention_plain(*v1, scale=d1 ** -0.5).float()).abs().max())
        print(f"{name}: serving {t_serve:.4f} ms, training {t_train:.4f} ms (path {path}, err {err:.3g}); the demo's "
              + ", ".join(f"B={b} N={n} {t:.4f} ms" for (b, n, _), t in zip(demo, t_demo))
              + f" (err {demo_err:.3g}); DP = 128: "
              + ", ".join(f"B={b} N={n} H={h} D={d} {t:.4f} ms" for (b, n, h, d, _), t in zip(wide, t_wide))
              + f" (err {wide_err:.3g}); registers, spill stores (B): DP=64 {regs[64]}, DP=32 {regs[32]}, "
              f"DP=128 {regs[128]}", flush=True)
        for note in sorted({ln.split(":", 1)[-1].strip() for ln in log.splitlines() if "Performance Loss" in ln}):
            print(f"  ptxas: {note}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
