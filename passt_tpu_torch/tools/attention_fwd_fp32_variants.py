"""Time text variants of ``csrc/attention_fwd_fp32.cu`` (the attention
forward's "simt" path) on the card, all in one process, to find what sets
its time.

    python3 -m passt_tpu_torch.tools.attention_fwd_fp32_variants [VARIANTS.json] [NAME ...]

VARIANTS.json (default: ``attention_fwd_fp32_variants.json`` beside this
file) maps a variant name to a list of ``[old, new]`` text edits of
``attention_fwd_fp32.cu``; an empty list is the source as it is; NAMEs keep
only those variants. Each variant is written with the other kernel sources
to ``build/attention_fwd_fp32_variants/<name>/`` and built (one ``nvcc`` per
variant, all started together). Each is then held against the plain version
(max abs error; a variant that removes work is wrong on purpose) and timed
at eight fp32 calls: through the ``[B, N, H, D]`` entry on the q, k, v
views of one qkv tensor at B = 20, N = 1190 (the fp32 ``Predictor``'s and
exported program's call) and B = 2, N = 474 (the fp32 training step's;
H = 12, D = 64), and at B = 2, N = 474 with 6 heads of D = 128 and 16 of
D = 48 (the same FLOPs: the DP = 128 instance and the DP = 64 one padded);
through the qkv entry at the convergence demo's B = 25, N = 79 (training)
and B = 50, N = 110 (eval) at H = 6, D = 32 and at H = 2, D = 96 (the
DP = 96 instance): by CUDA-graph replay and by the kernel's profiled time,
with the blocks an SM holds at each DP (the occupancy query), and each
fp32 DP instance's registers and spill stores. Before them, from the source as it is (:func:`baselines`):
the old "fma" kernel on the same call (the private path override), SDPA's
EFFICIENT and MATH backends, each alone, and the plain version, with the
bound. Prints the card (nvidia-smi name and power limit), then one line per
call and one per variant.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

from passt_tpu_torch.ops import attention as A
from passt_tpu_torch.tools import variants as V
from passt_tpu_torch.tools.timing import cuda_ms, gpu_line, graph_ms, kernel_times

#: (B, N, H, D, entry): the fp32 Predictor's and the fp32 training step's
#: calls, the training step's shape at D = 128 and 48, then the convergence
#: demo's at model.dtype=float32 (training, eval) at 6 heads and at 2
SHAPES = ((20, 1190, 12, 64, "bnhd"), (2, 474, 12, 64, "bnhd"), (2, 474, 6, 128, "bnhd"), (2, 474, 16, 48, "bnhd"),
          (25, 79, 6, 32, "qkv"), (50, 110, 6, 32, "qkv"), (25, 79, 2, 96, "qkv"), (50, 110, 2, 96, "qkv"))
PEAK_FP32, HBM_BYTES_PER_S = 67e12, 3.35e12  # one H100 SXM at 700 W: FMA FLOP/s, memory bytes/s


def _sdpa(q, k, v, scale):
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale=scale).transpose(1, 2)


def cases(dev, shapes=SHAPES) -> list:
    """Each call's inputs (seed 0 on the card), its public entry ``run``
    (the path :func:`forward_path` picks), the old "fma" kernel on the same
    views ``fma`` (the private path override), SDPA on them and the plain
    version's output."""
    gen = torch.Generator(device=dev).manual_seed(0)
    out = []
    for b, n, h, d, entry in shapes:
        qkv = torch.randn((b, n, 3 * h * d), device=dev, generator=gen)
        views, scale = A._head_views(qkv, h, d), d ** -0.5
        dst = torch.empty((b, n, h, d), device=dev)
        if entry == "qkv":
            run = lambda qkv=qkv, h=h, d=d, scale=scale: A.fused_attention_qkv(qkv, heads=h, head_dim=d, scale=scale)
        else:
            run = lambda views=views, scale=scale: A.fused_attention(*views, scale=scale)

        def fma(views=views, dst=dst, scale=scale):
            A._launch(*views, dst, scale, False, path="fma")
            return dst
        out.append(dict(b=b, n=n, h=h, d=d, entry=entry, run=run, fma=fma, scale=scale, views=views,
                        ref=A.attention_plain(*views, scale=scale)))
    return out


def bound_ms(b, n, h, d) -> float:
    """4 N^2 D FLOP a head over the fp32 FMA rate, or q, k, v read and o
    written once over the memory rate, whichever is longer."""
    return max(4.0 * n * n * d * b * h / PEAK_FP32, 4.0 * 4 * b * n * h * d / HBM_BYTES_PER_S) * 1e3


def baselines(calls) -> None:
    """One line per call: the old "fma" kernel (graph replay; error against
    plain), SDPA EFFICIENT and MATH each alone (graph replay and events),
    the plain version (events) and the bound."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    with torch.no_grad():
        for c in calls:
            fma_err = float((c["fma"]().reshape(c["ref"].shape) - c["ref"]).abs().max())
            lib = {}
            for be in (SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
                def call(be=be):
                    with sdpa_kernel([be]):
                        return _sdpa(*c["views"], c["scale"])
                lib[be.name] = (graph_ms(call), cuda_ms(call))
            plain = cuda_ms(lambda: A.attention_plain(*c["views"], scale=c["scale"]), reps=5)
            print(f"B={c['b']} N={c['n']} H={c['h']} D={c['d']} ({c['entry']} entry): old fma kernel "
                  f"{graph_ms(c['fma']):.4f} ms graph-replayed (err {fma_err:.3g}); "
                  + "; ".join(f"SDPA {k} {g:.4f} ms graph-replayed, {e:.4f} events" for k, (g, e) in lib.items())
                  + f"; plain {plain:.4f} ms events; bound {bound_ms(c['b'], c['n'], c['h'], c['d']):.4f} ms",
                  flush=True)


def main(argv=None) -> int:
    variants = V.load(sys.argv[1:] if argv is None else argv,
                      Path(__file__).with_name("attention_fwd_fp32_variants.json"))
    if not torch.cuda.is_available():
        raise SystemExit("attention_fwd_fp32_variants: no CUDA device; the variants run on the card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(gpu_line(), flush=True)
    calls = cases(torch.device("cuda", 0))
    baselines(calls)
    with torch.no_grad():
        for name, log in V.builds("attention_fwd_fp32", variants, A._fwd32_lib):
            times = []
            for c in calls:
                A.reset_path_launches()
                err = float((c["run"]().reshape(c["ref"].shape) - c["ref"]).abs().max())
                torch.cuda.synchronize()
                paths = [p for p, k in A.FWD_PATH_LAUNCHES.items() if k]
                kern = sum(ms for kn, ms in kernel_times(c["run"]).items() if "attn32_fwd_kernel" in kn)
                times.append(f"B={c['b']} N={c['n']} D={c['d']} {graph_ms(c['run']):.4f} ms (kernel {kern:.4f} "
                             f"profiled; err {err:.3g}, path {paths})")
            inst = "; ".join(f"DP={d}: {A.simt_forward_blocks_per_sm(d)} blocks an SM, registers, spill stores (B) "
                             f"{V.registers(log, f'attn32_fwd_kernelIfLi{d}ELb1E')}" for d in A.SIMT_HEAD_DIMS)
            print(f"{name}: " + "; ".join(times) + f"; {inst}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
