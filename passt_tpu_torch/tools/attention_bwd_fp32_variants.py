"""Time text variants of ``csrc/attention_bwd_fp32.cu`` (the attention
backward's "simt" path) on the card, all in one process, to find what sets
its time.

    python3 -m passt_tpu_torch.tools.attention_bwd_fp32_variants [VARIANTS.json] [NAME ...]

VARIANTS.json (default: ``attention_bwd_fp32_variants.json`` beside this
file) maps a variant name to a list of ``[old, new]`` text edits of
``attention_bwd_fp32.cu``; an empty list is the source as it is; NAMEs keep
only those variants. Each variant is written with the other kernel sources
to ``build/attention_bwd_fp32_variants/<name>/`` and built (one ``nvcc`` per
variant, all started together). Each is then held against the plain version
(the largest error over dq, dk and dv relative to that gradient's max|ref|;
a variant that removes work is wrong on purpose), checked to give the same
bits twice, and timed at six fp32 calls: through the ``[B, N, H, D]``
entry at B = 2, N = 474 (the fp32 training step's call) and B = 2, N = 1190
(H = 12, D = 64), and at B = 2, N = 474 with 6 heads of D = 128 and 16 of
D = 48 (the same FLOPs: the DP = 128 instance and the DP = 64 one padded),
and through the qkv entry at the convergence demo's training call B = 25,
N = 79 at H = 6, D = 32 and at H = 2, D = 96 (the DP = 96 instances): by
CUDA-graph replay, and each kernel's profiled time, with the blocks an SM
holds of each kernel at each DP (the occupancy query). Before them, from the source as it is
(:func:`baselines`): the old "fma" pair on the same call (the private path
override; graph replay and profiled), SDPA's backward with the EFFICIENT
and the MATH backend (the profiled kernel time of its forward and backward
less its forward's) and the plain version (events), with the bound. Prints
the card (nvidia-smi name and power limit), then one line per call and one
per variant with each instance's registers.
"""

from __future__ import annotations

import re
import sys
from pathlib import Path

import torch

from passt_tpu_torch.ops import attention as A
from passt_tpu_torch.tools import variants as V
from passt_tpu_torch.tools.timing import cuda_ms, gpu_line, graph_ms, kernel_ms, kernel_times

#: (B, N, H, D, entry): the fp32 training step's call, a long sequence, the
#: step's shape at D = 128 and 48, and the convergence demo's training call
#: at model.dtype=float32 at 6 heads and at 2
SHAPES = ((2, 474, 12, 64, "bnhd"), (2, 1190, 12, 64, "bnhd"), (2, 474, 6, 128, "bnhd"), (2, 474, 16, 48, "bnhd"),
          (25, 79, 6, 32, "qkv"), (25, 79, 2, 96, "qkv"))
PEAK_FP32, HBM_BYTES_PER_S = 67e12, 3.35e12  # one H100 SXM at 700 W: FMA FLOP/s, memory bytes/s


def cases(dev, shapes=SHAPES) -> list:
    """Each call's inputs (seed 0 on the card), its public entry ``run``
    (the path :func:`backward_path` picks; dq, dk, dv back), the old "fma"
    pair on the same views ``fma`` (the private path override) and the
    plain version's gradients."""
    gen = torch.Generator(device=dev).manual_seed(0)
    out = []
    for b, n, h, d, entry in shapes:
        qkv = torch.randn((b, n, 3 * h * d), device=dev, generator=gen)
        do = torch.randn((b, n, h, d), device=dev, generator=gen)
        views, scale = A._head_views(qkv, h, d), d ** -0.5
        if entry == "qkv":
            def run(qkv=qkv, do=do, h=h, d=d, scale=scale):
                dqkv = A.fused_attention_qkv_bwd(qkv, do.reshape(do.shape[0], do.shape[1], h * d), heads=h,
                                                 head_dim=d, scale=scale)
                return A._head_views(dqkv, h, d)
        else:
            run = lambda views=views, do=do, scale=scale: A.fused_attention_bwd(*views, do, scale=scale)
        dqkv_old = torch.empty_like(qkv)

        def fma(views=views, do=do, dqkv_old=dqkv_old, h=h, d=d, scale=scale):
            grads = A._head_views(dqkv_old, h, d)
            A._launch_bwd(*views, do, *grads, scale, False, path="fma")
            return grads
        out.append(dict(b=b, n=n, h=h, d=d, entry=entry, run=run, fma=fma, scale=scale, views=views, do=do,
                        ref=A.attention_bwd_plain(*views, do, scale=scale)))
    return out


def _err(got, ref) -> float:
    return max(float((g - r).abs().max() / r.abs().max()) for g, r in zip(got, ref))


def _sdpa_bwd_ms(q, k, v, do, scale) -> float:
    q, k, v = (t.detach().clone().transpose(1, 2).requires_grad_() for t in (q, k, v))
    fwd = lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, scale=scale)
    fwd_bwd = lambda: torch.autograd.grad(fwd(), (q, k, v), do.transpose(1, 2))
    return kernel_ms(fwd_bwd) - kernel_ms(fwd)


def bound_ms(b, n, h, d) -> float:
    """10 N^2 D FLOP a head over the fp32 FMA rate, or q, k, v, dO read and
    dq, dk, dv written once over the memory rate, whichever is longer."""
    return max(10.0 * n * n * d * b * h / PEAK_FP32, 4.0 * 7 * b * n * h * d / HBM_BYTES_PER_S) * 1e3


def baselines(calls) -> None:
    """One line per call: the old "fma" pair (graph replay and profiled;
    error against plain), SDPA's backward with EFFICIENT and with MATH
    (profiled), the plain version (events) and the bound."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    for c in calls:
        err = _err(c["fma"](), c["ref"])
        lib = {}
        for be in (SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH):
            with sdpa_kernel([be]):
                lib[be.name] = _sdpa_bwd_ms(*c["views"], c["do"], c["scale"])
        plain = cuda_ms(lambda: A.attention_bwd_plain(*c["views"], c["do"], scale=c["scale"]), reps=5)
        print(f"B={c['b']} N={c['n']} H={c['h']} D={c['d']} ({c['entry']} entry): old fma pair "
              f"{graph_ms(c['fma']):.4f} ms graph-replayed, {kernel_ms(c['fma']):.4f} profiled (err {err:.3g}); "
              + "; ".join(f"SDPA backward {k} {v:.4f} ms profiled" for k, v in lib.items())
              + f"; plain {plain:.4f} ms events; bound {bound_ms(c['b'], c['n'], c['h'], c['d']):.4f} ms",
              flush=True)


def main(argv=None) -> int:
    variants = V.load(sys.argv[1:] if argv is None else argv,
                      Path(__file__).with_name("attention_bwd_fp32_variants.json"))
    if not torch.cuda.is_available():
        raise SystemExit("attention_bwd_fp32_variants: no CUDA device; the variants run on the card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(gpu_line(), flush=True)
    calls = cases(torch.device("cuda", 0))
    baselines(calls)
    for name, log in V.builds("attention_bwd_fp32", variants, A._bwd32_lib):
        times = []
        for c in calls:
            A.reset_path_launches()
            got = [g.clone() for g in c["run"]()]
            again = c["run"]()
            torch.cuda.synchronize()
            paths = [p for p, k in A.BWD_PATH_LAUNCHES.items() if k]
            same = all(torch.equal(x, y) for x, y in zip(got, again))
            split = ", ".join(f"{re.search(r'bwd32_[a-z]+_kernel', kn).group(0)} {ms:.4f}"
                              for kn, ms in kernel_times(c["run"]).items() if "bwd32" in kn)
            times.append(f"B={c['b']} N={c['n']} D={c['d']} {graph_ms(c['run']):.4f} ms ({split}; err "
                         f"{_err(got, c['ref']):.3g}, {'same bits' if same else 'BITS DIFFER'}, path {paths})")
        inst = "; ".join(
            f"DP={d}: blocks an SM (S, KV) {A.simt_backward_blocks_per_sm(d)}, registers, spill stores (B) "
            + ", ".join(f"{k_} {V.registers(log, f'{k_}IfLi{d}ELb1E')}" for k_ in ("bwd32_stats_kernel", "bwd32_kv_kernel"))
            for d in A.SIMT_HEAD_DIMS)
        print(f"{name}: " + "; ".join(times) + f"; {inst}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
