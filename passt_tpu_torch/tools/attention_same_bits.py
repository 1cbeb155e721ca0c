"""The attention kernels' outputs on fixed inputs, saved, or held bit for bit
against a saved set: shows that a change to the kernel sources left a path's
bits as they were.

    python3 passt_tpu_torch/tools/attention_same_bits.py --root DIR --save OUT.pt
    python3 passt_tpu_torch/tools/attention_same_bits.py --root . --compare OUT.pt

``--root`` names the checkout whose ``passt_tpu_torch`` runs (e.g. a
``git archive`` of the parent commit unpacked under ``build/``); the script
is run by its path, so that package is the only one imported. The inputs
are made from seed 0 on the card: the bf16 and fp16 forward at D = 64 on its
"wgmma" path (the serving shape B = 20, N = 1190 on the [B, N, H, D] entry;
the training shape B = 12, N = 474 and N = 65, 129 on the qkv entry, plus1
on and off) and its "short" path (B = 256, N = 14), the fp32 "simt" forward,
the bf16 "wgmma" backward (B = 12, N = 474, plus1 on and off) and the fp32
"simt" backward (B = 2, N = 474), 12 heads; and the fp32 "simt" forward and
backward at D = 32 on the qkv entry at the convergence demo's shapes (6
heads; the forward at B = 25, N = 79 and B = 50, N = 110, the backward at
B = 25, N = 79; plus1 on and off); and the "simt" kernels' padded and
half-precision instances (their own generator, seed 23): fp32 at 2 heads
of D = 96 (the demo's shapes), 6 of D = 128 and 16 of D = 48 (B = 2,
N = 474), 8 of D = 24 in fp32, bf16 and fp16 (B = 25, N = 79), and fp32
and bf16 on views one element off 16-byte alignment (B = 2, N = 474,
12 heads of D = 64), forward and backward; and the "wgmma" instances at
padded head dims (their own generator, seed 24): bf16 at B = 2, N = 474,
6 heads of D = 128, 8 of D = 96, 16 of D = 48 and 48 of D = 16, forward
and backward, and the D = 32 backward at N = 200 (6 heads), plus1 on and
off (an older checkout runs these on its "mma" path, so a saved set of its
differs there). Every output is made twice and
must have the same bits both times. ``--compare`` prints each output's
name and whether its bits are equal to the saved one's, names the outputs
the saved set lacks (new cases: an older checkout's set), and exits
non-zero unless every saved output is made again with the same bits.
Runs on the card only.
"""

from __future__ import annotations

import argparse
import os
import sys


def outputs(dev) -> dict:
    """Every case's output, by name, from the imported package's kernels."""
    import torch

    from passt_tpu_torch.ops import attention as A

    gen = torch.Generator(device=dev).manual_seed(0)
    h, d, out = 12, 64, {}

    def qkv(b, n, dtype):
        return torch.randn((b, n, 3 * h * d), device=dev, generator=gen).to(dtype)

    with torch.no_grad():
        for dtype in (torch.bfloat16, torch.float16, torch.float32):
            tag = str(dtype)[6:]
            x = qkv(20, 1190, dtype)
            q, k, v = x.reshape(20, 1190, 3, h, d).unbind(2)
            out[f"fwd {tag} bnhd B=20 N=1190"] = A.fused_attention(q, k, v, scale=d ** -0.5)
            for b, n in ((12, 474), (2, 65), (2, 129), (256, 14)):
                x = qkv(b, n, dtype)
                for plus1 in (False, True):
                    out[f"fwd {tag} qkv B={b} N={n} plus1={plus1}"] = A.fused_attention_qkv(
                        x, heads=h, head_dim=d, scale=d ** -0.5, plus1=plus1)
    for dtype, b in ((torch.bfloat16, 12), (torch.float32, 2)):
        x = qkv(b, 474, dtype)
        do = torch.randn((b, 474, h * d), device=dev, generator=gen).to(dtype)
        for plus1 in (False, True):
            out[f"bwd {str(dtype)[6:]} qkv B={b} N=474 plus1={plus1}"] = A.fused_attention_qkv_bwd(
                x, do, heads=h, head_dim=d, scale=d ** -0.5, plus1=plus1)
    # the fp32 "simt" instances at D = 32 (its own generator: the cases
    # above draw the same numbers as before)
    gen32 = torch.Generator(device=dev).manual_seed(32)
    h32, d32 = 6, 32
    for b, n in ((25, 79), (50, 110)):
        x = torch.randn((b, n, 3 * h32 * d32), device=dev, generator=gen32)
        for plus1 in (False, True):
            with torch.no_grad():
                out[f"fwd float32 D=32 qkv B={b} N={n} plus1={plus1}"] = A.fused_attention_qkv(
                    x, heads=h32, head_dim=d32, scale=d32 ** -0.5, plus1=plus1)
            if b == 25:
                do = torch.randn((b, n, h32 * d32), device=dev, generator=gen32)
                out[f"bwd float32 D=32 qkv B={b} N={n} plus1={plus1}"] = A.fused_attention_qkv_bwd(
                    x, do, heads=h32, head_dim=d32, scale=d32 ** -0.5, plus1=plus1)
    # the "simt" instances at padded head dims, in bf16 / fp16 at D = 24 and
    # on unaligned views (a generator of their own: the cases above draw
    # the same numbers as before)
    gen23 = torch.Generator(device=dev).manual_seed(23)
    cases = [(torch.float32, 25, 79, 2, 96, True), (torch.float32, 50, 110, 2, 96, True),
             (torch.float32, 2, 474, 6, 128, True), (torch.float32, 2, 474, 16, 48, True)]
    cases += [(dt, 25, 79, 8, 24, True) for dt in (torch.float32, torch.bfloat16, torch.float16)]
    cases += [(dt, 2, 474, 12, 64, False) for dt in (torch.float32, torch.bfloat16)]
    for dtype, b, n, hh, dd, aligned in cases:
        x = torch.randn((b, n, 3 * hh * dd), device=dev, generator=gen23).to(dtype)
        do = torch.randn((b, n, hh * dd), device=dev, generator=gen23).to(dtype)
        if not aligned:
            x = torch.empty(x.numel() + 1, dtype=dtype, device=dev)[1:].view(x.shape).copy_(x)
        tag = f"{str(dtype)[6:]} D={dd} qkv B={b} N={n}" + ("" if aligned else " unaligned")
        for plus1 in (False, True):
            with torch.no_grad():
                out[f"fwd simt {tag} plus1={plus1}"] = A.fused_attention_qkv(
                    x, heads=hh, head_dim=dd, scale=dd ** -0.5, plus1=plus1)
            if b != 50:
                out[f"bwd simt {tag} plus1={plus1}"] = A.fused_attention_qkv_bwd(
                    x, do, heads=hh, head_dim=dd, scale=dd ** -0.5, plus1=plus1)
    # the "wgmma" instances at padded head dims (C = 768: 6 heads of D = 128,
    # 8 of 96, 16 of 48, 48 of 16) and the D = 32 backward above the
    # "resident" path's N (a generator of their own, seed 24)
    gen24 = torch.Generator(device=dev).manual_seed(24)
    for hh, dd, n in ((6, 128, 474), (8, 96, 474), (16, 48, 474), (48, 16, 474), (6, 32, 200)):
        x = torch.randn((2, n, 3 * hh * dd), device=dev, generator=gen24).to(torch.bfloat16)
        do = torch.randn((2, n, hh * dd), device=dev, generator=gen24).to(torch.bfloat16)
        tag = f"bfloat16 D={dd} qkv B=2 N={n}"
        for plus1 in (False, True):
            if dd != 32:
                with torch.no_grad():
                    out[f"fwd wgmma {tag} plus1={plus1}"] = A.fused_attention_qkv(
                        x, heads=hh, head_dim=dd, scale=dd ** -0.5, plus1=plus1)
            out[f"bwd wgmma {tag} plus1={plus1}"] = A.fused_attention_qkv_bwd(
                x, do, heads=hh, head_dim=dd, scale=dd ** -0.5, plus1=plus1)
    torch.cuda.synchronize()
    return {k: v.cpu() for k, v in out.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True, help="the checkout whose passt_tpu_torch runs")
    what = ap.add_mutually_exclusive_group(required=True)
    what.add_argument("--save", help="write the outputs here")
    what.add_argument("--compare", help="hold the outputs against this saved set")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("attention_same_bits: no CUDA device; the kernels run on the card only")
    from passt_tpu_torch.ops import attention as A
    from passt_tpu_torch.tools.timing import gpu_line

    print(gpu_line(), f"(package {os.path.dirname(A.__file__)})", flush=True)
    got = outputs(torch.device("cuda", 0))
    again = outputs(torch.device("cuda", 0))
    differ = sorted(k for k in got if not torch.equal(got[k], again[k]))
    print(f"{len(got) - len(differ)} of {len(got)} outputs the same bits on a second run; differ: "
          f"{differ or 'none'}", flush=True)
    if differ:
        return 1
    if args.save:
        torch.save(got, args.save)
        print(f"saved {len(got)} outputs to {args.save}", flush=True)
        return 0
    saved = torch.load(args.compare)
    same = {k: torch.equal(got[k], v) for k, v in saved.items() if k in got}
    for k, ok in same.items():
        print(f"{k}: {'same bits' if ok else 'BITS DIFFER'}", flush=True)
    new, missing = sorted(set(got) - set(saved)), sorted(set(saved) - set(got))
    print(f"{sum(same.values())} of {len(saved)} saved outputs bit-equal to {args.compare}; not made: "
          f"{missing or 'none'}; new (not in the saved set): {new or 'none'}", flush=True)
    return 0 if all(same.values()) and not missing else 1


if __name__ == "__main__":
    raise SystemExit(main())
