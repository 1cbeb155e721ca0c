"""A/B of the fused PaSST-S MLP on the card: the plain composition against
the fused-MLP kernels, forward and forward + backward.

    python3 -m passt_tpu_torch.tools.proto_mlp_fused

Port of scripts/proto_mlp_fused.py:main. Variants:

  xla     the prototype's composition: each Dense the fp32 sum plus the fp32
          bias, rounded once to x's dtype (``torch.addmm``); h rounded before
          the port's ``tanh_gelu`` (saved-derivative backward)
  fuse_f  the fused forward without residuals (``fused_mlp`` without grad):
          y only, h and g never in device memory
  fuse    the fused forward with residuals g and d, and the plain fp32
          backward products for dx and dh
  fuse2   fuse with the fused backward kernel for dx and dh

Inputs as the prototype's: x ~ N(0, 1) and weights 0.02 N(0, 1), all
bfloat16, zero bfloat16 biases, C = 768, H = 3072, from seed 0. For each
token count M (12 x 474 = 5688 in training, 12 x 1190 = 14280 in eval) it
prints fuse_f's and fuse's forward against xla (max error), fuse's and
fuse2's gradients of all five arguments of mean(y^2) against xla (the
largest max error relative to max|xla|), the ms of each variant (the best
of 3 CUDA-event timings of back-to-back eager calls), the kernel's row block, and fuse_f's peak
memory growth beside the size of one [M, H] tensor. Runs on the card and
raises without one; ``run(device="cpu")`` runs the same checks untimed and
prints "not measured" for the times and the memory.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from passt_tpu_torch.ops.activations import tanh_gelu
from passt_tpu_torch.ops.fused_mlp import fused_mlp, row_block
from passt_tpu_torch.tools.timing import cuda_ms, gpu_line

C, H = 768, 3072
SIZES = (5688, 14280)
WARMUP, FWD_REPS, FWDBWD_REPS, TRIALS = 2, 20, 10, 3


def _bf16(a, device):
    return torch.from_numpy(np.asarray(a, np.float32)).to(device, torch.bfloat16)


def make_weights(rng: np.random.Generator, device):
    """w1 [C, H], b1 [H], w2 [H, C], b2 [C] in bf16 on ``device``, drawn once
    as the prototype draws them."""
    w1 = _bf16(rng.standard_normal((C, H)) * 0.02, device)
    w2 = _bf16(rng.standard_normal((H, C)) * 0.02, device)
    zeros = lambda n: torch.zeros(n, device=device, dtype=torch.bfloat16)  # noqa: E731
    return w1, zeros(H), w2, zeros(C)


def dense(x, w, b):
    """The prototype's Dense: the fp32 sum plus the fp32 bias, rounded once
    to x's dtype (``addmm`` adds the bias before its one rounding, on the
    CPU as in cuBLAS's epilogue)."""
    return torch.addmm(b, x, w)


def xla_mlp(x, w1, b1, w2, b2):
    """The prototype's ``xla_mlp``: h rounded before the GELU."""
    return dense(tanh_gelu(dense(x, w1, b1)), w2, b2)


def _grads(fn, args):
    """A call computing the gradients of all five arguments of mean(fn^2)."""
    leaves = [t.detach().clone().requires_grad_() for t in args]

    def call():
        return torch.autograd.grad((fn(*leaves).float() ** 2).mean(), leaves)

    return call


def _best_ms(fn, reps: int) -> float:
    """The best of TRIALS CUDA-event timings of ``reps`` back-to-back calls
    (the prototype's harness also keeps the best of 3): the eager calls are
    host-bound, and the host's share varies from run to run."""
    return min(cuda_ms(fn, reps=reps, warmup=WARMUP) for _ in range(TRIALS))


def _rel(ref: torch.Tensor, got: torch.Tensor) -> float:
    ref, got = ref.float(), got.float()
    return float((ref - got).abs().max()) / (float(ref.abs().max()) + 1e-9)


def measure(x: torch.Tensor, weights) -> Dict:
    """The errors and, on a card, the times and fuse_f's memory growth at
    x's token count. ``fwd_calls`` and ``bwd_calls`` count the fused kernel
    calls made (one launch each on a card)."""
    device, m = x.device, x.shape[0]
    args = (x, *weights)
    calls = {"fwd": 0, "bwd": 0}

    def counted(fused_bwd, grad):
        def fn(*a):
            calls["fwd"] += 1
            calls["bwd"] += int(fused_bwd and grad)
            return fused_mlp(*a, fused_bwd=fused_bwd)
        return fn

    fuse_f = counted(False, False)
    fuse, fuse2 = counted(False, True), counted(True, True)
    with torch.no_grad():
        y_ref = xla_mlp(*args)
        y_f = fuse_f(*args)
    gx = _grads(xla_mlp, args)()
    leaves = [t.detach().clone().requires_grad_() for t in args]
    y_fuse = fuse(*leaves).detach()  # with grad: the forward that writes the residuals
    res = dict(M=m, row_block=row_block(m) if device.type == "cuda" else "none (the plain version)",
               fwd_err_fuse_f=float((y_f.float() - y_ref.float()).abs().max()),
               fwd_err_fuse=float((y_fuse.float() - y_ref.float()).abs().max()),
               y_max=float(y_ref.float().abs().max()))
    del y_fuse, leaves
    for tag, fn in (("fuse", fuse), ("fuse2", fuse2)):
        res[f"grad_rel_{tag}"] = max(_rel(a, b) for a, b in zip(gx, _grads(fn, args)()))

    if device.type != "cuda":
        for key in ("fwd_ms_xla", "fwd_ms_fuse_f", "fwdbwd_ms_xla", "fwdbwd_ms_fuse", "fwdbwd_ms_fuse2",
                    "fuse_f_peak_growth"):
            res[key] = "not measured"
    else:
        with torch.no_grad():
            res["fwd_ms_xla"] = _best_ms(lambda: xla_mlp(*args), FWD_REPS)
            res["fwd_ms_fuse_f"] = _best_ms(lambda: fuse_f(*args), FWD_REPS)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            base = torch.cuda.memory_allocated(device)
            y = fuse_f(*args)
            torch.cuda.synchronize()
            res["fuse_f_peak_growth"] = torch.cuda.max_memory_allocated(device) - base
            del y
        for tag, fn in (("xla", xla_mlp), ("fuse", fuse), ("fuse2", fuse2)):
            res[f"fwdbwd_ms_{tag}"] = _best_ms(_grads(fn, args), FWDBWD_REPS)
    res["hidden_bytes"] = m * H * 2
    res["fwd_calls"], res["bwd_calls"] = calls["fwd"], calls["bwd"]
    return res


def _ms(v) -> str:
    return f"{v:.4f} ms" if isinstance(v, float) else str(v)


def run(device="cuda", sizes: Sequence[int] = SIZES) -> List[Dict]:
    """Measure at each M in ``sizes`` and print the results; returns them."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("proto_mlp_fused runs on a CUDA device and found none (device='cpu' runs it untimed)")
    print(f"device: {gpu_line() if device.type == 'cuda' else 'cpu'}", flush=True)
    rng = np.random.default_rng(0)
    weights = make_weights(rng, device)
    results = []
    for m in sizes:
        r = measure(_bf16(rng.standard_normal((m, C)), device), weights)
        print(f"M={m} (kernel row block {r['row_block']}): fwd max err vs xla: fuse_f {r['fwd_err_fuse_f']:.4g}, "
              f"fuse {r['fwd_err_fuse']:.4g} (max|y| {r['y_max']:.4g}); grad rel err vs xla: fuse "
              f"{r['grad_rel_fuse']:.3g}, fuse2 {r['grad_rel_fuse2']:.3g}", flush=True)
        print(f"M={m} fwd: xla {_ms(r['fwd_ms_xla'])}, fuse_f {_ms(r['fwd_ms_fuse_f'])}; fwd+bwd: xla "
              f"{_ms(r['fwdbwd_ms_xla'])}, fuse {_ms(r['fwdbwd_ms_fuse'])}, fuse2 {_ms(r['fwdbwd_ms_fuse2'])}; "
              f"fuse_f peak memory growth {r['fuse_f_peak_growth']} B (one [M, {H}] bf16 tensor: "
              f"{r['hidden_bytes']} B)", flush=True)
        results.append(r)
    return results


def main() -> int:
    run()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
