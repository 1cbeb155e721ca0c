"""A/B of the PaSST-S MLP on the card: bf16 against int8, forward and
forward + backward.

    python3 -m passt_tpu_torch.tools.ab_int8_mlp

Port of scripts/ab_int8_mlp.py. The bf16 MLP is built from the port's own
pieces: each Dense in the ``Linear`` rounding order (the product rounded to
bf16, then the bias added in bf16) and ``ops/activations.tanh_gelu``. The
int8 MLP is ``int8_dense_gelu`` (fc1, the GELU in the kernel's epilogue) then
``int8_dense`` (fc2), both the int8 Dense kernel with the straight-through
backward. Inputs as the JAX script's: x ~ N(0, 1) in bf16, weights 0.02 N(0,
1) in bf16 ([768, 3072] and [3072, 768]), fp32 zero biases, from seed 0.

For each token count M (12 x 474 = 5688 in training, 12 x 1190 = 14280 in
eval) it prints the int8 MLP's error against the bf16 one (mean|int8 - bf16|
/ mean|y| and the correlation), each int8 layer's error against its exact
fp32 function on the same input (``mean|int8 - exact|``, beside the limit
``0.02 mean|exact| + 1e-3`` of tests/test_int8_dense.py), and the ms of both
MLPs forward and forward + backward (the gradients of x, w1 and w2 of
mean(y^2)), CUDA-event timed over back-to-back eager calls. Runs on the card
and raises without one; ``run(device="cpu")`` runs the same checks untimed
at any M and prints "not measured" for the times.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from passt_tpu_torch.ops.activations import tanh_gelu
from passt_tpu_torch.ops.int8 import int8_dense, int8_dense_gelu
from passt_tpu_torch.tools.timing import cuda_ms, gpu_line

C, H = 768, 3072
SIZES = (5688, 14280)
WARMUP, FWD_REPS, FWDBWD_REPS = 2, 20, 10


def make_args(m: int, rng: np.random.Generator, device):
    """x [m, C] bf16, w1 [C, H] and w2 [H, C] bf16, b1 and b2 fp32 zeros, on
    ``device``."""
    def bf16(a):
        return torch.from_numpy(a.astype(np.float32)).to(device, torch.bfloat16)

    x = bf16(rng.standard_normal((m, C)))
    w1 = bf16(rng.standard_normal((C, H)) * 0.02)
    w2 = bf16(rng.standard_normal((H, C)) * 0.02)
    return x, w1, torch.zeros(H, device=device), w2, torch.zeros(C, device=device)


def dense_bf16(x, w, b):
    """A Dense in the port's ``Linear`` order: the product rounded to x's
    dtype, then the bias added in that dtype."""
    return torch.matmul(x, w) + b.to(x.dtype)


def mlp_bf16(x, w1, b1, w2, b2):
    return dense_bf16(tanh_gelu(dense_bf16(x, w1, b1)), w2, b2)


def mlp_int8(x, w1, b1, w2, b2):
    return int8_dense(int8_dense_gelu(x, w1, b1), w2, b2)


def _fwd_bwd(fn, args):
    """A call computing the gradients of x, w1 and w2 of mean(fn(...)^2)."""
    x, w1, b1, w2, b2 = args
    leaves = [t.detach().clone().requires_grad_() for t in (x, w1, w2)]

    def call():
        y = fn(leaves[0], leaves[1], b1, leaves[2], b2)
        return torch.autograd.grad((y.float() ** 2).mean(), leaves)

    return call


def _err(got: torch.Tensor, exact: torch.Tensor):
    """mean|got - exact| and its limit, 0.02 mean|exact| + 1e-3."""
    got, exact = got.float(), exact.float()
    return float((got - exact).abs().mean()), 0.02 * float(exact.abs().mean()) + 1e-3


def measure(m: int, rng: np.random.Generator, device) -> Dict:
    """The errors and, on a card, the times at M = m. ``int8_forwards``
    counts the int8 MLP forwards run (one launch of each int8 kernel each)."""
    device = torch.device(device)
    args = make_args(m, rng, device)
    x, w1, b1, w2, b2 = args
    calls = [0]

    def int8_fn(*a):
        calls[0] += 1
        return mlp_int8(*a)

    with torch.no_grad():
        yb = mlp_bf16(*args).float()
        yi = int8_fn(*args).float()
        h = int8_dense_gelu(x, w1, b1)
        y2 = int8_dense(h, w2, b2)
        calls[0] += 1
        fc1 = _err(h, F.gelu(x.float() @ w1.float() + b1, approximate="tanh"))
        fc2 = _err(y2, h.float() @ w2.float() + b2)
    res = dict(M=m, rel_err=float((yi - yb).abs().mean() / yb.abs().mean()),
               corr=float(torch.corrcoef(torch.stack([yb.ravel(), yi.ravel()]))[0, 1]),
               fc1_err=fc1[0], fc1_limit=fc1[1], fc2_err=fc2[0], fc2_limit=fc2[1])
    for tag, fn in (("bf16", mlp_bf16), ("int8", int8_fn)):
        if device.type != "cuda":
            res[f"fwd_ms_{tag}"] = res[f"fwdbwd_ms_{tag}"] = "not measured"
            continue
        with torch.no_grad():
            res[f"fwd_ms_{tag}"] = cuda_ms(lambda: fn(*args), reps=FWD_REPS, warmup=WARMUP)
        res[f"fwdbwd_ms_{tag}"] = cuda_ms(_fwd_bwd(fn, args), reps=FWDBWD_REPS, warmup=WARMUP)
    res["int8_forwards"] = calls[0]
    return res


def _ms(v) -> str:
    return f"{v:.4f} ms" if isinstance(v, float) else str(v)


def run(device="cuda", sizes: Sequence[int] = SIZES) -> List[Dict]:
    """Measure at each M in ``sizes`` and print the results; returns them."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("ab_int8_mlp runs on a CUDA device and found none (device='cpu' runs it untimed)")
    print(f"device: {gpu_line() if device.type == 'cuda' else 'cpu'}", flush=True)
    rng = np.random.default_rng(0)
    results = []
    for m in sizes:
        r = measure(m, rng, device)
        print(f"M={m}: mean |int8-bf16| / mean|y| = {r['rel_err']:.4f}, corr = {r['corr']:.6f}; "
              f"mean |int8-exact|: fc1 {r['fc1_err']:.5f} (limit {r['fc1_limit']:.5f}), "
              f"fc2 {r['fc2_err']:.5f} (limit {r['fc2_limit']:.5f})", flush=True)
        print(f"M={m} fwd: bf16 {_ms(r['fwd_ms_bf16'])}, int8 {_ms(r['fwd_ms_int8'])}; fwd+bwd: bf16 "
              f"{_ms(r['fwdbwd_ms_bf16'])}, int8 {_ms(r['fwdbwd_ms_int8'])}", flush=True)
        results.append(r)
    return results


def main() -> int:
    run()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
