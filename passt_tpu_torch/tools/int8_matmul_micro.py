"""int8 and bf16 matmul rates of the int8 GEMM kernel on the card, beside
the library's.

    python3 -m passt_tpu_torch.tools.int8_matmul_micro

Port of scripts/int8_matmul_micro.py. At the model's matmul shapes
([5688, 768] x [768, 2304] qkv, the two MLP shapes) and at 8192^3 it runs
``int8_matmul`` (``csrc/int8_gemm.cu``'s ``wgmma`` loop, RAW epilogue) in
int8 (-> int32) and in bf16 (-> bf16), checks first that the int8 product is
bit-equal to its exact plain version, and times both with CUDA-graph
replays beside two library yardsticks of the same shapes: ``torch._int_mm``
(int8 -> int32) and ``torch.matmul`` (bf16). The B operand is the transpose
of a contiguous [N, K] tensor, the layout the kernel (and cuBLASLt's int8
path) reads without a copy. Prints the card, then one JSON block: TOP/s of
each and ``int8_vs_best_bf16`` (the kernel's int8 rate over the better bf16
rate). Runs on the card and raises without one; ``run(device="cpu")`` runs
the exactness check at any size and prints "not measured" for the rates.
"""

from __future__ import annotations

import json
from typing import Dict

import torch

from passt_tpu_torch.ops.int8 import int8_matmul, int8_matmul_plain
from passt_tpu_torch.tools.timing import gpu_line, graph_ms

#: label -> (m, k, n), the JAX script's shapes (M unpadded: the kernel takes
#: any M)
SHAPES = {
    "qkv_5688x768x2304": (5688, 768, 2304),
    "mlp1_5688x768x3072": (5688, 768, 3072),
    "mlp2_5688x3072x768": (5688, 3072, 768),
    "square_8192": (8192, 8192, 8192),
}


def run(device="cuda", shapes: Dict[str, tuple] = SHAPES) -> Dict:
    """Check and time each shape; prints and returns the results."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("int8_matmul_micro runs on a CUDA device and found none "
                           "(device='cpu' runs the check untimed)")
    print(f"device: {gpu_line() if device.type == 'cuda' else 'cpu'}", flush=True)
    gen = torch.Generator(device=device).manual_seed(0)
    results: Dict = {}
    for label, (m, k, n) in shapes.items():
        a8 = torch.randint(-127, 128, (m, k), generator=gen, device=device, dtype=torch.int8)
        b8 = torch.randint(-127, 128, (n, k), generator=gen, device=device, dtype=torch.int8).t()
        abf = torch.randn((m, k), generator=gen, device=device).to(torch.bfloat16)
        bbf = torch.randn((n, k), generator=gen, device=device).to(torch.bfloat16).t()
        got = int8_matmul(a8, b8, torch.int32)
        if not torch.equal(got, int8_matmul_plain(a8, b8, torch.int32)):
            raise RuntimeError(f"{label}: int8 kernel wrong")
        calls = {
            "kernel_int8": lambda: int8_matmul(a8, b8, torch.int32),
            "kernel_bf16": lambda: int8_matmul(abf, bbf, torch.bfloat16),
            "torch_int8": lambda: torch._int_mm(a8, b8),
            "torch_bf16": lambda: torch.matmul(abf, bbf),
        }
        for name, fn in calls.items():
            if device.type != "cuda":
                results[f"{label}_{name}_tops"] = "not measured"
                continue
            ms = graph_ms(fn, reps=5 if m >= 8192 else 20)
            results[f"{label}_{name}_tops"] = 2.0 * m * k * n / (ms * 1e-3) / 1e12
        best_bf16 = [results[f"{label}_{b}_tops"] for b in ("kernel_bf16", "torch_bf16")]
        results[f"{label}_int8_vs_best_bf16"] = (
            results[f"{label}_kernel_int8_tops"] / max(best_bf16) if device.type == "cuda" else "not measured")
    print(json.dumps(results, indent=2), flush=True)
    return results


def main() -> int:
    run()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
