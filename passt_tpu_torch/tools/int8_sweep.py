"""Tile sweep of the int8 GEMM's wgmma main loop on the card.

    python3 -m passt_tpu_torch.tools.int8_sweep

Port of scripts/int8_sweep.py, which sweeps the block sizes of the Pallas
int8 matmul. Here the tile is a template parameter of ``csrc/int8_gemm.cu``
and only the compiled ones exist (``ops/int8.py`` ``TILES``), so the sweep
runs ``int8_matmul`` on each of them at the script's shapes: 5696 x 768 x
2304 (the qkv product at the script's padded M) in int8, and 8192^3 in int8
and in bf16. Each int8 tile is first checked bit-equal to the exact product.
Times are CUDA-graph replays (CUDA events at 8192^3), beside
``torch._int_mm`` (int8 -> int32) and ``torch.matmul`` (bf16), and the tile
``pick_tile`` chooses for the shape. Prints the card's name and power limit
first, then one line per shape and dtype and one JSON block. Runs on the
card and raises without one; ``run(device="cpu")`` runs the checks through
the plain version and prints "not measured" for the rates.
"""

from __future__ import annotations

import json
from typing import Dict

import torch

from passt_tpu_torch.ops import _build
from passt_tpu_torch.ops.int8 import TILES, int8_matmul, int8_matmul_plain, pick_tile
from passt_tpu_torch.tools.timing import cuda_ms, gpu_line, graph_ms

#: label -> (m, k, n, dtypes), scripts/int8_sweep.py's shapes
SHAPES = {
    "qkv_5696x768x2304": (5696, 768, 2304, (torch.int8,)),
    "square_8192": (8192, 8192, 8192, (torch.int8, torch.bfloat16)),
}


def _operands(m, k, n, dtype, gen, device):
    """a [m, k] and b [k, n] (the transpose of a contiguous [n, k])."""
    if dtype == torch.int8:
        a = torch.randint(-127, 128, (m, k), generator=gen, device=device, dtype=torch.int8)
        bt = torch.randint(-127, 128, (n, k), generator=gen, device=device, dtype=torch.int8)
    else:
        a = torch.randn((m, k), generator=gen, device=device).to(dtype)
        bt = torch.randn((n, k), generator=gen, device=device).to(dtype)
    return a, bt.t()


def run(device="cuda", shapes: Dict[str, tuple] = SHAPES) -> Dict:
    """Check and time each compiled tile at each shape; prints and returns
    the results (TOP/s by ``<label>_<dtype>_<tile or library>``)."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("int8_sweep runs on a CUDA device and found none (device='cpu' runs the checks untimed)")
    print(f"device: {gpu_line() if on_card else 'cpu'}", flush=True)
    sms = _build.sm_count(device) if on_card else 132
    gen = torch.Generator(device=device).manual_seed(0)
    results: Dict = {}
    for label, (m, k, n, dtypes) in shapes.items():
        ops = 2.0 * m * k * n
        timer = (lambda fn: cuda_ms(fn, reps=5)) if m * k * n >= 8192**3 else graph_ms
        for dtype in dtypes:
            a, b = _operands(m, k, n, dtype, gen, device)
            name = str(dtype)[6:]
            out = torch.int32 if dtype == torch.int8 else torch.bfloat16
            if dtype == torch.int8:
                ref = int8_matmul_plain(a, b, out)
                for i, tile in enumerate(TILES):
                    if not torch.equal(int8_matmul(a, b, out, _tile=i), ref):
                        raise RuntimeError(f"{label} tile {tile}: the int8 product is wrong")
            calls = {f"{bm}x{bn}": (lambda i=i: int8_matmul(a, b, out, _tile=i)) for i, (bm, bn) in enumerate(TILES)}
            calls["library"] = (lambda: torch._int_mm(a, b)) if dtype == torch.int8 else (lambda: torch.matmul(a, b))
            rates = {key: (ops / (timer(fn) * 1e-3) / 1e12 if on_card else "not measured") for key, fn in calls.items()}
            for key, rate in rates.items():
                results[f"{label}_{name}_{key}_tops"] = rate
            results[f"{label}_picked_tile"] = "x".join(map(str, TILES[pick_tile(m, n, sms, gelu=False)]))
            library = "torch._int_mm" if dtype == torch.int8 else "torch.matmul"
            shown = ", ".join(f"{key.replace('library', library)} "
                              + (f"{r:.1f}" if isinstance(r, float) else r) for key, r in rates.items())
            print(f"{label} {name}: TOP/s {shown}; pick_tile chooses {results[f'{label}_picked_tile']}", flush=True)
    print(json.dumps(results, indent=2), flush=True)
    return results


def main() -> int:
    run()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
