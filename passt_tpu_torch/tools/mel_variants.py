"""Time text variants of ``csrc/mel_kernel.cu`` (the FFT mel kernel) on the
card, all in one process, to find what sets its time.

    python3 -m passt_tpu_torch.tools.mel_variants [VARIANTS.json]

VARIANTS.json (default: ``mel_variants.json`` beside this file) maps a
variant name to a list of ``[old, new]`` text edits of ``mel_kernel.cu``; an
empty list is the source as it is. The committed file removes the FFT
passes, the mel stage, or everything but the staging of the samples and the
output's store. Each variant is built beside the others (``tools/variants``),
held against the plain version (max error; a variant that removes work is
wrong on purpose) and timed at B = 20 x 10 s, hop 320: the wrapper by
CUDA-graph replay, the kernels alone by profiled kernel time. Prints the
card (nvidia-smi name and power limit), then one line per variant.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

from passt_tpu_torch.ops import mel_kernel as K
from passt_tpu_torch.ops.mel import kaldi_mel_banks
from passt_tpu_torch.tools import variants as V
from passt_tpu_torch.tools.timing import gpu_line, graph_ms, kernel_times


def main(argv=None) -> int:
    variants = V.load(sys.argv[1:] if argv is None else argv, Path(__file__).with_name("mel_variants.json"))
    if not torch.cuda.is_available():
        raise SystemExit("mel_variants: no CUDA device; the variants run on the card only")
    dev = torch.device("cuda", 0)
    wave = torch.from_numpy(np.random.default_rng(0).standard_normal((20, 320000)).astype(np.float32)).to(dev)
    bank = kaldi_mel_banks(128, 1024, 32000, 0.0, 15000.0, device=dev)
    ref = K.fused_log_mel_plain(wave, bank)
    print(gpu_line(), flush=True)

    for name, log in V.builds("mel_kernel", variants, K._lib):
        got = K.fused_log_mel(wave, bank)
        torch.cuda.synchronize()
        err = float((got - ref).abs().nan_to_num(float("inf")).max())
        ms = graph_ms(lambda: K.fused_log_mel(wave, bank))
        kernels = kernel_times(lambda: K.fused_log_mel(wave, bank))
        print(f"{name}: wrapper {ms:.4f} ms graph-replayed, kernels {sum(kernels.values()):.4f} ms profiled ("
              + ", ".join(f"{k[:40]} {v:.4f}" for k, v in kernels.items())
              + f"); max err {err:.3g}; registers, spill stores (B) {V.registers(log, 'log_mel_fft_kernel')}",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
