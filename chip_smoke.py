"""Smoke run of the PyTorch/CUDA port (passt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints one line or more; the first failure exits non-zero):

1. a CUDA device is present; its name and power limit (nvidia-smi);
2. the Hopper kernels build from ``passt_tpu_torch/csrc`` (one nvcc per
   source, all started together);
3. each forward kernel against its plain PyTorch version on the card, at
   the shapes the serving and training paths give it, with its time, the
   plain time, one library call's time where one computes the function,
   and the bound; the FFT mel kernel at hops 320, 160 and 100, on 10-s and
   2-s clips, a wave one sample longer than the reflect padding needs, a
   jittered bank, a bank with an all-zero row, and at every other n_fft it
   is built for (64, 128, 256, 512 with win 400, 2048) (the wrapper timed by
   CUDA-graph replay, its two kernels by profiled kernel time, beside the
   cuFFT composition of the same function); the attention forward on each of its three paths (every
   call checked to take the one ``forward_path`` picks, never "fma" or "mma"; fp32
   at D = 64 on "simt" from N = 1 to 1190 and at D = 32 from N = 1 to 200,
   fp32 at another D and every unaligned view on "simt"), timed by CUDA-graph
   replay and by events at the serving (B = 20, N = 1190), timestamp
   (B = 256, N = 14) and training (B = 12, N = 474) shapes beside SDPA as
   PyTorch dispatches it (the kernel it ran named from a profiler trace)
   and each SDPA backend that accepts the inputs, timed alone;
3b. the attention backward kernel through both entries against its plain
   version (bf16/fp16/fp32, plus1 on and off, ragged N, other head dims;
   every call checked to take the path ``backward_path`` picks, the
   "wgmma" and "simt" paths' bits checked equal run to run), timed at the
   training step's shapes (graph replay, events and profiled kernel time)
   beside the old pair on the same call ("mma" for bf16, "fma" for fp32; never dispatched)
   and SDPA's backward (the profiled kernel time of its forward and
   backward less its forward's, and events); then the "simt" kernels'
   instances (templates on the dtype and the head dim padded to DP = 32,
   64, 96, 128) over a sweep, forward and backward through both entries
   against the plain versions: fp32 at every D from 8 to 128 by 8, bf16
   and fp16 at D = 24, 40 and 120, each aligned and one element off, N 1,
   63, 64, 65, 97, 129 and 474, plus1 on and off, every call on "simt",
   the backward's bits equal on a second call; and timed through the qkv
   entry (forward by graph replay, backward also by profiled kernel time)
   at fp32 B = 2, N = 474 with 6 heads of D = 128 and 16 of D = 48, the
   convergence demo's two shapes at 2 heads of D = 96 and in bf16 at 8
   heads of D = 24, and one unaligned fp32 call, each beside the old
   "fma" kernels on the same call (which it must beat), SDPA's EFFICIENT
   and MATH backends alone, the plain version and the bound;
4. the serving path at full PaSST-S width (12 x 768, 12 heads, 527 classes,
   N = 1190, random weights from a seeded generator): Predictor calls at
   B = 1 and B = 20 (10-s clips), scene embeddings and timestamp embeddings
   on a 2-s clip; the kernel launch counts of exactly that run and the
   attention forward's launches per path; clips/s;
5. correctness: the same Predictor in fp32 with the kernels against one
   with the plain versions, and the repo's golden fixtures (reference mel
   and reference model outputs) through the kernels;
6. the training step of ``passt_tpu_torch.bench`` at full PaSST-S width
   (bf16, B = 12, patchout 40/4 -> N = 474, mixup, AdamW with bf16 SR
   moments and bf16 SR parameters): 2 warm-up and 10 timed steps, ms/step
   and specs/s, the loss finite, the parameters moved, the step counter
   advanced, and the exact launch counts per step (and per forward and
   backward path: the bf16 steps' backward all on "wgmma", the fp32 steps'
   of phases 7 and 9 all on "simt"; the optimizer phase on the one-pass
   kernel, ``adamw_sr``, once a step, ``foreach`` never);
6o. the one-pass optimizer kernel (``csrc/adamw_sr.cu``) on PaSST-S's 159
   leaves in their storage dtypes against its plain version on the card,
   bit for bit (parameters, mu, nu), its scalars and seeds read from device
   memory and passed by value; timed by CUDA-graph replay beside its byte
   bound, with the plain version and the ``_foreach`` update and apply it
   replaces by profiled kernel time;
7. one fp32 training step at full width (B = 2) with the kernels against
   the same step on the plain versions, from the same weights and the same
   draws: the loss, every leaf's gradient and the updated parameters;
8. the bf16 training step of phase 6 under the JAX config's two LayerNorm
   variants, ``fuse_ln_qkv=True`` (the F1 and B2 kernels around the
   attention kernels) and ``ln_impl="fused"`` (the LayerNorm-backward
   kernel in all 25 norms), with phase 6's checks and exact launch counts;
9. one fp32 full-width step (B = 2) under each variant with its kernels
   against the default config's step on the plain versions, under phase
   7's tolerances (``fuse_ln_qkv`` at patchout 80/4, N = 154, where its
   fp32 gate holds), and an fp32 ``Predictor(fuse_ln_qkv=True)``'s
   timestamp embeddings (F1 at N = 14) against the plain default one;
10. the int8 PaSST-S MLP (``python3 -m passt_tpu_torch.tools.ab_int8_mlp``:
   fc1 768 -> 3072 with the fused GELU, fc2 3072 -> 768) against the bf16
   MLP at M = 5688 and 14280, forward and forward + backward, with exact
   launch counts and each int8 layer's quantization error within
   0.02 mean|exact| + 1e-3;
11. the int8 / bf16 matmul micro-benchmark (``python3 -m
   passt_tpu_torch.tools.int8_matmul_micro``) at the model's matmul shapes
   and 8192^3, its JSON block printed;
12. the fused-MLP A/B (``python3 -m passt_tpu_torch.tools.proto_mlp_fused``:
   the prototype's xla composition, fuse_f, fuse and fuse2) at M = 5688 and
   14280, with exact launch counts, the variants' errors against xla, and
   fuse_f's peak memory growth below one [M, 3072] bf16 tensor;
13. ``fit`` at full PaSST-S width on the port's own data path (the bench's
   model and step config): 48 10-s wav clips written with the stdlib
   ``wave`` module, read by FolderDataset -> RollDataset -> WavMixDataset,
   a class-balanced WeightedEpochSampler, the DataLoader's 4 threads and the
   pinned side-stream DeviceFeed with int16 transfer; 3 epochs of 4 steps
   with ``evaluate`` on 40 clips at B = 20 each epoch, SWA from epoch 2,
   keep-2-best checkpoints by "ap": the losses finite, ap/val_loss/n_eval in
   every record, the SWA count as ``swa_should_update`` says, the kept
   epochs, the best and latest restores, a run preempted by SIGTERM after
   its first epoch and resumed from its checkpoint bit-equal to the
   uninterrupted run, exact launch counts (steps x (mel, 12 qkv forward, 12
   qkv backward) + eval batches x (mel, 12 forward)); fit's steady ms/step
   beside ``bench.timed_steps``, eval clips/s, the loader's items/s; and one
   line on the native host plane (``native/libhostplane.so``, or a build of
   ``native/hostplane.cpp`` into build/ when the checkout has none) with
   ``assemble_batch``/``wavmix`` against the numpy chain;
14. the graphed entry points (``passt_tpu_torch.graphs``, the counterpart
   of ``jax.jit``; the default of phases 4-6, 8 and 13) against the eager
   ones (``jit=False``): the bf16 train step under each config bit-equal
   over 5 steps from step 0 and 5 steps from a restored step-3 state
   (params, both moments, counts, loss, grad norms), its launches over
   three replays exact; the eval step (B = 20 and a tail of 8) and the
   ``Predictor`` (B = 1, B = 20, timestamp windows) bit-equal over their
   warm-up, capture and replay, the ``Predictor``'s replays' launches
   exact; [13]'s ``fit`` rerun with the eager steps bit-equal to the
   graphed run (printed after [13]); the times, graphed and eager in
   turns: the step's best of 2 runs of 30 (the eager step's: runs of 12)
   with the spread, its first
   calls and peak memory, the eager fit's steady
   ms/step against the eager ``timed_steps``, and the ``Predictor``'s
   ms/call and clips/s at B = 1 and B = 20;
15. the CLI (``python -m passt_tpu_torch.cli <experiment> <command>``,
   driven in-process through ``passt_tpu_torch.cli.run``, what
   ``cli.main`` runs) at full PaSST-S width, bf16, the recipes' defaults
   but where listed, each command timed
   (first calls included) with its exact launches: ``audioset print_config``
   and ``print_named_configs``; ``audioset model_speed_test`` (B = 12 on a
   resident mel batch) beside ``bench.timed_steps``; ``audioset main
   mini_train`` (2 epochs x 12 steps, the weighted sampler, SWA, keep-1-best
   checkpoints by ap, the metrics JSONL; fit's steady ms/step and the
   start-up to the first step); ``evaluate_only`` on that checkpoint
   directory, bit-equal to the best epoch's logged eval; ``predict``;
   ``evaluate_ensemble ensemble_s16_14`` on two random members written with
   ``save_params_npz``; ``esc50 main`` and ``openmic main`` (1 epoch x 2
   steps); ``test_loaders``. The card's machine has no h5py: the three
   functions of ``experiments/common.py`` that open an HDF5 container are
   replaced by FolderDatasets over 10-s wav clips, and ``common.fit`` is
   wrapped to time each step (the wrapper calls the package's ``fit`` and
   its step); nothing else is replaced;
16. data parallelism through NCCL at world size 1 (one card: NCCL puts no
   two ranks on one GPU), after [15] on its clips: a one-rank NCCL group on
   a FileStore; the train step's collectives (``DataParallel.gather_rows``,
   ``all_reduce_mean``) captured in one CUDA graph and replayed on new
   inputs, the replay's device ops profiled; ``audioset main`` (PaSST-S,
   B = 12, N = 474, bf16, graphed; 8 steps and one eval batch) without the
   runtime and with ``trainer.n_data=1`` (``maybe_ddp_runtime`` on the
   group): each step's loss, every parameter and the epoch record
   bit-equal, the launches exact in both, the collectives counted over the
   graph's replays (2 all-gathers and 1 all-reduce a step), fit's ms/step
   of each;
17. export -> load -> serve on the card: ``export_inference`` of PaSST-S
   (random weights from seed 0, a symbolic batch) in fp32 and bf16,
   ``load_exported``, a B = 20 x 10 s and a B = 1 call with exact launches
   (the mel kernel and the attention forward kernel inside the loaded
   program, as ``torch.library`` custom ops) against the graphed
   ``Predictor`` of the same weights (fp32 within 1e-4 of max|ref|, bf16
   within 1e-2), ``python -m passt_tpu_torch.tools.serve`` on 6 wav clips,
   and the loaded program's ms/call and clips/s beside the ``Predictor``'s,
   in turns;
18. the depth's forms at the bench's bf16 step (PaSST-S, B = 12, N = 474,
   graphed): ``blocks_impl`` "loop", "scan" and "stacked" and loop with
   ``remat``, 3 calls each from one state: scan (restacked) and remat
   bit-equal to loop (losses, parameters, both moments), stacked within the
   bf16 bound and its first moment within its bound, the launches exact;
   the four timed in turns (``tools/ab_scan_blocks``: best of 2 runs of
   30, first calls, peak memory, one eager step's own peak and what its
   forward holds, remat's under half the loop's, launches a step); the
   batched
   weight-gradient product against float64; one fp32 B = 2 stacked step (the hand-written
   backward) with the kernels against the loop step on the plain versions
   from the same weights, under [7]'s tolerances; a stacked ``Predictor``
   at B = 20, N = 1190 against the loop's logits, timed in turns;
   ``tools/ab_batched_dw`` (48 per-block weight-gradient products with
   their AdamW-SR updates against 4 batched products and one stacked
   update); the fp32 attention forward on its "simt" path at B = 20,
   N = 1190 and B = 2, N = 474 beside the old "fma" kernel on the same
   call, plain and each SDPA backend that takes fp32, with its bound (the
   new kernel must beat the old one and plain at both);
19. offline data preparation and the full-size training demo: the prep
   package (``passt_tpu_torch.data.prepare``) and every prep tool import,
   and one line names the optional pieces that load (h5py, libmp3lame,
   libvorbisfile, the native plane's libmpg123); an ESC-50-shaped tree (5
   folds x 40 clips of 5 s at 44.1 kHz in PCM16 mono and stereo, PCM24,
   float32 and an EXTENSIBLE PCM16, and meta/esc50.csv) through
   ``tools/prepare_esc50``'s functions on the card's host: the fold split,
   each clip decoded and resampled to 160000 finite samples, the stereo
   mixdown bit-equal to the mean of the channels, the resampler's 1 kHz
   passband (RMS within 1%) and 20 kHz stopband (40 dB down), the
   clips/s of decode + resample and of mp3 encode on 1 thread and the
   tool's 8 workers, each mp3 decoded back to the wave's length at 20 dB
   SNR, and ``pack_fold`` read back by ``HDF5AudioDataset`` (each stage
   where its library loads); then ``tools/fullsize_train_demo`` at full
   PaSST-S width, bf16, graphed (50 tones, 500 train and 150 test 1-s
   clips, 12 epochs x 41 steps; where h5py is absent its items are
   written as wav files and the recipe's ``main`` runs on the tool's
   config with [15]'s FolderDatasets): the ap of each epoch (the last at
   least 0.5 and 5x the first), the SWA average, steady ms/step and exact
   launches;
20. the last seven user tools (``passt_tpu_torch.tools``): each imports, and
   one line names which of h5py, libmp3lame and the native plane's
   libmpg123 load (``measure_mp3_loader`` and ``loader_worker_sweep`` need
   all three: where they load, the sweep runs on the host; where not, they
   are left to the CPU tests); ``tools/convergence_demo``'s ``run`` on the
   card (its 50 tones as wav folders with [15]'s openers, the ESC-50 recipe
   on PaSST depth 4, dim 192, 6 heads, so D = 32, bf16, graphed, 45 epochs x
   40 steps at B = 25, N = 79; eval at B = 50, N = 110): the accuracy of each
   epoch (the best at least 0.8; the script's 0.9 printed), the SWA
   accuracy, steady ms/step and the exact launches, every attention call on
   the D = 32 kernels (the "wgmma" forward, the "resident" backward); then
   [20g] the same run on the same folders at ``model.dtype=float32``
   (``run(["model.dtype=float32"], ...)``), with the same checks and every
   attention call on the fp32 "simt" kernels' D = 32 instances, "fma" 0;
   [20h] that fp32 run with the reduced arch at 2 heads (D = 96; the
   registry overridden for the phase through the tool's ``REDUCED``), every
   attention call on the "simt" kernels' DP = 96 instances, "fma" 0;
   ``tools/finetune_rehearsal``'s ``main`` at full PaSST-S
   width (60 / 40 5-s clips as wav folders, 4 epochs, SIGTERM after epoch
   2; each phase the CLI in a child process through a ``python -c`` shim
   that sets [15]'s openers, holds after the epoch-2 line until the signal
   has landed, and prints its launch counts): every assert of the tool, each
   phase's wall time and exact launches, the transcript;
   ``tools/run_flagship_parity`` on a full-width PaSST-S ``.pt`` (seed 0)
   and 20 wav clips, ungated (``pass`` null) and gated at tol 1e-6 on its
   own value from the ported ``.npz`` (rc 0); ``tools/fit_throughput`` at
   full width (--steps 40 --epochs 3, wav folders): its JSON line, sustained
   specs/s beside ``bench.timed_steps`` in the same process, fit's steady
   ms/step by CUDA events beside both, exact launches;
   the multi-seed tool's "ref" arm (fp32 moments, erf GELU) at seed 0
   through [19]'s route, its ap curve and swa_ap beside [19]'s production
   arm (the last ap at least 0.5; the gap printed, not gated).

Phase 3 and 3b hold the "wgmma" kernels' padded instances (templates on
the head dim padded to DP = 32, 64, 128; PERF.md row 4m) against their
plain versions: bf16 and fp16 at D = 16, 48, 80, 96, 112, 128 over N 1,
63, 64, 65, 128, 129, 200, 474 and at D = 32 above N = 128, plus1 on and
off, both entries, the backward's bits equal twice above N = 128; check
that a padded call writes nothing past D ([B, N, H, D] views into
[B, N, H, 128] buffers whose other columns hold a sentinel, forward and
backward); and time them beside the old "mma" kernels on the same call
(the private override), SDPA as dispatched and each backend alone, the
plain version and the bound, at 6 heads of D = 128 (B = 12, N = 474 and,
forward only, B = 20, N = 1190), 8 heads of D = 96 (B = 12, N = 474), the
convergence demo's two shapes at 2 heads of D = 96, and (backward only)
24 heads of D = 32 at B = 12, N = 474. Every draw of [3] and [3b] comes
from a seeded generator on the card, and each bf16 / fp16 forward is held
to one output ulp at the element's magnitude. Phase [6w] runs the bench's
bf16 step at PaSST-S width over 6 heads of D = 128
(``bench.setup(num_heads=6)``: 2 warm-up and 10 timed steps, graphed,
every attention call on the "wgmma" DP = 128 instances, exact launches),
holds its mean loss against the same steps under ``attn_impl="xla"``, and
times it in turns with the 12-head step; [20i] runs the convergence demo
in bf16 at 2 heads (D = 96, the DP = 128 instances) as [20h] runs it in
fp32. The line before the card's is the script's seconds, in all and by
phase.

Phase 3 also holds the D = 32 "wgmma" forward against its plain version
over a ragged-N sweep (N 1 to 200, bf16 and fp16, plus1 on and off, both
entries) and times it at the convergence demo's shapes (bf16, B = 25,
N = 79 and B = 50, N = 110, 6 heads of D = 32) beside the old "mma" kernel
on the same call, SDPA and the bound; phase 3b holds the "resident"
backward likewise (N 1 to 128, every call's bits equal on a second run;
N = 129 on "wgmma") and times it there beside the old "mma" pair, SDPA's
backward and the bound. In fp32 at D = 32 both phases hold the "simt"
kernels' D = 32 instances likewise (N 1 to 200, both entries, plus1 on and
off; the backward's bits equal on a second run) and time them at the
demo's two shapes beside the old "fma" kernels on the same call, SDPA's
EFFICIENT and MATH backends each alone, the plain version and the bound.

Phase 3c holds the LayerNorm-backward, F1 and B2 kernels against their
plain versions (F1 and B2 in bf16, fp16 and fp32 also at ragged M and C 64
to 1024, every B2 case checked for the same bits on two runs, every F1
call's tile and K split checked against ``ops/ln_qkv.py``) and times them
at the training step's shapes, F1 also at the timestamp windows' (bf16 and
fp32) and both at the fp32 step's, each beside the bare cuBLAS product and
the two library calls that compute its function (ATen's LayerNorm forward
then the product; the product then ATen's LayerNorm backward), with its
tiles, CTAs in flight and waves. Phase 3d holds
the int8 GEMM's three epilogues (int8_dense, int8_dense_gelu, int8_matmul)
on its wgmma main loop against their plain versions (int32 outputs
bit-equal) at the int8 MLP's shapes (M = 5688 and 14280), ragged shapes
(M and N multiples of no compiled tile, K of no 128 bytes; int8 -> int32 in
every compiled tile there and at 8192^3) and the micro-benchmark's four
shapes, checks that every public call took the wgmma loop, and times them
beside the old mma.sync loop, ``torch._int_mm`` and the bf16 cuBLAS GEMM
(8192^3 in turns: new, old, library, library, old, new). Phase 3e holds the fused MLP's forward (residuals off
and on) and backward kernels against their plain versions in bf16 and fp32
at M = 5688 and 14280 (C = 768, H = 3072), at ragged M with small C and H,
and in bf16 at C 256, 448 and 704 (clusters of 2, 3 and 4 CTAs, a last CTA
with part of its column blocks, chunks of H partly or wholly past H), checks
that the bf16 kernels give the same bits twice and that each bf16 launch's
plan is ``ops/fused_mlp.py`` ``plan``'s at the clusters the card holds at
once (``cudaOccupancyMaxActiveClusters``), and times them beside the bare
cuBLAS pair of the same products with the plan (rows, CTAs a cluster, CTAs,
clusters resident, waves).

Launch counts: each main-path run (phases 4, 6, 6w, 8, 10, 11, 12, 13's
uninterrupted fit, the kernel sides of 7 and 9, 14's replays, each of
15's and 16's CLI commands, 17's loaded-program and serve calls, 18's
equality runs, fp32 stacked step and stacked ``Predictor``, 19's demo, and
20's convergence demos (bf16, fp32, fp32 and bf16 at 2 heads), rehearsal phases (counted in their
child processes), parity runs, fit_throughput run and ref arm) starts
with every count at 0 and reads the counts right after; the ``launches``
of the kernels' record (thirteen entries) sum those runs. The comparisons
of phases 3, 3b, 3c, 3d and 3e are outside them. A count is of kernels
run: the graphs of ``passt_tpu_torch.graphs`` take back the counts their
capture added and add them once per replay. Phase 11 times with
``tools.timing.graph_ms``, whose plain CUDA graphs do not: its
int8_matmul count is of wrapper calls, the captured ones included, and
its replays run the kernel more times than that.

fp32 is compared with TF32 off: ``torch.backends.cuda.matmul.allow_tf32``
and ``torch.backends.cudnn.allow_tf32`` are set False for the whole run.

The last line is ``{"ok": true, "device": {...}}``; the line before it is
the kernels' JSON record.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import sys
import time

import numpy as np
import torch

T0 = time.perf_counter()  # the script's start, for [seconds]
ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from passt_tpu_torch.tools.timing import cuda_ms, gpu_line, graph_ms, kernel_ms, kernel_times  # noqa: E402

ARCH = "passt_s_swa_p16_128_ap476"
CLIP = 320000  # 10 s at 32 kHz
#: the convergence demo's attention ([20b]): its reduced PaSST's heads and
#: head dim, and its (B, N) in training and in eval
CONV_HEADS, CONV_HEAD_DIM = 6, 32
#: [20h] the same demo over 2 heads: D = 96, the "simt" kernels' DP = 96
#: instances in fp32; [20i] in bf16, the "wgmma" kernels' DP = 128 ones
CONV_WIDE_HEADS = 2
CONV_SHAPES = ((25, 79), (50, 110))
#: the ragged-N sweep at D = 32 ([3], [3b]): one tile's edges and the demo's N
D32_NS = (1, 17, 64, 65, 79, 110, 127, 128)
#: [3] / [3b] the "wgmma" instances at a padded head dim (templates on
#: DP = 32, 64, 128): the head dims that are no DP, and the N they are held
#: at (one and two 64-query tiles, the edges of the 64- and 128-key tiles,
#: the training step's N)
WIDE_DS = (16, 48, 80, 96, 112, 128)
WIDE_NS = (1, 63, 64, 65, 128, 129, 200, 474)
#: [3] the "wgmma" instances timed, (B, N, H, D, entry): 6 heads of D = 128
#: at the training and serving shapes (rows 3t's and 2's FLOPs), 8 heads of
#: D = 96, and the convergence demo's two shapes at 2 heads of D = 96
#: ([20i]); [3b] the backward at the same shapes but serving's, and at
#: 24 heads of D = 32 above the "resident" path's N
WIDE_TIMED = ((12, 474, 6, 128, "fused_attention_qkv"), (20, 1190, 6, 128, "fused_attention"),
              (12, 474, 8, 96, "fused_attention_qkv"), (25, 79, 2, 96, "fused_attention_qkv"),
              (50, 110, 2, 96, "fused_attention_qkv"))
WIDE_TIMED_BWD = ((12, 474, 6, 128), (12, 474, 8, 96), (25, 79, 2, 96), (50, 110, 2, 96), (12, 474, 24, 32))
# attention kernel vs plain: fp32 differs in summation order only; in bf16 /
# fp16 a p may round the other way and the output may round the other way:
# one output ulp at each element's magnitude, TOL_ATTN below |o| = 2 and
# doubled with each binade above (attn_err)
TOL_ATTN = {torch.float32: 5e-5, torch.bfloat16: 2.0**-7, torch.float16: 2.0**-10}
# backward kernel vs plain, max error relative to max|ref| of each gradient:
# fp32 differs in summation order only; in bf16 / fp16 the kernel rounds
# P_norm for dV's product (the plain version keeps fp32 there), a dS may
# round the other way, and the output rounds once: one output ulp at the
# largest gradient (2**-7 bf16, 2**-10 fp16) plus the P_norm rounding
TOL_BWD = {torch.float32: 5e-5, torch.bfloat16: 2.0**-6, torch.float16: 2.0**-9}
# LayerNorm backward kernel vs plain, max error relative to max|ref|: dx in
# fp32 differs by summation order only (the row means); in bf16 / fp16 it
# rounds once, and a summation-order change may move a value across a
# rounding boundary: one output ulp at the largest dx. dscale / dbias are
# fp32 sums over the M rows in another order (per-block partials).
TOL_LN_DX = {torch.float32: 1e-5, torch.bfloat16: 2.0**-7, torch.float16: 2.0**-10}
TOL_LN_SUMS = 1e-4
# F1 / B2 vs plain, relative to max|ref|: the products accumulate over K =
# C or 3C in another order; in bf16 / fp16 F1 rounds the sum, then adds the
# bias in the dtype (two roundings, one ulp each) and B2 rounds dx and xn
# once (a flipped xn rounding moves the statistics-free xn by one ulp); fp32
# keeps ~1e-6 of summation order, amplified by the LayerNorm backward's
# cancellation in dx
TOL_QKV = {torch.float32: 1e-4, torch.bfloat16: 2.0**-7, torch.float16: 2.0**-9}
# int8 GEMM kernel vs plain, max error relative to max|ref|: the dense and
# GELU epilogues repeat the plain version's fp32 roundings on the same exact
# int32 sums, so they differ at most where tanh does (fp32: an ulp), and in
# bf16 an fp32 ulp may flip the rounding; the bf16 product sums over K in
# another order than cuBLAS's fp32 product, so a value may round the other
# way: in bf16 one ulp of the largest value. int32 (and int32 -> bf16) must
# be bit-equal.
TOL_INT8 = {torch.float32: 1e-6, torch.bfloat16: 2.0**-7}
# fused MLP kernels vs plain, max error relative to max|ref|: the same fp32
# roundings in another summation order (and tanhf against torch's tanh, an
# fp32 ulp), so fp32 to 1e-5; in bf16 such an ulp may flip the rounding of
# y, g, d or dh: one bf16 ulp of the largest value, 2**-7; dx rounds twice
# (dh, then its own sum): 2**-6
TOL_MLP = {torch.float32: 1e-5, torch.bfloat16: 2.0**-7}
TOL_MLP_DX = {torch.float32: 1e-5, torch.bfloat16: 2.0**-6}
# [12] the fused variants against the prototype's xla composition, which
# rounds h to bf16 before the GELU: a few bf16 ulps of y (forward, relative
# to max|y|) and of each gradient (relative to its max)
TOL_PROTO_MLP = 2.0**-5
# peak rates of one H100 SXM (dense, 700 W) for the bounds
PEAK_BF16, PEAK_INT8, PEAK_FP32, HBM_BYTES_PER_S = 989e12, 1979e12, 67e12, 3.35e12
TRAIN_B, TRAIN_N = 12, 474  # the bench step: (12 - 4) x (99 - 40) + 2 tokens
# fp32 training step, kernels vs plain (phase 7): the loss and each leaf's
# gradient (max error over the leaf's max |g|) move only by summation order,
# which the near-empty mel bins (up to 1e-3 through the log) and 12 blocks
# amplify. A first AdamW update is -lr (g / (|g| + eps) + wd p): where the
# plain |g| exceeds 10x the leaf's gradient error d, the two g share a sign
# and the updates differ by at most lr eps d / (9d + eps)^2 <= lr / 36, so
# they are held to TOL_STEP_UPDATE of lr there; elsewhere a sign may flip
# and they differ by less than 2 lr. An updated parameter differs by at most
# the updates' difference plus one ulp of the parameter (each add rounds).
TOL_STEP_LOSS, TOL_STEP_GRAD, TOL_STEP_UPDATE = 1e-4, 1e-3, 0.05


#: the "simt" kernels' instances by input type (as ptxas's mangled template
#: arguments name it) and full rows (fp32 at D = DP, every operand aligned)
#: or not, for [2]'s register lines
SIMT_INSTANCES = ((torch.float32, "If", True), (torch.float32, "If", False), (torch.bfloat16, "I13__nv_bfloat16", False),
                  (torch.float16, "I6__half", False))


def say(line: str) -> None:
    print(line, flush=True)


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def attn_err(got: torch.Tensor, ref: torch.Tensor) -> tuple:
    """The attention forward's largest error against its plain version
    ``ref``, absolute and in units of its tolerance: TOL_ATTN in fp32; in
    bf16 / fp16 one output ulp at each element's magnitude, TOL_ATTN times
    2^floor(log2 max(|ref|, 1)) (2^-7 / 2^-10 below |o| = 2)."""
    err = (got.float() - ref.float()).abs()
    tol = TOL_ATTN[ref.dtype]
    if ref.dtype != torch.float32:
        tol = tol * torch.exp2(torch.floor(torch.log2(ref.float().abs().clamp_min(1.0))))
    return float(err.max()), float((err / tol).max())


def mel_strong_check(got: torch.Tensor, ref: torch.Tensor, what: str) -> float:
    """The bound tests/test_pallas_mel.py holds the TPU kernel to: 1e-3 in
    near-empty mel bins (the log is steep there), 2e-4 wherever the mel
    energy exceeds 1e-2 (normalised log-mel scale)."""
    err = max_err(got, ref)
    strong = torch.exp(5.0 * ref - 4.5) > 1e-2
    strong_err = float((got - ref)[strong].abs().max())
    check(err < 1e-3 and strong_err < 2e-4, f"{what}: max err {err:.3g}, strong-bin err {strong_err:.3g}")
    return err


def ptxas_summary(log: str) -> str:
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
    spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", log)]
    if not regs:
        return log.strip()[:200]
    return f"{len(regs)} functions, max {max(regs)} registers, max spill stores {max(spills or [0])} B"


def bound(flops: float, nbytes: float, peak: float) -> dict:
    """The least time the card could take: the larger of the operations over
    the peak rate of their type and the bytes over the memory rate."""
    ops_ms, bytes_ms = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return dict(bound_ms=max(ops_ms, bytes_ms), bound_by="operations" if ops_ms >= bytes_ms else "bytes")


def sdpa(q, k, v, scale):
    """One PyTorch call computing the attention function on [B, N, H, D]
    (plus1 off): the library yardstick, never called by the port."""
    return torch.nn.functional.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), scale=scale).transpose(1, 2)


def sdpa_backends(q, k, v, scale, do=None) -> list:
    """The SDPA backends, in PyTorch's priority order, that accept these
    inputs (and, with ``do``, their backward), each tried alone under
    ``torch.nn.attention.sdpa_kernel``."""
    import warnings

    from torch.nn.attention import SDPBackend, sdpa_kernel

    accepted = []
    for backend in (SDPBackend(i) for i in torch._C._get_sdp_priority_order()):
        if backend.name == "OVERRIDEABLE":
            continue
        try:
            with warnings.catch_warnings(), sdpa_kernel([backend]):
                warnings.simplefilter("ignore")
                out = sdpa(q, k, v, scale)
                if do is not None:
                    torch.autograd.grad(out, (q, k, v), do)
            torch.cuda.synchronize()
            accepted.append(backend)
        except RuntimeError:
            continue
    check(bool(accepted), "no SDPA backend accepts the attention inputs")
    return accepted


def top_kernel(times: dict) -> str:
    """The name of the kernel with the most device time (kernel_times)."""
    return max(times, key=times.get)[:100]


def backend_of(kernel: str) -> str:
    """The SDPA backend that ran, from the name of its main kernel
    (top_kernel): cuDNN's names also say "flash", so they come first."""
    name = kernel.lower()
    for backend, marks in (("CUDNN_ATTENTION", ("cudnn",)), ("FLASH_ATTENTION", ("flash",)),
                           ("EFFICIENT_ATTENTION", ("fmha", "efficient", "mem_eff"))):
        if any(m in name for m in marks):
            return backend
    return "MATH"


def under(backend, fn):
    """``fn`` run with SDPA held to one backend."""
    from torch.nn.attention import sdpa_kernel

    def run():
        with sdpa_kernel([backend]):
            return fn()
    return run


def phase_kernels(gpu: str, dev: torch.device) -> dict:
    from passt_tpu_torch.ops import attention as A
    from passt_tpu_torch.ops.attention import attention_plain, fused_attention, fused_attention_qkv
    from passt_tpu_torch.ops.mel import kaldi_mel_banks
    from passt_tpu_torch.ops.mel_kernel import fused_log_mel, fused_log_mel_plain
    from passt_tpu_torch.ops.stft import preemphasis, stft_power

    rng = np.random.default_rng(0)
    gen = torch.Generator(device=dev).manual_seed(0)  # every draw on the card
    rec = {}

    # mel: hop 320 at the slice's batch, hop 100 and 160 at a small one; a
    # 2-s clip, a wave one sample longer than the reflect padding needs, a
    # jittered bank and a bank with an all-zero and a full-width row; then
    # every other n_fft the kernel is built for (64 to 2048), each its own
    # instantiation of the kernel, on a 2-s clip at B = 2
    bank = kaldi_mel_banks(128, 1024, 32000, 0.0, 15000.0, device=dev)
    jittered = kaldi_mel_banks(128, 1024, 32000, torch.tensor(7.0, device=dev), torch.tensor(15731.0, device=dev))
    synthetic = bank.clone()
    synthetic[5] = 0.0
    synthetic[77] = torch.linspace(0.1, 1.0, bank.shape[1], device=dev)
    cases = [(1024, 800, 320, 20, CLIP, bank, "B=20x10s"), (1024, 800, 100, 2, CLIP, bank, "B=2x10s"),
             (1024, 800, 160, 2, CLIP, bank, "B=2x10s"), (1024, 800, 320, 3, 64000, bank, "2-s clip"),
             (1024, 800, 320, 3, 514, bank, "514 samples"), (1024, 800, 160, 2, 64000, jittered, "jittered bank"),
             (1024, 800, 320, 2, 64000, synthetic, "zero and full rows")]
    for n_fft, win, hop, n_mels in ((64, 64, 32, 32), (128, 128, 64, 64), (256, 200, 100, 64), (512, 400, 160, 128),
                                    (2048, 1600, 320, 128)):
        cases.append((n_fft, win, hop, 2, 64000, kaldi_mel_banks(n_mels, n_fft, 32000, 0.0, 15000.0, device=dev),
                      f"n_fft {n_fft} win {win} {n_mels} mels B=2x2s"))
    mel_err, mel_cases = 0.0, []
    for n_fft, win, hop, b, t, bk, what in cases:
        wave = torch.from_numpy(rng.standard_normal((b, t)).astype(np.float32)).to(dev)
        got = fused_log_mel(wave, bk, n_fft=n_fft, hop=hop, win_length=win)
        ref = fused_log_mel_plain(wave, bk, n_fft=n_fft, hop=hop, win_length=win)
        torch.cuda.synchronize()
        check(got.shape == ref.shape, f"mel hop {hop} {what}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
        mel_err = max(mel_err, mel_strong_check(got, ref, f"mel hop {hop} {what}"))
        mel_cases.append(f"hop {hop} {what}")
        if what == "zero and full rows":
            floor = (math.log(np.float32(1e-5)) + 4.5) / 5.0
            check(bool(torch.allclose(got[:, 5], torch.full_like(got[:, 5], floor))), "mel all-zero row")
    # the slice's call: the wrapper by graph replay, its kernels alone by
    # profiled kernel time, the plain version by events (its basis is copied
    # to the card each call, which a graph cannot capture), and the cuFFT
    # composition (the port's stft_method="fft" power, the bank product and
    # the log): a composition of library calls, not one call
    wave = torch.from_numpy(rng.standard_normal((20, CLIP)).astype(np.float32)).to(dev)

    def composition():
        power = stft_power(preemphasis(wave), 1024, 320, 800, center=True, method="fft")
        return (torch.log(torch.matmul(bank, power[:, : bank.shape[1]]) + 1e-5) + 4.5) / 5.0

    got = fused_log_mel(wave, bank)
    mel_strong_check(composition(), fused_log_mel_plain(wave, bank), "mel cuFFT composition")
    ms = graph_ms(lambda: fused_log_mel(wave, bank))
    ms_events = cuda_ms(lambda: fused_log_mel(wave, bank))
    kernels = kernel_times(lambda: fused_log_mel(wave, bank))
    plain_ms = cuda_ms(lambda: fused_log_mel_plain(wave, bank))
    comp_ms = cuda_ms(composition)
    # the function's least work, not the kernel's: the pre-emphasis per
    # sample; per frame the window, a real FFT of n_fft = 1024 (2.5 n log2 n
    # FLOP), the power of each bin, the bank's non-zero taps only (Kaldi
    # triangles) and the log and normalisation of each mel; the wave and the
    # bank read once, the mel written once
    frames, n_mels, n_freq = 20 * got.shape[-1], bank.shape[0], bank.shape[1]
    per_frame = 2.5 * 1024 * math.log2(1024) + 800 + 3 * n_freq + 2 * int((bank != 0).sum()) + 3 * n_mels
    mel_bound = bound(2 * wave.numel() + frames * per_frame,
                      (wave.numel() + bank.numel() + got.numel()) * 4, PEAK_FP32)
    say(f"[3] mel kernel vs plain: max err {mel_err:.3g} ({'; '.join(mel_cases)}); B=20x10s hop 320: "
        f"wrapper {ms:.4f} ms graph-replayed, {ms_events:.4f} events, kernels {sum(kernels.values()):.4f} ms "
        f"profiled over {len(kernels)} launches a call ("
        + ", ".join(f"{k[:48]} {v:.4f}" for k, v in kernels.items())
        + f"), plain {plain_ms:.4f} ms, cuFFT composition (stft fft + bank product + log; not one call) "
        f"{comp_ms:.4f} ms, bound {mel_bound['bound_ms']:.4f} ms ({mel_bound['bound_by']}) ({gpu})")
    rec["fused_log_mel"] = dict(max_abs_err=mel_err, ms=ms, ms_events=ms_events, kernel_ms=sum(kernels.values()),
                                device_launches_per_call=len(kernels), plain_ms=plain_ms, library_ms=None,
                                library_composition_ms=comp_ms, **mel_bound)

    # attention: both entries, bf16 and fp32 (and fp16), plus1 on and off,
    # N in {14, 474, 1190} at the model's heads; the edges of the short
    # path's two tile widths and of the wgmma path's first key tile; other
    # head dims; bf16 and fp16 on views one element off 16-byte alignment.
    # Each pair of calls takes the path forward_path picks ("wgmma" at
    # D = 64, N > 64 and at D = 16, 128; "short" at N <= 64; "simt" for
    # every fp32 call, bf16 at D = 24 and the unaligned views; never
    # "fma" or "mma"). fp32 also at the ragged edges of the simt kernel's 64-row
    # tiles (N = 1, 63, 64, 65, 97). The convergence demo's D = 32 ("wgmma"
    # in bf16 / fp16, "simt" in fp32, at any N) over a ragged-N sweep: one
    # and two 128-key tiles, one to four 64-key tiles
    heads, hd = 12, 64
    errs = {"fused_attention": 0.0, "fused_attention_qkv": 0.0}
    cases = [(dtype, n, plus1, heads, hd, True)
             for dtype in (torch.bfloat16, torch.float32, torch.float16)
             for n in (14, 474, 1190) for plus1 in (False, True)]
    cases += [(dtype, n, plus1, heads, hd, True) for dtype in (torch.bfloat16, torch.float16)
              for n in (16, 17, 33, 64, 65, 128, 129) for plus1 in (False, True)]
    cases += [(torch.bfloat16, 97, True, h_, d_, True) for h_, d_ in ((4, 16), (2, 24), (2, 128))]
    cases += [(dtype, n, plus1, heads, hd, False) for dtype in (torch.bfloat16, torch.float16)
              for n in (97, 1190) for plus1 in (False, True)]
    cases += [(torch.float32, n, plus1, heads, hd, True) for n in (1, 63, 64, 65, 97) for plus1 in (False, True)]
    cases += [(torch.float32, 97, plus1, 2, d_, True) for d_ in (32, 24) for plus1 in (False, True)]
    cases += [(torch.float32, n, plus1, heads, hd, False) for n in (97, 1190) for plus1 in (False, True)]
    cases += [(dtype, n, plus1, CONV_HEADS, CONV_HEAD_DIM, True)
              for dtype in (torch.bfloat16, torch.float16, torch.float32)
              for n in D32_NS + (129, 200) for plus1 in (False, True)]
    # the "wgmma" instances at padded head dims (D = 16 on DP = 32, 48 on
    # 64, 80 to 128 on 128) and D = 32 at the step's N, bf16 and fp16
    cases += [(dtype, n, plus1, 2, d_, True) for dtype in (torch.bfloat16, torch.float16) for d_ in WIDE_DS
              for n in WIDE_NS for plus1 in (False, True)]
    cases += [(dtype, TRAIN_N, plus1, CONV_HEADS, CONV_HEAD_DIM, True) for dtype in (torch.bfloat16, torch.float16)
              for plus1 in (False, True)]
    taken = dict.fromkeys(A.FWD_PATHS, 0)
    with torch.no_grad():
        for dtype, n, plus1, h_, d_, aligned in cases:
            qkv = torch.from_numpy(rng.standard_normal((2, n, 3 * h_ * d_)).astype(np.float32))
            qkv = qkv.to(dev, dtype)
            if not aligned:
                qkv = torch.empty(qkv.numel() + 1, dtype=dtype, device=dev)[1:].view(qkv.shape).copy_(qkv)
            q, k, v = qkv.reshape(2, n, 3, h_, d_).unbind(2)
            check(A._aligned(q, k, v) == aligned, f"{dtype} N={n} D={d_}: alignment is not {aligned}")
            ref = attention_plain(q, k, v, scale=d_ ** -0.5, plus1=plus1)
            A.reset_path_launches()
            got_b = fused_attention(q, k, v, scale=d_ ** -0.5, plus1=plus1)
            got_f = fused_attention_qkv(qkv, heads=h_, head_dim=d_, scale=d_ ** -0.5, plus1=plus1)
            torch.cuda.synchronize()
            path = A.forward_path(n, d_, dtype, aligned)
            check(path not in ("fma", "mma")
                  and (path == "simt") == (dtype == torch.float32 or not aligned or d_ % 16 != 0),
                  f"{dtype} N={n} D={d_} aligned={aligned}: path {path}")
            check(A.FWD_PATH_LAUNCHES[path] == 2 == sum(A.FWD_PATH_LAUNCHES.values()),
                  f"{dtype} N={n} D={d_}: forward paths {A.FWD_PATH_LAUNCHES}, want 2 on {path}")
            taken[path] += 2
            for name, got in (("fused_attention", got_b), ("fused_attention_qkv", got_f.view(ref.shape))):
                err, units = attn_err(got, ref)
                check(got.dtype == dtype and bool(torch.isfinite(got).all()), f"{name}: dtype/finite")
                check(units <= 1.0, f"{name} {dtype} N={n} H={h_} D={d_} plus1={plus1} aligned={aligned}: "
                      f"max err {err:.3g}, {units:.3g} of its tolerance (TOL_ATTN {TOL_ATTN[dtype]:.3g} at |o| < 2)")
                errs[name] = max(errs[name], err)

    def main_shape(b, n, entry, path, h=heads, d=hd):
        """The kernel against its plain version on the bf16 inputs of a main
        path's shape, on the forward path it must take there; returns the
        kernel call and the plain call on them."""
        qkv = torch.randn((b, n, 3 * h * d), device=dev, generator=gen).to(torch.bfloat16)
        q, k, v = qkv.reshape(b, n, 3, h, d).unbind(2)
        if entry == "fused_attention":
            kern = lambda: fused_attention(q, k, v, scale=d ** -0.5)
        else:
            kern = lambda: fused_attention_qkv(qkv, heads=h, head_dim=d, scale=d ** -0.5)
        plain = lambda: attention_plain(q, k, v, scale=d ** -0.5)
        with torch.no_grad():
            A.reset_path_launches()
            err, units = attn_err(kern().reshape(b, n, h, d), plain())
        check(A.FWD_PATH_LAUNCHES[path] == 1 == sum(A.FWD_PATH_LAUNCHES.values()),
              f"{entry} bf16 B={b} N={n} D={d}: forward paths {A.FWD_PATH_LAUNCHES}, want {path}")
        check(units <= 1.0, f"{entry} bf16 B={b} N={n} D={d}: max err {err:.3g}, {units:.3g} of its tolerance")
        errs[entry] = max(errs[entry], err)
        taken[path] += 1
        return kern, plain, (q, k, v)

    def timings(b, n, entry, path, h=heads, d=hd, old=None):
        """The kernel (graph replay and CUDA events), its plain version and
        SDPA as PyTorch dispatches it (graph replay and events; the kernel
        it ran, from a profiler trace), with each backend that accepts the
        inputs timed alone by graph replay (the unfused MATH backend left
        out); with ``old``, that old path's kernel on the same views
        through the private override, held against plain and timed."""
        kern, plain, (q, k, v) = main_shape(b, n, entry, path, h, d)
        lib = lambda: sdpa(q, k, v, d ** -0.5)
        with torch.no_grad():
            backends = sdpa_backends(q, k, v, d ** -0.5)
            ran = top_kernel(kernel_times(lib))
            t = dict(ms=graph_ms(kern), ms_events=cuda_ms(kern), plain_ms=cuda_ms(plain),
                     library_ms=graph_ms(lib), library_ms_events=cuda_ms(lib),
                     library_kernel=ran, library_backend=backend_of(ran),
                     library_backend_ms={be.name: graph_ms(under(be, lib)) for be in backends if be.name != "MATH"},
                     path=path, **bound(4 * n * n * d * b * h, 4 * b * n * h * d * 2, PEAK_BF16))
            if old:
                out = torch.empty((b, n, h, d), device=dev, dtype=torch.bfloat16)
                old_fn = lambda: A._launch(q, k, v, out, d ** -0.5, False, path=old)
                old_fn()
                err, units = attn_err(out, plain())
                check(units <= 1.0, f"the old {old} forward B={b} N={n} H={h} D={d}: max err {err:.3g}")
                t.update({f"{old}_ms": graph_ms(old_fn), f"{old}_ms_events": cuda_ms(old_fn),
                          f"{old}_max_abs_err": err})
            return t

    def line(t):
        return (f"kernel ({t['path']}) {t['ms']:.4f} ms graph-replayed, {t['ms_events']:.4f} events; plain "
                f"{t['plain_ms']:.4f} ms; SDPA {t['library_ms']:.4f} ms graph-replayed, {t['library_ms_events']:.4f} "
                f"events (ran {t['library_backend']}: {t['library_kernel']}; alone: "
                + ", ".join(f"{k} {v:.4f}" for k, v in t["library_backend_ms"].items())
                + f" ms); bound {t['bound_ms']:.4f} ms ({t['bound_by']})")

    # the serving call ([B, N, H, D] entry), the timestamp windows and the
    # bf16 training step's forward (both on the qkv entry)
    serve = timings(20, 1190, "fused_attention", "wgmma")
    stamps = timings(256, 14, "fused_attention_qkv", "short")
    train = timings(TRAIN_B, TRAIN_N, "fused_attention_qkv", "wgmma")
    for name, t, b, n in (("fused_attention", serve, 20, 1190), ("fused_attention_qkv", stamps, 256, 14),
                          ("fused_attention_qkv", train, TRAIN_B, TRAIN_N)):
        say(f"[3] {name} bf16 B={b} H=12 N={n} D=64: {line(t)} ({gpu})")
    # row 4o's redesign on a user path: the convergence demo's reduced PaSST
    # (6 heads of D = 32, bf16) takes the D = 32 "wgmma" forward at its
    # training and eval shapes ([20b]); the old "mma" kernel on the same call
    # through the private override
    demo = {}
    for b, n in CONV_SHAPES:
        t = timings(b, n, "fused_attention_qkv", "wgmma", CONV_HEADS, CONV_HEAD_DIM, old="mma")
        demo[f"B={b} N={n}"] = t
        say(f"[3] fused_attention_qkv bf16 B={b} N={n} H={CONV_HEADS} D={CONV_HEAD_DIM} (the convergence demo's): "
            f"{line(t)}; the old mma kernel on the same call {t['mma_ms']:.4f} ms graph-replayed, "
            f"{t['mma_ms_events']:.4f} events ({gpu})")
    # row 4f on a user path: the convergence demo at model.dtype=float32
    # ([20g]) takes the D = 32 instance of the fp32 "simt" forward at its
    # training and eval shapes; the old "fma" kernel on the same call
    # through the private override, SDPA's EFFICIENT and MATH backends each
    # alone (flash and cuDNN take no fp32), the plain version and the bound
    from torch.nn.attention import SDPBackend

    demo32 = {}
    for b, n in CONV_SHAPES:
        h_, d_, scale = CONV_HEADS, CONV_HEAD_DIM, CONV_HEAD_DIM ** -0.5
        qkv = torch.randn((b, n, 3 * h_ * d_), device=dev, generator=gen)
        views = A._head_views(qkv, h_, d_)
        out = torch.empty((b, n, h_, d_), device=dev)
        kern = lambda: fused_attention_qkv(qkv, heads=h_, head_dim=d_, scale=scale)
        old = lambda: A._launch(*views, out, scale, False, path="fma")
        lib = lambda: sdpa(*views, scale)
        backends = (SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH)
        with torch.no_grad():
            ref = attention_plain(*views, scale=scale)
            A.reset_path_launches()
            got = kern().view(ref.shape)
            check(A.FWD_PATH_LAUNCHES["simt"] == 1 == sum(A.FWD_PATH_LAUNCHES.values()),
                  f"fused_attention_qkv fp32 B={b} N={n} D={d_}: forward paths {A.FWD_PATH_LAUNCHES}, want simt")
            old()
            err, old_err = max_err(got, ref), max_err(out, ref)
            check(max(err, old_err) <= TOL_ATTN[torch.float32],
                  f"fused_attention_qkv fp32 B={b} N={n} D={d_}: max err {err:.3g} (simt), {old_err:.3g} (fma)")
            errs["fused_attention_qkv"] = max(errs["fused_attention_qkv"], err)
            taken["simt"] += 1
            t = dict(path="simt", ms=graph_ms(kern), ms_events=cuda_ms(kern), max_abs_err=err,
                     fma_ms=graph_ms(old), fma_ms_events=cuda_ms(old), fma_max_abs_err=old_err,
                     plain_ms=cuda_ms(lambda: attention_plain(*views, scale=scale)),
                     library_backend_ms={be.name: graph_ms(under(be, lib)) for be in backends},
                     library_backend_ms_events={be.name: cuda_ms(under(be, lib)) for be in backends},
                     **bound(4 * n * n * d_ * b * h_, 4 * b * n * h_ * d_ * 4, PEAK_FP32))
            t["library_ms"] = t["library_backend_ms"]["EFFICIENT_ATTENTION"]
        demo32[f"B={b} N={n}"] = t
        say(f"[3] fused_attention_qkv fp32 B={b} N={n} H={h_} D={d_} (the convergence demo's at "
            f"model.dtype=float32): kernel (simt) {t['ms']:.4f} ms graph-replayed, {t['ms_events']:.4f} events, "
            f"max err {err:.3g}; the old fma kernel on the same call {t['fma_ms']:.4f} ms graph-replayed, "
            f"{t['fma_ms_events']:.4f} events (max err {old_err:.3g}); SDPA alone: "
            + ", ".join(f"{k} {v:.4f} ms graph-replayed, {t['library_backend_ms_events'][k]:.4f} events"
                        for k, v in t["library_backend_ms"].items())
            + f"; plain {t['plain_ms']:.4f} ms events; bound {t['bound_ms']:.4f} ms ({t['bound_by']}); "
            f"{A.simt_forward_blocks_per_sm(d_)} simt blocks an SM ({gpu})")
    # row 4m: the "wgmma" instances at padded head dims on the calls the
    # old "mma" kernel took, beside it on the same call (the private
    # override), SDPA, plain and the bound; then a padded call's writes
    wide = {}
    for b, n, h_, d_, entry in WIDE_TIMED:
        t = timings(b, n, entry, "wgmma", h_, d_, old="mma")
        wide[f"{entry} B={b} N={n} H={h_} D={d_}"] = t
        say(f"[3] {entry} bf16 B={b} N={n} H={h_} D={d_} (DP = {A.wgmma_head_dim(d_)}): {line(t)}; the old mma "
            f"kernel on the same call {t['mma_ms']:.4f} ms graph-replayed, {t['mma_ms_events']:.4f} events ({gpu})")
    say("[3] " + padded_writes(dev, gen, backward=False))
    say(f"[3] attention forward vs plain: max err {errs['fused_attention']:.3g} ([B, N, H, D] entry), "
        f"{errs['fused_attention_qkv']:.3g} (qkv entry) (bf16/fp32/fp16, plus1 on/off, N 14/474/1190 at D=64; "
        f"bf16/fp16 N 16/17/33/64/65/128/129 at D=64; fp32 N 1/63/64/65/97 at D=64; D 16/24/128 at N=97, fp32 "
        f"D 24 and 32 (simt); bf16/fp16/fp32 unaligned views at N 97/1190 (simt); bf16/fp16/fp32 D=32 N "
        f"{'/'.join(map(str, D32_NS + (129, 200)))}, plus1 on/off (fp32 on simt); bf16/fp16 D "
        f"{'/'.join(map(str, WIDE_DS))} (2 heads) N {'/'.join(map(str, WIDE_NS))} and D=32 N={TRAIN_N}, plus1 on/off "
        f"(wgmma); bf16 at the serving, timestamp and training shapes, bf16 and fp32 D=32 at the convergence "
        f"demo's, bf16 at row 4m's timed shapes; each within one output ulp at its magnitude, TOL_ATTN below "
        f"|o| = 2); calls per path {taken}")
    rec["fused_attention"] = dict(max_abs_err=errs["fused_attention"], **serve)
    rec["fused_attention_qkv"] = dict(max_abs_err=errs["fused_attention_qkv"], **stamps, training=train,
                                      conv_demo_d32=demo, conv_demo_d32_fp32=demo32, wgmma_padded=wide)
    return rec


def padded_writes(dev: torch.device, gen: torch.Generator, backward: bool) -> str:
    """A padded "wgmma" call writes nothing past D: q, k, v (and dO) as
    [B, N, H, D] views into [B, N, H, 128] buffers, the output (dq, dk, dv)
    as such views into buffers whose other columns hold a sentinel, bf16 and
    fp16, each D of WIDE_DS but 128, plus1 on and off: the sentinel's bits
    unchanged, the views within tolerance of the plain version, every call
    on "wgmma"."""
    from passt_tpu_torch.ops import attention as A

    b, n, h, width, worst = 2, 97, 3, 128, 0.0
    for dtype in (torch.bfloat16, torch.float16):
        for d in WIDE_DS[:-1]:
            for plus1 in (False, True):
                x = torch.randn((4, b, n, h, width), device=dev, generator=gen).to(dtype)
                q, k, v, do = (x[i, ..., :d] for i in range(4))
                sentinel = torch.full((b, n, h, width), -7.0, device=dev, dtype=dtype)
                bufs = [sentinel.clone() for _ in range(3 if backward else 1)]
                outs = [t[..., :d] for t in bufs]
                A.reset_path_launches()
                with torch.no_grad():
                    if backward:
                        A._launch_bwd(q, k, v, do, *outs, d ** -0.5, plus1)
                        refs = A.attention_bwd_plain(q, k, v, do, scale=d ** -0.5, plus1=plus1)
                        err = max(rel_err(o, r) for o, r in zip(outs, refs))
                        ok, counts = err <= TOL_BWD[dtype], A.BWD_PATH_LAUNCHES
                    else:
                        A._launch(q, k, v, outs[0], d ** -0.5, plus1)
                        err, units = attn_err(outs[0], A.attention_plain(q, k, v, scale=d ** -0.5, plus1=plus1))
                        ok, counts = units <= 1.0, A.FWD_PATH_LAUNCHES
                torch.cuda.synchronize()
                what = f"{'backward' if backward else 'forward'} {dtype} D={d} plus1={plus1}"
                check(counts["wgmma"] == 1 == sum(counts.values()), f"padded {what}: paths {counts}")
                check(all(torch.equal(t[..., d:], sentinel[..., d:]) for t in bufs),
                      f"padded {what}: columns past D were written")
                check(ok, f"padded {what}: max err {err:.3g}")
                worst = max(worst, err)
    return (f"padded {'backward' if backward else 'forward'} calls write nothing past D: [B, N, H, D] views into "
            f"[B, N, H, {width}] buffers (B={b} N={n} H={h}, bf16/fp16, D {'/'.join(map(str, WIDE_DS[:-1]))}, "
            f"plus1 on/off, all on wgmma), the sentinel columns' bits unchanged; max err {worst:.3g}"
            + (" of max|ref|" if backward else ""))


def phase_backward(gpu: str, dev: torch.device) -> dict:
    """[3b] the backward kernel through both entries against its plain
    version on the path backward_path picks (every call checked to take
    it), the same bits run to run, then its times at the shapes the
    training paths give it, the old "mma" pair beside the "wgmma" path."""
    from passt_tpu_torch.ops import attention as A
    from passt_tpu_torch.ops.attention import (
        attention_bwd_plain,
        fused_attention_bwd,
        fused_attention_qkv_bwd,
    )

    rng = np.random.default_rng(3)
    gen = torch.Generator(device=dev).manual_seed(3)  # every draw on the card
    heads, hd = 12, 64
    worst = {"fused_attention_bwd": 0.0, "fused_attention_qkv_bwd": 0.0}  # of max|ref|
    worst_abs = dict(worst)
    # (dtype, B, N, plus1, H, D): N 14/474/1190 in three dtypes; for the
    # wgmma path one and two query tiles (65, 128, 129), at B = 12, N = 1190
    # more key blocks than the card holds at once (the dQ order), and at
    # n_plain more key blocks a head than SMs, so that kernel KV of the wgmma
    # and the simt path takes the plain block order, four heads of them more
    # than the card holds at once
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    n_plain = 64 * (sms + 1) + 20
    cases = [(dtype, 2, n, plus1, heads, hd)
             for dtype in (torch.bfloat16, torch.float16, torch.float32)
             for n in (14, 474, 1190) for plus1 in (False, True)]
    cases += [(dtype, 2, n, plus1, heads, hd) for dtype in (torch.bfloat16, torch.float16)
              for n in (65, 128, 129) for plus1 in (False, True)]
    cases += [(torch.bfloat16, 12, 1190, True, heads, hd), (torch.bfloat16, 1, n_plain, False, 4, hd),
              (torch.float32, 1, n_plain, False, 4, hd)]
    cases += [(dtype, 2, 97, True, h_, d_) for dtype in (torch.bfloat16, torch.float32)
              for h_, d_ in ((4, 16), (2, 24), (2, 128))]
    # the convergence demo's D = 32: in bf16 / fp16 "resident" up to N = 128,
    # "wgmma" above (DP = 32); in fp32 "simt" at any N (one to four 64-key
    # tiles)
    cases += [(dtype, 2, n, plus1, CONV_HEADS, CONV_HEAD_DIM) for dtype in (torch.bfloat16, torch.float16)
              for n in D32_NS + (129, 200, TRAIN_N) for plus1 in (False, True)]
    # the "wgmma" instances at padded head dims, bf16 and fp16
    cases += [(dtype, 2, n, plus1, 2, d_) for dtype in (torch.bfloat16, torch.float16) for d_ in WIDE_DS
              for n in WIDE_NS for plus1 in (False, True)]
    cases += [(torch.float32, 2, n, plus1, CONV_HEADS, CONV_HEAD_DIM) for n in D32_NS + (129, 200)
              for plus1 in (False, True)]
    taken = dict.fromkeys(A.BWD_PATHS, 0)
    for dtype, b, n, plus1, h_, d_ in cases:
        qkv = torch.from_numpy(rng.standard_normal((b, n, 3 * h_ * d_)).astype(np.float32)).to(dev, dtype)
        do = torch.from_numpy(rng.standard_normal((b, n, h_, d_)).astype(np.float32)).to(dev, dtype)
        q, k, v = qkv.reshape(b, n, 3, h_, d_).unbind(2)
        scale = d_ ** -0.5
        ref = attention_bwd_plain(q, k, v, do, scale=scale, plus1=plus1)
        A.reset_path_launches()
        got_b = fused_attention_bwd(q, k, v, do, scale=scale, plus1=plus1)
        dqkv = fused_attention_qkv_bwd(qkv, do.reshape(b, n, h_ * d_), heads=h_, head_dim=d_, scale=scale, plus1=plus1)
        got_f = dqkv.reshape(b, n, 3, h_, d_).unbind(2)
        torch.cuda.synchronize()
        path = A.backward_path(n, d_, dtype, True)
        check(A.BWD_PATH_LAUNCHES[path] == 2 == sum(A.BWD_PATH_LAUNCHES.values()),
              f"{dtype} B={b} N={n} D={d_}: backward paths {A.BWD_PATH_LAUNCHES}, want 2 on {path}")
        check(d_ != CONV_HEAD_DIM or path == ("simt" if dtype == torch.float32 else "resident" if n <= 128 else "wgmma"),
              f"{dtype} D=32 N={n}: path {path}")
        check(path not in ("fma", "mma"), f"{dtype} N={n} D={d_}: path {path}")
        taken[path] += 2
        if path in ("simt", "resident") or (path == "wgmma" and ((n, plus1) in ((1190, True), (129, False),
                                                                               (n_plain, False))
                                                                 or (d_ != hd and n > 128))):
            # the ordered dQ sum: the same bits again, through both entries
            again = fused_attention_qkv_bwd(qkv, do.reshape(b, n, h_ * d_), heads=h_, head_dim=d_, scale=scale,
                                            plus1=plus1)
            again_b = fused_attention_bwd(q, k, v, do, scale=scale, plus1=plus1)
            check(torch.equal(dqkv, again) and all(torch.equal(x, y) for x, y in zip(got_b, again_b)),
                  f"{dtype} B={b} N={n}: the backward's bits differ between two runs")
        for name, got in (("fused_attention_bwd", got_b), ("fused_attention_qkv_bwd", got_f)):
            for what, g, r in zip(("dq", "dk", "dv"), got, ref):
                check(g.dtype == dtype and bool(torch.isfinite(g).all()), f"{name} {what}: dtype/finite")
                err = max_err(g, r)
                rel = err / max(float(r.float().abs().max()), 1e-30)
                check(rel <= TOL_BWD[dtype], f"{name} {what} {dtype} B={b} N={n} H={h_} D={d_} plus1={plus1}: "
                      f"max err {rel:.3g} of max|ref| > {TOL_BWD[dtype]:.3g}")
                worst[name] = max(worst[name], rel)
                worst_abs[name] = max(worst_abs[name], err)

    # autograd through views: the [B, N, H, D] entry on unbind views of qkv
    # gets its d(qkv) assembled by autograd from three view gradients; the
    # qkv entry's kernel writes d(qkv) itself. The same kernel math on the
    # same inputs, so the same bits.
    from passt_tpu_torch.ops.attention import fused_attention, fused_attention_qkv

    for dtype in (torch.bfloat16, torch.float32):
        b, n = 2, TRAIN_N
        qkv = torch.from_numpy(rng.standard_normal((b, n, 3 * heads * hd)).astype(np.float32)).to(dev, dtype)
        do = torch.from_numpy(rng.standard_normal((b, n, heads * hd)).astype(np.float32)).to(dev, dtype)
        x1, x2 = qkv.clone().requires_grad_(), qkv.clone().requires_grad_()
        q, k, v = x1.reshape(b, n, 3, heads, hd).unbind(2)
        (g1,) = torch.autograd.grad(fused_attention(q, k, v, scale=hd ** -0.5).reshape(b, n, -1), x1, do)
        (g2,) = torch.autograd.grad(fused_attention_qkv(x2, heads=heads, head_dim=hd, scale=hd ** -0.5), x2, do)
        check(torch.equal(g1, g2), f"{dtype}: d(qkv) through the unbind views != the qkv entry's d(qkv) "
              f"(max err {max_err(g1, g2):.3g})")
    say(f"[3b] d(qkv) assembled by autograd from the [B, N, H, D] entry's view gradients equals the "
        f"qkv entry's d(qkv) bit for bit (bf16 and fp32, B=2 N={TRAIN_N}); the wgmma path gives the same bits "
        f"twice through both entries (bf16/fp16 B=2 N=129, B=2 and B=12 N=1190, B=1 H=4 N={n_plain} in the plain "
        f"block order: {-(-n_plain // 64)} key blocks a head > {sms} SMs), the simt path in every fp32 D=64 case "
        f"(B=1 H=4 N={n_plain} in the plain block order too) and every fp32 D=32 case (N "
        f"{'/'.join(map(str, D32_NS + (129, 200)))}, plus1 on/off), the resident path in every bf16/fp16 D=32 "
        f"case (N {'/'.join(map(str, D32_NS))}, plus1 on/off; N 129/200/{TRAIN_N} on wgmma, DP = 32, the same bits "
        f"twice, as every padded wgmma case above N = 128: D {'/'.join(map(str, WIDE_DS))}); calls per path "
        f"{taken}")

    def bwd_times(kern, q, k, v, do4, scale, peak, math=False) -> dict:
        """The backward kernel call ``kern`` on [B, N, H, D] views q, k, v
        and dO: its times (graph replay, events, profiled kernel time), its
        device kernels, the plain version, SDPA's backward and the bound.
        SDPA's backward alone is the kernel time of its forward and
        autograd.grad together less that of its forward alone, from profiler
        traces. A CUDA graph captures an autograd backward only with its
        forward (each backward op runs on its forward op's stream; the train
        step is captured so, [14]), and this forward-and-backward capture of
        SDPA fails here with cudaErrorStreamCaptureImplicit. Beside it the
        backward alone by CUDA events, and the port's backward by the same
        profiled kernel time. With ``math`` the unfused MATH backend is timed
        alone too."""
        b, n, h, d = q.shape
        ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
        fwd = lambda: sdpa(ql, kl, vl, scale)
        fwd_bwd = lambda: torch.autograd.grad(sdpa(ql, kl, vl, scale), (ql, kl, vl), do4)
        out = fwd()
        lib = lambda: torch.autograd.grad(out, (ql, kl, vl), do4, retain_graph=True)
        backends = sdpa_backends(ql, kl, vl, scale, do4)
        ran = top_kernel(kernel_times(lib, 3))
        t = dict(path=A.backward_path(n, d, q.dtype, True), ms=graph_ms(kern), ms_events=cuda_ms(kern),
                 ms_kernels=kernel_ms(kern),
                 device_kernels=sorted({m_.group(0) for m_ in map(re.compile(r"(attention_bwd|bwd32)_\w+_kernel").search,
                                                                   kernel_times(kern, 2)) if m_}),
                 plain_ms=cuda_ms(lambda: attention_bwd_plain(q, k, v, do4, scale=scale)),
                 library_ms=kernel_ms(fwd_bwd) - kernel_ms(fwd), library_ms_events=cuda_ms(lib),
                 library_kernel=ran, library_backend=backend_of(ran),
                 library_backend_ms={be.name: kernel_ms(under(be, fwd_bwd)) - kernel_ms(under(be, fwd))
                                     for be in backends if be.name != "MATH" or math},
                 # five N x N x D products per head; q, k, v, dO read, dq, dk, dv written
                 **bound(10 * n * n * d * b * h, 7 * b * n * h * d * q.element_size(), peak))
        # the "wgmma" and "simt" paths' own work: 14 N^2 D (4 in kernel S, 10 in kernel KV)
        t.update(design_bound_ms=14 * n * n * d * b * h / peak * 1e3)
        return t

    rec = {}
    # the qkv entry at the bf16 training step's shape; the [B, N, H, D] entry
    # at the fp32 correctness step's (phase 7)
    for name, dtype, b, peak in (("fused_attention_qkv_bwd", torch.bfloat16, TRAIN_B, PEAK_BF16),
                                 ("fused_attention_bwd", torch.float32, 2, PEAK_FP32)):
        n, scale = TRAIN_N, hd ** -0.5
        qkv = torch.randn((b, n, 3 * heads * hd), device=dev, generator=gen).to(dtype)
        do = torch.randn((b, n, heads * hd), device=dev, generator=gen).to(dtype)
        q, k, v = qkv.reshape(b, n, 3, heads, hd).unbind(2)
        do4 = do.view(b, n, heads, hd)
        mma = fma = None
        if name == "fused_attention_qkv_bwd":
            kern = lambda: fused_attention_qkv_bwd(qkv, do, heads=heads, head_dim=hd, scale=scale)
            A.reset_path_launches()
            got = kern().reshape(b, n, 3, heads, hd).unbind(2)
            check(A.BWD_PATH_LAUNCHES["wgmma"] == 1 == sum(A.BWD_PATH_LAUNCHES.values()),
                  f"{name}: backward paths {A.BWD_PATH_LAUNCHES}, want wgmma")

            def mma():
                """The old "mma" pair on the same call (the private override)."""
                dqkv = torch.empty_like(qkv)
                A._launch_bwd(*A._head_views(qkv, heads, hd), do4, *A._head_views(dqkv, heads, hd), scale, False,
                              path="mma")
                return dqkv
            for what, g, r in zip(("dq", "dk", "dv"), mma().reshape(b, n, 3, heads, hd).unbind(2),
                                  attention_bwd_plain(q, k, v, do4, scale=scale)):
                rel = max_err(g, r) / max(float(r.float().abs().max()), 1e-30)
                check(rel <= TOL_BWD[dtype], f"{name} mma path {what}: max err {rel:.3g} of max|ref|")
        else:
            kern = lambda: fused_attention_bwd(q, k, v, do4, scale=scale)
            A.reset_path_launches()
            got = kern()
            check(A.BWD_PATH_LAUNCHES["simt"] == 1 == sum(A.BWD_PATH_LAUNCHES.values()),
                  f"{name}: backward paths {A.BWD_PATH_LAUNCHES}, want simt")

            def fma():
                """The old "fma" pair on the same call (the private override)."""
                grads = [torch.empty((b, n, heads, hd), dtype=dtype, device=dev) for _ in range(3)]
                A._launch_bwd(q, k, v, do4, *grads, scale, False, path="fma")
                return grads
            for what, g, r in zip(("dq", "dk", "dv"), fma(), attention_bwd_plain(q, k, v, do4, scale=scale)):
                rel = max_err(g, r) / max(float(r.float().abs().max()), 1e-30)
                check(rel <= TOL_BWD[dtype], f"{name} fma path {what}: max err {rel:.3g} of max|ref|")
        # the timed inputs, at the training path's shape, against the plain version
        for what, g, r in zip(("dq", "dk", "dv"), got, attention_bwd_plain(q, k, v, do4, scale=scale)):
            err = max_err(g, r)
            rel = err / max(float(r.float().abs().max()), 1e-30)
            check(rel <= TOL_BWD[dtype], f"{name} {what} {dtype} B={b} N={n}: max err {rel:.3g} of max|ref| "
                  f"> {TOL_BWD[dtype]:.3g}")
            worst[name] = max(worst[name], rel)
            worst_abs[name] = max(worst_abs[name], err)
        t = bwd_times(kern, q, k, v, do4, scale, peak)
        old_name, old_fn = ("mma", mma) if mma is not None else ("fma", fma)
        t.update({f"{old_name}_ms": graph_ms(old_fn), f"{old_name}_ms_kernels": kernel_ms(old_fn)})
        old = (f"; the old {old_name} path {t[old_name + '_ms']:.4f} ms graph-replayed, "
               f"{t[old_name + '_ms_kernels']:.4f} of kernels; the design's 14N^2D at peak "
               f"{t['design_bound_ms']:.4f} ms")
        say(f"[3b] {name} vs plain: max err {worst[name]:.3g} of max|ref|, {worst_abs[name]:.3g} absolute "
            f"(bf16/fp16/fp32, plus1 on/off, N 14/474/1190 at D=64; bf16/fp16 N 65/128/129; bf16 B=12 N=1190; "
            f"bf16 B=1 H=4 N={n_plain}; "
            f"D 16/24/128 at N=97; bf16/fp16 D=32 N {'/'.join(map(str, D32_NS + (129,)))}; fp32 D=32 N "
            f"{'/'.join(map(str, D32_NS + (129, 200)))}; the timed inputs); "
            f"{str(dtype)[6:]} B={b} H=12 N={n} D=64: kernel "
            f"({t['path']}: {', '.join(t['device_kernels'])}) "
            f"{t['ms']:.4f} ms graph-replayed, {t['ms_events']:.4f} events, {t['ms_kernels']:.4f} of kernels "
            f"(profiled){old}; plain {t['plain_ms']:.4f} ms; SDPA "
            f"backward {t['library_ms']:.4f} ms of kernels (profiled forward + backward less forward), "
            f"{t['library_ms_events']:.4f} events (ran {t['library_backend']}: {t['library_kernel']}; alone: " + ", ".join(f"{k} {v:.4f}" for k, v in t["library_backend_ms"].items())
            + f" ms); bound {t['bound_ms']:.4f} ms ({t['bound_by']}) ({gpu})")
        rec[name] = dict(max_abs_err=worst_abs[name], **t)

    # row 4o's redesign on a user path: the convergence demo's bf16 backward
    # at 6 heads of D = 32 takes "resident" through the qkv entry, at its
    # training shape (and its eval shape, which runs no backward, for the
    # comparison); the old "mma" pair on the same call through the private
    # override
    demo = {}
    for b, n in CONV_SHAPES:
        h_, d_, scale = CONV_HEADS, CONV_HEAD_DIM, CONV_HEAD_DIM ** -0.5
        qkv = torch.randn((b, n, 3 * h_ * d_), device=dev, generator=gen).to(torch.bfloat16)
        do = torch.randn((b, n, h_ * d_), device=dev, generator=gen).to(torch.bfloat16)
        q, k, v = qkv.reshape(b, n, 3, h_, d_).unbind(2)
        do4 = do.view(b, n, h_, d_)
        kern = lambda: fused_attention_qkv_bwd(qkv, do, heads=h_, head_dim=d_, scale=scale)
        A.reset_path_launches()
        got = kern().reshape(b, n, 3, h_, d_).unbind(2)
        again = kern().reshape(b, n, 3, h_, d_).unbind(2)
        check(A.BWD_PATH_LAUNCHES["resident"] == 2 == sum(A.BWD_PATH_LAUNCHES.values()),
              f"fused_attention_qkv_bwd bf16 B={b} N={n} D={d_}: backward paths {A.BWD_PATH_LAUNCHES}, "
              "want resident")
        check(all(torch.equal(x, y) for x, y in zip(got, again)), f"resident B={b} N={n}: the bits differ")
        dqkv_old = torch.empty_like(qkv)

        def mma():
            """The old "mma" pair on the same call (the private override)."""
            A._launch_bwd(*A._head_views(qkv, h_, d_), do4, *A._head_views(dqkv_old, h_, d_), scale, False,
                          path="mma")
        errs, mma_errs = [], []
        mma()
        ref = attention_bwd_plain(q, k, v, do4, scale=scale)
        for what, g, o, r in zip(("dq", "dk", "dv"), got, dqkv_old.reshape(b, n, 3, h_, d_).unbind(2), ref):
            errs.append(rel_err(g, r))
            mma_errs.append(rel_err(o, r))
            check(max(errs[-1], mma_errs[-1]) <= TOL_BWD[torch.bfloat16], f"fused_attention_qkv_bwd B={b} N={n} "
                  f"D={d_} {what}: max err {errs[-1]:.3g} (resident), {mma_errs[-1]:.3g} (mma) of max|ref|")
        t = bwd_times(kern, q, k, v, do4, scale, PEAK_BF16)
        t.pop("design_bound_ms")
        t.update(mma_ms=graph_ms(mma), mma_ms_kernels=kernel_ms(mma), mma_max_rel_err=max(mma_errs))
        demo[f"B={b} N={n}"] = dict(max_rel_err=max(errs), **t)
        say(f"[3b] fused_attention_qkv_bwd bf16 B={b} H={h_} N={n} D={d_} (the convergence demo's): kernel "
            f"({t['path']}: {', '.join(t['device_kernels'])}) max err {max(errs):.3g} of max|ref|, the same bits "
            f"twice; {t['ms']:.4f} ms graph-replayed, {t['ms_events']:.4f} events, {t['ms_kernels']:.4f} of kernels "
            f"(profiled); the old mma pair on the same call {t['mma_ms']:.4f} ms graph-replayed, "
            f"{t['mma_ms_kernels']:.4f} of kernels; plain "
            f"{t['plain_ms']:.4f} ms; SDPA backward {t['library_ms']:.4f} ms of kernels (profiled forward + backward "
            f"less forward), {t['library_ms_events']:.4f} events (ran {t['library_backend']}: {t['library_kernel']}; "
            "alone: " + ", ".join(f"{k_} {v_:.4f}" for k_, v_ in t["library_backend_ms"].items())
            + f" ms); bound {t['bound_ms']:.4f} ms ({t['bound_by']}) ({gpu})")
    rec["fused_attention_qkv_bwd"]["conv_demo_d32"] = demo

    # row 4f on a user path: the convergence demo's backward at
    # model.dtype=float32 ([20g]) takes the D = 32 instance of the "simt"
    # pair through the qkv entry at its training shape (and at its eval
    # shape, which runs no backward, for the comparison); the old "fma" pair
    # on the same call through the private override; SDPA's EFFICIENT and
    # MATH backends each alone
    demo32 = {}
    for b, n in CONV_SHAPES:
        h_, d_, scale = CONV_HEADS, CONV_HEAD_DIM, CONV_HEAD_DIM ** -0.5
        qkv = torch.randn((b, n, 3 * h_ * d_), device=dev, generator=gen)
        do = torch.randn((b, n, h_ * d_), device=dev, generator=gen)
        q, k, v = qkv.reshape(b, n, 3, h_, d_).unbind(2)
        do4 = do.view(b, n, h_, d_)
        kern = lambda: fused_attention_qkv_bwd(qkv, do, heads=h_, head_dim=d_, scale=scale)
        A.reset_path_launches()
        got = kern().reshape(b, n, 3, h_, d_).unbind(2)
        again = kern().reshape(b, n, 3, h_, d_).unbind(2)
        check(A.BWD_PATH_LAUNCHES["simt"] == 2 == sum(A.BWD_PATH_LAUNCHES.values()),
              f"fused_attention_qkv_bwd fp32 B={b} N={n} D={d_}: backward paths {A.BWD_PATH_LAUNCHES}, want simt")
        check(all(torch.equal(x, y) for x, y in zip(got, again)), f"simt fp32 B={b} N={n} D={d_}: the bits differ")
        dqkv_old = torch.empty_like(qkv)

        def fma():
            """The old "fma" pair on the same call (the private override)."""
            A._launch_bwd(*A._head_views(qkv, h_, d_), do4, *A._head_views(dqkv_old, h_, d_), scale, False,
                          path="fma")
        errs, fma_errs = [], []
        fma()
        ref = attention_bwd_plain(q, k, v, do4, scale=scale)
        for what, g, o, r in zip(("dq", "dk", "dv"), got, dqkv_old.reshape(b, n, 3, h_, d_).unbind(2), ref):
            errs.append(rel_err(g, r))
            fma_errs.append(rel_err(o, r))
            check(max(errs[-1], fma_errs[-1]) <= TOL_BWD[torch.float32], f"fused_attention_qkv_bwd fp32 B={b} "
                  f"N={n} D={d_} {what}: max err {errs[-1]:.3g} (simt), {fma_errs[-1]:.3g} (fma) of max|ref|")
        t = bwd_times(kern, q, k, v, do4, scale, PEAK_FP32, math=True)
        t.update(fma_ms=graph_ms(fma), fma_ms_kernels=kernel_ms(fma), fma_max_rel_err=max(fma_errs))
        demo32[f"B={b} N={n}"] = dict(max_rel_err=max(errs), **t)
        stats_blocks, kv_blocks = A.simt_backward_blocks_per_sm(d_)
        say(f"[3b] fused_attention_qkv_bwd fp32 B={b} H={h_} N={n} D={d_} (the convergence demo's at "
            f"model.dtype=float32): kernel ({t['path']}: {', '.join(t['device_kernels'])}; {stats_blocks} and "
            f"{kv_blocks} blocks an SM) max err {max(errs):.3g} of max|ref|, the same bits twice; {t['ms']:.4f} ms "
            f"graph-replayed, {t['ms_events']:.4f} events, {t['ms_kernels']:.4f} of kernels (profiled); the old fma "
            f"pair on the same call {t['fma_ms']:.4f} ms graph-replayed, {t['fma_ms_kernels']:.4f} of kernels; "
            f"plain {t['plain_ms']:.4f} ms; SDPA backward {t['library_ms']:.4f} ms of kernels (profiled forward + "
            f"backward less forward; ran {t['library_backend']}: {t['library_kernel']}; alone: "
            + ", ".join(f"{k_} {v_:.4f}" for k_, v_ in t["library_backend_ms"].items())
            + f" ms); bound {t['bound_ms']:.4f} ms ({t['bound_by']}); the design's 14N^2D at peak "
            f"{t['design_bound_ms']:.4f} ms ({gpu})")
    rec["fused_attention_qkv_bwd"]["conv_demo_d32_fp32"] = demo32

    # row 4m: the "wgmma" backward at padded head dims and at D = 32 above
    # "resident"'s N, on the calls the old "mma" pair took, beside it on the
    # same call (the private override), SDPA's backward, plain and the bound
    wide = {}
    for b, n, h_, d_ in WIDE_TIMED_BWD:
        scale = d_ ** -0.5
        qkv = torch.randn((b, n, 3 * h_ * d_), device=dev, generator=gen).to(torch.bfloat16)
        do = torch.randn((b, n, h_ * d_), device=dev, generator=gen).to(torch.bfloat16)
        q, k, v = qkv.reshape(b, n, 3, h_, d_).unbind(2)
        do4 = do.view(b, n, h_, d_)
        kern = lambda: fused_attention_qkv_bwd(qkv, do, heads=h_, head_dim=d_, scale=scale)
        A.reset_path_launches()
        got = kern().reshape(b, n, 3, h_, d_).unbind(2)
        check(A.BWD_PATH_LAUNCHES["wgmma"] == 1 == sum(A.BWD_PATH_LAUNCHES.values()),
              f"fused_attention_qkv_bwd bf16 B={b} N={n} H={h_} D={d_}: backward paths {A.BWD_PATH_LAUNCHES}")
        dqkv_old = torch.empty_like(qkv)

        def mma():
            """The old "mma" pair on the same call (the private override)."""
            A._launch_bwd(*A._head_views(qkv, h_, d_), do4, *A._head_views(dqkv_old, h_, d_), scale, False,
                          path="mma")
        mma()
        ref = attention_bwd_plain(q, k, v, do4, scale=scale)
        errs = [rel_err(g, r) for g, r in zip(got, ref)]
        mma_errs = [rel_err(o, r) for o, r in zip(dqkv_old.reshape(b, n, 3, h_, d_).unbind(2), ref)]
        check(max(errs + mma_errs) <= TOL_BWD[torch.bfloat16], f"fused_attention_qkv_bwd B={b} N={n} H={h_} "
              f"D={d_}: max err {max(errs):.3g} (wgmma), {max(mma_errs):.3g} (mma) of max|ref|")
        t = bwd_times(kern, q, k, v, do4, scale, PEAK_BF16)
        t.update(mma_ms=graph_ms(mma), mma_ms_kernels=kernel_ms(mma), mma_max_rel_err=max(mma_errs))
        wide[f"B={b} N={n} H={h_} D={d_}"] = dict(max_rel_err=max(errs), **t)
        say(f"[3b] fused_attention_qkv_bwd bf16 B={b} N={n} H={h_} D={d_} (DP = {A.wgmma_head_dim(d_)}): kernel "
            f"({t['path']}: {', '.join(t['device_kernels'])}) max err {max(errs):.3g} of max|ref|; {t['ms']:.4f} ms "
            f"graph-replayed, {t['ms_events']:.4f} events, {t['ms_kernels']:.4f} of kernels (profiled); the old mma "
            f"pair on the same call {t['mma_ms']:.4f} ms graph-replayed, {t['mma_ms_kernels']:.4f} of kernels; plain "
            f"{t['plain_ms']:.4f} ms; SDPA backward {t['library_ms']:.4f} ms of kernels (profiled forward + backward "
            f"less forward), {t['library_ms_events']:.4f} events (ran {t['library_backend']}: {t['library_kernel']}; "
            "alone: " + ", ".join(f"{k_} {v_:.4f}" for k_, v_ in t["library_backend_ms"].items())
            + f" ms); bound {t['bound_ms']:.4f} ms ({t['bound_by']}); the design's 14N^2D at peak "
            f"{t['design_bound_ms']:.4f} ms ({gpu})")
    rec["fused_attention_qkv_bwd"]["wgmma_padded"] = wide
    say("[3b] " + padded_writes(dev, gen, backward=True))
    return rec


#: [3] / [3b] the "simt" sweep: the ragged N of the 64-row tiles (one, the
#: edges of the first, two and three tiles, the fp32 step's N)
SIMT_NS = (1, 63, 64, 65, 97, 129, 474)
#: [3] / [3b] the "simt" instances timed, (dtype, B, N, H, D, aligned): the
#: fp32 step's shape (C = 768) at 6 heads of D = 128 and 16 of D = 48 (row
#: 2f's and row 4's FLOPs), the convergence demo's training and eval shapes
#: at 2 heads of D = 96 ([20h]) and in bf16 at 8 heads of D = 24, and one
#: fp32 call on views one element off 16-byte alignment
SIMT_TIMED = ((torch.float32, 2, 474, 6, 128, True), (torch.float32, 2, 474, 16, 48, True),
              (torch.float32, 25, 79, 2, 96, True), (torch.float32, 50, 110, 2, 96, True),
              (torch.bfloat16, 25, 79, 8, 24, True), (torch.bfloat16, 50, 110, 8, 24, True),
              (torch.float32, 2, 474, 6, 128, False))


def off_alignment(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` in a view one element off 16-byte alignment."""
    return torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape).copy_(t)


def simt_sweep(gpu: str, dev: torch.device) -> dict:
    """[3] / [3b] the "simt" kernels' instances against their plain versions:
    fp32 at every D from 8 to 128 by 8, bf16 and fp16 at D = 24, 40 and 120,
    each aligned and on views one element off 16-byte alignment, at every N
    of SIMT_NS with plus1 on and off; both entries forward and backward,
    every call checked to take "simt", the backward's bits equal on a second
    call. Returns the worst errors by entry."""
    from passt_tpu_torch.ops import attention as A

    rng = np.random.default_rng(23)
    cases = [(torch.float32, d, al) for d in range(8, 129, 8) for al in (True, False)]
    cases += [(dt, d, al) for dt in (torch.bfloat16, torch.float16) for d in (24, 40, 120) for al in (True, False)]
    worst = dict.fromkeys(("fused_attention", "fused_attention_qkv", "fused_attention_bwd", "fused_attention_qkv_bwd"),
                          0.0)
    by_dp, t0, calls = {}, time.perf_counter(), 0
    for dtype, d, aligned in cases:
        for n in SIMT_NS:
            for plus1 in (False, True):
                b, h, scale = 2, 2, d ** -0.5
                qkv = torch.from_numpy(rng.standard_normal((b, n, 3 * h * d)).astype(np.float32)).to(dev, dtype)
                do = torch.from_numpy(rng.standard_normal((b, n, h * d)).astype(np.float32)).to(dev, dtype)
                if not aligned:
                    qkv, do = off_alignment(qkv), off_alignment(do)
                q, k, v = qkv.reshape(b, n, 3, h, d).unbind(2)
                do4 = do.view(b, n, h, d)
                check(A._aligned(q, k, v, do4) == aligned, f"simt sweep {dtype} D={d} N={n}: alignment")
                A.reset_path_launches()
                with torch.no_grad():
                    fb = A.fused_attention(q, k, v, scale=scale, plus1=plus1)
                    ff = A.fused_attention_qkv(qkv, heads=h, head_dim=d, scale=scale, plus1=plus1)
                gb = A.fused_attention_bwd(q, k, v, do4, scale=scale, plus1=plus1)
                gf = A.fused_attention_qkv_bwd(qkv, do, heads=h, head_dim=d, scale=scale, plus1=plus1)
                gb2 = A.fused_attention_bwd(q, k, v, do4, scale=scale, plus1=plus1)
                gf2 = A.fused_attention_qkv_bwd(qkv, do, heads=h, head_dim=d, scale=scale, plus1=plus1)
                torch.cuda.synchronize()
                what = f"simt sweep {dtype} D={d} N={n} plus1={plus1} aligned={aligned}"
                check(A.FWD_PATH_LAUNCHES["simt"] == 2 == sum(A.FWD_PATH_LAUNCHES.values())
                      and A.BWD_PATH_LAUNCHES["simt"] == 4 == sum(A.BWD_PATH_LAUNCHES.values()),
                      f"{what}: paths {A.FWD_PATH_LAUNCHES}, {A.BWD_PATH_LAUNCHES}")
                check(all(torch.equal(x, y) for x, y in zip(gb, gb2)) and torch.equal(gf, gf2),
                      f"{what}: the backward's bits differ between two calls")
                ref = A.attention_plain(q, k, v, scale=scale, plus1=plus1)
                refs = A.attention_bwd_plain(q, k, v, do4, scale=scale, plus1=plus1)
                errs = {"fused_attention": max_err(fb, ref), "fused_attention_qkv": max_err(ff.view(ref.shape), ref),
                        "fused_attention_bwd": max(rel_err(g, r) for g, r in zip(gb, refs)),
                        "fused_attention_qkv_bwd": max(rel_err(g, r) for g, r in
                                                       zip(gf.reshape(b, n, 3, h, d).unbind(2), refs))}
                for name, err in errs.items():
                    tol = (TOL_ATTN if name in ("fused_attention", "fused_attention_qkv") else TOL_BWD)[dtype]
                    check(err <= tol, f"{what} {name}: max err {err:.3g} > {tol:.3g}")
                    worst[name] = max(worst[name], err)
                key = f"{str(dtype)[6:]} DP={A.simt_head_dim(d)}"
                by_dp[key] = max(by_dp.get(key, 0.0), errs["fused_attention_qkv"], errs["fused_attention"])
                calls += 6
    say(f"[3] / [3b] simt sweep: {len(cases) * len(SIMT_NS) * 2} cases, {calls} kernel calls in "
        f"{time.perf_counter() - t0:.1f} s (fp32 D 8 to 128 by 8, bf16 / fp16 D 24/40/120, each aligned and one "
        f"element off, N {'/'.join(map(str, SIMT_NS))}, plus1 on/off, both entries, forward and backward, every call "
        f"on simt, the backward's bits equal on a second call): forward max err {worst['fused_attention']:.3g} "
        f"([B, N, H, D]), {worst['fused_attention_qkv']:.3g} (qkv); backward {worst['fused_attention_bwd']:.3g}, "
        f"{worst['fused_attention_qkv_bwd']:.3g} of max|ref|; forward by instance "
        + ", ".join(f"{k} {v:.3g}" for k, v in by_dp.items()) + f" ({gpu})")
    return worst


def simt_timings(gpu: str, dev: torch.device) -> tuple:
    """[3] / [3b] the "simt" instances at SIMT_TIMED's calls through the qkv
    entry: the forward by CUDA-graph replay, the backward by graph replay
    and profiled kernel time, each beside the old "fma" kernels on the same
    call (the private path override), SDPA's EFFICIENT and MATH backends
    alone, the plain version (events) and the bound; each checked against
    the plain version and to beat "fma". On the unaligned call SDPA's MATH
    backend alone: its EFFICIENT kernel faulted there with a misaligned
    address on the card (CUDA error 716), which ends the process's CUDA
    context. Returns the forward's and the backward's records by call."""
    from torch.nn.attention import SDPBackend

    from passt_tpu_torch.ops import attention as A

    gen = torch.Generator(device=dev).manual_seed(23)
    fwd_rec, bwd_rec = {}, {}
    for dtype, b, n, h, d, aligned in SIMT_TIMED:
        backends = (SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH) if aligned else (SDPBackend.MATH,)
        scale, peak = d ** -0.5, PEAK_FP32 if dtype == torch.float32 else PEAK_BF16
        qkv = torch.randn((b, n, 3 * h * d), device=dev, generator=gen).to(dtype)
        do = torch.randn((b, n, h * d), device=dev, generator=gen).to(dtype)
        if not aligned:
            qkv, do = off_alignment(qkv), off_alignment(do)
        views, do4 = A._head_views(qkv, h, d), do.view(b, n, h, d)
        key = f"{str(dtype)[6:]} B={b} N={n} H={h} D={d}" + ("" if aligned else " unaligned")
        check(A._aligned(*views, do4) == aligned, f"simt timing {key}: alignment")
        out, dqkv_old = torch.empty((b, n, h, d), dtype=dtype, device=dev), torch.empty_like(qkv)
        kern = lambda: A.fused_attention_qkv(qkv, heads=h, head_dim=d, scale=scale)
        old = lambda: A._launch(*views, out, scale, False, path="fma")
        kern_b = lambda: A.fused_attention_qkv_bwd(qkv, do, heads=h, head_dim=d, scale=scale)
        old_b = lambda: A._launch_bwd(*views, do4, *A._head_views(dqkv_old, h, d), scale, False, path="fma")
        with torch.no_grad():
            ref = A.attention_plain(*views, scale=scale)
            A.reset_path_launches()
            got = kern().view(ref.shape)
            got_b = kern_b()
            again_b = kern_b()
            check(A.FWD_PATH_LAUNCHES["simt"] == 1 == sum(A.FWD_PATH_LAUNCHES.values())
                  and A.BWD_PATH_LAUNCHES["simt"] == 2 == sum(A.BWD_PATH_LAUNCHES.values()),
                  f"simt timing {key}: paths {A.FWD_PATH_LAUNCHES}, {A.BWD_PATH_LAUNCHES}")
            check(torch.equal(got_b, again_b), f"simt timing {key}: the backward's bits differ")
            old()
            old_b()
            refs = A.attention_bwd_plain(*views, do4, scale=scale)
            err, old_err = max_err(got, ref), max_err(out, ref)
            errs_b = [rel_err(g, r) for g, r in zip(got_b.reshape(b, n, 3, h, d).unbind(2), refs)]
            old_errs_b = [rel_err(g, r) for g, r in zip(A._head_views(dqkv_old, h, d), refs)]
            check(max(err, old_err) <= TOL_ATTN[dtype] and max(errs_b + old_errs_b) <= TOL_BWD[dtype],
                  f"simt timing {key}: max err {err:.3g} / {max(errs_b):.3g} (simt), {old_err:.3g} / "
                  f"{max(old_errs_b):.3g} (fma)")
            lib = lambda: sdpa(*views, scale)
            f = dict(path="simt", dp=A.simt_head_dim(d), max_abs_err=err, ms=graph_ms(kern), fma_ms=graph_ms(old),
                     fma_max_abs_err=old_err, plain_ms=cuda_ms(lambda: A.attention_plain(*views, scale=scale)),
                     library_backend_ms={be.name: graph_ms(under(be, lib)) for be in backends},
                     blocks_per_sm=A.simt_forward_blocks_per_sm(d, dtype, aligned),
                     **bound(4 * n * n * d * b * h, 4 * b * n * h * d * qkv.element_size(), peak))
        ql, kl, vl = (t.detach().clone().requires_grad_() for t in views)
        fwd = lambda: sdpa(ql, kl, vl, scale)
        fwd_bwd = lambda: torch.autograd.grad(sdpa(ql, kl, vl, scale), (ql, kl, vl), do4)
        g = dict(path="simt", dp=A.simt_head_dim(d), max_rel_err=max(errs_b), ms=graph_ms(kern_b),
                 ms_kernels=kernel_ms(kern_b), fma_ms=graph_ms(old_b), fma_ms_kernels=kernel_ms(old_b),
                 fma_max_rel_err=max(old_errs_b),
                 plain_ms=cuda_ms(lambda: A.attention_bwd_plain(*views, do4, scale=scale)),
                 library_backend_ms={be.name: kernel_ms(under(be, fwd_bwd)) - kernel_ms(under(be, fwd))
                                     for be in backends},
                 blocks_per_sm=A.simt_backward_blocks_per_sm(d, dtype, aligned),
                 **bound(10 * n * n * d * b * h, 7 * b * n * h * d * qkv.element_size(), peak))
        del ql, kl, vl
        check(f["ms"] < f["fma_ms"] and g["ms_kernels"] < g["fma_ms_kernels"],
              f"simt timing {key}: simt {f['ms']:.4f} / {g['ms_kernels']:.4f} ms not under the old fma "
              f"{f['fma_ms']:.4f} / {g['fma_ms_kernels']:.4f}")
        lib_f = ", ".join(f"{k} {v:.4f}" for k, v in f["library_backend_ms"].items())
        lib_b = ", ".join(f"{k} {v:.4f}" for k, v in g["library_backend_ms"].items())
        say(f"[3] fused_attention_qkv simt {key} (DP = {f['dp']}, {f['blocks_per_sm']} blocks an SM): kernel "
            f"{f['ms']:.4f} ms graph-replayed, max err {err:.3g}; the old fma kernel on the same call "
            f"{f['fma_ms']:.4f} ({f['fma_ms'] / f['ms']:.2f}x); SDPA alone {lib_f} ms graph-replayed; plain "
            f"{f['plain_ms']:.4f} ms events; bound {f['bound_ms']:.4f} ms ({f['bound_by']}) ({gpu})")
        say(f"[3b] fused_attention_qkv_bwd simt {key} (DP = {g['dp']}, blocks an SM (S, KV) {g['blocks_per_sm']}): "
            f"kernels {g['ms_kernels']:.4f} ms profiled, {g['ms']:.4f} graph-replayed, max err {max(errs_b):.3g} of "
            f"max|ref|, the same bits twice; the old fma pair on the same call {g['fma_ms_kernels']:.4f} profiled "
            f"({g['fma_ms_kernels'] / g['ms_kernels']:.2f}x), {g['fma_ms']:.4f} graph-replayed; SDPA backward alone "
            f"{lib_b} ms profiled (forward + backward less forward); plain {g['plain_ms']:.4f} ms events; bound "
            f"{g['bound_ms']:.4f} ms ({g['bound_by']}) ({gpu})")
        fwd_rec[key], bwd_rec[key] = f, g
    return fwd_rec, bwd_rec


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """Max error relative to max|ref|."""
    return max_err(got, ref) / max(float(ref.float().abs().max()), 1e-30)


def phase_layernorm(gpu: str, dev: torch.device) -> dict:
    """[3c] the LayerNorm-backward, F1 and B2 kernels against their plain
    versions, then their times at the training step's shapes."""
    from passt_tpu_torch.ops import _build
    from passt_tpu_torch.ops.layernorm import layer_norm_bwd, layer_norm_bwd_plain, ln_forward
    from passt_tpu_torch.ops import ln_qkv as L
    from passt_tpu_torch.ops.ln_qkv import ln_qkv_b2, ln_qkv_b2_plain, ln_qkv_f1, ln_qkv_f1_plain

    rng = np.random.default_rng(4)
    c0 = 768

    def arr(shape, scale=1.0, offset=0.0, dtype=torch.float32):
        return (torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) * scale + offset).to(dev, dtype)

    worst = {"layer_norm_bwd": 0.0, "ln_qkv_f1": 0.0, "ln_qkv_b2": 0.0}  # of max|ref|
    worst_abs = dict(worst)

    def hold(name, what, got, ref, tol):
        check(got.dtype == ref.dtype and got.shape == ref.shape and bool(torch.isfinite(got).all()),
              f"{name} {what}: dtype/shape/finite")
        rel = rel_err(got, ref)
        check(rel <= tol, f"{name} {what}: max err {rel:.3g} of max|ref| > {tol:.3g}")
        worst[name] = max(worst[name], rel)
        worst_abs[name] = max(worst_abs[name], max_err(got, ref))

    def ln_case(m, c, dtype):
        x = arr((m, c), dtype=dtype)
        dy = arr((m, c))
        scale, bias = arr((c,), 0.1, 1.0), arr((c,), 0.1)
        _, mu, rstd = ln_forward(x, scale, bias, 1e-6)
        return x, dy, mu, rstd, scale

    # the LayerNorm backward: the training step's rows (bf16 x with f32 dy,
    # and f32 x), ragged M, other C
    for m, c, dtype in ((TRAIN_B * TRAIN_N, c0, torch.bfloat16), (TRAIN_B * TRAIN_N, c0, torch.float32),
                        (1000, 64, torch.bfloat16), (77, 384, torch.float32), (333, 8, torch.float16),
                        (41, 1024, torch.float32)):
        args = ln_case(m, c, dtype)
        got, ref = layer_norm_bwd(*args), layer_norm_bwd_plain(*args)
        torch.cuda.synchronize()
        for what, g, r in zip(("dx", "dscale", "dbias"), got, ref):
            tol = TOL_LN_DX[dtype] if what == "dx" else TOL_LN_SUMS
            hold("layer_norm_bwd", f"{what} {str(dtype)[6:]} M={m} C={c}", g, r, tol)

    # F1 and B2: bf16 at the training step's and the timestamp windows'
    # shapes, fp32 at the fp32 step's (patchout 80/4: N = 154) and windows',
    # fp16 small
    def qkv_case(b, n, dtype, c=c0):
        x = arr((b, n, c), dtype=dtype)
        s, bb = arr((c,), 0.1, 1.0), arr((c,), 0.1)
        w, wb = arr((3 * c, c), 0.02, dtype=dtype), arr((3 * c,), 0.02, dtype=dtype)
        return x, s, bb, w, wb

    sms = _build.sm_count(dev)
    f1_plans = {}

    def hold_f1(b, n, dtype, c, x, s, bb, w, wb):
        got, ref = ln_qkv_f1(x, s, bb, w, wb), ln_qkv_f1_plain(x, s, bb, w, wb)
        torch.cuda.synchronize()
        hold("ln_qkv_f1", f"{str(dtype)[6:]} B={b} N={n} C={c}", got, ref, TOL_QKV[dtype])
        plan = L.f1_plan_kernel(dtype, b * n, c, sms)
        check(plan[:5] == L.f1_plan(dtype, b * n, c, sms), f"F1 plan {plan} != ops/ln_qkv.py f1_plan")
        f1_plans[(dtype, b * n, c)] = plan

    for b, n, dtype in ((TRAIN_B, TRAIN_N, torch.bfloat16), (256, 14, torch.bfloat16), (2, 154, torch.float32),
                        (256, 14, torch.float32), (3, 47, torch.float16), (TRAIN_B, TRAIN_N, torch.float16)):
        hold_f1(b, n, dtype, c0, *qkv_case(b, n, dtype))
    # B2 (and F1 on the same inputs) at the training step's and the fp32
    # step's shapes and at other widths (F1: C 64 to 1024 on both of its
    # tiles and, in fp32, each K split; B2: the bf16/fp16 clusters split C
    # into one to six CTAs of one to three 64-column blocks, the fp32 ones K
    # into eight ranges over 16 rows), ragged in the rows: 5688 + 37, 37,
    # fewer than one 16-row tile; every B2 case checked for the same bits on
    # a second run
    b2_cases = [(TRAIN_B, TRAIN_N, torch.bfloat16, c0), (2, 154, torch.float32, c0), (3, 47, torch.float16, c0),
                (2, 47, torch.bfloat16, 192), (2, 33, torch.bfloat16, 1024), (2, 20, torch.float16, 320),
                (1, 9, torch.float32, 64), (2, 47, torch.float32, 192), (2, 20, torch.float32, 320),
                (2, 33, torch.float32, 1024), (1, 37, torch.float32, c0),
                (1, TRAIN_B * TRAIN_N + 37, torch.float32, c0), (TRAIN_B, TRAIN_N, torch.float16, c0),
                (1, TRAIN_B * TRAIN_N + 37, torch.bfloat16, c0), (1, TRAIN_B * TRAIN_N + 37, torch.float16, c0),
                (1, 37, torch.bfloat16, c0)]
    b2_cases += [(1, m_, dtype, c) for c in (64, 384, 1024) for dtype in (torch.bfloat16, torch.float16)
                 for m_ in (TRAIN_B * TRAIN_N, 37)]
    b2_same = 0
    for b, n, dtype, c in b2_cases:
        x, s, bb, w, wb = qkv_case(b, n, dtype, c)
        if (dtype, b * n, c) not in f1_plans:
            hold_f1(b, n, dtype, c, x, s, bb, w, wb)
        dqkv = arr((b, n, 3 * c), dtype=dtype)
        got, ref = ln_qkv_b2(x, dqkv, w, s, bb), ln_qkv_b2_plain(x, dqkv, w, s, bb)
        torch.cuda.synchronize()
        for what, g, r in zip(("dx", "xn", "dscale", "dbias"), got, ref):
            hold("ln_qkv_b2", f"{what} {str(dtype)[6:]} B={b} N={n} C={c}", g, r,
                 TOL_QKV[dtype] if what in ("dx", "xn") else TOL_LN_SUMS)
        again = ln_qkv_b2(x, dqkv, w, s, bb)
        torch.cuda.synchronize()
        check(all(torch.equal(g, a) for g, a in zip(got, again)),
              f"ln_qkv_b2 {str(dtype)[6:]} M={b * n} C={c}: another run gave other bits")
        b2_same += 1

    rec = {}
    # times: CUDA-graph replays (graph_ms), so the wrappers' host work (a
    # ctypes launch, allocations, the partials' sum) does not hide the
    # device time of these short calls.
    # the LayerNorm backward at the training step's rows, bf16 x, f32 dy;
    # the library yardstick is ATen's LayerNorm backward on the same x and
    # statistics (it takes dy and the weight in x's dtype)
    m = TRAIN_B * TRAIN_N
    x, dy, mu, rstd, scale = ln_case(m, c0, torch.bfloat16)
    dy_x, w_x, b_x = dy.to(x.dtype), scale.to(x.dtype), torch.zeros_like(scale, dtype=x.dtype)
    lib = lambda: torch.ops.aten.native_layer_norm_backward(dy_x, x, [c0], mu, rstd, w_x, b_x,
                                                            [True, True, True])
    t = dict(ms=graph_ms(lambda: layer_norm_bwd(x, dy, mu, rstd, scale)),
             plain_ms=graph_ms(lambda: layer_norm_bwd_plain(x, dy, mu, rstd, scale)),
             library_ms=graph_ms(lib),
             # ~10 FLOP an element; x (bf16) and dy (f32) read, dx (bf16) written
             **bound(10 * m * c0, m * c0 * (2 + 4 + 2), PEAK_FP32))
    say(f"[3c] layer_norm_bwd vs plain: max err {worst['layer_norm_bwd']:.3g} of max|ref| (dx, dscale, "
        f"dbias; bf16/fp32/fp16 x, M 5688/1000/77/333/41, C 768/64/384/8/1024); bf16 M={m} C={c0}: "
        f"kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, ATen LN backward {t['library_ms']:.4f} ms, "
        f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}) ({gpu})")
    rec["layer_norm_bwd"] = dict(max_abs_err=worst_abs["layer_norm_bwd"], **t)

    # F1 and B2: no single library call computes either; beside them, the
    # bare cuBLAS product of the same shape, and two library calls that
    # compute the same function (ATen's LayerNorm forward then the product;
    # the product then ATen's LayerNorm backward)
    for name, b, n, dtype in (("ln_qkv_f1", TRAIN_B, TRAIN_N, torch.bfloat16),
                              ("ln_qkv_f1", 256, 14, torch.bfloat16),
                              ("ln_qkv_f1", 2, 154, torch.float32),
                              ("ln_qkv_f1", 256, 14, torch.float32),
                              ("ln_qkv_b2", TRAIN_B, TRAIN_N, torch.bfloat16),
                              ("ln_qkv_b2", 2, 154, torch.float32)):
        x, s, bb, w, wb = qkv_case(b, n, dtype)
        mrows, esize = b * n, x.element_size()
        peak = PEAK_FP32 if dtype == torch.float32 else PEAK_BF16
        s_x, b_x = s.to(dtype), bb.to(dtype)
        if name == "ln_qkv_f1":
            kern = lambda: ln_qkv_f1(x, s, bb, w, wb)
            plain = lambda: ln_qkv_f1_plain(x, s, bb, w, wb)
            gemm = lambda: torch.matmul(x, w.t())
            # ATen's LayerNorm forward (two-pass variance), then the product
            two = lambda: torch.matmul(torch.ops.aten.native_layer_norm(x, [c0], s_x, b_x, 1e-6)[0], w.t())
            nbytes = (mrows * c0 + 3 * c0 * c0 + 3 * c0 + mrows * 3 * c0) * esize + 2 * c0 * 4
        else:
            dqkv = arr((b, n, 3 * c0), dtype=dtype)
            kern = lambda: ln_qkv_b2(x, dqkv, w, s, bb)
            plain = lambda: ln_qkv_b2_plain(x, dqkv, w, s, bb)
            gemm = lambda: torch.matmul(dqkv, w)
            # the product, then ATen's LayerNorm backward on it (statistics
            # from ATen's forward, outside the timing)
            _, mu_, rstd_ = torch.ops.aten.native_layer_norm(x, [c0], s_x, b_x, 1e-6)
            two = lambda: torch.ops.aten.native_layer_norm_backward(
                torch.matmul(dqkv, w), x, [c0], mu_, rstd_, s_x, b_x, [True, True, True])
            # x, dqkv, W read; dx, xn written; s, b read and dscale, dbias written in fp32
            nbytes = (mrows * c0 * 3 + mrows * 3 * c0 + 3 * c0 * c0) * esize + 4 * c0 * 4
        t = dict(ms=graph_ms(kern), plain_ms=graph_ms(plain), library_ms=None,
                 **bound(2 * mrows * c0 * 3 * c0, nbytes, peak))
        t["gemm_ms"], t["two_library_calls_ms"] = graph_ms(gemm), graph_ms(two)
        if name == "ln_qkv_f1":
            bm, bn, ck, tiles, grid, resident = f1_plans[(dtype, mrows, c0)]
            t.update(tile=[bm, bn], k_split=ck, tiles=tiles, ctas=grid, resident_ctas=resident)
            what = "ATen's LayerNorm forward plus the product"
            shape = (f"{tiles} tiles of {bm} x {bn}" + (f", K split over clusters of {ck}" if ck > 1 else "")
                     + f": {grid} CTAs, {min(grid, resident)} in flight ({resident} resident at most), "
                     + (f"{tiles / grid:.2f} tiles a CTA" if dtype != torch.float32 else
                        f"{grid / resident:.2f} waves"))
        else:
            code = 0 if dtype == torch.float32 else 1
            rows = L.B2_ROWS_FP32 if dtype == torch.float32 else L.B2_ROWS
            check(L._lib().passt_ln_qkv_b2_rows(code) == rows, "B2's row tile != ops/ln_qkv.py's")
            ctas, active = L.b2_clusters(c0, dtype)
            clusters = -(-mrows // rows)
            t.update(cluster_ctas=ctas, active_clusters=active, clusters=clusters)
            what = "the product plus ATen's LayerNorm backward"
            shape = (f"{clusters} clusters of {ctas} CTAs ({rows} rows each): {clusters * ctas} CTAs, "
                     f"{active} clusters resident at once, {clusters / active:.2f} waves; same bits on two runs "
                     f"in {b2_same} cases")
        say(f"[3c] {name} vs plain: max err {worst[name]:.3g} of max|ref| (bf16/fp32/fp16; C 768/192/1024/"
            f"320/64/384; M ragged to 9, 37 and 5688 + 37; the shapes below); {str(dtype)[6:]} B={b} N={n} "
            f"C={c0}: kernel {t['ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, no single library call "
            f"(the bare cuBLAS product {t['gemm_ms']:.4f} ms, {what} {t['two_library_calls_ms']:.4f} ms), "
            f"bound {t['bound_ms']:.4f} ms ({t['bound_by']}); {shape} ({gpu})")
        if name not in rec:  # the record keeps the training step's shape
            rec[name] = dict(max_abs_err=worst_abs[name], **t)
    return rec


def phase_int8(gpu: str, dev: torch.device) -> dict:
    """[3d] the int8 GEMM kernel's three epilogues against their plain
    versions, then their times at the int8 MLP's and the micro-benchmark's
    shapes."""
    from passt_tpu_torch.ops import _build
    from passt_tpu_torch.ops import int8 as I
    from passt_tpu_torch.ops.int8 import (
        int8_dense_forward,
        int8_dense_plain,
        int8_matmul,
        int8_matmul_plain,
        quantize_rows,
        quantized_dense,
        quantized_dense_plain,
    )
    from passt_tpu_torch.tools.int8_matmul_micro import SHAPES

    gen = torch.Generator(device=dev).manual_seed(8)
    m0 = TRAIN_B * TRAIN_N
    worst = {"int8_dense": 0.0, "int8_dense_gelu": 0.0, "int8_matmul": 0.0}  # absolute

    def hold(name, what, got, ref, tol):
        check(got.dtype == ref.dtype and got.shape == ref.shape and bool(torch.isfinite(got.float()).all()),
              f"{name} {what}: dtype/shape/finite")
        if tol == 0:
            check(torch.equal(got, ref), f"{name} {what}: not bit-equal (max err {max_err(got, ref):.3g})")
        else:
            check(rel_err(got, ref) <= tol, f"{name} {what}: max err {rel_err(got, ref):.3g} of max|ref| > {tol:.3g}")
        worst[name] = max(worst[name], max_err(got, ref))

    # the dense epilogues: fc1 (GELU) and fc2 of the int8 MLP at the training
    # token count (bf16 and fp32) and the eval count (bf16, as phase [10]
    # runs it: 14280 = 111 x 128 + 72 rows), ragged M, K and N; a zero row of
    # x and a zero weight column
    m_eval = TRAIN_B * 1190
    exact = []
    I.reset_path_launches()
    for m, k, n, dtypes in ((m0, 768, 3072, (torch.bfloat16, torch.float32)),
                            (m0, 3072, 768, (torch.bfloat16, torch.float32)),
                            (m_eval, 768, 3072, (torch.bfloat16,)), (m_eval, 3072, 768, (torch.bfloat16,)),
                            (130, 40, 96, (torch.bfloat16, torch.float32)),
                            (130, 64, 96, (torch.bfloat16, torch.float32)),
                            (300, 200, 333, (torch.bfloat16, torch.float32))):
        for dtype in dtypes:
            x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
            w = (torch.randn((k, n), generator=gen, device=dev) * 0.02).to(dtype)
            b = torch.randn(n, generator=gen, device=dev) * 0.01
            x[3], w[:, 5] = 0, 0
            for gelu in ((True, False) if k != 3072 else (False,)):
                got, ref = int8_dense_forward(x, w, b, gelu), int8_dense_plain(x, w, b, gelu)
                torch.cuda.synchronize()
                what = f"{str(dtype)[6:]} {m}x{k}->{n}"
                if gelu:
                    hold("int8_dense_gelu", f"h {what}", got[0], ref[0], TOL_INT8[dtype])
                    hold("int8_dense_gelu", f"d {what}", got[1], ref[1], TOL_INT8[dtype])
                    exact.append(torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]))
                else:
                    hold("int8_dense", what, got, ref, TOL_INT8[dtype])
                    exact.append(torch.equal(got, ref))
    # the RAW epilogue: the micro-benchmark's four shapes and ragged ones (M
    # and N multiples of no compiled tile, K of no 128 bytes); rows and
    # columns of 127s push the int32 sums past 2**24. int8 -> int32 at the
    # ragged shapes and 8192^3 in every compiled tile too, and on the old
    # mma loop (the private path, timed below), which counts its own launches
    ragged = ((130, 40, 96), (300, 200, 333), (1000, 4000, 520))
    old_calls = 0
    for m, k, n in (*SHAPES.values(), *ragged):
        a = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
        bt = torch.randint(-127, 128, (n, k), generator=gen, device=dev, dtype=torch.int8)
        a[0], bt[0] = 127, 127
        for out in (torch.int32, torch.bfloat16):
            hold("int8_matmul", f"int8 -> {str(out)[6:]} {m}x{k}x{n}", int8_matmul(a, bt.t(), out),
                 int8_matmul_plain(a, bt.t(), out), 0)
        if (m, k, n) in ragged or (m, k, n) == SHAPES["square_8192"]:
            ref = int8_matmul_plain(a, bt.t(), torch.int32)
            for tile, (bm, bn) in enumerate(I.TILES):
                hold("int8_matmul", f"int8 -> int32 {m}x{k}x{n} tile {bm}x{bn}",
                     int8_matmul(a, bt.t(), torch.int32, _tile=tile), ref, 0)
            hold("int8_matmul", f"int8 -> int32 {m}x{k}x{n} old mma loop",
                 int8_matmul(a, bt.t(), torch.int32, _path="mma"), ref, 0)
            old_calls += 1
        af = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        bf = torch.randn((n, k), generator=gen, device=dev).to(torch.bfloat16)
        hold("int8_matmul", f"bf16 {m}x{k}x{n}", int8_matmul(af, bf.t(), torch.bfloat16),
             int8_matmul_plain(af, bf.t(), torch.bfloat16), TOL_INT8[torch.bfloat16])
    paths = dict(I.PATH_LAUNCHES)
    check(paths["mma"] == old_calls and paths["wgmma"] > 0,
          f"[3d] int8 calls took {paths}, want all wgmma but the {old_calls} private mma ones")
    say(f"[3d] int8 GEMM (wgmma loop) vs plain: dense/GELU (bf16, fp32; {m0}x768->3072, {m0}x3072->768, "
        f"130x40/64->96, 300x200->333; bf16 {m_eval}x768->3072, {m_eval}x3072->768; a zero row and column) max err "
        f"{worst['int8_dense']:.3g} / {worst['int8_dense_gelu']:.3g}, bit-equal in {sum(exact)}/{len(exact)} cases; "
        f"int8 -> int32 and -> bf16 bit-equal at {', '.join(SHAPES)}, 130x40x96, 300x200x333 and 1000x4000x520, "
        f"int8 -> int32 in every tile {I.TILES} and on the old mma loop at the ragged shapes and 8192^3; "
        f"bf16 -> bf16 within "
        f"{TOL_INT8[torch.bfloat16]:g} of max|ref|; loop launches {paths}")

    rec = {}
    # the dense epilogues on quantized operands (the kernel's function), bf16
    # out; CUDA-graph replays, the events time beside them
    for name, k, n, gelu in (("int8_dense_gelu", 768, 3072, True), ("int8_dense", 3072, 768, False)):
        x = torch.randn((m0, k), generator=gen, device=dev).to(torch.bfloat16)
        w = (torch.randn((k, n), generator=gen, device=dev) * 0.02).to(torch.bfloat16)
        b = torch.zeros(n, device=dev)
        qx, sx = quantize_rows(x)
        qwt, sw = quantize_rows(w.t())
        qwt = qwt.contiguous()
        kern = lambda: quantized_dense(qx, sx, qwt, sw, b, out_dtype=torch.bfloat16, gelu=gelu)
        plain = lambda: quantized_dense_plain(qx, sx, qwt, sw, b, out_dtype=torch.bfloat16, gelu=gelu)
        old = lambda: quantized_dense(qx, sx, qwt, sw, b, out_dtype=torch.bfloat16, gelu=gelu, _path="mma")
        # the timed calls on these inputs: the new and the old loop bit-equal to plain
        ref = plain()
        for loop, got in (("wgmma", kern()), ("old mma", old())):
            for part, g, r in (zip(("h", "d"), got, ref) if gelu else (("y", got, ref),)):
                hold(name, f"{part} bf16 {m0}x{k}->{n} timed inputs, {loop} loop", g, r, 0)
        tiles = {f"{bm}x{bn}": graph_ms(lambda: quantized_dense(qx, sx, qwt, sw, b, out_dtype=torch.bfloat16,
                                                                gelu=gelu, _tile=i))
                 for i, (bm, bn) in enumerate(I.TILES)}
        # qx, qwt read; sx, sw, b read in fp32; y (or h and d) written in bf16
        nbytes = m0 * k + n * k + 4 * (m0 + 2 * n) + (2 if gelu else 1) * m0 * n * 2
        t = dict(ms=graph_ms(kern), plain_ms=graph_ms(plain), library_ms=None, mma_ms=graph_ms(old),
                 tile=I.TILES[I.pick_tile(m0, n, _build.sm_count(dev), gelu=gelu)],
                 tile_ms=tiles, **bound(2 * m0 * k * n, nbytes, PEAK_INT8))
        events, int_mm = cuda_ms(kern), graph_ms(lambda: torch._int_mm(qx, qwt.t()))
        bf16_mm = graph_ms(lambda: torch.matmul(x, w))
        say(f"[3d] {name} bf16 {m0}x{k}->{n}: kernel (wgmma, tile {t['tile']}) {t['ms']:.4f} ms (graph; "
            f"{events:.4f} ms under events; each tile: " + ", ".join(f"{k_} {v:.4f}" for k_, v in tiles.items())
            + f"), the old mma loop {t['mma_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, no single library call (the "
            f"bare torch._int_mm product {int_mm:.4f} ms, the bf16 cuBLAS GEMM {bf16_mm:.4f} ms), bound "
            f"{t['bound_ms']:.4f} ms ({t['bound_by']}) ({gpu})")
        rec[name] = dict(max_abs_err=worst[name], **t)

    # the RAW epilogue at 8192^3, int8 -> int32, beside torch._int_mm
    m, k, n = SHAPES["square_8192"]
    a = torch.randint(-127, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
    bt = torch.randint(-127, 128, (n, k), generator=gen, device=dev, dtype=torch.int8)
    kern = lambda: int8_matmul(a, bt.t(), torch.int32)
    old = lambda: int8_matmul(a, bt.t(), torch.int32, _path="mma")
    lib = lambda: torch._int_mm(a, bt.t())
    ref = int8_matmul_plain(a, bt.t(), torch.int32)
    hold("int8_matmul", f"int8 -> int32 {m}x{k}x{n} timed inputs, wgmma loop", kern(), ref, 0)
    hold("int8_matmul", f"int8 -> int32 {m}x{k}x{n} timed inputs, old mma loop", old(), ref, 0)
    del ref
    # in turns: new, old, library, library, old, new
    turns = {"ms": [], "mma_ms": [], "library_ms": []}
    for key, fn in (("ms", kern), ("mma_ms", old), ("library_ms", lib), ("library_ms", lib), ("mma_ms", old),
                    ("ms", kern)):
        turns[key].append(cuda_ms(fn, reps=5))
    t = {key: min(v) for key, v in turns.items()}
    t.update(plain_ms=cuda_ms(lambda: int8_matmul_plain(a, bt.t(), torch.int32), reps=5),
             tile=I.TILES[I.pick_tile(m, n, _build.sm_count(dev), gelu=False)],
             tile_ms={f"{bm}x{bn}": cuda_ms(lambda: int8_matmul(a, bt.t(), torch.int32, _tile=i), reps=5)
                      for i, (bm, bn) in enumerate(I.TILES)},
             **bound(2 * m * k * n, m * k + n * k + 4 * m * n, PEAK_INT8))
    check(t["ms"] < t["mma_ms"], f"[3d] 8192^3: the wgmma loop {t['ms']:.4f} ms is not faster than the old "
          f"mma loop {t['mma_ms']:.4f} ms")
    say(f"[3d] int8_matmul int8 -> int32 {m}x{k}x{n}: kernel (wgmma, tile {t['tile']}) {t['ms']:.4f} ms = "
        f"{2 * m * k * n / t['ms'] / 1e9:.1f} TOP/s (best of two turns; each tile: "
        + ", ".join(f"{k_} {v:.4f}" for k_, v in t["tile_ms"].items())
        + f"), the old mma loop {t['mma_ms']:.4f} ms, torch._int_mm {t['library_ms']:.4f} ms, plain (float64) "
        f"{t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}) ({gpu})")
    rec["int8_matmul"] = dict(max_abs_err=worst["int8_matmul"], **t)
    return rec


def phase_fused_mlp(gpu: str, dev: torch.device) -> dict:
    """[3e] the fused MLP's forward (with and without residuals) and backward
    kernels against their plain versions, then their times at the A/B's
    shapes beside the bare cuBLAS pair of products."""
    from passt_tpu_torch.ops import _build
    from passt_tpu_torch.ops.fused_mlp import (
        fused_mlp_bwd,
        fused_mlp_bwd_plain,
        fused_mlp_fwd,
        fused_mlp_fwd_plain,
        plan,
        plan_kernel,
    )

    gen = torch.Generator(device=dev).manual_seed(12)
    m0, m_eval = TRAIN_B * TRAIN_N, TRAIN_B * 1190
    worst = {"fused_mlp_fwd": 0.0, "fused_mlp_bwd": 0.0}  # of max|ref|
    worst_abs = dict(worst)

    def hold(name, what, got, ref, tol):
        check(got.dtype == ref.dtype and got.shape == ref.shape and bool(torch.isfinite(got.float()).all()),
              f"{name} {what}: dtype/shape/finite")
        rel = rel_err(got, ref)
        check(rel <= tol, f"{name} {what}: max err {rel:.3g} of max|ref| > {tol:.3g}")
        worst[name] = max(worst[name], rel)
        worst_abs[name] = max(worst_abs[name], max_err(got, ref))

    def randn(shape, scale, dtype):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def case(m, c, h, dtype):
        """x (a zero row), w1, b1, w2, b2 as the A/B draws them, with small
        non-zero biases."""
        x = randn((m, c), 1.0, dtype)
        x[3] = 0
        return x, randn((c, h), 0.02, dtype), randn((h,), 0.1, dtype), randn((h, c), 0.02, dtype), \
            randn((c,), 0.1, dtype)

    # the A/B's token counts at PaSST-S width (bf16 and fp32), ragged M with
    # small C and H; residuals off and on; the backward on each case's d.
    # Then the cluster's other shapes: C 256 (2 CTAs; H 192 leaves the
    # second 128-unit chunk half empty), C 448 (3 CTAs, the last with one of
    # its three column blocks; H 448 ends in a third of a chunk) and C 704 (4
    # CTAs, the last one block short; H 320: the second chunk's 64 units in
    # the first CTA alone)
    cases = [(m0, 768, 3072, torch.bfloat16), (m0, 768, 3072, torch.float32), (m_eval, 768, 3072, torch.bfloat16),
             (m_eval, 768, 3072, torch.float32), (130, 64, 256, torch.bfloat16), (130, 64, 256, torch.float32),
             (77, 192, 128, torch.bfloat16), (77, 192, 128, torch.float32),
             (33, 256, 192, torch.bfloat16), (150, 448, 448, torch.bfloat16), (21, 704, 320, torch.bfloat16)]
    sms = _build.sm_count(dev)
    for m, c, h, dtype in cases:
        args = case(m, c, h, dtype)
        what = f"{str(dtype)[6:]} M={m} C={c} H={h}"
        if dtype == torch.bfloat16:
            for bwd in (False, True):
                rows, cs, ctas, resident, waves = plan_kernel(m, c, bwd)
                check(0 < resident <= sms // cs and (rows, cs, ctas, waves) == plan(m, c, sms, resident),
                      f"fused MLP plan {(rows, cs, ctas, resident, waves)} at {what} (bwd {bwd}) != ops/fused_mlp.py "
                      f"plan {plan(m, c, sms, resident)} at {resident} clusters resident (at most {sms // cs})")
        ref = fused_mlp_fwd_plain(*args, residuals=True)
        got = fused_mlp_fwd(*args, residuals=True)
        y_only = fused_mlp_fwd(*args, residuals=False)
        again = fused_mlp_fwd(*args, residuals=True)
        torch.cuda.synchronize()
        for part, g, r in zip(("y", "g", "d"), got, ref):
            hold("fused_mlp_fwd", f"{part} {what}", g, r, TOL_MLP[dtype])
        check(torch.equal(y_only, got[0]), f"fused_mlp_fwd {what}: y without residuals != y with them")
        if dtype == torch.bfloat16:
            check(all(torch.equal(a, b) for a, b in zip(got, again)), f"fused_mlp_fwd {what}: bits differ run to run")
        dy = randn((m, c), 1.0, dtype)
        got = fused_mlp_bwd(dy, ref[2], args[1], args[3])
        want = fused_mlp_bwd_plain(dy, ref[2], args[1], args[3])
        again = fused_mlp_bwd(dy, ref[2], args[1], args[3])
        torch.cuda.synchronize()
        hold("fused_mlp_bwd", f"dx {what}", got[0], want[0], TOL_MLP_DX[dtype])
        hold("fused_mlp_bwd", f"dh {what}", got[1], want[1], TOL_MLP[dtype])
        if dtype == torch.bfloat16:
            check(all(torch.equal(a, b) for a, b in zip(got, again)), f"fused_mlp_bwd {what}: bits differ run to run")
    say(f"[3e] fused MLP vs plain (bf16, fp32; M {m0}/{m_eval} at 768/3072, M 130 at 64/256, M 77 at 192/128; "
        f"bf16 M 33 at 256/192, M 150 at 448/448, M 21 at 704/320; a zero row; residuals off and on): forward max err {worst['fused_mlp_fwd']:.3g}, backward "
        f"{worst['fused_mlp_bwd']:.3g} of max|ref|; y bit-equal with and without residuals; bf16 forward and "
        f"backward bit-equal run to run; every bf16 plan as ops/fused_mlp.py's")

    rec = {}
    # times by CUDA-graph replay; beside them the bare cuBLAS pair of the
    # same products (no single library call computes either function)
    c, h = 768, 3072
    for m in (m0, m_eval):
        x, w1, b1, w2, b2 = case(m, c, h, torch.bfloat16)
        gh = randn((m, h), 1.0, torch.bfloat16)
        dy, d = randn((m, c), 1.0, torch.bfloat16), randn((m, h), 1.0, torch.bfloat16)
        flops, wbytes = 4 * m * c * h, (2 * c * h + h + c) * 2
        fwd = dict(ms=graph_ms(lambda: fused_mlp_fwd(x, w1, b1, w2, b2, residuals=False)),
                   plain_ms=graph_ms(lambda: fused_mlp_fwd_plain(x, w1, b1, w2, b2, residuals=False)),
                   library_ms=None, **bound(flops, wbytes + 2 * m * c * 2, PEAK_BF16))
        res_ms = graph_ms(lambda: fused_mlp_fwd(x, w1, b1, w2, b2, residuals=True))
        pair_f = graph_ms(lambda: (torch.matmul(x, w1), torch.matmul(gh, w2)))
        bwd = dict(ms=graph_ms(lambda: fused_mlp_bwd(dy, d, w1, w2)),
                   plain_ms=graph_ms(lambda: fused_mlp_bwd_plain(dy, d, w1, w2)),
                   library_ms=None, **bound(flops, 2 * c * h * 2 + 2 * m * (c + h) * 2, PEAK_BF16))
        pair_b = graph_ms(lambda: (torch.matmul(dy, w2.t()), torch.matmul(gh, w1.t())))
        rows, cs, ctas, resident, waves = plan_kernel(m, c)
        config = (f"rows {rows}, {cs} CTAs a cluster, {ctas} CTAs, {resident} clusters resident, "
                  f"{waves} wave{'s' * (waves != 1)}")
        say(f"[3e] fused_mlp_fwd bf16 M={m} C={c} H={h} ({config}): kernel {fwd['ms']:.4f} ms "
            f"({res_ms:.4f} with residuals), plain {fwd['plain_ms']:.4f} ms, no single library call (the bare "
            f"cuBLAS pair x.W1, g.W2 {pair_f:.4f} ms), bound {fwd['bound_ms']:.4f} ms ({fwd['bound_by']}) ({gpu})")
        say(f"[3e] fused_mlp_bwd bf16 M={m} C={c} H={h} ({config}): kernel {bwd['ms']:.4f} ms, plain "
            f"{bwd['plain_ms']:.4f} ms, "
            f"no single library call (the bare cuBLAS pair dy.W2^T, dh.W1^T {pair_b:.4f} ms), bound "
            f"{bwd['bound_ms']:.4f} ms ({bwd['bound_by']}) ({gpu})")
        if m == m0:  # the record keeps the training token count
            rec["fused_mlp_fwd"] = dict(max_abs_err=worst_abs["fused_mlp_fwd"], **fwd)
            rec["fused_mlp_bwd"] = dict(max_abs_err=worst_abs["fused_mlp_bwd"], **bwd)
    return rec


def phase_serving(gpu: str, dev: torch.device) -> dict:
    from passt_tpu_torch.hear import Predictor
    from passt_tpu_torch.ops import _build
    from passt_tpu_torch.ops import attention as A

    pred = Predictor.create(arch=ARCH, dtype="bfloat16", device=dev,
                            generator=torch.Generator().manual_seed(0))
    cfg = pred.model.cfg
    check((cfg.embed_dim, cfg.depth, cfg.num_heads, cfg.num_classes) == (768, 12, 12, 527),
          f"not PaSST-S width: {cfg}")
    rng = np.random.default_rng(1)
    w20 = torch.from_numpy(rng.standard_normal((20, CLIP)).astype(np.float32) * 0.1).to(dev)
    w2s = torch.from_numpy(rng.standard_normal((1, 64000)).astype(np.float32) * 0.1).to(dev)

    _build.reset_launches()
    A.reset_path_launches()
    logits1 = pred(w20[:1])
    logits20, feats20 = pred.logits_and_features(w20)
    scene = pred.scene_embeddings(w20)
    ts_emb, ts = pred.timestamp_embeddings(w2s)
    torch.cuda.synchronize()
    launches = {name: _build.LAUNCHES.get(name, 0) for name in KERNEL_NAMES}
    paths = dict(A.FWD_PATH_LAUNCHES)

    check(tuple(logits1.shape) == (1, 527) and tuple(logits20.shape) == (20, 527), "logits shape")
    check(tuple(scene.shape) == (20, 527 + 768), f"scene shape {tuple(scene.shape)}")
    check(tuple(ts_emb.shape) == (1, 40, 527 + 768) and tuple(ts.shape) == (1, 40),
          f"timestamp shapes {tuple(ts_emb.shape)}, {tuple(ts.shape)}")
    for name, t in (("logits1", logits1), ("logits20", logits20), ("scene", scene), ("timestamps", ts_emb)):
        check(bool(torch.isfinite(t).all()), f"{name} not finite")
    # the same clip alone and in a batch of 20 (bf16: cuBLAS may pick other
    # GEMM tilings per batch, so the bf16 rounding differs a little)
    b1_err = max_err(logits1[0], logits20[0])
    check(b1_err < 5e-2, f"B=1 vs B=20 row 0: {b1_err:.3g}")
    # 3 clip-level calls + 1 timestamp chunk: one mel launch each; 12 blocks
    # per forward at N = 1190 on the [B, N, H, D] entry, at N = 14 on qkv
    want = want_launches(fused_log_mel=4, fused_attention=36, fused_attention_qkv=12)
    check(launches == want, f"launches {launches} != {want}")
    # the clip-level calls at N = 1190 on "wgmma", the timestamp windows at
    # N = 14 on "short"
    want_paths = dict(fma=0, mma=0, short=12, wgmma=36, simt=0)
    check(paths == want_paths, f"forward paths {paths} != {want_paths}")
    say(f"[4] serving PaSST-S bf16 (random weights, seed 0): B=1, B=20 logits, scene "
        f"[20, 1295], timestamps [1, 40, 1295]; launches {launches}; forward paths {paths}")

    ms20 = cuda_ms(lambda: pred(w20), reps=5, warmup=1)
    ms1 = cuda_ms(lambda: pred(w20[:1]), reps=10, warmup=2)
    say(f"[4] Predictor bf16 B=20 x 10 s: {ms20:.3f} ms/call = {20000.0 / ms20:.2f} clips/s; "
        f"B=1: {ms1:.3f} ms/call ({gpu})")
    return launches


def phase_correctness(dev: torch.device) -> None:
    from passt_tpu_torch.hear import Predictor
    from passt_tpu_torch.models.passt import PaSST, PaSSTConfig
    from passt_tpu_torch.ops.frontend import MelConfig, log_mel_spectrogram

    fix_dir = os.path.join(ROOT, "tests", "fixtures")

    # full width fp32: kernels vs plain versions on the same weights
    kern = Predictor.create(arch=ARCH, dtype="float32", device=dev,
                            generator=torch.Generator().manual_seed(0))
    plain = Predictor.create(arch=ARCH, dtype="float32", device=dev, attn_impl="xla",
                             mel_cfg=dataclasses.replace(kern.mel_cfg, stft_method="matmul"))
    plain.model.load_state_dict(kern.model.state_dict())
    wave = torch.from_numpy(
        np.random.default_rng(2).standard_normal((2, CLIP)).astype(np.float32) * 0.1
    ).to(dev)
    lk, fk = kern.logits_and_features(wave)
    lp, fp = plain.logits_and_features(wave)
    # fp32 on both sides; the kernels sum in another order (800-sample DFT
    # sums, 1190-key softmax sums) and near-empty mel bins move by up to 1e-3
    # through the log, which 12 blocks carry into the outputs
    l_err, f_err = max_err(lk, lp), max_err(fk, fp)
    check(l_err < 5e-3 and f_err < 5e-3, f"fp32 kernels vs plain: logits {l_err:.3g}, features {f_err:.3g}")
    say(f"[5] fp32 PaSST-S, kernels vs plain versions: logits err {l_err:.3g}, features err "
        f"{f_err:.3g} (tol 5e-3)")

    # the repo's golden fixtures (reference torch outputs), through the kernels
    fix = np.load(os.path.join(fix_dir, "mel_flagship.npz"))
    mel = log_mel_spectrogram(torch.from_numpy(fix["wave"]).to(dev),
                              MelConfig(fmin_aug_range=10, fmax_aug_range=2000))
    mel_err = mel_strong_check(mel.cpu(), torch.from_numpy(fix["mel"]), "golden mel")
    fix = np.load(os.path.join(fix_dir, "model_fullgeom.npz"))
    model = PaSST(PaSSTConfig(embed_dim=128, depth=3, num_heads=2, attn_impl="fused"))
    model.load_state_dict({k[3:]: torch.from_numpy(fix[k]) for k in fix.files if k.startswith("sd.")})
    with torch.inference_mode():
        logits, features = model.eval().to(dev)(torch.from_numpy(fix["x"]).to(dev))
    l_err = max_err(logits.cpu(), torch.from_numpy(fix["logits"]))
    f_err = max_err(features.cpu(), torch.from_numpy(fix["features"]))
    check(l_err < 2e-4 and f_err < 2e-4, f"golden model: logits {l_err:.3g}, features {f_err:.3g}")
    say(f"[5] golden fixtures through the kernels: mel err {mel_err:.3g}; N=1190 model "
        f"logits err {l_err:.3g}, features err {f_err:.3g} (tol 2e-4)")


#: the forward paths of one fp32 model call at D = 64: every block on "simt"
FP32_FWD_PATHS = dict(fma=0, mma=0, short=0, wgmma=0, simt=12)
#: every kernel wrapper's count; a main path's want lists the ones it launches
KERNEL_NAMES = ("fused_log_mel", "fused_attention", "fused_attention_qkv", "fused_attention_bwd",
                "fused_attention_qkv_bwd", "layer_norm_bwd", "ln_qkv_f1", "ln_qkv_b2", "int8_dense",
                "int8_dense_gelu", "int8_matmul", "fused_mlp_fwd", "fused_mlp_bwd")


def want_launches(**counts) -> dict:
    """The exact launch counts of a run: the named ones, 0 for the rest."""
    return {name: counts.get(name, 0) for name in KERNEL_NAMES}


#: the bf16-SR train step's wrappers: KERNEL_NAMES and the one-pass
#: optimizer's, which ports no TPU kernel (XLA fuses it on the TPU)
STEP_NAMES = KERNEL_NAMES + ("adamw_sr",)


def step_launches() -> dict:
    """The launch counts of STEP_NAMES since the last reset."""
    from passt_tpu_torch.ops import _build

    return {name: _build.LAUNCHES.get(name, 0) for name in STEP_NAMES}


def want_step(**counts) -> dict:
    """A bf16-SR step's exact launches a step: the named ones and one
    ``adamw_sr``."""
    return dict(want_launches(**counts), adamw_sr=1)


#: the bench step's launches per step, by the model overrides of each variant
STEP_LAUNCHES = {
    "default": want_step(fused_log_mel=1, fused_attention_qkv=12, fused_attention_qkv_bwd=12),
    "fuse_ln_qkv": want_step(fused_log_mel=1, ln_qkv_f1=12, fused_attention_qkv=12,
                             fused_attention_qkv_bwd=12, ln_qkv_b2=12),
    "ln_impl=fused": want_step(fused_log_mel=1, fused_attention_qkv=12, fused_attention_qkv_bwd=12,
                               layer_norm_bwd=25),
}
VARIANTS = {"default": {}, "fuse_ln_qkv": dict(fuse_ln_qkv=True), "ln_impl=fused": dict(ln_impl="fused")}


def train_steps(gpu: str, dev: torch.device, variant: str) -> dict:
    """The bench's bf16 training step at full width under one variant of
    its model config, through the port's own entry points
    (passt_tpu_torch.bench): 2 warm-up and 10 timed steps."""
    from passt_tpu_torch import bench
    from passt_tpu_torch.ops import _build
    from passt_tpu_torch.ops import attention as A
    from passt_tpu_torch.train import optim

    model, state, step, batch = bench.setup(dev, **VARIANTS[variant])
    cfg = model.cfg
    check((cfg.embed_dim, cfg.depth, cfg.num_heads, cfg.num_classes) == (768, 12, 12, 527),
          f"not PaSST-S width: {cfg}")
    check(cfg.seq_len(train=True) == TRAIN_N, f"train sequence {cfg.seq_len(train=True)} != {TRAIN_N}")
    before = {k: v.clone() for k, v in state.params.items()}
    warmup, steps = 2, 10
    _build.reset_launches()
    A.reset_path_launches()
    optim.OPTIM_PATHS.update(fused=0, foreach=0)
    state, ms, loss = bench.timed_steps(step, state, batch, steps, warmup)
    torch.cuda.synchronize()
    launches = step_launches()
    paths = dict(A.FWD_PATH_LAUNCHES)
    bwd_paths = dict(A.BWD_PATH_LAUNCHES)

    n = warmup + steps
    check(optim.OPTIM_PATHS == dict(fused=n, foreach=0), f"{variant}: optimizer paths {optim.OPTIM_PATHS}, "
          f"want fused on each of {n} steps")
    check(state.step == n, f"{variant}: step counter {state.step} != {n}")
    check(bool(torch.isfinite(loss)), f"{variant}: loss {float(loss)} not finite")
    still = {k for k, v in state.params.items() if torch.equal(before[k], v)}
    moved = len(before) - len(still)
    # every leaf in the forward moves; head_dist is in the checkpoint only,
    # so its gradient is 0 and weight decay alone (lr * wd * p, ~1e-12) can
    # only move its bf16 weight by a rare stochastic rounding
    check(still <= {"head_dist.weight", "head_dist.bias"},
          f"{variant}: parameter leaves that did not move: {sorted(still)}")
    want = {k: v * n for k, v in STEP_LAUNCHES[variant].items()}
    check(launches == want, f"{variant}: training launches {launches} != {want} ({n} steps)")
    want_paths = dict(fma=0, mma=0, short=0, wgmma=12 * n, simt=0)  # every block's forward at N = 474
    check(paths == want_paths, f"{variant}: forward paths {paths} != {want_paths}")
    want_bwd = dict(fma=0, mma=0, resident=0, wgmma=12 * n, simt=0)  # every block's backward at N = 474
    check(bwd_paths == want_bwd, f"{variant}: backward paths {bwd_paths} != {want_bwd}")
    phase = "[6]" if variant == "default" else "[8]"
    say(f"{phase} training step PaSST-S bf16 B={TRAIN_B} N={TRAIN_N} ({variant}; mixup, bf16 SR AdamW and "
        f"params; graphed): {ms:.3f} ms/step = {TRAIN_B * 1000.0 / ms:.2f} specs/s over {steps} steps after "
        f"{warmup}; "
        f"mean loss {float(loss):.5f}; {moved}/{len(before)} leaves moved; launches per step "
        f"{ {k: v // n for k, v in launches.items() if v} }; forward paths per step "
        f"{ {k: v // n for k, v in paths.items() if v} }, backward paths per step "
        f"{ {k: v // n for k, v in bwd_paths.items() if v} } ({gpu})")
    return launches


def phase_adamw_sr(gpu: str, dev: torch.device) -> None:
    """[6o] the one-pass optimizer (train/optim.py adamw_sr,
    csrc/adamw_sr.cu) on PaSST-S's 159 leaves in their storage dtypes (bf16
    matrices, fp32 vectors, bf16 gradients and moments, values at the
    trained model's scale from a seeded generator): the kernel bit-equal to
    its plain version on the card (parameters, mu, nu), with its scalars
    and seeds read from device memory and passed by value; its mu equal to
    the ``_foreach`` update's, and its fp32 leaves counted where they equal
    that apply's (no SR draws in either); its time by
    CUDA-graph replay and profiled kernel time beside its byte bound (each
    value read and written once), the plain version on the card, and the
    ``_foreach`` update and apply_updates_sr it replaces, both by profiled
    kernel time."""
    from passt_tpu_torch.models.passt import PaSST, PaSSTConfig
    from passt_tpu_torch.ops import _build
    from passt_tpu_torch.train import optim

    with torch.device("meta"):
        net = PaSST(PaSSTConfig())
    shapes = {k: tuple(p.shape) for k, p in net.named_parameters()}
    check(len(shapes) == 159, f"[6o] PaSST-S has {len(shapes)} leaves, not 159")
    gen = torch.Generator().manual_seed(6)
    params = optim.cast_params_storage({k: torch.randn(s, generator=gen) * 0.02 for k, s in shapes.items()},
                                       "bfloat16_sr")
    mu = {k: (torch.randn(s, generator=gen) * 1e-4).to(torch.bfloat16) for k, s in shapes.items()}
    nu = {k: (torch.rand(s, generator=gen) * 1e-8).to(torch.bfloat16) for k, s in shapes.items()}
    grads = {k: (torch.randn(p.shape, generator=gen) * 1e-4).to(p.dtype) for k, p in params.items()}
    names = list(shapes)
    on_card = [[d[k].to(dev) for k in names] for d in (grads, mu, nu, params)]
    hyper = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4)
    lr, c1, c2, seeds = 2e-5, float(np.float32(0.271)), float(np.float32(0.002997)), {"nu": optim.fold_seed(
        "adamw_bf16sr.nu", 3), "apply_updates_sr": optim.fold_seed("apply_updates_sr", 2)}
    dev_scalars = dict(lr=torch.tensor(lr, device=dev), c1=torch.tensor(c1, device=dev),
                       c2=torch.tensor(c2, device=dev),
                       seeds={k: torch.tensor(v, dtype=torch.int64, device=dev) for k, v in seeds.items()})
    by_value = dict(lr=lr, c1=c1, c2=c2, seeds=seeds)
    want = optim.adamw_sr_plain(*on_card, names=names, **by_value, **hyper)

    def bits(t: torch.Tensor) -> torch.Tensor:
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else t.view(torch.int32)

    _build.reset_launches()
    differ = {}
    for how, kw in (("device", dev_scalars), ("value", by_value)):
        got = optim.adamw_sr(*on_card, names=names, **kw, **hyper)
        for part, gs, ws in zip(("params", "mu", "nu"), got, want):
            bad = [(k, int((bits(g) != bits(w)).sum())) for k, g, w in zip(names, gs, ws)
                   if not torch.equal(bits(g), bits(w))]
            if bad:
                differ[f"{how} {part}"] = bad[:4]
    torch.cuda.synchronize()
    check(not differ, f"[6o] adamw_sr kernel != its plain version: {differ} (leaf, values)")
    check(_build.LAUNCHES["adamw_sr"] == 2, f"[6o] adamw_sr launches {_build.LAUNCHES['adamw_sr']} != 2")
    del want

    def fused():
        optim.adamw_sr(*on_card, names=names, **dev_scalars, **hyper)

    def plain():
        optim.adamw_sr_plain(*on_card, names=names, **dev_scalars, **hyper)

    tx = optim.adamw_bf16sr(lr, weight_decay=hyper["weight_decay"])
    state = optim.AdamState(2, dict(zip(names, on_card[1])), dict(zip(names, on_card[2])))
    g_card, p_card = dict(zip(names, on_card[0])), dict(zip(names, on_card[3]))
    sr_gen = {k: torch.Generator(device=dev).manual_seed(v) for k, v in seeds.items()}

    def composition():
        inputs = {"lr": dev_scalars["lr"], "c1": dev_scalars["c1"], "c2": dev_scalars["c2"], "nu": sr_gen["nu"]}
        upd, new_state = tx.update(g_card, state, p_card, inputs)
        return optim.apply_updates_sr(p_card, upd, sr_gen["apply_updates_sr"]), new_state.mu

    # the composition's bits where no SR draws: mu, and the fp32 leaves' sums
    comp_p, comp_mu = composition()
    mu_diff = [k for k, m in zip(names, got[1]) if not torch.equal(bits(m), bits(comp_mu[k]))]
    fp32 = [i for i, k in enumerate(names) if params[k].dtype == torch.float32]
    fp32_same = sum(int(torch.equal(got[0][i], comp_p[names[i]])) for i in fp32)
    check(not mu_diff, f"[6o] adamw_sr's mu != the _foreach update's in {mu_diff[:4]}")
    del comp_p, comp_mu, got

    graph = graph_ms(fused)
    profiled = kernel_ms(fused)
    plain_ms, foreach_ms = kernel_ms(plain, reps=3), kernel_ms(composition, reps=3)
    values = sum(int(np.prod(s)) for s in shapes.values())
    nbytes = sum(int(np.prod(shapes[k])) * (2 * (2 + 2) + grads[k].element_size() + 2 * params[k].element_size())
                 for k in names)
    b = bound(0.0, nbytes, 1.0)
    say(f"[6o] adamw_sr on PaSST-S's {len(names)} leaves ({values:,} values, {nbytes / 1e9:.3f} GB read and "
        f"written once): kernel bit-equal to its plain version in parameters, mu and nu, scalars and seeds from "
        f"device memory and by value; mu bit-equal to the _foreach update's, fp32 leaves bit-equal to its apply's "
        f"in {fp32_same}/{len(fp32)}; {graph:.4f} ms graph replay, {profiled:.4f} ms profiled, bound "
        f"{b['bound_ms']:.4f} ms ({100 * b['bound_ms'] / graph:.1f}% of it); plain version {plain_ms:.4f} ms "
        f"profiled; the _foreach update + apply_updates_sr it replaces {foreach_ms:.4f} ms profiled ({gpu})")


#: [6w] the bench's step at PaSST-S width over 6 heads (D = 128) against
#: the same step under attn_impl="xla": the mean loss of the timed steps
#: within the port's bf16 bound (TOL_STACKED_BF16's 2e-2 of max(1, |ref|))
WIDE_STEP_HEADS = 6


def wide_heads_step(gpu: str, dev: torch.device) -> dict:
    """[6w] the bench's bf16 training step at full PaSST-S width over 6
    heads of D = 128 (``bench.setup(dev, num_heads=6)``): 2 warm-up and 10
    timed steps, graphed, every attention call on the "wgmma" kernels'
    DP = 128 instances ("mma" 0), exact launches; its mean loss against the
    same steps under ``attn_impl="xla"``; then its ms/step and the 12-head
    step's in turns (12, 6, 6, 12 heads, 10 steps each)."""
    from passt_tpu_torch import bench
    from passt_tpu_torch.ops import _build
    from passt_tpu_torch.ops import attention as A

    model, state, step, batch = bench.setup(dev, num_heads=WIDE_STEP_HEADS)
    cfg = model.cfg
    d = cfg.embed_dim // cfg.num_heads
    check((cfg.embed_dim, cfg.depth, cfg.num_heads, cfg.num_classes, d) == (768, 12, WIDE_STEP_HEADS, 527, 128),
          f"[6w] not PaSST-S width at 6 heads: {cfg}")
    check(A.forward_path(TRAIN_N, d, torch.bfloat16, True) == A.backward_path(TRAIN_N, d, torch.bfloat16, True)
          == "wgmma", "[6w] D = 128 is not on the wgmma kernels")
    warmup, steps = 2, 10
    _build.reset_launches()
    A.reset_path_launches()
    state, ms, loss = bench.timed_steps(step, state, batch, steps, warmup)
    torch.cuda.synchronize()
    launches = step_launches()
    paths, bwd_paths = dict(A.FWD_PATH_LAUNCHES), dict(A.BWD_PATH_LAUNCHES)
    n = warmup + steps
    want = {k: v * n for k, v in STEP_LAUNCHES["default"].items()}
    check(launches == want, f"[6w] training launches {launches} != {want} ({n} steps)")
    want_paths = dict.fromkeys(A.FWD_PATHS, 0)
    want_paths["wgmma"] = 12 * n
    check(paths == want_paths, f"[6w] forward paths {paths} != {want_paths}")
    want_bwd = dict.fromkeys(A.BWD_PATHS, 0)
    want_bwd["wgmma"] = 12 * n
    check(bwd_paths == want_bwd, f"[6w] backward paths {bwd_paths} != {want_bwd}")
    check(bool(torch.isfinite(loss)) and state.step == n, f"[6w] loss {float(loss)}, step {state.step}")
    # the same steps with the attention in plain PyTorch, from the same weights and draws
    _, xstate, xstep, xbatch = bench.setup(dev, num_heads=WIDE_STEP_HEADS, attn_impl="xla")
    xstate, xms, xloss = bench.timed_steps(xstep, xstate, xbatch, steps, warmup)
    gap = abs(float(loss) - float(xloss))
    check(gap <= TOL_STACKED_BF16 * max(1.0, abs(float(xloss))),
          f"[6w] mean loss {float(loss):.5f} against attn_impl=xla's {float(xloss):.5f}")
    del xstate, xstep
    # in turns with the 12-head step
    _, state12, step12, batch12 = bench.setup(dev)
    state12, _, _ = bench.timed_steps(step12, state12, batch12, 1, warmup)
    runs = {12: [], WIDE_STEP_HEADS: []}
    for heads in (12, WIDE_STEP_HEADS, WIDE_STEP_HEADS, 12):
        if heads == 12:
            state12, t, _ = bench.timed_steps(step12, state12, batch12, steps, 0)
        else:
            state, t, _ = bench.timed_steps(step, state, batch, steps, 0)
        runs[heads].append(t)
    say(f"[6w] training step PaSST-S bf16 B={TRAIN_B} N={TRAIN_N} at {WIDE_STEP_HEADS} heads of D = {d} (bench.setup("
        f"num_heads={WIDE_STEP_HEADS}); graphed): {ms:.3f} ms/step over {steps} steps after {warmup}; mean loss "
        f"{float(loss):.5f} against attn_impl=xla's {float(xloss):.5f} ({xms:.3f} ms/step; |gap| {gap:.2e}, limit "
        f"{TOL_STACKED_BF16} of max(1, |ref|)); launches per step { {k: v // n for k, v in launches.items() if v} }; "
        f"forward wgmma {paths['wgmma'] // n}, backward wgmma {bwd_paths['wgmma'] // n} a step, mma {paths['mma']} / "
        f"{bwd_paths['mma']}; in turns (12, 6, 6, 12 heads, {steps} steps each): 12 heads "
        f"{', '.join(f'{t:.3f}' for t in runs[12])} ms/step, {WIDE_STEP_HEADS} heads "
        f"{', '.join(f'{t:.3f}' for t in runs[WIDE_STEP_HEADS])} ({gpu})")
    return launches


def fp32_step(dev: torch.device, cfg_kwargs: dict, stft_method: str, init_params=None) -> dict:
    """One fp32 training step at full width (B = 2) from seed-0 weights (or
    ``init_params``) and the bench's seed, recording the gradients and the
    optimizer's updates; returns the loss, gradients, updates, new
    parameters, launches and the attention's paths."""
    from passt_tpu_torch import bench
    from passt_tpu_torch.models.passt import PaSSTConfig
    from passt_tpu_torch.ops import _build
    from passt_tpu_torch.ops import attention as A
    from passt_tpu_torch.ops.frontend import MelConfig
    from passt_tpu_torch.train.optim import GradientTransformation
    from passt_tpu_torch.train.steps import create_train_state, make_optimizer, make_train_step

    cfg = PaSSTConfig(dtype="float32", **cfg_kwargs)
    tx = make_optimizer(lr=2e-5, steps_per_epoch=1000)
    grads, updates = {}, {}

    def update(g, opt_state, params, inputs=None):
        grads.update(g)  # the step's gradients, on their way to the optimizer
        u, opt_state = tx.update(g, opt_state, params, inputs)
        updates.update(u)  # and the optimizer's updates, before the apply
        return u, opt_state

    recorder = GradientTransformation(tx.init, update, tx.plan)
    model, state = create_train_state(cfg, recorder, torch.Generator().manual_seed(0), device=dev)
    if init_params is not None:
        from passt_tpu_torch.train.steps import TrainState

        params = {k: v.to(dev) for k, v in init_params.items()}
        state = TrainState(params=params, opt_state=recorder.init(params), step=0)
    # eager: the recorder keeps the tensors of this one call
    step = make_train_step(model, recorder,
                           MelConfig(fmin_aug_range=10, fmax_aug_range=2000, stft_method=stft_method), jit=False)
    rng = np.random.default_rng(5)
    batch = {
        "wave": torch.from_numpy(rng.standard_normal((2, CLIP)).astype(np.float32) * 0.1).to(dev),
        "target": torch.from_numpy((rng.uniform(size=(2, 527)) < 0.05).astype(np.float32)).to(dev),
    }
    _build.reset_launches()
    A.reset_path_launches()
    new_state, metrics = step(state, batch, bench.SEED)
    torch.cuda.synchronize()
    return dict(loss=float(metrics["loss"]), grads=grads, updates=updates, params=new_state.params,
                launches={name: _build.LAUNCHES.get(name, 0) for name in KERNEL_NAMES},
                bwd_paths=dict(A.BWD_PATH_LAUNCHES),
                fwd_paths=dict(A.FWD_PATH_LAUNCHES), n=cfg.seq_len(train=True))


def hold_fp32_step(k: dict, p: dict, what: str) -> str:
    """Hold a kernel step against a plain one (see TOL_STEP_*); returns the
    summary."""
    from passt_tpu_torch.train.steps import make_schedule

    lr0 = make_schedule(lr=2e-5, steps_per_epoch=1000)(0)  # the rate of this first step
    check(not any(p["launches"].values()), f"{what}: plain step launched kernels: {p['launches']}")
    loss_err = abs(k["loss"] - p["loss"])
    check(np.isfinite(k["loss"]) and loss_err <= TOL_STEP_LOSS, f"{what}: loss {k['loss']} vs plain {p['loss']}")
    grad_err = max(max_err(k["grads"][n], g) / max(float(g.abs().max()), 1e-30)
                   for n, g in p["grads"].items() if float(g.abs().max()) > 0)
    check(grad_err <= TOL_STEP_GRAD, f"{what}: gradients: max err {grad_err:.3g} of the leaf's max")
    # the updates, relative to this step's lr, where the gradients' sign is
    # sure (see TOL_STEP_UPDATE) and elsewhere; the parameters against them
    upd_sure = upd_rest = param_excess = 0.0
    n_sure = n_all = 0
    for n, g in p["grads"].items():
        sure = g.abs() > 10 * (k["grads"][n] - g).abs().max()
        du = (k["updates"][n] - p["updates"][n]).abs() / lr0
        if bool(sure.any()):
            upd_sure = max(upd_sure, float(du[sure].max()))
        if not bool(sure.all()):
            upd_rest = max(upd_rest, float(du[~sure].max()))
        n_sure, n_all = n_sure + int(sure.sum()), n_all + g.numel()
        new_k, new_p = k["params"][n], p["params"][n]
        top = torch.maximum(new_k.abs(), new_p.abs())
        ulp = torch.nextafter(top, torch.full_like(top, math.inf)) - top
        # (1 + 1e-6): the updates' fp32 difference may itself round
        param_excess = max(param_excess, float(((new_k - new_p).abs() - du * lr0 * (1 + 1e-6) - ulp).max()))
    check(upd_sure <= TOL_STEP_UPDATE, f"{what}: updates where the gradient's sign is sure: max err "
          f"{upd_sure:.3g} lr > {TOL_STEP_UPDATE:g} lr")
    check(upd_rest < 2.0, f"{what}: updates elsewhere: max err {upd_rest:.3g} lr >= 2 lr")
    check(param_excess <= 0.0, f"{what}: parameters differ by {param_excess:.3g} more than their "
          f"updates' difference plus one ulp")
    return (f"loss {k['loss']:.6f} vs {p['loss']:.6f} (err {loss_err:.3g}, tol {TOL_STEP_LOSS:g}); gradients "
            f"{len(p['grads'])} leaves, max err {grad_err:.3g} of the leaf's max (tol {TOL_STEP_GRAD:g}); "
            f"updates (lr {lr0:.4g}) max err {upd_sure:.3g} lr on the {n_sure}/{n_all} elements whose "
            f"gradient sign is sure (tol {TOL_STEP_UPDATE:g} lr), {upd_rest:.3g} lr on the rest (tol 2 lr); "
            f"updated parameters within the updates' difference plus one ulp; launches "
            f"{ {n: v for n, v in k['launches'].items() if v} }")


def phase_train_correctness(dev: torch.device) -> dict:
    """[7] one fp32 training step at full width with the kernels against the
    same step on the plain versions: same weights, same seeds, so the same
    draws."""
    patchout = dict(s_patchout_t=40, s_patchout_f=4)
    k = fp32_step(dev, dict(attn_impl="fused", **patchout), "auto")
    p = fp32_step(dev, dict(attn_impl="xla", **patchout), "matmul")
    want = want_launches(fused_log_mel=1, fused_attention=12, fused_attention_bwd=12)
    check(k["launches"] == want, f"fp32 step launches {k['launches']} != {want}")
    check(k["bwd_paths"] == dict(fma=0, mma=0, resident=0, wgmma=0, simt=12),
          f"fp32 step backward paths {k['bwd_paths']}, want 12 simt")
    check(k["fwd_paths"] == FP32_FWD_PATHS, f"fp32 step forward paths {k['fwd_paths']}, want 12 simt")
    say(f"[7] fp32 training step PaSST-S B=2 N={TRAIN_N}, kernels vs plain versions: {hold_fp32_step(k, p, '[7]')}")
    return k["launches"]


def phase_variant_correctness(dev: torch.device) -> list:
    """[9] one fp32 training step at full width (B = 2) under each variant
    with its kernels against the default config's step on the plain
    versions, from the same weights and draws; and an fp32 Predictor under
    fuse_ln_qkv (F1 at N = 14 in its timestamp windows) against the plain
    default one. fuse_ln_qkv runs at patchout 80/4 (N = 154), where the F1
    and B2 gate holds in fp32; at N = 474 it does not."""
    from passt_tpu_torch.hear import Predictor
    from passt_tpu_torch.ops import _build
    from passt_tpu_torch.ops import attention as A

    runs = []
    cases = (("fuse_ln_qkv", dict(s_patchout_t=80, s_patchout_f=4), 154,
              want_launches(fused_log_mel=1, ln_qkv_f1=12, fused_attention_qkv=12, fused_attention_qkv_bwd=12,
                            ln_qkv_b2=12)),
             ("ln_impl=fused", dict(s_patchout_t=40, s_patchout_f=4), TRAIN_N,
              want_launches(fused_log_mel=1, fused_attention=12, fused_attention_bwd=12, layer_norm_bwd=25)))
    for variant, patchout, n, want in cases:
        k = fp32_step(dev, dict(attn_impl="fused", **patchout, **VARIANTS[variant]), "auto")
        p = fp32_step(dev, dict(attn_impl="xla", **patchout), "matmul")
        check(k["n"] == n, f"{variant}: sequence {k['n']} != {n}")
        check(k["launches"] == want, f"[9] {variant} fp32 step launches {k['launches']} != {want}")
        check(k["bwd_paths"] == dict(fma=0, mma=0, resident=0, wgmma=0, simt=12),
              f"[9] {variant} fp32 step backward paths {k['bwd_paths']}, want 12 simt")
        check(k["fwd_paths"] == FP32_FWD_PATHS, f"[9] {variant} fp32 step forward paths {k['fwd_paths']}, want 12 simt")
        say(f"[9] fp32 training step PaSST-S B=2 N={n} under {variant}, kernels vs the default config on "
            f"plain versions: {hold_fp32_step(k, p, f'[9] {variant}')}")
        runs.append(k["launches"])

    kern = Predictor.create(arch=ARCH, dtype="float32", device=dev, fuse_ln_qkv=True,
                            generator=torch.Generator().manual_seed(0))
    plain = Predictor.create(arch=ARCH, dtype="float32", device=dev, attn_impl="xla",
                             mel_cfg=dataclasses.replace(kern.mel_cfg, stft_method="matmul"))
    plain.model.load_state_dict(kern.model.state_dict())
    wave = torch.from_numpy(np.random.default_rng(6).standard_normal((1, 64000)).astype(np.float32) * 0.1).to(dev)
    _build.reset_launches()
    A.reset_path_launches()
    ek, tk = kern.timestamp_embeddings(wave)
    torch.cuda.synchronize()
    launches = {name: _build.LAUNCHES.get(name, 0) for name in KERNEL_NAMES}
    paths = dict(A.FWD_PATH_LAUNCHES)
    ep, tp = plain.timestamp_embeddings(wave)
    want = want_launches(fused_log_mel=1, ln_qkv_f1=12, fused_attention_qkv=12)
    check(launches == want, f"[9] fuse_ln_qkv Predictor launches {launches} != {want}")
    check(paths == FP32_FWD_PATHS, f"[9] fuse_ln_qkv Predictor forward paths {paths}, want 12 simt")
    err = max_err(ek, ep)
    # fp32 on both sides, as [5]: summation order, carried through 12 blocks
    check(torch.equal(tk, tp) and err < 5e-3, f"[9] fuse_ln_qkv timestamp embeddings: err {err:.3g}")
    say(f"[9] fp32 Predictor(fuse_ln_qkv=True) timestamp embeddings [1, 40, 1295] (B=256 windows, N=14) vs the "
        f"plain default: max err {err:.3g} (tol 5e-3); launches { {k: v for k, v in launches.items() if v} }")
    runs.append(launches)
    return runs


def phase_int8_mlp(gpu: str, dev: torch.device) -> dict:
    """[10] the int8 PaSST-S MLP against the bf16 one (tools/ab_int8_mlp) at
    M = 5688 and 14280, with exact launch counts and each int8 layer's
    quantization error within tests/test_int8_dense.py's limit."""
    from passt_tpu_torch.ops import _build
    from passt_tpu_torch.ops import int8 as I
    from passt_tpu_torch.tools import ab_int8_mlp

    _build.reset_launches()
    I.reset_path_launches()
    results = ab_int8_mlp.run(dev)
    torch.cuda.synchronize()
    launches = {name: _build.LAUNCHES.get(name, 0) for name in KERNEL_NAMES}
    check(I.PATH_LAUNCHES == dict(wgmma=sum(launches.values()), mma=0), f"[10] loops {I.PATH_LAUNCHES}")
    check([r["M"] for r in results] == [TRAIN_B * TRAIN_N, TRAIN_B * 1190], "[10] token counts")
    n = sum(r["int8_forwards"] for r in results)
    want = want_launches(int8_dense=n, int8_dense_gelu=n)
    check(launches == want, f"[10] launches {launches} != {want}")
    for r in results:
        for layer in ("fc1", "fc2"):
            check(r[f"{layer}_err"] < r[f"{layer}_limit"], f"[10] M={r['M']} {layer}: mean|int8 - exact| "
                  f"{r[f'{layer}_err']:.4g} >= {r[f'{layer}_limit']:.4g}")
        check(all(isinstance(r[f"{p}_ms_{t}"], float) for p in ("fwd", "fwdbwd") for t in ("bf16", "int8")),
              f"[10] M={r['M']}: times")
    say(f"[10] int8 MLP (int8_dense_gelu -> int8_dense) vs bf16 at M = "
        f"{', '.join(str(r['M']) for r in results)}: layer errors within 0.02 mean|exact| + 1e-3; launches "
        f"{ {k: v for k, v in launches.items() if v} } ({gpu})")
    return launches


def phase_int8_micro(gpu: str, dev: torch.device) -> dict:
    """[11] the int8 / bf16 matmul micro-benchmark (tools/int8_matmul_micro)
    at the model's shapes and 8192^3; it checks the int8 product bit-equal
    first and prints its JSON."""
    from passt_tpu_torch.ops import _build
    from passt_tpu_torch.ops import int8 as I
    from passt_tpu_torch.tools import int8_matmul_micro

    _build.reset_launches()
    I.reset_path_launches()
    res = int8_matmul_micro.run(dev)
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    check(I.PATH_LAUNCHES == dict(wgmma=launches["int8_matmul"], mma=0), f"[11] loops {I.PATH_LAUNCHES}")
    check(launches["int8_matmul"] > 0 and sum(launches.values()) == launches["int8_matmul"],
          f"[11] launches {launches}")
    say(f"[11] int8_matmul micro-benchmark: int8 kernel {res['square_8192_kernel_int8_tops']:.1f} TOP/s at 8192^3 "
        f"({res['square_8192_int8_vs_best_bf16']:.2f}x the best bf16), torch._int_mm "
        f"{res['square_8192_torch_int8_tops']:.1f}; {launches['int8_matmul']} launches ({gpu})")
    return launches


def phase_proto_mlp(gpu: str, dev: torch.device) -> dict:
    """[12] the fused-MLP A/B (tools/proto_mlp_fused) at M = 5688 and 14280,
    with exact launch counts, the variants' errors against the xla
    composition, and fuse_f's peak memory growth below one [M, H] bf16
    tensor: the hidden activation never reached device memory."""
    from passt_tpu_torch.ops import _build
    from passt_tpu_torch.tools import proto_mlp_fused

    _build.reset_launches()
    results = proto_mlp_fused.run(dev)
    torch.cuda.synchronize()
    launches = {name: _build.LAUNCHES.get(name, 0) for name in KERNEL_NAMES}
    check([r["M"] for r in results] == [TRAIN_B * TRAIN_N, TRAIN_B * 1190], "[12] token counts")
    want = want_launches(fused_mlp_fwd=sum(r["fwd_calls"] for r in results),
                         fused_mlp_bwd=sum(r["bwd_calls"] for r in results))
    check(launches == want, f"[12] launches {launches} != {want}")
    for r in results:
        for key in ("fwd_err_fuse_f", "fwd_err_fuse"):
            check(r[key] <= TOL_PROTO_MLP * r["y_max"], f"[12] M={r['M']} {key} {r[key]:.4g} > "
                  f"{TOL_PROTO_MLP:g} max|y| ({r['y_max']:.4g})")
        for key in ("grad_rel_fuse", "grad_rel_fuse2"):
            check(r[key] <= TOL_PROTO_MLP, f"[12] M={r['M']} {key} {r[key]:.3g} > {TOL_PROTO_MLP:g}")
        check(r["fuse_f_peak_growth"] < r["hidden_bytes"], f"[12] M={r['M']}: fuse_f grew the peak memory by "
              f"{r['fuse_f_peak_growth']} B >= one [M, 3072] bf16 tensor ({r['hidden_bytes']} B)")
        check(all(isinstance(r[k], float) for k in ("fwd_ms_xla", "fwd_ms_fuse_f", "fwdbwd_ms_xla",
                                                     "fwdbwd_ms_fuse", "fwdbwd_ms_fuse2")), f"[12] M={r['M']}: times")
    say(f"[12] fused-MLP A/B (xla, fuse_f, fuse, fuse2) at M = {', '.join(str(r['M']) for r in results)}: errors "
        f"within {TOL_PROTO_MLP:g}; fuse_f peak growth "
        f"{', '.join(str(r['fuse_f_peak_growth']) for r in results)} B < one [M, 3072] bf16 tensor; launches "
        f"{ {k: v for k, v in launches.items() if v} } ({gpu})")
    return launches


# [13] the data layer and fit: clips written as wav files, the port's loaders
FIT_TRAIN_CLIPS, FIT_VAL_CLIPS = 48, 40
FIT_CLASSES = 12  # classes in use of the 527 (a tone per class)
FIT_EPOCHS, FIT_STEPS, FIT_VAL_B = 3, 4, 20
FIT_SWA_START = 2


class _Collated:
    """A loader of batches collated in advance (fit's data path without the
    datasets and the loader)."""

    def __init__(self, batches):
        self.batches = batches

    def set_epoch(self, epoch):
        pass

    def __iter__(self):
        return iter(self.batches)


def write_clips(root: str, n: int, seed: int) -> dict:
    """``n`` 10-s 32 kHz 16-bit wav clips of seeded noise plus one tone per
    label (1-3 of FIT_CLASSES classes), written with the stdlib ``wave``
    module; returns the labels dict (file name -> multi-hot 527)."""
    import wave as wavemod

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    t = np.arange(CLIP, dtype=np.float64) / 32000.0
    labels = {}
    for i in range(n):
        classes = rng.choice(FIT_CLASSES, size=int(rng.integers(1, 4)), replace=False)
        x = rng.standard_normal(CLIP) * 0.05
        for c in classes:
            x += 0.2 * np.sin(2 * np.pi * (220.0 + 140.0 * c) * t + rng.uniform(0, 2 * np.pi))
        pcm = np.clip(np.rint(x * 32767.0), -32768, 32767).astype(np.int16)
        name = f"clip_{seed}_{i:03d}.wav"
        with wavemod.open(os.path.join(root, name), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(32000)
            w.writeframes(pcm.tobytes())
        target = np.zeros(527, np.float32)
        target[classes] = 1.0
        labels[name] = target
    return labels


def native_line(gpu: str) -> str:
    """Whether the native host plane loads here, and if it does (as found,
    or built from native/hostplane.cpp into build/ when the checkout has no
    library), assemble_batch and wavmix against the numpy chain."""
    import subprocess

    from passt_tpu_torch.data import native as N
    from passt_tpu_torch.data.datasets import pad_or_truncate

    found = N._lib_path()
    how = f"found {os.path.relpath(found, ROOT)}" if found else "native/libhostplane.so not in the checkout"
    if found is None:
        out = os.path.join(ROOT, "build", "hostplane", "libhostplane.so")
        os.makedirs(os.path.dirname(out), exist_ok=True)
        res = subprocess.run(["g++", "-O3", "-std=c++17", "-fPIC", os.path.join(ROOT, "native", "hostplane.cpp"),
                              "-o", out, "-shared", "-pthread", "-ldl"], capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            return f"[13] native host plane: {how}; building it failed: {res.stderr.strip()[-300:]}"
        os.environ["PASST_TPU_HOSTPLANE"] = out
        how += "; built from native/hostplane.cpp into build/hostplane/"
    try:
        if not N.available():
            return f"[13] native host plane: {how}; does not load"
    except Exception as e:  # a stale or broken library is reported, not hidden
        return f"[13] native host plane: {how}; does not load: {e}"
    rng = np.random.default_rng(13)
    pcm = [(rng.standard_normal(int(n)) * 6000).astype(np.int16) for n in rng.integers(200000, 400000, 12)]
    t0 = time.perf_counter()
    got = N.assemble_batch(pcm, CLIP)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = np.stack([pad_or_truncate(p.astype(np.float32) / 32768.0, CLIP) for p in pcm])
    numpy_s = time.perf_counter() - t0
    check(np.array_equal(got, ref), "[13] native assemble_batch != the numpy chain")
    other = rng.standard_normal((12, CLIP)).astype(np.float32)
    lam = rng.uniform(0.5, 1.0, 12).astype(np.float32)
    apply = (rng.uniform(size=12) < 0.5).astype(np.uint8)
    mixed = got.copy()
    N.wavmix(mixed, other, lam, apply)
    err = 0.0
    for i in range(12):
        if apply[i]:
            a, b = got[i] - got[i].mean(), other[i] - other[i].mean()
            r = a * lam[i] + b * (1 - lam[i])
            err = max(err, float(np.abs(mixed[i] - (r - r.mean())).max()))
        else:
            check(np.array_equal(mixed[i], got[i]), "[13] native wavmix changed an unmixed row")
    check(err < 1e-5, f"[13] native wavmix vs numpy: {err:.3g}")
    return (f"[13] native host plane: {how}; loads; assemble_batch of 12 x 10 s bit-equal to the numpy chain "
            f"({12 / native_s:.1f} items/s against numpy's {12 / numpy_s:.1f}), wavmix within {err:.2g} of numpy "
            f"(tol 1e-5)")


def phase_fit(gpu: str, dev: torch.device) -> dict:
    """[13] ``fit`` at full PaSST-S width on the port's own data path: wav
    clips read by FolderDataset -> RollDataset -> WavMixDataset, a
    class-balanced WeightedEpochSampler, the DataLoader's worker threads and
    the pinned side-stream DeviceFeed with int16 transfer; validation by
    ``evaluate`` each epoch, SWA, keep-2-best checkpoints by "ap", restores,
    and a preempted run resumed from its checkpoint against the
    uninterrupted one. Exact launch counts of the fit run."""
    import signal
    import tempfile

    from passt_tpu_torch import bench
    from passt_tpu_torch.data import (
        DataLoader, FolderDataset, RollDataset, SequentialSampler, WavMixDataset, WeightedEpochSampler,
        class_balanced_sample_weights,
    )
    from passt_tpu_torch.ops import _build
    from passt_tpu_torch.ops import attention as A
    from passt_tpu_torch.train import loop
    from passt_tpu_torch.train.steps import make_eval_step, make_train_step
    from passt_tpu_torch.train.swa import SWAState, swa_should_update

    tmp = tempfile.mkdtemp(prefix="chip_smoke_fit_")
    try:
        t0 = time.perf_counter()
        train_labels = write_clips(os.path.join(tmp, "train"), FIT_TRAIN_CLIPS, seed=1)
        val_labels = write_clips(os.path.join(tmp, "val"), FIT_VAL_CLIPS, seed=2)
        write_s = time.perf_counter() - t0
        base = FolderDataset(os.path.join(tmp, "train"), clip_length=CLIP / 32000, labels=train_labels)
        train_ds = WavMixDataset(RollDataset(base, shift_range=50, seed=3), seed=4)
        weights = class_balanced_sample_weights(np.stack([train_labels[os.path.basename(f)] for f in base.files]))
        sampler = WeightedEpochSampler(weights, epoch_len=FIT_TRAIN_CLIPS, seed=5)
        train_loader = DataLoader(train_ds, batch_size=TRAIN_B, sampler=sampler, drop_last=True, num_workers=4)
        val_ds = FolderDataset(os.path.join(tmp, "val"), clip_length=CLIP / 32000, labels=val_labels)
        val_loader = DataLoader(val_ds, batch_size=FIT_VAL_B, sampler=SequentialSampler(len(val_ds)), num_workers=4)
        check(len(train_loader) == FIT_STEPS and len(val_loader) == FIT_VAL_CLIPS // FIT_VAL_B, "[13] loader sizes")

        model, state0, step, bench_batch = bench.setup(dev)
        cfg = model.cfg
        check((cfg.embed_dim, cfg.depth, cfg.num_heads, cfg.num_classes) == (768, 12, 12, 527),
              f"[13] not PaSST-S width: {cfg}")
        eval_step = make_eval_step(model, bench.MEL_CFG)
        starts = []

        def timed(train_step):
            def run(s, batch, seed):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                starts.append(ev)
                return train_step(s, batch, seed)
            return run

        def steady_ms(n_steps: int):
            """Mean CUDA-event time between step starts, each epoch's first
            step (which waits for the loader's first batch) and the run's
            first two (a graphed step's eager warm-up call and its capture)
            left out."""
            gaps = [starts[i].elapsed_time(starts[i + 1]) for i in range(2, n_steps - 1) if (i + 1) % FIT_STEPS != 0]
            return sum(gaps) / len(gaps), len(gaps)

        kw = dict(eval_step=eval_step, train_loader=train_loader, val_loader=val_loader, max_epochs=FIT_EPOCHS,
                  seed=bench.SEED, swa_epoch_start=FIT_SWA_START, swa_freq=1, log_every_steps=2, keep_last_n=2,
                  monitor="ap", transfer_dtype="int16", logger=loop.MetricsLogger(quiet=True))
        full_dir = os.path.join(tmp, "ckpt_full")
        _build.reset_launches()
        A.reset_path_launches()
        t0 = time.perf_counter()
        res = loop.fit(train_step=timed(step), state=state0, checkpoint_dir=full_dir, **kw)
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = {name: _build.LAUNCHES.get(name, 0) for name in KERNEL_NAMES}
        paths, bwd_paths = dict(A.FWD_PATH_LAUNCHES), dict(A.BWD_PATH_LAUNCHES)
        # the graphed step donates: its next call overwrites res.state's tensors
        final = clone_state(res.state)

        # what fit did: steps, records, SWA as swa_should_update says
        steps = FIT_EPOCHS * FIT_STEPS
        check(res.state.step == steps and len(starts) == steps and not res.interrupted, "[13] fit steps")
        fit_ms, n_gaps = steady_ms(steps)
        probe = SWAState(avg_params=None, swa_epoch_start=FIT_SWA_START, swa_freq=1)
        fires = [e for e in range(FIT_EPOCHS) if swa_should_update(probe, e, FIT_EPOCHS)]
        check(res.swa is not None and res.swa.n_averaged == len(fires) > 0, f"[13] SWA {res.swa and res.swa.n_averaged}"
              f" updates, swa_should_update fires at {fires}")
        check(all(v.dtype == torch.float32 and v.device == dev for v in res.swa.avg_params.values()),
              "[13] the SWA average is fp32 on the card")
        for e, rec in enumerate(res.history):
            check(math.isfinite(rec["train_loss"]), f"[13] epoch {e} loss {rec['train_loss']}")
            for key in ("ap", "val_loss", "n_eval", "roc"):
                check(key in rec and math.isfinite(rec[key]), f"[13] epoch {e}: {key} missing or not finite")
            check(rec["n_eval"] == FIT_VAL_CLIPS, f"[13] n_eval {rec['n_eval']}")
            check(rec.get("swa_n") == (fires.index(e) + 1 if e in fires else None), f"[13] epoch {e} swa_n")
            check(("swa_ap" in rec) == (e >= fires[0]), f"[13] epoch {e}: SWA eval")
        evals = sum(1 + (e >= fires[0]) for e in range(FIT_EPOCHS)) * (FIT_VAL_CLIPS // FIT_VAL_B)
        eval_entry = ("fused_attention_qkv" if A.flat_kernel_supports(1190, 12, 64, backward=False, itemsize=2,
                                                                      batch=FIT_VAL_B) else "fused_attention")
        counts = dict(fused_log_mel=steps + evals, fused_attention_qkv=12 * steps, fused_attention_qkv_bwd=12 * steps)
        counts[eval_entry] = counts.get(eval_entry, 0) + 12 * evals
        want = want_launches(**counts)
        check(launches == want, f"[13] fit launches {launches} != {want}")
        want_paths = dict(fma=0, mma=0, short=0, wgmma=12 * (steps + evals), simt=0)
        check(paths == want_paths and bwd_paths == dict(fma=0, mma=0, resident=0, wgmma=12 * steps, simt=0),
              f"[13] paths {paths}, {bwd_paths}")

        # checkpoints: the 2 best by ap kept, the best and the latest restored
        aps = {r["epoch"]: r["ap"] for r in res.history}
        kept = loop.checkpoint_epochs(full_dir)
        best2 = sorted(sorted(aps, key=lambda e: (aps[e], e))[-2:])
        check(kept == best2, f"[13] kept checkpoints {kept} != the 2 best by ap {best2} ({aps})")
        latest, _, latest_epoch = loop.restore_checkpoint(full_dir, state0)
        best, _, best_epoch = loop.restore_checkpoint(full_dir, state0, monitor="ap")
        check(latest_epoch == kept[-1] and latest.step == (latest_epoch + 1) * FIT_STEPS, "[13] latest restore")
        check(best_epoch == max(kept, key=lambda e: (aps[e], e)) and best.step == (best_epoch + 1) * FIT_STEPS,
              "[13] best restore")
        if latest_epoch == FIT_EPOCHS - 1:
            check(all(torch.equal(latest.params[k], v) for k, v in final.params.items()),
                  "[13] restored latest params != fit's")

        # preempted after the first epoch (SIGTERM in its last step), restored, resumed
        def preempted(s, batch, seed):
            if s.step == FIT_STEPS - 1:
                os.kill(os.getpid(), signal.SIGTERM)
            return step(s, batch, seed)

        cut_dir = os.path.join(tmp, "ckpt_cut")
        cut = loop.fit(train_step=preempted, state=state0, checkpoint_dir=cut_dir, **dict(kw, keep_last_n=3))
        check(cut.interrupted and len(cut.history) == 1 and loop.checkpoint_epochs(cut_dir) == [0],
              "[13] the preempted run did not stop after its first epoch")
        restored, swa_rest, epoch = loop.restore_checkpoint(cut_dir, state0)
        resumed = loop.fit(train_step=step, state=restored, checkpoint_dir=cut_dir, start_epoch=epoch + 1,
                           swa_restore=swa_rest, **dict(kw, keep_last_n=3))
        torch.cuda.synchronize()
        check(resumed.state.step == steps and not resumed.interrupted, "[13] resumed steps")
        diff = {k: max_err(resumed.state.params[k].float(), v.float()) for k, v in final.params.items()}
        swa_diff = max(max_err(resumed.swa.avg_params[k], v) for k, v in res.swa.avg_params.items())
        exact = all(torch.equal(resumed.state.params[k], v) for k, v in final.params.items())
        exact_swa = all(torch.equal(resumed.swa.avg_params[k], v) for k, v in res.swa.avg_params.items())
        check(exact and exact_swa, f"[13] resumed run differs from the uninterrupted one: params max err "
              f"{max(diff.values()):.3g} ({max(diff, key=diff.get)}), SWA {swa_diff:.3g}")
        losses_full = [r["train_loss"] for r in res.history]
        losses_cut = [r["train_loss"] for r in cut.history + resumed.history]

        # [14] the same fit with the eager steps (jit=False), no checkpoints:
        # bit-equal to the graphed run, and its steady ms/step
        eager_step = make_train_step(model, bench.optimizer(), bench.MEL_CFG, jit=False, **bench.STEP_KW)
        eager_eval = make_eval_step(model, bench.MEL_CFG, jit=False)
        starts.clear()
        eager = loop.fit(train_step=timed(eager_step), state=state0, **dict(kw, eval_step=eager_eval))
        torch.cuda.synchronize()
        eager_fit_ms, _ = steady_ms(steps)
        fit_diff = [k for k, v in final.params.items() if not torch.equal(eager.state.params[k], v)]
        fit_diff += [f"swa {k}" for k, v in res.swa.avg_params.items() if not torch.equal(eager.swa.avg_params[k], v)]
        check(not fit_diff and [r["train_loss"] for r in eager.history] == losses_full
              and [r["ap"] for r in eager.history] == [aps[e] for e in sorted(aps)]
              and [r["val_loss"] for r in eager.history] == [r["val_loss"] for r in res.history],
              f"[14] graphed fit != eager fit: {fit_diff[:5]}, losses {losses_full} vs "
              f"{[r['train_loss'] for r in eager.history]}")

        # the time: fit's steady steps beside bench's timed steps, graphed and eager
        _, bench_ms, _ = bench.timed_steps(step, final, bench_batch, 10, 2)
        _, eager_bench_ms, _ = bench.timed_steps(eager_step, final, bench_batch, 10, 2)
        t0 = time.perf_counter()
        loop.evaluate(eval_step, final.params, val_loader, transfer_dtype="int16")
        eval_s = time.perf_counter() - t0
        train_loader.set_epoch(0)
        t0 = time.perf_counter()
        collated = list(train_loader)
        load_s = time.perf_counter() - t0
        n_items = sum(len(b["name"]) for b in collated)
        # the feed alone: the same fit on these batches collated in advance
        starts.clear()
        loop.fit(train_step=timed(step), state=final, train_loader=_Collated(collated), eval_step=eval_step,
                 max_epochs=2, seed=bench.SEED, transfer_dtype="int16", logger=loop.MetricsLogger(quiet=True))
        torch.cuda.synchronize()
        feed_ms, n_feed = steady_ms(len(starts))
    finally:
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    say(f"[13] fit PaSST-S bf16 B={TRAIN_B} (bench config, graphed steps) on {FIT_TRAIN_CLIPS} wav clips (written in "
        f"{write_s:.1f} s; FolderDataset -> Roll -> WavMix, class-balanced sampler, 4 loader threads, DeviceFeed "
        f"int16): {FIT_EPOCHS} epochs x {FIT_STEPS} steps in {fit_s:.1f} s; losses "
        f"{', '.join(f'{x:.5f}' for x in losses_full)}; ap {', '.join(f'{aps[e]:.4f}' for e in sorted(aps))}; "
        f"val_loss {res.history[-1]['val_loss']:.5f}, n_eval {res.history[-1]['n_eval']}; SWA n={res.swa.n_averaged}"
        f" (fires at epochs {fires}); kept {kept}, best {best_epoch}, latest {latest_epoch}; launches "
        f"{ {k: v for k, v in launches.items() if v} } ({steps} steps, {evals} eval batches of {FIT_VAL_B})")
    say(f"[13] resumed after epoch 0 (SIGTERM, restore, start_epoch=1): params and SWA average bit-equal to the "
        f"uninterrupted run; losses {', '.join(f'{x:.5f}' for x in losses_cut)}")
    say(f"[13] fit {fit_ms:.3f} ms/step steady (graphed; CUDA events between step starts, {n_gaps} steps) against "
        f"bench.timed_steps {bench_ms:.3f} ms/step on a resident batch (ratio {fit_ms / bench_ms:.3f}), fit on the "
        f"same batches collated in advance (the feed alone) {feed_ms:.3f} ms/step ({n_feed} steps); eval "
        f"{FIT_VAL_CLIPS / eval_s:.2f} clips/s (B={FIT_VAL_B}, int16 feed); train loader alone "
        f"{n_items / load_s:.2f} items/s ({n_items} items, wavmix reads included) ({gpu})")
    say(f"[14] graphed fit bit-equal to the eager fit (jit=False train and eval steps) on [13]'s data: params, SWA "
        f"average, losses, ap, val_loss; eager fit {eager_fit_ms:.3f} ms/step steady against eager "
        f"bench.timed_steps {eager_bench_ms:.3f} (ratio {eager_fit_ms / eager_bench_ms:.3f}); graphed ratio "
        f"{fit_ms / bench_ms:.3f} ({gpu})")
    say(native_line(gpu))
    return launches


def clone_state(state):
    """A copy of a TrainState whose tensors no step owns."""
    from torch.utils import _pytree as pytree

    from passt_tpu_torch.train.steps import TrainState

    copy = lambda x: x.clone() if isinstance(x, torch.Tensor) else x  # noqa: E731
    return TrainState({k: v.clone() for k, v in state.params.items()}, pytree.tree_map(copy, state.opt_state),
                      state.step)


def state_diff(a, b) -> list:
    """The leaves (params by name, optimizer state by position) and counts
    in which two TrainStates differ, bit for bit, with the max error."""
    from torch.utils import _pytree as pytree

    out = [(k, max_err(a.params[k], v)) for k, v in b.params.items() if not torch.equal(a.params[k], v)]
    la, lb = pytree.tree_leaves(a.opt_state), pytree.tree_leaves(b.opt_state)
    for i, (x, y) in enumerate(zip(la, lb)):
        if isinstance(x, torch.Tensor) and not torch.equal(x, y):
            out.append((f"opt_state[{i}] {tuple(x.shape)} {x.dtype}", max_err(x, y)))
        elif not isinstance(x, torch.Tensor) and x != y:
            out.append((f"opt_state[{i}] count", abs(x - y)))
    if a.step != b.step or len(la) != len(lb):
        out.append(("step", abs(a.step - b.step)))
    return out


def metrics_diff(a: dict, b: dict) -> list:
    return [(k, max_err(a[k], b[k])) for k in b if not torch.equal(a[k], b[k])] + [(k, None) for k in a if k not in b]


def replay_launches(fn, calls: int) -> tuple:
    """The launch counts (and the attention paths) of ``calls`` calls of
    ``fn`` that are all graph replays."""
    from passt_tpu_torch.ops import _build
    from passt_tpu_torch.ops import attention as A

    torch.cuda.synchronize()
    _build.reset_launches()
    A.reset_path_launches()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return step_launches(), dict(A.FWD_PATH_LAUNCHES), dict(A.BWD_PATH_LAUNCHES)


def in_turns(fns: dict, rounds: int, run) -> dict:
    """``run(fn)`` for each of ``fns`` in turns, ``rounds`` times; returns
    name -> the list of its readings."""
    out = {name: [] for name in fns}
    for _ in range(rounds):
        for name, fn in fns.items():
            out[name].append(run(fn))
    return out


def phase_graphs(gpu: str, dev: torch.device) -> list:
    """[14] the graphed entry points (the counterpart of jax.jit) against
    the eager ones at full PaSST-S width: the bf16 train step under the
    three configs bit-equal over 5 steps from step 0 and 5 steps from a
    state restored at step 3 (params, both moments, counts, loss, grad
    norms), its launches over replays exact; the eval step and the
    Predictor (B = 1, B = 20, timestamp windows) bit-equal; the times, in
    turns: the step's best of 2 runs of 30 with the spread, its warm-up
    (eager call, capture) and peak memory, and the Predictor's ms/call and
    clips/s. Where the device time goes is the benchmark's to say (its
    traced runs read the step's phase marks)."""
    from passt_tpu_torch import bench
    from passt_tpu_torch.hear import Predictor
    from passt_tpu_torch.train.steps import make_eval_step, make_train_step

    runs = []
    for variant, overrides in VARIANTS.items():
        model, state0, _, batch = bench.setup(dev, jit=False, **overrides)
        kw = dict(log_grad_norm=True, **bench.STEP_KW)
        eager = make_train_step(model, bench.optimizer(), bench.MEL_CFG, jit=False, **kw)
        graphed = make_train_step(model, bench.optimizer(), bench.MEL_CFG, **kw)
        batches = [dict(batch, wave=torch.roll(batch["wave"], 997 * i, 1)) for i in range(8)]
        states, metrics = [state0], []
        for b in batches:  # eager: states 0..8 and the metrics of steps 0..7
            st, m = eager(states[-1], b, bench.SEED)
            states.append(st)
            metrics.append(m)
        diffs = []
        g = state0
        for i in range(5):
            g, m = graphed(g, batches[i], bench.SEED)
            diffs += [(f"step {i} {k}", e) for k, e in metrics_diff(m, metrics[i])]
        diffs += [(f"state 5 {k}", e) for k, e in state_diff(g, states[5])]
        # the next call replays: count what replays launch
        launches, paths, bwd_paths = replay_launches(lambda: graphed(clone_state(states[5]), batches[5], bench.SEED), 3)
        want = {k: 3 * v for k, v in STEP_LAUNCHES[variant].items()}
        check(launches == want and paths["wgmma"] == bwd_paths["wgmma"] == 36,
              f"[14] {variant}: replay launches {launches} != {want} ({paths}, {bwd_paths})")
        runs.append(launches)
        g = states[3]  # restored: not the graph's tensors
        for i in range(3, 8):
            g, m = graphed(g, batches[i], bench.SEED)
            diffs += [(f"resumed step {i} {k}", e) for k, e in metrics_diff(m, metrics[i])]
        diffs += [(f"resumed state 8 {k}", e) for k, e in state_diff(g, states[8])]
        check(not diffs, f"[14] {variant}: graphed step != eager step: {diffs[:8]} ({len(diffs)} differ)")
        del states, metrics, g, eager, graphed

        # the times, graphed and eager in turns, each from a fresh bench set-up
        steps = {}
        for name, jit in (("graph", True), ("eager", False)):
            st, stp, b, warm_s, peak = bench.warmed(dev, jit, 2, **overrides)
            steps[name] = dict(state=st, step=stp, batch=b, warm_s=warm_s, peak=peak, runs=[])
        # the eager runs are 12 steps long (host-bound), the graphed ones 30,
        # two of each: the script's time limit (they were 50 and 200, three
        # of each, until its phases outgrew it)
        lengths = {"graph": 30, "eager": 12}
        for _ in range(2):
            for name, rec in steps.items():
                rec["state"], ms, _ = bench.timed_steps(rec["step"], rec["state"], rec["batch"], lengths[name], 0)
                rec["runs"].append(ms)
        parts = []
        for name, rec in steps.items():
            parts.append(
                f"{name} (runs of {lengths[name]}) {', '.join(f'{t:.3f}' for t in rec['runs'])} ms/step (best "
                f"{min(rec['runs']):.3f}, spread "
                f"{100 * (max(rec['runs']) - min(rec['runs'])) / min(rec['runs']):.2f}%), first calls "
                f"{', '.join(f'{t:.2f}' for t in rec['warm_s'])} s, peak memory {rec['peak'] / 2**30:.2f} GiB")
        say(f"[14] bf16 train step B={TRAIN_B} ({variant}): graphed bit-equal to eager over 5 steps from step 0 and 5 "
            f"from a restored step-3 state (params, mu, nu, counts, loss, grad norms); 3 replays launch "
            f"{ {k: v // 3 for k, v in launches.items() if v} } a step; " + "; ".join(parts) + f" ({gpu})")
        del steps

    # the eval step and the Predictor, graphed against eager
    pred = Predictor.create(arch=ARCH, dtype="bfloat16", device=dev, generator=torch.Generator().manual_seed(0))
    plain = Predictor(model=pred.model, mel_cfg=pred.mel_cfg, jit=False)
    rng = np.random.default_rng(14)
    waves = {b: [torch.from_numpy(rng.standard_normal((b, CLIP)).astype(np.float32) * 0.1).to(dev) for _ in range(3)]
             for b in (1, 20)}
    windows = [torch.from_numpy(rng.standard_normal((1, 64000)).astype(np.float32) * 0.1).to(dev) for _ in range(3)]
    diffs = []
    for b, ws in waves.items():
        for i, w in enumerate(ws):  # warm-up, capture, replay
            diffs += [(f"B={b} call {i} {n}", max_err(x, y)) for n, x, y in
                      zip(("logits", "features"), pred.logits_and_features(w), plain.logits_and_features(w))
                      if not torch.equal(x, y)]
    for i, w in enumerate(windows):
        diffs += [(f"timestamps call {i} {n}", max_err(x, y)) for n, x, y in
                  zip(("embeddings", "ms"), pred.timestamp_embeddings(w), plain.timestamp_embeddings(w))
                  if not torch.equal(x, y)]
    params = {k: p.detach() for k, p in pred.model.named_parameters()}
    ev_graph, ev_eager = make_eval_step(pred.model, pred.mel_cfg), make_eval_step(pred.model, pred.mel_cfg, jit=False)
    for b in (20, 8):  # a full batch and a tail
        for i in range(3):
            batch = {"wave": waves[20][i][:b],
                     "target": torch.from_numpy((rng.uniform(size=(b, 527)) < 0.05).astype(np.float32)).to(dev)}
            diffs += [(f"eval B={b} call {i} {k}", e) for k, e in metrics_diff(ev_graph(params, batch),
                                                                               ev_eager(params, batch))]
    check(not diffs, f"[14] graphed serving != eager: {diffs[:8]}")
    launches, paths, _ = replay_launches(lambda: (pred(waves[20][0]), pred.timestamp_embeddings(windows[0])), 2)
    want = dict(want_launches(fused_log_mel=4, fused_attention=24, fused_attention_qkv=24), adamw_sr=0)
    check(launches == want and paths == dict(fma=0, mma=0, short=24, wgmma=24, simt=0),
          f"[14] Predictor replay launches {launches} != {want} ({paths})")
    runs.append(launches)
    times = {}
    for b, reps in ((20, 5), (1, 20)):
        fns = {"graph": lambda: pred(waves[b][0]), "eager": lambda: plain(waves[b][0])}
        times[b] = in_turns(fns, 3, lambda fn: cuda_ms(fn, reps=reps, warmup=1))
    say(f"[14] Predictor bf16 graphed bit-equal to eager at B=1 and B=20 (3 calls each: warm-up, capture, replay), "
        f"timestamp windows (B=256, N=14) and the eval step at B=20 and a tail of 8; replays launch "
        f"{ {k: v // 2 for k, v in launches.items() if v} } a (B=20 call + 2-s timestamp call); in turns, ms/call: "
        + "; ".join(f"B={b} " + ", ".join(f"{name} {', '.join(f'{t:.3f}' for t in ts)} (best {min(ts):.3f} = "
                                           f"{b * 1000.0 / min(ts):.2f} clips/s)" for name, ts in tt.items())
                    for b, tt in times.items()) + f" ({gpu})")
    return runs


# [15] the CLI on the card: python -m passt_tpu_torch.cli <experiment> <command>, in-process
CLI_TRAIN_CLIPS, CLI_VAL_CLIPS = 144, 40  # 12 steps of 12; 2 eval batches of 20
CLI_EPOCHS, CLI_STEPS, CLI_EVAL_BATCHES = 2, 12, 2
CLI_ENSEMBLE = "ensemble_s16_14"


def attn_counts(n: int, b: int, train: bool, calls: int, depth: int = 12, heads: int = 12,
                head_dim: int = 64, itemsize: int = 2) -> dict:
    """The attention launches of ``calls`` forward passes (and their
    backward when ``train``) of PaSST (PaSST-S unless told) at N tokens,
    batch b, in bf16 (fp32 at ``itemsize`` 4): the entry the model picks
    (``flat_kernel_supports``, the JAX package's rule)."""
    from passt_tpu_torch.ops import attention as A

    if A.flat_kernel_supports(n, heads, head_dim, backward=train, itemsize=itemsize, batch=b):
        out = {"fused_attention_qkv": depth * calls}
        if train:
            out["fused_attention_qkv_bwd"] = depth * calls
        return out
    out = {"fused_attention": depth * calls}
    if train:
        out["fused_attention_bwd"] = depth * calls
    return out


def add_counts(*parts: dict) -> dict:
    total: dict = {}
    for part in parts:
        for k, v in part.items():
            total[k] = total.get(k, 0) + v
    return total


def folder_openers(labels_for) -> dict:
    """Stand-ins for the three functions of ``experiments/common.py`` that
    open an HDF5 container (the two that make datasets and the target
    reader), by name: FolderDatasets over the wav folders the config names
    in their place, labelled by ``labels_for(cfg, path)`` ({file name:
    target}). The card's machine has no h5py; [15] and [19] set them on
    ``common`` and put the package's back after."""
    from passt_tpu_torch.data import FolderDataset

    def folder(cfg, path):
        return FolderDataset(path, num_classes=cfg.data.num_classes, sample_rate=cfg.data.sample_rate,
                             clip_length=cfg.data.clip_length, labels=labels_for(cfg, path))

    def eval_folder(cfg, which="eval"):
        path = cfg.data.eval_hdf5 if which == "eval" else cfg.data.valid_hdf5
        if path is None:
            raise FileNotFoundError(f"data.{which}_hdf5 is not set")
        return folder(cfg, path)

    def target_chunks(cfg, chunk_rows=131072):
        ds = folder(cfg, cfg.data.train_hdf5)
        yield np.stack([np.asarray(ds.labels[os.path.basename(f)], np.float32) for f in ds.files])

    return {"build_base_train_dataset": lambda cfg, path, seed: folder(cfg, path),
            "build_eval_dataset": eval_folder, "train_target_chunks": target_chunks}


def phase_cli(gpu: str, dev: torch.device) -> dict:
    """[15] the port's CLI (``passt_tpu_torch.cli.run``) at full PaSST-S
    width, bf16, the recipes' defaults but where listed: print_config and
    print_named_configs; audioset model_speed_test (B = 12, a resident mel
    batch) beside ``bench.timed_steps``; audioset main mini_train (2 epochs x
    12 steps, weighted sampler, SWA, keep-1-best checkpoints by ap, the
    metrics JSONL); evaluate_only on that checkpoint, bit-equal to the
    logged eval; predict; evaluate_ensemble on two random members written
    with ``save_params_npz``; esc50 and openmic main (1 epoch x 2 steps);
    test_loaders; then [16] (:func:`ddp_main`) on the same clips. Each
    command goes through ``cli.run``, which ``cli.main`` calls, and its
    result is read from there. The card's machine has no
    h5py, so the functions of ``experiments/common.py`` that open an HDF5
    container (the two dataset builders and the target reader) are replaced
    by FolderDatasets over wav clips; ``common.fit`` is wrapped to time each
    step, the wrapper calling the package's ``fit`` with the package's step.
    Everything after the container is the package's own. The launches of
    every command are exact."""
    import contextlib
    import io
    import subprocess
    import tempfile

    from passt_tpu_torch import bench, cli
    from passt_tpu_torch.experiments import common
    from passt_tpu_torch.models import registry
    from passt_tpu_torch.models.pretrained import save_params_npz
    from passt_tpu_torch.ops import _build
    from passt_tpu_torch.ops import attention as A
    from passt_tpu_torch.train.swa import SWAState, swa_should_update

    tmp = tempfile.mkdtemp(prefix="chip_smoke_cli_")
    saved = {name: getattr(common, name) for name in ("build_base_train_dataset", "build_eval_dataset",
                                                      "train_target_chunks", "fit")}
    lines, total, runs = [], {}, []
    try:
        t0 = time.perf_counter()
        train_labels = write_clips(os.path.join(tmp, "train"), CLI_TRAIN_CLIPS, seed=21)
        val_labels = write_clips(os.path.join(tmp, "val"), CLI_VAL_CLIPS, seed=22)
        write_s = time.perf_counter() - t0

        def recipe_labels(name: str, labels: dict) -> dict:
            """The recipe's targets for the clips: multi-hot 527 (audioset),
            a class index (esc50), 20 labels and 20 observed-masks (openmic)."""
            if name == "esc50":
                return {k: int(np.argmax(v)) for k, v in labels.items()}
            if name == "openmic":
                return {k: np.concatenate([v[:20], np.ones(20, np.float32)]) for k, v in labels.items()}
            return labels

        def labels_for(cfg, path):
            labels = train_labels if os.path.basename(path) == "train" else val_labels
            return recipe_labels(cfg.name, labels)

        for name, fn in folder_openers(labels_for).items():
            setattr(common, name, fn)
        results = []
        step_t = []  # per train step: (host start, CUDA event at its start)
        step_losses, fit_results = [], []  # each step's loss (a graph output copy) and each fit's result

        def timed_fit(**kw):
            train_step = kw["train_step"]

            def run(s, batch, seed):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                step_t.append((time.perf_counter(), ev))
                out = train_step(s, batch, seed)
                step_losses.append(out[1]["loss"])
                if len(step_t) <= 2:  # the eager warm-up and the capture, each timed alone
                    torch.cuda.synchronize()
                    step_t[-1] = step_t[-1] + (time.perf_counter(),)
                return out

            fit_results.append(saved["fit"](**dict(kw, train_step=run)))
            return fit_results[-1]

        common.fit = timed_fit
        data = [f"data.train_hdf5={os.path.join(tmp, 'train')}", f"data.eval_hdf5={os.path.join(tmp, 'val')}"]

        def run_cli(what: str, argv: list, want: dict, fwd_paths=None, bwd_paths=None, phase="[15]"):
            """One CLI call, timed, its stdout captured, its launches exact."""
            step_t.clear()
            step_losses.clear()
            _build.reset_launches()
            A.reset_path_launches()
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                results.append(cli.run(list(argv)))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {name: _build.LAUNCHES.get(name, 0) for name in KERNEL_NAMES}
            paths, bwd = dict(A.FWD_PATH_LAUNCHES), dict(A.BWD_PATH_LAUNCHES)
            want = want_launches(**want)
            check(launches == want, f"{phase} {what}: launches {launches} != {want}")
            n_fwd = sum(v for k, v in want.items() if k in ("fused_attention", "fused_attention_qkv"))
            n_bwd = sum(v for k, v in want.items() if k.endswith("_bwd") and k.startswith("fused_attention"))
            check(paths == dict(fma=0, mma=0, short=0, wgmma=n_fwd, simt=0), f"{phase} {what}: forward paths {paths}")
            check(bwd == dict(fma=0, mma=0, resident=0, wgmma=n_bwd, simt=0), f"{phase} {what}: backward paths {bwd}")
            runs.append(launches)
            out = buf.getvalue()
            lines.append(f"{phase} {what}: {wall:.2f} s; launches { {k: v for k, v in launches.items() if v} }")
            return out, wall, launches

        # 1. the config
        out, _, _ = run_cli("audioset print_config", ["audioset", "print_config"], {})
        printed = json.loads(out)
        check(printed["model"]["arch"] == ARCH and printed["model"]["dtype"] == "bfloat16"
              and printed["data"]["num_classes"] == 527, f"[15] print_config: {printed['model']}")
        out, _, _ = run_cli("audioset print_named_configs", ["audioset", "print_named_configs"], {})
        check("mini_train: {" in out and results[-1]["presets"][0] == "mini_train", "[15] print_named_configs")

        # 2. model_speed_test between two runs of the bench's graphed step
        _, state, step, batch = bench.setup(dev)
        state, bench_before, _ = bench.timed_steps(step, state, batch, 50, 2)
        steps = 2 * 100  # the warm-up run and the timed run
        out, _, speed_launches = run_cli("audioset model_speed_test (B=12, resident mel)",
                                         ["audioset", "model_speed_test"], attn_counts(TRAIN_N, TRAIN_B, True, steps))
        specs = results[-1]["specs_per_second"]
        check("average speed: " in out and math.isfinite(specs) and specs > 0, f"[15] model_speed_test: {out[-300:]}")
        speed_ms = TRAIN_B * 1000.0 / specs
        _, bench_after, _ = bench.timed_steps(step, state, batch, 50, 0)
        del state, step, batch
        bench_ms = (bench_before + bench_after) / 2
        lines.append(f"[15] model_speed_test: {specs:.2f} specs/s = {speed_ms:.3f} ms/step (graphed step on a resident "
                     f"mel batch, 100 steps after 100) between bench.timed_steps runs of {bench_before:.3f} and "
                     f"{bench_after:.3f} ms/step (50 steps each; the graphed step with the frontend on a resident "
                     f"wave batch) in the same call (ratio to their mean {speed_ms / bench_ms:.3f}); launches a step: "
                     f"{ {k: v // steps for k, v in speed_launches.items() if v} }, no mel ({gpu})")

        # 3. audioset main mini_train
        ckpt = os.path.join(tmp, "ckpt")
        main_argv = ["audioset", "main", "with", "mini_train"] + data + [
            f"trainer.max_epochs={CLI_EPOCHS}", f"trainer.limit_train_batches={CLI_STEPS}",
            f"trainer.limit_eval_batches={CLI_EVAL_BATCHES}", "trainer.swa_epoch_start=1", "trainer.swa_freq=1",
            f"trainer.checkpoint_dir={ckpt}", "trainer.keep_last_n=1", "trainer.monitor=ap"]
        probe = SWAState(avg_params=None, swa_epoch_start=1, swa_freq=1)
        fires = [e for e in range(CLI_EPOCHS) if swa_should_update(probe, e, CLI_EPOCHS)]
        check(bool(fires), f"[15] SWA never fires in {CLI_EPOCHS} epochs")
        n_steps = CLI_EPOCHS * CLI_STEPS
        n_evals = sum(1 + (e >= fires[0]) for e in range(CLI_EPOCHS)) * CLI_EVAL_BATCHES
        t_cli = time.perf_counter()
        out, _, _ = run_cli("audioset main mini_train", main_argv, add_counts(
            {"fused_log_mel": n_steps + n_evals}, attn_counts(TRAIN_N, TRAIN_B, True, n_steps),
            attn_counts(1190, 20, False, n_evals)))
        res = results[-1]
        hist = res["history"]
        check(res["done"] and not res["interrupted"] and len(hist) == CLI_EPOCHS, f"[15] main: {res}")
        check(("native_loader=true but" in out) and "numpy loader path" in out,
              "[15] main: maybe_native_builder's line missing")
        for rec in hist:
            check(math.isfinite(rec["train_loss"]) and math.isfinite(rec["ap"]) and rec["n_eval"] == CLI_VAL_CLIPS,
                  f"[15] main record {rec}")
        check("ap" in hist[-1] and "swa_ap" in hist[-1] and math.isfinite(hist[-1]["swa_ap"]),
              f"[15] main: no ap / swa_ap in the last record {sorted(hist[-1])}")
        logged = [json.loads(x) for x in open(os.path.join(ckpt, "audioset_metrics.jsonl"))]
        check([r["epoch"] for r in logged] == list(range(CLI_EPOCHS)) and logged[-1]["swa_ap"] == hist[-1]["swa_ap"],
              "[15] main: the metrics JSONL")
        from passt_tpu_torch.train.loop import checkpoint_epochs

        best = max(range(CLI_EPOCHS), key=lambda e: (hist[e]["ap"], e))
        check(checkpoint_epochs(ckpt) == [best], f"[15] main: kept {checkpoint_epochs(ckpt)}, best by ap {best}")
        check(len(step_t) == n_steps and all(len(t) == 3 for t in step_t[:2]), "[15] main: steps timed")
        start_up = step_t[0][0] - t_cli
        first_calls = [t[2] - t[0] for t in step_t[:2]]
        gaps = [step_t[i][1].elapsed_time(step_t[i + 1][1]) for i in range(n_steps - 1)
                if (i + 1) % CLI_STEPS != 0 and i >= 2]
        fit_ms = sum(gaps) / len(gaps)
        imp = subprocess.run([sys.executable, "-c", "import time; t = time.perf_counter(); "
                              "import passt_tpu_torch.cli, passt_tpu_torch.experiments; "
                              "print(time.perf_counter() - t)"], cwd=ROOT, capture_output=True, text=True,
                             timeout=120, check=True)
        import_s = float(imp.stdout.strip().splitlines()[-1])
        losses = ", ".join(f"{r['train_loss']:.5f}" for r in hist)
        aps = ", ".join(f"{r['ap']:.4f}" for r in hist)
        gap_list = ", ".join(f"{g:.1f}" for g in gaps)
        lines.append(f"[15] main: losses {losses}; ap {aps}; swa_ap {hist[-1]['swa_ap']:.4f} (SWA fires at epochs "
                     f"{fires}); kept checkpoint {best}; fit {fit_ms:.3f} ms/step steady ({len(gaps)} steps: "
                     f"{gap_list}; CUDA events between step starts) against bench.timed_steps {bench_ms:.3f} (ratio "
                     f"{fit_ms / bench_ms:.3f}); start-up: import {import_s:.2f} s (a fresh interpreter), cli.run to "
                     f"the first step {start_up:.2f} s (loaders, build), first step (eager) {first_calls[0]:.2f} s, "
                     f"second (capture + replay) {first_calls[1]:.2f} s ({gpu})")

        # 4. evaluate_only on the same checkpoint dir: bit-equal to the logged eval of the best epoch
        ev_argv = ["audioset", "evaluate_only"] + main_argv[3:]
        n_ev = 2 * CLI_EVAL_BATCHES if best >= fires[0] else CLI_EVAL_BATCHES
        run_cli("audioset evaluate_only (best checkpoint)", ev_argv,
                add_counts({"fused_log_mel": n_ev}, attn_counts(1190, 20, False, n_ev)))
        got = results[-1]
        keys = ["val_loss", "ap", "roc", "n_eval"] + (["swa_val_loss", "swa_ap"] if best >= fires[0] else [])
        diff = {k: (got.get(k), hist[best].get(k)) for k in keys if got.get(k) != hist[best].get(k)}
        check(not diff, f"[15] evaluate_only != the logged eval of epoch {best}: {diff}")
        lines.append(f"[15] evaluate_only: restored epoch {best}; {', '.join(keys)} bit-equal to the logged eval "
                     f"(ap {got['ap']:.6f}, val_loss {got['val_loss']:.6f})")

        # 5. predict
        run_cli("audioset predict", ["audioset", "predict"] + main_argv[3:],
                add_counts({"fused_log_mel": CLI_EVAL_BATCHES}, attn_counts(1190, 20, False, CLI_EVAL_BATCHES)))
        with np.load(results[-1]["path"]) as f:
            probs, names = f["out"], f["names"]
        check(probs.shape == (CLI_EVAL_BATCHES * 20, 527) and np.isfinite(probs).all()
              and probs.min() >= 0 and probs.max() <= 1 and len(names) == len(probs), f"[15] predict {probs.shape}")

        # 6. evaluate_ensemble on two random members written with save_params_npz
        members = os.path.join(tmp, "members")
        os.makedirs(members)
        arch_list = registry.ENSEMBLES[CLI_ENSEMBLE][0]
        for i, (arch, fs, ts) in enumerate(arch_list):
            model = registry.get_model(arch, pretrained=False, generator=torch.Generator().manual_seed(100 + i),
                                       device="cpu", fstride=fs, tstride=ts)
            save_params_npz(os.path.join(members, f"{arch}.npz"), dict(model.named_parameters()))
            del model
        tokens = [registry.get_model_config(a, fstride=fs, tstride=ts).seq_len(train=False) for a, fs, ts in arch_list]
        run_cli(f"audioset evaluate_ensemble ({CLI_ENSEMBLE}, N = {tokens})",
                ["audioset", "evaluate_ensemble", f"model.ensemble={CLI_ENSEMBLE}",
                 f"model.ensemble_checkpoint_dir={members}", f"trainer.limit_eval_batches={CLI_EVAL_BATCHES}"] + data,
                add_counts({"fused_log_mel": CLI_EVAL_BATCHES},
                           *[attn_counts(n, 20, False, CLI_EVAL_BATCHES) for n in tokens]))
        ens = results[-1]
        check(math.isfinite(ens["ap"]) and ens["published_map"] == 0.48579, f"[15] evaluate_ensemble {ens}")
        lines.append(f"[15] evaluate_ensemble {CLI_ENSEMBLE}: ap {ens['ap']:.4f} (random members) beside the published "
                     f"{ens['published_map']}")

        # 7. esc50 (single-label CE) and openmic (masked BCE), 1 epoch x 2 steps each
        from passt_tpu_torch.experiments import EXPERIMENTS

        for name, key in (("esc50", "accuracy"), ("openmic", "ap")):
            rcfg = EXPERIMENTS[name].default_config
            n_train, n_eval = token_counts(rcfg, rcfg.passt_config())
            b = rcfg.data.batch_size
            run_cli(f"{name} main (1 epoch x 2 steps, B={b})",
                    [name, "main"] + data + ["trainer.max_epochs=1", "trainer.limit_train_batches=2",
                                             "trainer.limit_eval_batches=1"],
                    add_counts({"fused_log_mel": 2 + 1}, attn_counts(n_train, b, True, 2),
                               attn_counts(n_eval, 20, False, 1)))
            rec = results[-1]["history"][-1]
            check(math.isfinite(rec["train_loss"]) and math.isfinite(rec[key]) and rec["n_eval"] == 20,
                  f"[15] {name}: {rec}")
            lines.append(f"[15] {name} main: train_loss {rec['train_loss']:.5f}, {key} {rec[key]:.4f}, val_loss "
                         f"{rec['val_loss']:.5f} (N = {n_train} train, {n_eval} eval)")

        # 8. test_loaders
        run_cli("audioset test_loaders", ["audioset", "test_loaders"] + data, {})
        check(results[-1] == {"training": (TRAIN_B, CLIP), "test": (20, CLIP)}, f"[15] test_loaders {results[-1]}")

        # 9. [16] audioset main at trainer.n_data=1: the data-parallel step in a one-rank NCCL group
        lines += ddp_main(gpu, dev, tmp, data, run_cli, step_t, step_losses, fit_results)
        total = add_counts(*runs)
    finally:
        import shutil

        for name, fn in saved.items():
            setattr(common, name, fn)
        shutil.rmtree(tmp, ignore_errors=True)
    say(f"[15] the CLI (python -m passt_tpu_torch.cli <experiment> <command>, in-process) at full PaSST-S width, bf16: "
        f"HDF5 containers replaced by FolderDatasets over {CLI_TRAIN_CLIPS} + {CLI_VAL_CLIPS} 10-s wav clips (written "
        f"in {write_s:.1f} s; the card's machine has no h5py): the two dataset builders and the target reader of "
        f"experiments/common.py; common.fit wrapped to time each step (it calls the package's fit and step); "
        f"nothing else replaced")
    for line in lines:
        say(line)
    return total


DDP_STEPS = 8  # [16]: steps of main, 1 eval batch of 20


def ddp_main(gpu: str, dev: torch.device, tmp: str, data: list, run_cli, step_t: list, step_losses: list,
             fit_results: list) -> list:
    """[16] data parallelism through NCCL at world size 1 (one card: NCCL
    puts no two ranks on one GPU). A one-rank NCCL group on a FileStore; the
    step's collectives (``DataParallel.gather_rows`` and
    ``all_reduce_mean``) captured in a CUDA graph and replayed on new
    inputs, the replay profiled; then ``audioset main`` (PaSST-S, B = 12,
    N = 474, bf16, graphed, DDP_STEPS steps and one eval batch, on
    [15]'s clips and replaced containers) without the runtime and with
    ``trainer.n_data=1`` (``maybe_ddp_runtime`` on the group): the
    per-step losses and the final parameters bit-equal, the launches exact
    in both, the collectives counted inside the graph's replays (2
    all-gathers and 1 all-reduce a step), ms/step of each. The group is
    destroyed at the end. Returns the lines to print."""
    import datetime

    import torch.distributed as dist

    from passt_tpu_torch.parallel import COLLECTIVES, DataParallel, reset_collectives

    lines = []
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "nccl_store"), 1), rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=120))
    try:
        torch.cuda.set_device(dev)
        # the collectives in a captured graph, replayed on new inputs
        dp = DataParallel(1, 0)
        x = torch.randn(TRAIN_B, 1, 128, 998, device=dev)
        g = torch.randn(1 << 20, device=dev).to(torch.bfloat16)
        loss = torch.zeros((), device=dev)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            dp.gather_rows(x)
            dp.all_reduce_mean({"g": g}, [loss])
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        reset_collectives()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            xg = dp.gather_rows(x)
            red, (loss_r,) = dp.all_reduce_mean({"g": g}, [loss])
        captured = dict(COLLECTIVES)
        check(captured == {"all_gather": 1, "all_reduce": 1}, f"[16] collectives captured {captured}")
        for i in range(3):
            x.normal_()
            g.copy_(torch.randn(g.shape, device=dev))
            loss.fill_(float(i) + 0.5)
            graph.replay()
            torch.cuda.synchronize()
            check(torch.equal(xg, x) and torch.equal(red["g"], g) and float(loss_r) == i + 0.5,
                  f"[16] replay {i}: the captured collectives did not follow their inputs")
        device_ops = sorted(kernel_times(graph.replay, reps=2))
        nccl_ops = [k for k in device_ops if "nccl" in k.lower() or "memcpy" in k.lower()]
        lines.append(f"[16] one-rank NCCL group (FileStore): gather_rows [12, 1, 128, 998] fp32 and all_reduce_mean of "
                     f"1M bf16 + the loss captured in one CUDA graph (the capture counted {captured}), 3 replays on new "
                     f"inputs bit-equal to them; a profiled replay's device ops: {device_ops} (NCCL or copies: "
                     f"{nccl_ops})")
        del graph, x, xg, g, red

        argv = ["audioset", "main", "with"] + data + [
            "trainer.max_epochs=1", f"trainer.limit_train_batches={DDP_STEPS}", "trainer.limit_eval_batches=1",
            "trainer.log_every_steps=1000"]
        want = add_counts({"fused_log_mel": DDP_STEPS + 1}, attn_counts(TRAIN_N, TRAIN_B, True, DDP_STEPS),
                          attn_counts(1190, 20, False, 1))
        got = {}
        for name, extra in (("without the runtime", []), ("trainer.n_data=1", ["trainer.n_data=1",
                                                                                "data.num_replicas=0"])):
            reset_collectives()
            fit_results.clear()
            out, wall, _ = run_cli(f"audioset main {name} ({DDP_STEPS} steps + 1 eval batch)", argv + extra, want,
                                   phase="[16]")
            collectives = dict(COLLECTIVES)
            res = fit_results[-1]
            check(len(step_losses) == DDP_STEPS and len(step_t) == DDP_STEPS, f"[16] {name}: steps {len(step_t)}")
            gaps = [step_t[i][1].elapsed_time(step_t[i + 1][1]) for i in range(2, DDP_STEPS - 1)]
            got[name] = dict(losses=[float(v) for v in step_losses],
                             params={k: p.detach().clone() for k, p in res.state.params.items()},
                             record=res.history[-1], collectives=collectives, ms=sum(gaps) / len(gaps), wall=wall,
                             printed="data parallel: rank 0 of 1" in out)
        plain, ddp = got["without the runtime"], got["trainer.n_data=1"]
        check(plain["collectives"] == {"all_gather": 0, "all_reduce": 0} and not plain["printed"],
              f"[16] the plain run issued collectives {plain['collectives']}")
        check(ddp["collectives"] == {"all_gather": 2 * DDP_STEPS, "all_reduce": DDP_STEPS} and ddp["printed"],
              f"[16] the data-parallel run's collectives {ddp['collectives']} (2 all-gathers and 1 all-reduce a step)")
        check(ddp["losses"] == plain["losses"] and all(math.isfinite(v) for v in ddp["losses"]),
              f"[16] losses {ddp['losses']} != {plain['losses']}")
        diffs = [k for k, p in plain["params"].items() if not torch.equal(p, ddp["params"][k])]
        check(not diffs, f"[16] parameters differ: {diffs[:6]}")
        drop = ("epoch_time_s", "it_per_s")
        check({k: v for k, v in ddp["record"].items() if k not in drop}
              == {k: v for k, v in plain["record"].items() if k not in drop},
              f"[16] epoch records {ddp['record']} != {plain['record']}")
        lines.append(f"[16] audioset main at trainer.n_data=1 (DDPRuntime over the one-rank NCCL group, the "
                     f"data-parallel step graphed with its collectives) bit-equal to main without the runtime: "
                     f"{DDP_STEPS} losses ({', '.join(f'{v:.6f}' for v in ddp['losses'])}), all "
                     f"{len(plain['params'])} parameters, the epoch record (ap {ddp['record']['ap']:.6f}); "
                     f"collectives over the graph's replays {ddp['collectives']}; fit ms/step (CUDA events between "
                     f"step starts, steps 3-{DDP_STEPS}): {plain['ms']:.3f} without, {ddp['ms']:.3f} with the "
                     f"runtime (ratio {ddp['ms'] / plain['ms']:.3f}); run wall {plain['wall']:.1f} / "
                     f"{ddp['wall']:.1f} s ({gpu})")
    finally:
        dist.destroy_process_group()
    return lines


def phase_export(gpu: str, dev: torch.device) -> list:
    """[17] export -> load -> serve on the card: ``export_inference``
    (PaSST-S, random weights from seed 0, symbolic batch) in fp32 and bf16,
    ``load_exported``, calls at B = 20 x 10 s and B = 1 with exact launches
    (the mel kernel and the attention forward kernel run inside the loaded
    program, as custom ops; the forward's "wgmma" path in bf16, "simt" in
    fp32) against the live graphed ``Predictor`` of the
    same weights (fp32 within 1e-4 of max|ref|, bf16 within 1e-2: the
    program runs the same kernels and ATen ops as the live model, eagerly;
    bf16 GEMMs may pick other tilings per batch, the bound of [4]'s B = 1
    against B = 20), ``python -m passt_tpu_torch.tools.serve`` on a folder
    of 6 wav clips, and ms/call and clips/s of the loaded program beside the
    Predictor, in turns. Returns the launch counts of its runs."""
    import contextlib
    import io
    import shutil
    import tempfile

    from passt_tpu_torch import export
    from passt_tpu_torch.hear import Predictor
    from passt_tpu_torch.ops import _build
    from passt_tpu_torch.ops import attention as A
    from passt_tpu_torch.tools import serve

    tmp = tempfile.mkdtemp(prefix="chip_smoke_export_")
    runs, lines = [], []

    def counted(fn):
        _build.reset_launches()
        A.reset_path_launches()
        out = fn()
        torch.cuda.synchronize()
        launches = {name: _build.LAUNCHES.get(name, 0) for name in KERNEL_NAMES}
        runs.append(launches)
        return out, launches, dict(A.FWD_PATH_LAUNCHES)

    try:
        rng = np.random.default_rng(17)
        w20 = torch.from_numpy(rng.standard_normal((20, CLIP)).astype(np.float32) * 0.1).to(dev)
        artifacts = {}
        for dtype, tol in (("float32", 1e-4), ("bfloat16", 1e-2)):
            prefix = os.path.join(tmp, f"passt_s_{dtype}")
            t0 = time.perf_counter()
            artifact, _ = export.export_inference(ARCH, prefix, device=dev, dtype=dtype, batch="b")
            export_s = time.perf_counter() - t0
            manifest = export.read_manifest(prefix)
            check(manifest["platforms"] == ["cuda"] and manifest["input"]["shape"] == [None, CLIP]
                  and manifest["outputs"] == {"logits": 527, "features": 768} and manifest["dtype"] == dtype,
                  f"[17] manifest {manifest}")
            t0 = time.perf_counter()
            fn = export.load_exported(prefix)
            load_s = time.perf_counter() - t0
            artifacts[dtype] = prefix
            live = Predictor.create(arch=ARCH, dtype=dtype, device=dev)  # export_inference's weights: seed 0
            (got20, got1), launches, paths = counted(lambda: (fn(w20), fn(w20[:1])))
            want = want_launches(fused_log_mel=2, fused_attention=24)
            path = "simt" if dtype == "float32" else "wgmma"  # forward_path: fp32 at D = 64 takes "simt"
            check(launches == want and paths == dict(dict(fma=0, mma=0, short=0, wgmma=0, simt=0), **{path: 24}),
                  f"[17] {dtype}: launches {launches} != {want} (forward paths {paths})")
            errs, equal = {}, True
            for b, got in ((20, got20), (1, got1)):
                ref = live.logits_and_features(w20[:b])
                for name, x, y in zip(("logits", "features"), got, ref):
                    check(tuple(x.shape) == tuple(y.shape) and bool(torch.isfinite(x).all()),
                          f"[17] {dtype} B={b} {name} {tuple(x.shape)}")
                    errs[f"B={b} {name}"] = max_err(x, y) / float(y.float().abs().max())
                    equal = equal and torch.equal(x, y)
            check(max(errs.values()) <= tol, f"[17] {dtype}: artifact vs Predictor {errs} > {tol}")
            times = {}
            for b, reps in ((20, 5), (1, 20)):
                fns = {"artifact": lambda: fn(w20[:b]), "Predictor": lambda: live(w20[:b])}
                times[b] = in_turns(fns, 3, lambda f: cuda_ms(f, reps=reps, warmup=1))
            lines.append(
                f"[17] {dtype}: export_inference {export_s:.1f} s ({os.path.getsize(artifact) / 1e6:.1f} MB), "
                f"load_exported {load_s:.1f} s; B=20 and B=1 calls launch {launches} (forward paths {paths}); "
                f"against the graphed Predictor {'bit-equal' if equal else 'not bit-equal'}, max|diff| / max|ref| "
                + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()) + f" (bound {tol}); in turns, ms/call: "
                + "; ".join(f"B={b} " + ", ".join(f"{name} {', '.join(f'{t:.3f}' for t in ts)} (best {min(ts):.3f} = "
                                                  f"{b * 1000.0 / min(ts):.2f} clips/s)" for name, ts in tt.items())
                            for b, tt in times.items()) + f" ({gpu})")
            del live, fn
        # the serve tool on a folder of wav clips, the bf16 artifact
        labels = write_clips(os.path.join(tmp, "wavs"), 6, seed=23)
        npz = os.path.join(tmp, "pred.npz")
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            _, launches, _ = counted(lambda: serve.main(["--artifact", artifacts["bfloat16"], "--wav-dir",
                                                         os.path.join(tmp, "wavs"), "--out", npz, "--batch", "4",
                                                         "--probs"]))
        serve_s = time.perf_counter() - t0
        want = want_launches(fused_log_mel=2, fused_attention=24)
        check(launches == want, f"[17] serve launches {launches} != {want}")
        with np.load(npz) as f:
            names, probs = list(f["names"]), f["out"]
        check(names == sorted(labels) and probs.shape == (6, 527) and np.isfinite(probs).all()
              and probs.min() >= 0 and probs.max() <= 1, f"[17] serve: {names} {probs.shape}")
        lines.append(f"[17] serve (python -m passt_tpu_torch.tools.serve, bf16 artifact, --batch 4 --probs): 6 10-s "
                     f"wav clips tagged in {serve_s:.2f} s (load, decode, 2 calls) into [6, 527] probabilities; "
                     f"launches {launches}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    say("[17] export -> load -> serve, PaSST-S (random weights, seed 0), symbolic batch, on the card:")
    for line in lines:
        say(line)
    return runs


# [18] the depth's forms (blocks_impl loop / scan / stacked, remat) at the
# bench's step, the stacked backward's fp32 step and serving, and the fp32
# attention forward ("simt", beside the old "fma") that the fp32 paths take
BLOCK_STEPS = 3  # graphed calls per form in the equality runs: eager, capture + replay, replay
#: the bench step's launches per step under each form (remat recomputes
#: each block's forward, its attention forward included, in the backward)
BLOCK_LAUNCHES = {
    "loop": STEP_LAUNCHES["default"],
    "scan": STEP_LAUNCHES["default"],
    "stacked": STEP_LAUNCHES["default"],
    "loop+remat": want_step(fused_log_mel=1, fused_attention_qkv=24, fused_attention_qkv_bwd=12),
}
# stacked against loop in bf16: the stack normalises in the JAX stack's
# order ((x - mu) rstd) s, the loop in flax's (x - mu) (rstd s), and keeps
# its weight gradients in fp32 before the cast; a bf16 value may round the
# other way and the difference rides through 12 blocks: the port's bf16
# bound, 2e-2 of max(1, max|ref|)
TOL_STACKED_BF16 = 2e-2
# stacked's first moment against loop's after the 3 steps (mu ~ 0.27 of the
# gradient; the parameters move ~lr a step whatever the gradient, so they
# cannot show a wrong one): the largest leaf's relative L2 error. Sound, it
# read 3.5e-3 (weight families 2.3e-3 to 2.5e-3); a zeroed weight gradient
# reads 1, one taken a block off 1.35 to 1.42 (PERF.md §6, PR 17): ten
# times the sound reading
TOL_STACKED_MU = 0.035
# the batched weight-gradient product (stacked_blocks._bdw: bf16 operands,
# an fp32 result) against the float64 product of the same values, relative
# to max|ref|: it read 7.2e-6 to 7.6e-6, its bf16-rounded result 2.3e-3 to
# 2.6e-3 (PERF.md §6, PR 17)
TOL_BDW = 1e-4
#: the weight-gradient products of the stacked backward: (activation,
#: cotangent) widths of qkv, proj, fc1, fc2 at PaSST-S
BDW_FAMILIES = {"attn.qkv": (768, 2304), "attn.proj": (768, 768), "mlp.fc1": (768, 3072), "mlp.fc2": (3072, 768)}


def rel_l2(got: torch.Tensor, ref: torch.Tensor) -> float:
    """||got - ref|| / ||ref||, in fp32."""
    ref = ref.float()
    return float((got.float() - ref).norm() / ref.norm().clamp_min(1e-30))


def phase_blocks(gpu: str, dev: torch.device) -> tuple:
    """[18] the bench's bf16 step (PaSST-S, B = 12, N = 474, graphed) under
    blocks_impl "loop", "scan", "stacked" and loop + remat from one state:
    3 calls each, scan and remat bit-equal to loop (loss, parameters, both
    moments; scan restacked), stacked within the bf16 bound and its first
    moment within TOL_STACKED_MU, the launches exact; the four timed in
    turns (tools/ab_scan_blocks: best of 2 x 30, peak memory, one eager
    step's memory, launches a step); the batched dW product
    against float64; one fp32 B = 2 stacked
    step with the kernels against the loop step on the plain versions (as
    [7]); a stacked Predictor at B = 20, N = 1190 against the loop's
    logits; tools/ab_batched_dw; and the fp32 attention forward on its
    "simt" path beside the old "fma" kernel at the serving and the fp32
    step's shapes. Returns (the
    main-path runs' launches, the fp32 forward's record)."""
    from passt_tpu_torch import bench
    from passt_tpu_torch.models.pretrained import stack_block_params
    from passt_tpu_torch.ops import _build
    from passt_tpu_torch.tools import ab_scan_blocks
    from passt_tpu_torch.train.steps import TrainState

    runs = []
    _, base, _, batch = bench.setup(dev, jit=False)
    params0 = {k: v.clone() for k, v in base.params.items()}
    del base
    out = {}
    for name, overrides in ab_scan_blocks.VARIANTS.items():
        _, _, step, _ = bench.setup(dev, **overrides)  # its own weights are replaced by the loop's
        params = {k: v.clone() for k, v in params0.items()}
        if overrides.get("blocks_impl"):
            params = stack_block_params(params)
        state = TrainState(params=params, opt_state=bench.optimizer().init(params), step=0)
        torch.cuda.synchronize()
        _build.reset_launches()
        losses = []
        for _ in range(BLOCK_STEPS):
            state, m = step(state, batch, bench.SEED)
            losses.append(m["loss"].clone())
        torch.cuda.synchronize()
        launches = step_launches()
        want = {k: v * BLOCK_STEPS for k, v in BLOCK_LAUNCHES[name].items()}
        check(launches == want, f"[18] {name}: launches {launches} != {want}")
        runs.append(launches)
        out[name] = dict(losses=torch.stack(losses), state=clone_state(state))
        del step, state
    ref = out["loop"]
    ref_stacked = {part: stack_block_params(getattr(ref["state"], "params") if part == "params"
                                            else getattr(ref["state"].opt_state, part))
                   for part in ("params", "mu", "nu")}
    notes = []
    for name in ("scan", "loop+remat", "stacked"):
        got = out[name]
        want = ref_stacked if name != "loop+remat" else {
            "params": ref["state"].params, "mu": ref["state"].opt_state.mu, "nu": ref["state"].opt_state.nu}
        leaves = {part: (got["state"].params if part == "params" else getattr(got["state"].opt_state, part))
                  for part in ("params", "mu", "nu")}
        if name != "stacked":
            diffs = [f"{part} {k}" for part in want for k in want[part]
                     if not torch.equal(want[part][k], leaves[part][k])]
            check(torch.equal(got["losses"], ref["losses"]) and not diffs,
                  f"[18] {name} != loop: losses {got['losses'].tolist()} vs {ref['losses'].tolist()}, "
                  f"{len(diffs)} leaves differ: {diffs[:6]}")
            notes.append(f"{name} bit-equal to loop (3 losses, {len(want['params'])} parameter leaves, mu, nu)")
        else:
            loss_err = max_err(got["losses"], ref["losses"])
            leaf_err = max(max_err(leaves["params"][k], w) / max(1.0, float(w.float().abs().max()))
                           for k, w in want["params"].items())
            mu_err = {k: rel_l2(leaves["mu"][k], w) for k, w in want["mu"].items()}
            worst = max(mu_err, key=mu_err.get)
            # what a wrong batched dW would read: each family's mu a block off
            rolled = {f: rel_l2(leaves["mu"][f"blocks.block.{f}.weight"].roll(1, 0),
                                want["mu"][f"blocks.block.{f}.weight"]) for f in BDW_FAMILIES}
            check(loss_err <= TOL_STACKED_BF16 and leaf_err <= TOL_STACKED_BF16 and mu_err[worst] <= TOL_STACKED_MU,
                  f"[18] stacked vs loop: loss err {loss_err:.3g}, parameter err {leaf_err:.3g} (tol "
                  f"{TOL_STACKED_BF16}), mu rel L2 err {mu_err[worst]:.3g} at {worst} (tol {TOL_STACKED_MU})")
            notes.append(f"stacked vs loop: losses max err {loss_err:.3g}, parameters max err {leaf_err:.3g} of "
                         f"max(1, max|ref|) (tol {TOL_STACKED_BF16:g}), mu rel L2 err max {mu_err[worst]:.3g} at "
                         f"{worst} (tol {TOL_STACKED_MU:g}; weight families "
                         + ", ".join(f"{f} {mu_err[f'blocks.block.{f}.weight']:.3g}" for f in BDW_FAMILIES)
                         + "; a zeroed dW reads 1, one a block off reads "
                         + ", ".join(f"{f} {e:.3g}" for f, e in rolled.items()) + ")")
    del out, ref, ref_stacked
    say(f"[18] bf16 train step PaSST-S B={TRAIN_B} N={TRAIN_N} (bench config, graphed), {BLOCK_STEPS} calls from "
        f"one state under each form: " + "; ".join(notes) + "; launches a step "
        + "; ".join(f"{n} { {k: v for k, v in w.items() if v} }" for n, w in BLOCK_LAUNCHES.items()))

    ab = ab_scan_blocks.run(dev, steps=30, runs=2)  # two runs of 30 keep the script in its time limit
    for name, r in ab.items():
        say(f"[18] {name}: {', '.join(f'{t:.3f}' for t in r['ms_per_step_runs'])} ms/step in turns (best "
            f"{r['ms_per_step']:.3f}, spread {100 * r['spread']:.2f}%), first calls "
            f"{', '.join(f'{t:.2f}' for t in r['warmup_s'])} s, peak memory {r['peak_memory_bytes'] / 2**30:.3f} GiB "
            f"(max_memory_allocated over set-up and warm-up); launches a step {r['launches_per_step']} ({gpu})")
        check(r["launches_per_step"] == {k: v for k, v in BLOCK_LAUNCHES[name].items() if v},
              f"[18] {name}: timed launches a step {r['launches_per_step']}")
    say("[18] one eager step on a warmed state (bench.step_memory), GiB: " + "; ".join(
        f"{name} peak {r['step_peak_bytes'] / 2**30:.3f}, the training forward holds "
        f"{r['forward_saved_bytes'] / 2**30:.3f}" for name, r in ab.items()) + f" ({gpu})")
    held, held_remat = ab["loop"]["forward_saved_bytes"], ab["loop+remat"]["forward_saved_bytes"]
    check(held_remat < held / 2, f"[18] remat's forward holds {held_remat} B, not under half the loop's {held} B")
    say("[18] ab_scan_blocks JSON: " + json.dumps(ab))
    blocks_bdw(gpu, dev)
    runs.append(blocks_fp32_step(dev))
    runs.append(blocks_predictor(gpu, dev))
    blocks_batched_dw(gpu, dev)
    return runs, fp32_attention_forward(gpu, dev)


def blocks_bdw(gpu: str, dev: torch.device) -> None:
    """[18] the stacked backward's batched weight-gradient product on the
    card (bf16 operands, an fp32 result: the branch only the card takes) at
    the bench step's shapes, against the float64 product of the same
    values."""
    from passt_tpu_torch.models.stacked_blocks import _bdw

    gen = torch.Generator(device=dev).manual_seed(18)
    notes = []
    for fam, (k_in, k_out) in BDW_FAMILIES.items():
        acts = torch.randn(12, TRAIN_B, TRAIN_N, k_in, generator=gen, device=dev).bfloat16()
        cots = torch.randn(12, TRAIN_B, TRAIN_N, k_out, generator=gen, device=dev).bfloat16()
        got = _bdw(acts, cots)
        ref = torch.bmm(cots.double().reshape(12, -1, k_out).transpose(1, 2), acts.double().reshape(12, -1, k_in))
        err, err_bf16 = rel_err(got, ref), rel_err(got.bfloat16(), ref)
        check(got.dtype == torch.float32 and err <= TOL_BDW,
              f"[18] batched dW {fam}: {got.dtype}, err {err:.3g} (tol {TOL_BDW:g})")
        notes.append(f"{fam} [12, {k_out}, {k_in}] err {err:.3g} (bf16-rounded {err_bf16:.3g})")
    say(f"[18] batched weight-gradient product (stacked_blocks._bdw, B={TRAIN_B} N={TRAIN_N}, 12 blocks) vs float64, "
        f"max err of max|ref| (tol {TOL_BDW:g}): " + "; ".join(notes) + f" ({gpu})")


def blocks_fp32_step(dev: torch.device) -> dict:
    """[18] one fp32 B = 2 stacked step with the kernels against the loop
    step on the plain versions, from the same weights and draws (as [7])."""
    from passt_tpu_torch.models.passt import PaSSTConfig
    from passt_tpu_torch.models.pretrained import stack_block_params
    from passt_tpu_torch.train.steps import create_train_state, make_optimizer

    patchout = dict(s_patchout_t=40, s_patchout_f=4)
    _, init = create_train_state(PaSSTConfig(dtype="float32", **patchout), make_optimizer(),
                                 torch.Generator().manual_seed(0), device="cpu")
    k = fp32_step(dev, dict(attn_impl="fused", blocks_impl="stacked", **patchout), "auto",
                  init_params=stack_block_params(init.params))
    p = fp32_step(dev, dict(attn_impl="xla", **patchout), "matmul", init_params=init.params)
    for part in ("grads", "updates", "params"):
        p[part] = stack_block_params(p[part])
    want = want_launches(fused_log_mel=1, fused_attention=12, fused_attention_qkv_bwd=12)
    launches = {name: k["launches"].get(name, 0) for name in KERNEL_NAMES}
    check(launches == want, f"[18] fp32 stacked step launches {launches} != {want}")
    check(k["bwd_paths"] == dict(fma=0, mma=0, resident=0, wgmma=0, simt=12) and k["fwd_paths"] == FP32_FWD_PATHS,
          f"[18] fp32 stacked step paths: forward {k['fwd_paths']}, backward {k['bwd_paths']}")
    say(f"[18] fp32 stacked training step PaSST-S B=2 N={TRAIN_N} (the hand-written backward, 4 batched weight-"
        f"gradient products), kernels vs the loop step on plain versions: {hold_fp32_step(k, p, '[18] stacked')}; "
        f"forward paths {k['fwd_paths']}, backward paths {k['bwd_paths']}")
    return launches


def blocks_predictor(gpu: str, dev: torch.device) -> dict:
    """[18] a stacked Predictor at B = 20, N = 1190 (no gradient: the
    forward unrolled, outside the Function) against the loop's."""
    from passt_tpu_torch.hear import Predictor
    from passt_tpu_torch.models.pretrained import stack_block_params
    from passt_tpu_torch.ops import _build
    from passt_tpu_torch.ops import attention as A

    loop_pred = Predictor.create(arch=ARCH, dtype="bfloat16", device=dev, generator=torch.Generator().manual_seed(0))
    st_pred = Predictor.create(arch=ARCH, dtype="bfloat16", device=dev, blocks_impl="stacked")
    st_pred.model.load_state_dict(stack_block_params(loop_pred.model.state_dict()))
    rng = np.random.default_rng(18)
    waves = [torch.from_numpy(rng.standard_normal((20, CLIP)).astype(np.float32) * 0.1).to(dev) for _ in range(3)]
    refs = [loop_pred(w) for w in waves]
    torch.cuda.synchronize()
    _build.reset_launches()
    A.reset_path_launches()
    gots = [st_pred(w) for w in waves]  # warm-up, capture, replay
    torch.cuda.synchronize()
    launches = {k: _build.LAUNCHES.get(k, 0) for k in KERNEL_NAMES}
    want = want_launches(fused_log_mel=3, fused_attention=36)
    check(launches == want, f"[18] stacked Predictor launches {launches} != {want}")
    errs = [max_err(g, r) / max(1.0, float(r.abs().max())) for g, r in zip(gots, refs)]
    check(max(errs) <= TOL_STACKED_BF16, f"[18] stacked Predictor vs loop: errs {errs}")
    times = in_turns({"stacked": lambda: st_pred(waves[0]), "loop": lambda: loop_pred(waves[0])}, 3,
                     lambda fn: cuda_ms(fn, reps=5, warmup=1))
    say(f"[18] stacked Predictor bf16 B=20 N=1190 (graphed; warm-up, capture, replay) vs the loop Predictor on the "
        f"same weights: logits max err {max(errs):.3g} of max(1, max|ref|) (tol {TOL_STACKED_BF16:g}); launches "
        f"{ {k: v for k, v in launches.items() if v} } over 3 calls (forward paths {dict(A.FWD_PATH_LAUNCHES)}); in "
        f"turns, ms/call: " + ", ".join(f"{n} {', '.join(f'{t:.3f}' for t in ts)}" for n, ts in times.items())
        + f" ({gpu})")
    return launches


def blocks_batched_dw(gpu: str, dev: torch.device) -> None:
    """[18] tools/ab_batched_dw once."""
    from passt_tpu_torch.tools import ab_batched_dw

    dw = ab_batched_dw.run(dev, reps=5)
    say(f"[18] ab_batched_dw (12 blocks x 4 weight families at M = {ab_batched_dw.M}, bf16, AdamW-SR): per block "
        f"{dw['per_block']['best_kernel_ms']:.3f} ms of kernels an iteration ({dw['per_block']['product_tflops']:.1f} "
        f"TFLOP/s of products over it; eager events {dw['per_block']['best_events_ms']:.3f} ms), batched "
        f"{dw['batched']['best_kernel_ms']:.3f} ms ({dw['batched']['product_tflops']:.1f} TFLOP/s; eager events "
        f"{dw['batched']['best_events_ms']:.3f} ms); the products alone {dw['products_only']['per_block_ms']:.3f} "
        f"per block, {dw['products_only']['batched_ms']:.3f} batched ({gpu})")
    say("[18] ab_batched_dw JSON: " + json.dumps(dw))


def fp32_attention_forward(gpu: str, dev: torch.device) -> dict:
    """[18] the fp32 attention forward on its "simt" path, at the fp32
    Predictor's (B = 20, N = 1190) and the fp32 step's (B = 2, N = 474)
    shapes, on the q, k, v views of one qkv tensor (the model's layout),
    beside the old "fma" kernel on the same call (the private path
    override), plain and each SDPA backend that takes fp32, with the bound;
    the new kernel must be faster than the old one and than plain."""
    from passt_tpu_torch.ops import attention as A
    from passt_tpu_torch.ops.attention import attention_plain, fused_attention

    def old(q, kk, v, scale):
        out = torch.empty(q.shape, device=q.device)
        A._launch(q, kk, v, out, scale, False, path="fma")
        return out

    simt = {}
    for b, n in ((20, 1190), (2, TRAIN_N)):
        gen = torch.Generator().manual_seed(n)
        qkv = torch.randn(b, n, 3 * 12 * 64, generator=gen).to(dev)
        q, kk, v = qkv.reshape(b, n, 3, 12, 64).unbind(2)
        scale = 64 ** -0.5
        ref = attention_plain(q, kk, v, scale=scale)
        A.reset_path_launches()
        got = fused_attention(q, kk, v, scale=scale)
        check(A.FWD_PATH_LAUNCHES["simt"] == 1 == sum(A.FWD_PATH_LAUNCHES.values()),
              f"[18] fp32 forward took {A.FWD_PATH_LAUNCHES}")
        A.reset_path_launches()
        got_old = old(q, kk, v, scale)
        check(A.FWD_PATH_LAUNCHES["fma"] == 1 == sum(A.FWD_PATH_LAUNCHES.values()),
              f"[18] fp32 fma override took {A.FWD_PATH_LAUNCHES}")
        err, err_old = max_err(got, ref), max_err(got_old, ref)
        check(err < 1e-4 and err_old < 1e-4, f"[18] fp32 forward B={b} N={n}: err {err:.3g}, old fma {err_old:.3g}")
        new_fn, old_fn = (lambda: fused_attention(q, kk, v, scale=scale)), (lambda: old(q, kk, v, scale))
        rec = dict(ms=graph_ms(new_fn), ms_events=cuda_ms(new_fn, reps=20), fma_ms=graph_ms(old_fn),
                   fma_ms_events=cuda_ms(old_fn, reps=20),
                   plain_ms=cuda_ms(lambda: attention_plain(q, kk, v, scale=scale), reps=5), max_abs_err=err,
                   fma_max_abs_err=err_old, **bound(4.0 * n * n * 64 * b * 12, 4.0 * 4 * b * n * 12 * 64, PEAK_FP32))
        rec["library_backend_ms"] = {be.name: cuda_ms(under(be, lambda: sdpa(q, kk, v, scale)), reps=10)
                                     for be in sdpa_backends(q, kk, v, scale)}
        check(rec["ms"] < rec["fma_ms"] and rec["ms"] < rec["plain_ms"],
              f"[18] fp32 forward B={b} N={n}: simt {rec['ms']:.4f} ms not under the old fma {rec['fma_ms']:.4f} "
              f"and plain {rec['plain_ms']:.4f}")
        simt[f"B{b}_N{n}"] = rec
    say("[18] fp32 attention forward ('simt' path; the old 'fma' kernel on the same call) vs plain and each SDPA "
        "backend that takes fp32: " + "; ".join(
            f"{shape}: simt {r['ms']:.4f} ms (graph replay; events {r['ms_events']:.4f}), fma {r['fma_ms']:.4f} "
            f"(events {r['fma_ms_events']:.4f}), plain {r['plain_ms']:.3f}, bound {r['bound_ms']:.4f} "
            f"({r['bound_by']}), SDPA { {k: round(v, 4) for k, v in r['library_backend_ms'].items()} }, max err "
            f"{r['max_abs_err']:.3g} (fma {r['fma_max_abs_err']:.3g})" for shape, r in simt.items())
        + f"; {A.simt_forward_blocks_per_sm()} simt blocks an SM ({gpu})")
    say("[18] fp32 attention forward JSON: " + json.dumps(simt))
    return simt


# [19] offline data preparation (passt_tpu_torch.data.prepare and the prep
# tools) on the card's host at ESC-50's clip length and rate, and the
# full-size training demo (tools/fullsize_train_demo) at full PaSST-S width
PREP_FOLDS, PREP_CLIPS_PER_FOLD = 5, 40  # ESC-50 has 400 a fold; the tree is cut in count only
PREP_SECONDS, PREP_RATE = 5, 44100  # ESC-50's clips: 5 s at 44.1 kHz
PREP_KINDS = ("pcm16", "pcm16_stereo", "pcm24", "float32", "extensible_pcm16")
PREP_TOOLS = ("prepare_esc50", "prepare_fsd50k", "prepare_audioset", "prepare_openmic", "transcode_to_mp3",
              "fullsize_train_demo")
# the resampler (320/441) keeps a 1 kHz tone's RMS within 1% and takes a
# 20 kHz tone (above the 16 kHz Nyquist) at least 40 dB down
TOL_PASSBAND, STOPBAND_DB = 0.01, 40.0
MP3_MIN_SNR_DB = 20.0  # a 128 kbit/s mono mp3 decoded against its 32 kHz wave
# the demo learns: the last epoch's ap at least 0.5 and 5x the first's
# (chance for 50 balanced classes is ~0.02)
DEMO_MIN_AP, DEMO_MIN_GAIN = 0.5, 5.0


def write_riff(path: str, kind: str, x: np.ndarray, rate: int) -> None:
    """One RIFF/WAVE file of ``x`` ([n] mono or [n, 2] stereo, in [-1, 1])
    in one of PREP_KINDS: PCM16 mono or stereo, PCM24, IEEE float32, or
    PCM16 in a WAVE_FORMAT_EXTENSIBLE header."""
    import struct

    channels = 1 if x.ndim == 1 else x.shape[1]
    if kind == "pcm24":
        bits, code = 24, 1
        data = np.rint(x * 8388607).astype("<i4").view(np.uint8).reshape(-1, 4)[:, :3].tobytes()
    elif kind == "float32":
        bits, code, data = 32, 3, x.astype("<f4").tobytes()
    else:
        bits, code, data = 16, 1, np.rint(x * 32767).astype("<i2").tobytes()
    block = channels * bits // 8
    if kind == "extensible_pcm16":
        fmt = struct.pack("<HHIIHHHHIH", 0xFFFE, channels, rate, rate * block, block, bits, 22, bits, 0, code)
        fmt += b"\x00\x00\x00\x00\x10\x00\x80\x00\x00\xaa\x00\x38\x9b\x71"
    else:
        fmt = struct.pack("<HHIIHH", code, channels, rate, rate * block, block, bits)
    body = b"fmt " + struct.pack("<I", len(fmt)) + fmt + b"data" + struct.pack("<I", len(data)) + data
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + len(body)) + b"WAVE" + body)


def write_esc50_tree(root: str, seed: int) -> dict:
    """An ESC-50-shaped tree (audio/*.wav, meta/esc50.csv): PREP_FOLDS folds
    of PREP_CLIPS_PER_FOLD clips, PREP_SECONDS s at PREP_RATE, a class tone
    plus noise, cycling through PREP_KINDS (stereo clips get a second,
    different channel). Returns {file name: int16 channels} of the PCM16
    stereo clips, for the mixdown check."""
    import csv

    os.makedirs(os.path.join(root, "audio"))
    os.makedirs(os.path.join(root, "meta"))
    rng = np.random.default_rng(seed)
    n = PREP_SECONDS * PREP_RATE
    t = np.arange(n) / PREP_RATE
    rows, stereo = [], {}
    for i in range(PREP_FOLDS * PREP_CLIPS_PER_FOLD):
        fold, target, kind = 1 + i % PREP_FOLDS, i % 50, PREP_KINDS[i % len(PREP_KINDS)]
        name = f"{fold}-{100000 + i}-A-{target}.wav"
        x = 0.4 * np.sin(2 * np.pi * (110.0 * 1.07 ** target) * t + rng.uniform(0, 2 * np.pi)) \
            + 0.05 * rng.standard_normal(n)
        if kind == "pcm16_stereo":
            x = np.stack([x, 0.3 * np.sin(2 * np.pi * 2500.0 * t) + 0.05 * rng.standard_normal(n)], axis=1)
            stereo[name] = np.rint(x * 32767).astype(np.int16)
        write_riff(os.path.join(root, "audio", name), kind, x, PREP_RATE)
        rows.append([name, fold, target, f"class{target}", "False", 100000 + i, "A"])
    with open(os.path.join(root, "meta", "esc50.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["filename", "fold", "target", "category", "esc10", "src_file", "take"])
        w.writerows(rows)
    return stereo


def prep_imports() -> tuple:
    """[19a] the prep package and every prep tool import; which optional
    pieces load: h5py, libmp3lame, libvorbisfile, the native plane's
    libmpg123. A piece found that then fails fails the run."""
    import importlib
    import importlib.util
    import tempfile

    import passt_tpu_torch.data.prepare  # noqa: F401
    from passt_tpu_torch.data import native as N
    from passt_tpu_torch.data.prepare import mp3enc, oggdec

    for tool in PREP_TOOLS:
        importlib.import_module(f"passt_tpu_torch.tools.{tool}")
    have = {"h5py": importlib.util.find_spec("h5py") is not None, "libmp3lame": mp3enc.available(),
            "libvorbisfile": oggdec.available(), "libmpg123": N.mp3_available()}
    parts = []
    if have["h5py"]:
        import h5py  # a found h5py that does not import fails the run

        parts.append(f"h5py {h5py.__version__} loads")
    else:
        parts.append("h5py absent (the container write and read-back are left to the CPU tests)")
    parts.append("libmp3lame loads" if have["libmp3lame"] else "libmp3lame absent (mp3 encode left to the CPU tests)")
    if have["libvorbisfile"]:
        with tempfile.NamedTemporaryFile(suffix=".ogg") as f:
            f.write(b"OggS" + bytes(200))
            f.flush()
            try:
                oggdec.decode_ogg(f.name)
            except ValueError as e:  # the library was reached and refused a broken stream
                check("ov_fopen failed" in str(e), f"[19] decode_ogg of a broken stream: {e}")
            else:
                check(False, "[19] decode_ogg decoded a broken stream")
        parts.append("libvorbisfile loads (refuses a broken stream through ov_fopen; no ogg on this machine to "
                     "decode)")
    else:
        parts.append("libvorbisfile absent (ogg decode left to the CPU tests)")
    parts.append("the native plane's libmpg123 loads" if have["libmpg123"]
                 else "the native plane's libmpg123 absent (mp3 decode left to the CPU tests)")
    return have, (f"[19] prep imports: passt_tpu_torch.data.prepare and the tools {', '.join(PREP_TOOLS)} import; "
                  + "; ".join(parts))


def prep_chain(gpu: str, have: dict) -> str:
    """[19b] the ESC-50 prep chain on the card's host, through
    ``tools/prepare_esc50``'s own functions: metadata, decode + resample of
    every clip (1 thread and the tool's default workers), the stereo
    mixdown, the resampler's passband and stopband, mp3 encode and decode
    back where the libraries load, ``pack_fold`` and the port's
    HDF5AudioDataset where h5py loads."""
    import inspect
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from passt_tpu_torch.data.prepare.metadata import parse_esc50_meta
    from passt_tpu_torch.data.prepare.wavdec import decode_wav, resample
    from passt_tpu_torch.tools import prepare_esc50

    workers = inspect.signature(prepare_esc50.pack_fold).parameters["workers"].default
    n_out = math.ceil(PREP_SECONDS * PREP_RATE * prepare_esc50.TARGET_RATE / PREP_RATE)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_prep_")
    parts = []
    try:
        t0 = time.perf_counter()
        stereo = write_esc50_tree(tmp, seed=19)
        write_s = time.perf_counter() - t0
        meta, audio = os.path.join(tmp, "meta", "esc50.csv"), os.path.join(tmp, "audio")
        n_clips = PREP_FOLDS * PREP_CLIPS_PER_FOLD
        for fold in range(1, PREP_FOLDS + 1):
            train, _ = parse_esc50_meta(meta, fold=fold, train=True)
            test, _ = parse_esc50_meta(meta, fold=fold, train=False)
            check((len(train), len(test)) == (n_clips - PREP_CLIPS_PER_FOLD, PREP_CLIPS_PER_FOLD)
                  and not set(train) & set(test), f"[19] fold {fold}: {len(train)} train, {len(test)} test")
        files = sorted(os.listdir(audio))

        def rate(fn, pool_size):
            """clips/s of ``fn`` over every clip with ``pool_size`` threads, and its outputs."""
            t0 = time.perf_counter()
            if pool_size == 1:
                out = [fn(f) for f in files]
            else:
                with ThreadPoolExecutor(max_workers=pool_size) as pool:
                    out = list(pool.map(fn, files))
            return len(files) / (time.perf_counter() - t0), out

        prepare_esc50._load_clip(audio, files[0])  # scipy.signal's import left out of the times
        load_1, waves = rate(lambda f: prepare_esc50._load_clip(audio, f), 1)
        load_n, waves_n = rate(lambda f: prepare_esc50._load_clip(audio, f), workers)
        for f, w, w2 in zip(files, waves, waves_n):
            check(w.shape == (n_out,) and w.dtype == np.float32 and bool(np.isfinite(w).all())
                  and np.array_equal(w, w2), f"[19] {f}: decode + resample gave {w.shape} {w.dtype}")
        parts.append(f"decode + resample ({'/'.join(PREP_KINDS)} at {PREP_RATE} Hz -> {n_out} samples at "
                     f"{prepare_esc50.TARGET_RATE} Hz, all finite): {load_1:.1f} clips/s on 1 thread, {load_n:.1f} "
                     f"clips/s on the tool's {workers} workers")
        for name, pcm in stereo.items():
            x, _ = decode_wav(os.path.join(audio, name))
            ref = ((pcm[:, 0].astype(np.float64) + pcm[:, 1].astype(np.float64)) / 65536.0).astype(np.float32)
            check(np.array_equal(x, ref), f"[19] {name}: stereo mixdown != the mean of its channels")
        parts.append(f"the stereo mixdown bit-equal to the mean of the channels ({len(stereo)} clips)")

        t = np.arange(PREP_SECONDS * PREP_RATE) / PREP_RATE
        edge = prepare_esc50.TARGET_RATE // 10  # the filter's transients at the clip's ends left out
        gains = {}
        for f in (1000.0, 20000.0):
            x = (0.5 * np.sin(2 * np.pi * f * t)).astype(np.float32)
            y = resample(x, PREP_RATE, prepare_esc50.TARGET_RATE)
            gains[f] = float(np.sqrt(np.mean(y[edge:-edge].astype(np.float64) ** 2)) / (0.5 / math.sqrt(2)))
        stop_db = -20 * math.log10(max(gains[20000.0], 1e-30))
        check(abs(gains[1000.0] - 1) <= TOL_PASSBAND, f"[19] 1 kHz through the resampler: RMS ratio {gains[1000.0]}")
        check(stop_db >= STOPBAND_DB, f"[19] 20 kHz through the resampler only {stop_db:.1f} dB down")
        parts.append(f"1 kHz RMS ratio {gains[1000.0]:.6f} (tol {TOL_PASSBAND}), 20 kHz {stop_db:.1f} dB down "
                     f"(at least {STOPBAND_DB:.0f})")

        if have["libmp3lame"]:
            from passt_tpu_torch.data.prepare.mp3enc import encode_mp3

            by_name = dict(zip(files, waves))
            encode_mp3(waves[0], prepare_esc50.TARGET_RATE)  # the library's load left out of the times
            enc_1, blobs = rate(lambda f: encode_mp3(by_name[f], prepare_esc50.TARGET_RATE), 1)
            enc_n, blobs_n = rate(lambda f: encode_mp3(by_name[f], prepare_esc50.TARGET_RATE), workers)
            check(blobs == blobs_n, "[19] mp3 bytes differ between 1 thread and the workers")
            kbytes = sum(len(b) for b in blobs) / len(blobs) / 1024
            part = (f"mp3 encode (128 kbit/s mono CBR, {kbytes:.1f} KiB a clip): {enc_1:.1f} clips/s on 1 thread, "
                    f"{enc_n:.1f} on {workers} workers")
            if have["libmpg123"]:
                from passt_tpu_torch.data import native as N

                snrs = []
                for f, blob in zip(files, blobs):
                    y, sr = N.decode_mp3(blob)
                    w = by_name[f].astype(np.float64)
                    check(sr == prepare_esc50.TARGET_RATE and len(y) == len(w),
                          f"[19] {f}: mp3 decoded to {len(y)} samples at {sr} Hz, not {len(w)}")
                    snrs.append(10 * math.log10(np.sum(w ** 2) / max(np.sum((y - w) ** 2), 1e-30)))
                check(min(snrs) >= MP3_MIN_SNR_DB, f"[19] mp3 round trip SNR {min(snrs):.2f} dB")
                part += (f"; decoded back (the native plane's libmpg123) to exactly len(wave) samples, SNR "
                         f"{min(snrs):.2f} to {max(snrs):.2f} dB (at least {MP3_MIN_SNR_DB:.0f})")
            parts.append(part)

        if have["h5py"]:
            from passt_tpu_torch.data import HDF5AudioDataset

            out = os.path.join(tmp, "hdf5")
            os.makedirs(out)
            t0 = time.perf_counter()
            paths = prepare_esc50.pack_fold(tmp, out, fold=1, fmt="raw", workers=workers)
            pack_s = time.perf_counter() - t0
            by_name = dict(zip(files, waves))
            for path in paths:
                ds = HDF5AudioDataset(path, classes_num=50, clip_length=PREP_SECONDS, packed_targets=False)
                for i in range(len(ds)):
                    got, name, _ = ds[i]
                    q = (np.clip(by_name[name], -1.0, 1.0) * 32767.0).astype(np.int16)
                    want = np.zeros(PREP_SECONDS * prepare_esc50.TARGET_RATE, np.float32)
                    want[: len(q)] = q.astype(np.float32) / 32768.0
                    check(np.array_equal(got, want), f"[19] {name}: the container's wave != the chain's int16 wave")
            parts.append(f"pack_fold (fold 1, raw) in {pack_s:.2f} s, read back by HDF5AudioDataset bit-equal to "
                         f"the chain's int16 waves")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return (f"[19] prep chain (tools/prepare_esc50's functions) on an ESC-50-shaped tree of {PREP_FOLDS} folds x "
            f"{PREP_CLIPS_PER_FOLD} clips of {PREP_SECONDS} s at {PREP_RATE} Hz (written in {write_s:.1f} s; "
            f"parse_esc50_meta {n_clips - PREP_CLIPS_PER_FOLD} train / {PREP_CLIPS_PER_FOLD} test a fold): "
            + "; ".join(parts) + f" ({gpu})")


def write_demo_items(root: str, items: list) -> dict:
    """The demo's items as 32 kHz PCM16 wav files, quantised as the
    container's raw_i16 column is (clip to [-1, 1], x 32767, truncate);
    returns {file name: target}."""
    import wave as wavemod

    os.makedirs(root)
    labels = {}
    for name, w, y in items:
        q = (np.clip(np.asarray(w, np.float32), -1.0, 1.0) * 32767.0).astype(np.int16)
        with wavemod.open(os.path.join(root, name), "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(32000)
            f.writeframes(q.tobytes())
        labels[name] = np.asarray(y, np.float32)
    return labels


def token_counts(cfg, pcfg) -> tuple:
    """(N in training, N in eval) of a recipe's config on its clips."""
    frames = min(cfg.mel.frames(int(cfg.data.clip_length * 32000)), pcfg.input_tdim)
    t_grid = (frames - pcfg.patch_size[1]) // pcfg.stride[1] + 1
    return pcfg.seq_len(train=True, t_grid=t_grid), pcfg.seq_len(train=False, t_grid=t_grid)


def swa_evals(cfg, epochs: int) -> list:
    """The 0-based epochs of a run of ``epochs`` epochs (its
    ``trainer.max_epochs``) that also evaluate an SWA average: every epoch
    from SWA's first average on."""
    from passt_tpu_torch.train.swa import SWAState, swa_should_update

    probe = SWAState(avg_params=None, swa_epoch_start=cfg.trainer.swa_epoch_start, swa_freq=cfg.trainer.swa_freq)
    fires = [e for e in range(epochs) if swa_should_update(probe, e, epochs)]
    return [e for e in range(epochs) if cfg.trainer.swa and fires and e >= fires[0]]


class Openers:
    """[15]'s folder openers (unless ``labels_for`` is None) set on
    ``experiments/common.py``, and ``fit`` wrapped to record a CUDA event at
    each step's start, for a ``with`` block; the package's functions put
    back after it."""

    NAMES = ("build_base_train_dataset", "build_eval_dataset", "train_target_chunks", "fit")

    def __init__(self, labels_for):
        from passt_tpu_torch.experiments import common

        self.common, self.labels_for, self.starts = common, labels_for, []

    def __enter__(self):
        self.saved = {name: getattr(self.common, name) for name in self.NAMES}
        for name, fn in (folder_openers(self.labels_for) if self.labels_for else {}).items():
            setattr(self.common, name, fn)
        fit, starts = self.saved["fit"], self.starts

        def timed_fit(**kw):
            train_step = kw["train_step"]

            def run(s, batch, seed):
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                starts.append(ev)
                return train_step(s, batch, seed)

            return fit(**dict(kw, train_step=run))

        self.common.fit = timed_fit
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.common, name, fn)

    def steady_ms(self, per_epoch: int) -> tuple:
        """Mean ms between step starts, each epoch's first step and the
        run's first two left out; and the count of steps averaged."""
        gaps = [self.starts[i].elapsed_time(self.starts[i + 1]) for i in range(2, len(self.starts) - 1)
                if (i + 1) % per_epoch != 0]
        return sum(gaps) / len(gaps), len(gaps)


def counted(fn) -> tuple:
    """``fn()`` with its stdout captured and the launches it made (every
    count set to 0 just before): (result, stdout, launches, forward paths,
    backward paths, seconds)."""
    import contextlib
    import io

    from passt_tpu_torch.ops import _build
    from passt_tpu_torch.ops import attention as A

    buf = io.StringIO()
    _build.reset_launches()
    A.reset_path_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        out = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {name: _build.LAUNCHES.get(name, 0) for name in KERNEL_NAMES}
    return out, buf.getvalue(), launches, dict(A.FWD_PATH_LAUNCHES), dict(A.BWD_PATH_LAUNCHES), wall


def demo_run(gpu: str, dev: torch.device, have: dict, extra=(), tag: str = "[19]") -> tuple:
    """[19c] the full-size demo: where h5py loads, the tool's ``main``;
    where it does not, its items as wav files and the AudioSet recipe's
    ``main`` on the tool's config, with the three HDF5 openers of
    ``experiments/common.py`` replaced by FolderDatasets (:func:`folder_openers`).
    ``common.fit`` is wrapped to time each step (the wrapper calls the
    package's ``fit`` and step). Exact launches; the ap curve held to
    DEMO_MIN_AP and DEMO_MIN_GAIN. ``extra``: the tool's ``key=value``
    overrides (the multi-seed tool's arm, [20f]). Returns the launches,
    the line and the epochs' records."""
    import shutil
    import tempfile

    from passt_tpu_torch.experiments import EXPERIMENTS
    from passt_tpu_torch.tools import fullsize_train_demo as demo
    from passt_tpu_torch.train.swa import SWAState, swa_should_update

    tmp = tempfile.mkdtemp(prefix="chip_smoke_demo_")
    try:
        train_items, test_items = demo.make_items(10, 1), demo.make_items(3, 2)
        labels = None
        if have["h5py"]:
            how = "the tool's main (packed with pack_waveform_hdf5)"
            cfg = demo.config("train.h5", "test.h5", extra)
            run = lambda: demo.main(list(extra), device="cuda")  # noqa: E731
        else:
            t0 = time.perf_counter()
            labels = {"train": write_demo_items(os.path.join(tmp, "train"), train_items),
                      "test": write_demo_items(os.path.join(tmp, "test"), test_items)}
            how = (f"the AudioSet recipe's main on the tool's config, its items as 32 kHz wav files (written in "
                   f"{time.perf_counter() - t0:.1f} s; no h5py here: the three HDF5 openers replaced by FolderDatasets, "
                   f"so no gain augment)")
            cfg = demo.config(os.path.join(tmp, "train"), os.path.join(tmp, "test"), extra)
            run = lambda: EXPERIMENTS["audioset"].main(cfg, device="cuda")  # noqa: E731
        pcfg = cfg.passt_config()
        check((pcfg.embed_dim, pcfg.depth, pcfg.num_heads, pcfg.num_classes, cfg.model.dtype)
              == (768, 12, 12, 50, "bfloat16"), f"{tag} demo: not PaSST-S width in bf16: {pcfg}")
        n_train, n_eval = token_counts(cfg, pcfg)
        per_epoch = cfg.data.epoch_len // cfg.data.batch_size
        epochs = cfg.trainer.max_epochs
        steps = epochs * per_epoch
        probe = SWAState(avg_params=None, swa_epoch_start=cfg.trainer.swa_epoch_start, swa_freq=cfg.trainer.swa_freq)
        fires = [e for e in range(epochs) if swa_should_update(probe, e, epochs)]
        # swa_epoch_start counts from 1, as the reference's callback does: its
        # first average is taken at the start of that epoch, i.e. at the end
        # of 0-based epoch swa_epoch_start - 2
        check(fires and fires[0] == cfg.trainer.swa_epoch_start - 2, f"{tag} demo: SWA fires at {fires}")
        batches = -(-len(test_items) // cfg.data.eval_batch_size)
        evals = sum(1 + (e >= fires[0]) for e in range(epochs)) * batches
        with Openers(labels and (lambda cfg, path: labels[os.path.basename(path)])) as op:
            res, text, launches, paths, bwd, wall = counted(run)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    hist = res["history"]
    check(res["done"] and not res["interrupted"] and len(hist) == epochs and len(op.starts) == steps,
          f"{tag} demo: {len(hist)} epochs, {len(op.starts)} steps (want {epochs}, {steps})")
    want = want_launches(**add_counts({"fused_log_mel": steps + evals}, attn_counts(n_train, cfg.data.batch_size,
                                                                                     True, steps),
                                      attn_counts(n_eval, cfg.data.eval_batch_size, False, evals)))
    check(launches == want, f"{tag} demo launches {launches} != {want}")
    check(paths == dict(fma=0, mma=0, short=0, wgmma=12 * (steps + evals), simt=0)
          and bwd == dict(fma=0, mma=0, resident=0, wgmma=12 * steps, simt=0), f"{tag} demo paths {paths}, {bwd}")
    for e, rec in enumerate(hist):
        check(math.isfinite(rec["train_loss"]) and math.isfinite(rec["ap"]) and rec["n_eval"] == len(test_items),
              f"{tag} demo epoch {e}: {rec}")
        check(("swa_ap" in rec) == (e >= fires[0]) and rec.get("swa_n") == (fires.index(e) + 1 if e in fires else None),
              f"{tag} demo epoch {e}: swa_ap present: {'swa_ap' in rec}, swa_n {rec.get('swa_n')} (fires at {fires})")
    aps = [r["ap"] for r in hist]
    check(aps[-1] >= DEMO_MIN_AP and aps[-1] >= DEMO_MIN_GAIN * aps[0],
          f"{tag} demo did not learn: ap {aps[0]:.4f} -> {aps[-1]:.4f} (limits {DEMO_MIN_AP}, {DEMO_MIN_GAIN}x)")
    ms, n_ms = op.steady_ms(per_epoch)
    check("ap by epoch:" in text or not have["h5py"], f"{tag} demo: the tool's summary line missing")
    line = (f"{tag} full-size demo (tools/fullsize_train_demo: 50 tones, {len(train_items)} train / {len(test_items)} "
            f"test 1-s clips) through {how}: PaSST-S bf16, B={cfg.data.batch_size} N={n_train} train, "
            f"B={cfg.data.eval_batch_size} N={n_eval} eval, graphed; {epochs} epochs x {per_epoch} steps in "
            f"{wall:.1f} s; ap by epoch {', '.join(f'{a:.4f}' for a in aps)}; swa_ap {hist[-1]['swa_ap']:.4f} (SWA "
            f"averages at the end of 0-based epochs {fires}); losses {hist[0]['train_loss']:.5f} -> {hist[-1]['train_loss']:.5f}; fit "
            f"{ms:.3f} ms/step steady ({n_ms} steps; CUDA events between step starts, each epoch's first step "
            f"and the run's first two left out); launches { {k: v for k, v in launches.items() if v} } ({steps} "
            f"steps, {evals} eval batches) ({gpu})")
    return launches, line, hist


def phase_prep(gpu: str, dev: torch.device) -> tuple:
    """[19] offline prep and the full-size demo: the imports, the prep chain
    on the card's host, the demo on the card. Returns the demo's launches
    and its epochs' records."""
    t0 = time.perf_counter()
    have, line = prep_imports()
    say(line)
    say(prep_chain(gpu, have))
    launches, line, hist = demo_run(gpu, dev, have)
    say(line)
    say(f"[19] {time.perf_counter() - t0:.1f} s in all")
    return launches, hist


TOOLS_20 = ("convergence_demo", "finetune_rehearsal", "run_flagship_parity", "measure_mp3_loader",
            "loader_worker_sweep", "fit_throughput", "multiseed_quality")
# [20b], [20g] the convergence demo learns, in bf16 and at
# model.dtype=float32: its best raw accuracy at least 0.8 (chance 0.02; the
# script itself asks more than 0.9, printed beside it)
CONV_MIN_ACC, CONV_SCRIPT_ACC = 0.8, 0.9
REHEARSAL_K = 2  # [20c] the epoch after which the rehearsal's first phase is preempted (the tool's default)
PARITY_CLIPS = 20  # [20d] 10-s clips of 527-class targets, one eval batch
# [20e] fit_throughput's --steps and --epochs: the tool reads each epoch's
# rate on the host clock, which at 20 steps ended before the card did
# (1.08x the bench step's rate, measured on one H100); the steady ms/step between
# step starts by CUDA events is printed beside it
FIT_TP_STEPS, FIT_TP_EPOCHS = 40, 3
# [20c] the rehearsal's train and eval clips and epochs, cut from the tool's
# 240 / 100 and 8 to keep the whole script inside its time limit (4 epochs
# still preempt after epoch 2, resume and run SWA, which the ESC-50 recipe
# starts at epoch 2); 40 eval clips keep
# every accuracy a multiple of 0.025, exact in the 5 digits the epoch line
# prints, which the tool's 1e-6 reproduction check reads
REHEARSAL_CLIPS, REHEARSAL_EPOCHS = (60, 40), 4
REF_ARM = ("trainer.opt_moments_dtype=null", "model.gelu=erf")  # [20f] the multi-seed tool's "ref" arm
#: [20c] the rehearsal's CLI shim: [15]'s folder openers in place of the
#: HDF5 openers, the hold after the preempted phase's epoch line, then
#: ``cli.main``; its launch counts printed at the end
REHEARSAL_SHIM = """
import json, os, sys
sys.path.insert(0, {root!r})
import chip_smoke
from passt_tpu_torch import cli
from passt_tpu_torch.experiments import common
from passt_tpu_torch.ops import _build
from passt_tpu_torch.tools.finetune_rehearsal import hold_after_epoch

labels = json.load(open({labels!r}))
for name, fn in chip_smoke.folder_openers(lambda cfg, path: labels[os.path.basename(path)]).items():
    setattr(common, name, fn)
argv = sys.argv[1:]
if argv[1] == "main" and "trainer.resume=true" not in argv:
    hold_after_epoch({k})
try:
    cli.main(argv)
finally:
    print("launches " + json.dumps({{n: _build.LAUNCHES.get(n, 0) for n in chip_smoke.KERNEL_NAMES}}), flush=True)
"""


def tools_imports() -> tuple:
    """[20a] the seven tools import; which of h5py, libmp3lame and the native
    plane's libmpg123 load. Where all three do, the loader sweep runs on the
    host; a piece found that then fails fails the run."""
    import contextlib
    import importlib
    import importlib.util
    import io

    from passt_tpu_torch.data import native as N
    from passt_tpu_torch.data.prepare import mp3enc

    for tool in TOOLS_20:
        importlib.import_module(f"passt_tpu_torch.tools.{tool}")
    have = {"h5py": importlib.util.find_spec("h5py") is not None, "libmp3lame": mp3enc.available(),
            "libmpg123": N.mp3_available()}
    if have["h5py"]:
        import h5py  # noqa: F401  (a found h5py that does not import fails the run)
    line = (f"[20] tool imports: {', '.join(TOOLS_20)} import; "
            + ", ".join(f"{k} {'loads' if v else 'absent'}" for k, v in have.items()))
    if all(have.values()):
        from passt_tpu_torch.tools import loader_worker_sweep

        with contextlib.redirect_stdout(io.StringIO()):
            res = loader_worker_sweep.sweep(16, [1, 8], (True, False))
        check(all(r > 0 for per in res.values() for r in per.values()), f"[20] loader_worker_sweep: {res}")
        line += f"; loader_worker_sweep (16 clips a container, workers 1 and 8, the host): {res} clips/s"
    else:
        line += ("; measure_mp3_loader and loader_worker_sweep (mp3 containers) need all three: left to the CPU "
                 "tests here")
    return have, line


def conv_demo(gpu: str, dev: torch.device) -> tuple:
    """[20b] ``tools/convergence_demo``'s ``run`` on the card: its 50 tones
    (``make_split(20, 1)``, ``make_split(4, 2)``) as 32 kHz wav folders with
    [15]'s openers, the reduced PaSST (depth 4, dim 192, 6 heads: D = 32),
    bf16, graphed, 45 epochs; then [20g] the same run on the same folders at
    ``model.dtype=float32``, [20h] that at 2 heads (D = 96), and [20i] the
    bf16 run at 2 heads. Returns each run's launches and line."""
    import shutil
    import tempfile

    from passt_tpu_torch.tools import convergence_demo as cd

    tmp = tempfile.mkdtemp(prefix="chip_smoke_conv_")
    try:
        t0 = time.perf_counter()
        labels = {}
        for split, n_per, seed in (("train", 20, 1), ("test", 4, 2)):
            written = write_demo_items(os.path.join(tmp, split), cd.make_split(n_per, seed))
            labels[split] = {k: int(v) for k, v in written.items()}
        write_s = time.perf_counter() - t0
        data = (os.path.join(tmp, "train"), os.path.join(tmp, "test"))
        arms = []
        for dtype, heads in (("bfloat16", CONV_HEADS), ("float32", CONV_HEADS), ("float32", CONV_WIDE_HEADS),
                             ("bfloat16", CONV_WIDE_HEADS)):
            with demo_heads(heads):
                arms.append(conv_demo_arm(gpu, dev, data, labels, write_s, dtype, heads))
        return tuple(zip(*arms))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


@contextlib.contextmanager
def demo_heads(heads: int):
    """``tools/convergence_demo``'s reduced arch at ``heads`` heads for the
    block's length: its ``reduced_arch`` sets the registry from
    ``REDUCED``, which is put back after."""
    from passt_tpu_torch.tools import convergence_demo as cd

    reduced = cd.REDUCED
    cd.REDUCED = dict(reduced, num_heads=heads)
    try:
        yield
    finally:
        cd.REDUCED = reduced


def conv_demo_arm(gpu: str, dev: torch.device, data: tuple, labels: dict, write_s: float, dtype: str,
                  want_heads: int) -> tuple:
    """One run of the convergence demo on the wav folders ``data`` (file
    name -> class by split in ``labels``) with the reduced arch at
    ``want_heads`` heads (set by :func:`demo_heads` around the call): bf16
    ([20b]: every attention call on the D = 32 kernels of row 4o, the
    "wgmma" forward and the "resident" backward) or, with
    ``model.dtype=float32`` ([20g]), every call on the D = 32 instances of
    the "simt" kernels (row 4f), or that at 2 heads ([20h]: D = 96, the
    DP = 96 instances, row 4p), or the bf16 run at 2 heads ([20i]: D = 96,
    the "wgmma" kernels' DP = 128 instances, row 4m). Exact launches per
    path, none on "fma" or "mma"; the best accuracy held to CONV_MIN_ACC;
    fit's steady ms/step beside the same step on a resident batch."""
    from passt_tpu_torch import bench
    from passt_tpu_torch.experiments import EXPERIMENTS
    from passt_tpu_torch.ops import attention as A
    from passt_tpu_torch.tools import convergence_demo as cd

    tag = {("bfloat16", CONV_HEADS): "[20b]", ("float32", CONV_HEADS): "[20g]",
           ("float32", CONV_WIDE_HEADS): "[20h]", ("bfloat16", CONV_WIDE_HEADS): "[20i]"}[dtype, want_heads]
    extra = [] if dtype == "bfloat16" else ["model.dtype=float32"]
    tdt = getattr(torch, dtype)
    cfg = cd.config(*data, extra)
    with cd.reduced_arch():
        pcfg = cfg.passt_config()
    depth, heads, d = pcfg.depth, pcfg.num_heads, pcfg.embed_dim // pcfg.num_heads
    check((depth, pcfg.embed_dim, heads, cfg.model.dtype) == (4, 192, want_heads, dtype)
          and d * want_heads == 192, f"{tag} convergence demo: {pcfg}")
    n_train, n_eval = token_counts(cfg, pcfg)
    b, eb = cfg.data.batch_size, cfg.data.eval_batch_size
    check(((b, n_train), (eb, n_eval)) == CONV_SHAPES, f"{tag} convergence demo shapes {b, n_train, eb, n_eval}")
    if dtype == "bfloat16":
        fwd_path, bwd_path = "wgmma", "resident" if d == CONV_HEAD_DIM else "wgmma"
    else:
        fwd_path, bwd_path = "simt", "simt"
    check(A.forward_path(n_train, d, tdt, True) == A.forward_path(n_eval, d, tdt, True) == fwd_path
          and A.backward_path(n_train, d, tdt, True) == bwd_path,
          f"{tag} convergence demo: not on the {fwd_path} forward and the {bwd_path} backward")
    n_clips, n_test = len(labels["train"]), len(labels["test"])
    per_epoch, epochs = n_clips // b, cfg.trainer.max_epochs
    steps = per_epoch * epochs
    swa = swa_evals(cfg, epochs)
    evals = (epochs + len(swa)) * -(-n_test // eb)
    with Openers(lambda cfg, path: labels[os.path.basename(path)]) as op:
        hist, _, launches, paths, bwd, wall = counted(lambda: cd.run(extra, device="cuda", data=data))
    # the same graphed step on a resident batch after the run: what the loop and the loader add
    with cd.reduced_arch():
        _, state, step, _, _ = EXPERIMENTS["esc50"].build(cfg, steps_per_epoch=n_clips // b, device=dev)
    rng = np.random.default_rng(0)
    batch = {"wave": torch.from_numpy(rng.standard_normal((b, int(cfg.data.clip_length * 32000))).astype(np.float32))
             .to(dev), "target": torch.from_numpy(rng.integers(0, 50, b)).to(dev)}
    _, step_ms, _ = bench.timed_steps(step, state, batch, 200, 2)
    del state, step
    itemsize = tdt.itemsize
    counts = add_counts({"fused_log_mel": steps + evals},
                        attn_counts(n_train, b, True, steps, depth, heads, d, itemsize),
                        attn_counts(n_eval, eb, False, evals, depth, heads, d, itemsize))
    check(launches == want_launches(**counts), f"{tag} convergence demo launches {launches} != {counts}")
    want_fwd = dict.fromkeys(A.FWD_PATHS, 0)
    want_fwd[fwd_path] = depth * (steps + evals)
    want_bwd = dict.fromkeys(A.BWD_PATHS, 0)
    want_bwd[bwd_path] = depth * steps
    check(paths == want_fwd and bwd == want_bwd, f"{tag} convergence demo paths {paths}, {bwd}; want {want_fwd}, "
          f"{want_bwd}")
    check(len(hist) == epochs and len(op.starts) == steps, f"{tag} convergence demo: {len(hist)} epochs, "
          f"{len(op.starts)} steps")
    for e, rec in enumerate(hist):
        check(math.isfinite(rec["train_loss"]) and math.isfinite(rec["accuracy"]) and rec["n_eval"] == n_test,
              f"{tag} convergence demo epoch {e}: {rec}")
    accs = [r["accuracy"] for r in hist]
    swa_acc = hist[-1].get("swa_accuracy")
    check(max(accs) >= CONV_MIN_ACC, f"{tag} convergence demo did not learn: best accuracy {max(accs)}")
    check(swa_acc is not None and math.isfinite(swa_acc), f"{tag} convergence demo: no SWA accuracy")
    ms, n_ms = op.steady_ms(per_epoch)
    entries = ", ".join(f"{k} {v}" for k, v in counts.items())
    line = (f"{'[20]' if tag == '[20b]' else tag} convergence demo (tools/convergence_demo.run"
            + (f", extra {' '.join(extra)}" if extra else "")
            + f": 50 tones, {n_clips} train / {n_test} test 1-s clips as wav folders written in {write_s:.1f} s, "
            f"[15]'s openers): the ESC-50 recipe on PaSST depth {depth}, dim {pcfg.embed_dim}, {heads} heads "
            f"(D = {d}), {dtype}, graphed, B={b} N={n_train} train, B={eb} N={n_eval} eval; {epochs} epochs x "
            f"{per_epoch} steps in {wall:.1f} s; accuracy by epoch {', '.join(f'{a:.3f}' for a in accs)}; best "
            f"{max(accs):.3f} (limit {CONV_MIN_ACC}; the script's > {CONV_SCRIPT_ACC} "
            f"{'reached' if max(accs) > CONV_SCRIPT_ACC else 'not reached'}); swa_accuracy {swa_acc:.3f} (SWA "
            f"evaluated at {len(swa)} epochs); losses {hist[0]['train_loss']:.5f} -> {hist[-1]['train_loss']:.5f}; "
            f"fit {ms:.3f} ms/step steady ({n_ms} steps; CUDA events between step starts) against the same graphed "
            f"step on a resident batch {step_ms:.3f} (bench.timed_steps, 200 after 2; ratio {ms / step_ms:.2f}); "
            f"launches {entries} ({steps} steps x (mel, {depth} forward, {depth} backward) + {evals} eval batches x "
            f"(mel, {depth} forward)), every attention call on the D = {d} kernels: forward {fwd_path} "
            f"{paths[fwd_path]}, backward {bwd_path} {bwd[bwd_path]}, fma {paths['fma']} / {bwd['fma']}, mma "
            f"{paths['mma']} / {bwd['mma']} ({gpu})")
    return launches, line


def rehearsal_run(gpu: str) -> tuple:
    """[20c] ``tools/finetune_rehearsal``'s ``main`` at full PaSST-S width:
    its phases run the real CLI in child processes (the CLI prefix
    REHEARSAL_SHIM, since the card's machine has no h5py: its containers
    are wav folders of the tool's items, passed with --reuse). Every assert
    of the tool holds; each phase's launches are exact."""
    import contextlib
    import io
    import shutil
    import tempfile

    from passt_tpu_torch.experiments import EXPERIMENTS
    from passt_tpu_torch.tools import finetune_rehearsal as fr

    tmp = tempfile.mkdtemp(prefix="chip_smoke_rehearsal_")
    walls, run_phase = [], fr.run_phase

    def timed_phase(*a, **kw):
        t0 = time.perf_counter()
        out = run_phase(*a, **kw)
        walls.append(time.perf_counter() - t0)
        return out

    (n_train, n_eval), epochs = REHEARSAL_CLIPS, REHEARSAL_EPOCHS
    try:
        wd = os.path.join(tmp, "ft")
        labels = {}
        t0 = time.perf_counter()
        for name, n, seed in (("esc_train.h5", n_train, 0), ("esc_eval.h5", n_eval, 1)):
            written = write_demo_items(os.path.join(wd, name), list(fr.synth_items(n, seed=seed)))
            labels[name] = {k: int(v) for k, v in written.items()}
        write_s = time.perf_counter() - t0
        with open(os.path.join(tmp, "labels.json"), "w") as f:
            json.dump(labels, f)
        shim = REHEARSAL_SHIM.format(root=ROOT, labels=os.path.join(tmp, "labels.json"), k=REHEARSAL_K)
        fr.run_phase = timed_phase
        buf = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                rc = fr.main(["--workdir", wd, "--reuse", "--epochs", str(epochs), "--sigterm-after-epoch",
                              str(REHEARSAL_K), "--train-clips", str(n_train), "--eval-clips", str(n_eval)],
                             cli=[sys.executable, "-c", shim, "esc50"])
        finally:
            fr.run_phase = run_phase
        wall = time.perf_counter() - t0
        check(rc == 0 and "REHEARSAL OK" in buf.getvalue(), f"[20] rehearsal: rc {rc}\n{buf.getvalue()[-2000:]}")
        transcript = json.load(open(os.path.join(wd, "transcript.json")))
        logs = [open(os.path.join(wd, f"phase_{p}.log")).read() for p in "abc"]
        npz_mb = os.path.getsize(os.path.join(wd, "pretrained.npz")) / 1e6
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(transcript["preempted_after_epoch"] == transcript["resumed_from"] == REHEARSAL_K
          and [e["epoch"] for e in transcript["epochs"]] == list(range(epochs)) and transcript["swa_evaluated"],
          f"[20] rehearsal transcript {transcript}")
    cfg = EXPERIMENTS["esc50"].default_config
    pcfg = cfg.passt_config()
    check((pcfg.depth, pcfg.embed_dim, pcfg.num_heads) == (12, 768, 12), f"[20] rehearsal: {pcfg}")
    nt, ne = token_counts(cfg, pcfg)
    b, eb = cfg.data.batch_size, cfg.data.eval_batch_size
    per_epoch, batches = n_train // b, -(-n_eval // eb)
    swa = swa_evals(cfg, epochs)

    def phase_counts(first, last):
        steps = (last - first + 1) * per_epoch
        evals = sum(1 + (e in swa) for e in range(first, last + 1)) * batches
        return add_counts({"fused_log_mel": steps + evals}, attn_counts(nt, b, True, steps),
                          attn_counts(ne, eb, False, evals))

    best = transcript["best_epoch"]
    wants = [phase_counts(0, REHEARSAL_K), phase_counts(REHEARSAL_K + 1, epochs - 1),
             add_counts({"fused_log_mel": batches * (1 + (best in swa))},
                        attn_counts(ne, eb, False, batches * (1 + (best in swa))))]
    runs = []
    for p, log, want in zip("ABC", logs, wants):
        got = json.loads(re.findall(r"^launches (\{.*\})$", log, re.M)[-1])
        check(got == want_launches(**want), f"[20] rehearsal phase {p} launches {got} != {want}")
        runs.append(got)
    accs = ", ".join(f"{e['accuracy']:.2f}" for e in transcript["epochs"])
    line = (f"[20] fine-tune rehearsal (tools/finetune_rehearsal.main, the CLI in child processes: [15]'s openers over "
            f"{n_train} / {n_eval} 5-s clips as wav folders written in {write_s:.1f} s): PaSST-S 12 x 768 bf16, "
            f"B={b} N={nt} train, B={eb} N={ne} eval; a {npz_mb:.0f} MB pretrained npz loaded; {epochs} epochs, "
            f"SIGTERM after epoch {REHEARSAL_K} (the child held after that epoch's line until it landed), resumed "
            f"from epoch {transcript['resumed_from']}, the best (epoch {best}, accuracy "
            f"{transcript['evaluate_only_accuracy']:.2f}) restored by evaluate_only within 1e-6, SWA evaluated; "
            f"accuracy by epoch {accs}; phases A / B / C {' / '.join(f'{w:.1f}' for w in walls)} s, "
            f"{wall:.1f} s in all; launches exact in each phase (A {sum(runs[0].values())}, B "
            f"{sum(runs[1].values())}, C {sum(runs[2].values())}); transcript {json.dumps(transcript)} ({gpu})")
    return runs, line


def parity_run(gpu: str) -> tuple:
    """[20d] ``tools/run_flagship_parity``'s wiring on the card: a full-width
    PaSST-S ``.pt`` in the reference's layout (the port's state dict, random
    weights from seed 0) and PARITY_CLIPS 10-s wav clips of 527-class
    targets ([15]'s openers); ungated (``trainer.limit_eval_batches=1``:
    ``pass`` null, rc 0), then gated on its own value at tol 1e-6 from the
    ported ``.npz`` (rc 0, the port step skipped). Exact launches."""
    import shutil
    import tempfile

    from passt_tpu_torch.models import registry
    from passt_tpu_torch.tools import run_flagship_parity as rfp

    tmp = tempfile.mkdtemp(prefix="chip_smoke_parity_")
    try:
        clips = os.path.join(tmp, "eval")
        labels = write_clips(clips, PARITY_CLIPS, seed=31)
        model = registry.get_model(ARCH, pretrained=False, generator=torch.Generator().manual_seed(0), device="cpu")
        pt = os.path.join(tmp, "passt-s-seed0.pt")
        torch.save(model.state_dict(), pt)
        del model
        npz = os.path.join(tmp, "passt-s-seed0.ported.npz")
        want = want_launches(**add_counts({"fused_log_mel": 1}, attn_counts(1190, 20, False, 1)))
        with Openers(lambda cfg, path: labels):
            rc1, out1, l1, _, _, wall1 = counted(lambda: rfp.main([pt, clips, "trainer.limit_eval_batches=1"]))
            value = float(re.findall(r"(?<!swa_)'ap': ([0-9.e-]+)", out1)[-1])
            rc2, out2, l2, _, _, wall2 = counted(lambda: rfp.main([npz, clips, "--expect", repr(value), "--tol",
                                                                   "1e-6"]))
        npz_ok = os.path.exists(npz)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec1 = json.loads([x for x in out1.splitlines() if x.startswith('{"mode"')][-1])
    rec2 = json.loads([x for x in out2.splitlines() if x.startswith('{"mode"')][-1])
    check(rc1 == 0 and rec1["pass"] is None and rec1["gated"] is False and rec1["ported_npz"] == npz and npz_ok
          and f"ported {pt} -> {npz}" in out1, f"[20] parity ungated: rc {rc1}, {rec1}")
    check(rc2 == 0 and rec2["pass"] is True and rec2["ported_npz"] == npz and "ported " not in out2,
          f"[20] parity gated: rc {rc2}, {rec2}")
    for what, got in (("ungated", l1), ("gated", l2)):
        check(got == want, f"[20] parity {what} launches {got} != {want}")
    line = (f"[20] parity oracle (tools/run_flagship_parity.main): a full-width PaSST-S .pt (seed 0) ported to "
            f"{os.path.basename(npz)} and evaluated on {PARITY_CLIPS} 10-s clips ([15]'s openers): ungated (limit 1 "
            f"batch) rc {rc1}, pass {rec1['pass']}, ap {value:.6f}, {wall1:.1f} s; gated from the npz at --expect "
            f"that value, --tol 1e-6: rc {rc2}, pass {rec2['pass']}, delta {rec2['delta']}, {wall2:.1f} s; "
            f"launches exact in each ({ {k: v for k, v in l1.items() if v} }) ({gpu})")
    return [l1, l2], line


def fit_throughput_run(gpu: str) -> tuple:
    """[20e] ``tools/fit_throughput``'s ``main`` at full width, --steps
    FIT_TP_STEPS --epochs FIT_TP_EPOCHS, over wav folders of the tool's
    items (--reuse, [15]'s openers): its JSON line, sustained specs/s
    beside ``bench.timed_steps`` in the same process, and fit's steady
    ms/step between step starts by CUDA events. Exact launches."""
    import shutil
    import tempfile

    from passt_tpu_torch.experiments import EXPERIMENTS
    from passt_tpu_torch.tools import fit_throughput as ft

    cfg = EXPERIMENTS["audioset"].default_config
    b, eb = 12, cfg.data.eval_batch_size
    n = FIT_TP_STEPS * b
    tmp = tempfile.mkdtemp(prefix="chip_smoke_fit_tp_")
    try:
        wd = os.path.join(tmp, "fit")
        t0 = time.perf_counter()
        labels = {f"train_{n}.h5": write_demo_items(os.path.join(wd, f"train_{n}.h5"), list(ft.make_items(n))),
                  "eval_120.h5": write_demo_items(os.path.join(wd, "eval_120.h5"), list(ft.make_items(120)))}
        write_s = time.perf_counter() - t0
        with Openers(lambda cfg, path: labels[os.path.basename(path)]) as op:
            out, text, launches, _, _, wall = counted(lambda: ft.main(
                ["--steps", str(FIT_TP_STEPS), "--epochs", str(FIT_TP_EPOCHS), "--workdir", wd, "--reuse"],
                device="cuda"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    steps, evals, bench_steps = FIT_TP_STEPS * FIT_TP_EPOCHS, FIT_TP_EPOCHS * 2, 102
    check(not swa_evals(cfg, FIT_TP_EPOCHS), "[20] fit_throughput: SWA in the run")
    want = add_counts({"fused_log_mel": steps + evals + bench_steps}, attn_counts(TRAIN_N, b, True, steps),
                      attn_counts(1190, eb, False, evals), attn_counts(TRAIN_N, b, True, bench_steps))
    check(launches == want_launches(**want), f"[20] fit_throughput launches {launches} != {want}")
    ms, n_ms = op.steady_ms(FIT_TP_STEPS)
    line_json = text.strip().splitlines()[-1]
    check(json.loads(line_json) == json.loads(json.dumps(out)) and len(out["epoch_it_per_s"]) == FIT_TP_EPOCHS
          and out["value"] > 0 and out["bench_ms_per_step"] > 0 and math.isfinite(out["vs_in_graph_bench"]),
          f"[20] fit_throughput: {line_json}")
    line = (f"[20] fit_throughput (tools/fit_throughput.main --steps {FIT_TP_STEPS} --epochs {FIT_TP_EPOCHS}: audioset "
            f"main at full width, bf16, B={b} N={TRAIN_N}, {n} + 120 10-s clips as wav folders written in "
            f"{write_s:.1f} s, [15]'s openers; checkpoints on): sustained {out['value']:.2f} specs/s "
            f"({b * 1000.0 / out['value']:.3f} ms/step; epochs' it/s {out['epoch_it_per_s']}) beside bench.timed_steps "
            f"{out['bench_specs_per_s']:.2f} specs/s ({out['bench_ms_per_step']:.3f} ms/step, 100 after 2, same "
            f"process, after the run): vs_in_graph_bench {out['vs_in_graph_bench']} (each epoch's rate on the host clock); "
            f"fit {ms:.3f} ms/step steady by CUDA events between step starts ({n_ms} steps; ratio to the bench step "
            f"{ms / out['bench_ms_per_step']:.3f}); {wall:.1f} s; launches exact "
            f"({steps} steps, {evals} eval batches, {bench_steps} bench steps) ({gpu})")
    return launches, line + "\n[20] fit_throughput JSON: " + line_json


def phase_tools(gpu: str, dev: torch.device, prod_hist: list) -> list:
    """[20] the last seven tools: imports, the convergence demo, the
    fine-tune rehearsal, the parity oracle, fit_throughput, and the
    multi-seed tool's "ref" arm at seed 0 beside [19]'s production arm
    (``prod_hist``). Returns the main-path runs' launches."""
    t0 = time.perf_counter()
    have, line = tools_imports()
    say(line)
    runs = []
    launches, lines = conv_demo(gpu, dev)
    runs += launches
    for line in lines:
        say(line)
    more, line = rehearsal_run(gpu)
    runs += more
    say(line)
    more, line = parity_run(gpu)
    runs += more
    say(line)
    launches, line = fit_throughput_run(gpu)
    runs.append(launches)
    say(line)
    launches, line, ref_hist = demo_run(gpu, dev, have, extra=REF_ARM, tag="[20f]")
    runs.append(launches)
    say(line)
    prod, ref = [r["ap"] for r in prod_hist], [r["ap"] for r in ref_hist]
    check(ref[-1] >= DEMO_MIN_AP, f"[20f] the ref arm's last ap {ref[-1]:.4f} < {DEMO_MIN_AP}")
    say(f"[20f] multi-seed arms at seed 0 (tools/multiseed_quality's runs through [19]'s route): prod ap "
        f"{', '.join(f'{a:.4f}' for a in prod)}, swa_ap {prod_hist[-1]['swa_ap']:.4f}; ref ({' '.join(REF_ARM)}) ap "
        f"{', '.join(f'{a:.4f}' for a in ref)}, swa_ap {ref_hist[-1]['swa_ap']:.4f}; ref - prod: last ap "
        f"{ref[-1] - prod[-1]:+.4f}, swa_ap {ref_hist[-1]['swa_ap'] - prod_hist[-1]['swa_ap']:+.4f} (not gated) "
        f"({gpu})")
    say(f"[20] {time.perf_counter() - t0:.1f} s in all")
    return runs


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 1
    from passt_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gpu = gpu_line()
    say(f"[1] device {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
        f"nvidia-smi: {gpu}; torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    logs = _build.build()
    seconds = time.perf_counter() - t0
    say(f"[2] built {', '.join(_build.KERNELS)} in {seconds:.1f} s: "
        + "; ".join(f"{k}: {ptxas_summary(v)}" for k, v in logs.items()))
    if logs["attention_fwd"] != "(cached)":
        from passt_tpu_torch.tools.variants import registers

        paths = {"wgmma DP=64": ("wgmma_kernel", "Li64E"), "wgmma DP=32": ("wgmma_kernel", "Li32E"),
                 "wgmma DP=128": ("wgmma_kernel", "Li128E"), "short": ("short_kernel",), "mma": ("fwd_mma_kernel",),
                 "fma": ("attention_fwd_kernel",)}
        say("[2] attention_fwd registers, spill stores (B) per path: " + "; ".join(
            f"{p} {registers(logs['attention_fwd'], *frags)}" for p, frags in paths.items())
            + "; ptxas serializes wgmma (C7512) in: " + (", ".join(
                p for p, frags in paths.items() if any(
                    all(f in ln for f in frags) for ln in logs["attention_fwd"].splitlines() if "C7512" in ln))
                or "none"))
    if logs["attention_fwd_fp32"] != "(cached)":
        from passt_tpu_torch.ops.attention import SIMT_HEAD_DIMS, simt_forward_blocks_per_sm
        from passt_tpu_torch.tools.variants import registers

        say("[2] attention_fwd_fp32 registers, spill stores (B) per instance (the simt forward, by dtype, padded "
            "head dim DP and full rows, i.e. fp32 at D = DP with aligned operands, or not): " + "; ".join(
                f"{str(dt)[6:]} DP={d}{' full' if full else ''} "
                f"{registers(logs['attention_fwd_fp32'], f'attn32_fwd_kernel{m}Li{d}ELb{int(full)}E')}, "
                f"{simt_forward_blocks_per_sm(d, dt, full)} blocks an SM" for dt, m, full in SIMT_INSTANCES
                for d in SIMT_HEAD_DIMS))
    if logs["attention_bwd"] != "(cached)":
        from passt_tpu_torch.tools.variants import registers

        kernels = {"resident": ("resident_kernel",), "mma A": ("dq_mma_kernel",), "mma B": ("dkv_mma_kernel",),
                   "fma A": ("attention_bwd_dq_kernel",), "fma B": ("attention_bwd_dkv_kernel",)}
        kernels.update({f"wgmma {k} DP={dp}": (frag, f"Li{dp}E") for dp in (32, 64, 128)
                        for k, frag in (("S", "stats_kernel"), ("KV", "kv_kernel"))})
        say("[2] attention_bwd registers, spill stores (B) per kernel: " + "; ".join(
            f"{p} {registers(logs['attention_bwd'], *frags)}" for p, frags in kernels.items()))
    if logs["attention_bwd_fp32"] != "(cached)":
        from passt_tpu_torch.ops.attention import SIMT_HEAD_DIMS, simt_backward_blocks_per_sm
        from passt_tpu_torch.tools.variants import registers

        log = logs["attention_bwd_fp32"]
        say("[2] attention_bwd_fp32 registers, spill stores (B) per instance (the simt backward, by dtype, padded "
            "head dim DP and full rows or not): " + "; ".join(
                f"{str(dt)[6:]} DP={d}{' full' if full else ''}: S "
                f"{registers(log, f'bwd32_stats_kernel{m}Li{d}ELb{int(full)}E')}, KV "
                f"{registers(log, f'bwd32_kv_kernel{m}Li{d}ELb{int(full)}E')}, blocks an SM (S, KV) "
                f"{simt_backward_blocks_per_sm(d, dt, full)}" for dt, m, full in SIMT_INSTANCES
                for d in SIMT_HEAD_DIMS))
    if logs["int8_gemm"] != "(cached)":
        from passt_tpu_torch.tools.variants import registers

        say("[2] int8_gemm registers, spill stores (B) per tile (all epilogues; ptxas counts the 168 of the "
            "launch, setmaxnreg gives the consumers 232): " + "; ".join(
                f"{bn} {registers(logs['int8_gemm'], f'Li{bn}ELi')}" for bn in (128, 192, 256)))

    marks, last = [("[2]", seconds)], [time.perf_counter()]

    def mark(label: str) -> None:
        """Record the seconds since the last mark under ``label``."""
        now = time.perf_counter()
        marks.append((label, now - last[0]))
        last[0] = now

    rec = phase_kernels(gpu, dev)
    mark("[3]")
    rec.update(phase_backward(gpu, dev))
    mark("[3b]")
    for name, err in simt_sweep(gpu, dev).items():
        rec[name]["simt_sweep_max_err"] = err
    rec["fused_attention_qkv"]["simt_timed"], rec["fused_attention_qkv_bwd"]["simt_timed"] = simt_timings(gpu, dev)
    mark("simt")
    rec.update(phase_layernorm(gpu, dev))
    rec.update(phase_int8(gpu, dev))
    rec.update(phase_fused_mlp(gpu, dev))
    mark("[3c]-[3e]")
    runs = [phase_serving(gpu, dev)]
    phase_correctness(dev)
    mark("[4]-[5]")
    runs.append(train_steps(gpu, dev, "default"))
    mark("[6]")
    phase_adamw_sr(gpu, dev)
    mark("[6o]")
    runs.append(wide_heads_step(gpu, dev))
    mark("[6w]")
    runs.append(phase_train_correctness(dev))
    runs += [train_steps(gpu, dev, variant) for variant in ("fuse_ln_qkv", "ln_impl=fused")]
    runs += phase_variant_correctness(dev)
    mark("[7]-[9]")
    runs += [phase_int8_mlp(gpu, dev), phase_int8_micro(gpu, dev), phase_proto_mlp(gpu, dev)]
    mark("[10]-[12]")
    runs.append(phase_fit(gpu, dev))
    mark("[13]")
    runs += phase_graphs(gpu, dev)
    mark("[14]")
    runs.append(phase_cli(gpu, dev))
    mark("[15]-[16]")
    runs += phase_export(gpu, dev)
    mark("[17]")
    blocks_runs, rec["fused_attention"]["fp32_simt"] = phase_blocks(gpu, dev)
    runs += blocks_runs
    mark("[18]")
    prep_launches, demo_hist = phase_prep(gpu, dev)
    runs.append(prep_launches)
    mark("[19]")
    runs += phase_tools(gpu, dev, demo_hist)
    mark("[20]")
    launches = {name: sum(run.get(name, 0) for run in runs) for name in rec}

    sources = {
        "fused_log_mel": ("passt_tpu_torch/csrc/mel_kernel.cu", "passt_tpu/ops/pallas/mel_kernel.py:65"),
        "fused_attention": ("passt_tpu_torch/csrc/attention_fwd.cu", "passt_tpu/ops/pallas/attention.py:171"),
        "fused_attention_qkv": ("passt_tpu_torch/csrc/attention_fwd.cu",
                                "passt_tpu/ops/pallas/attention.py:373, scripts/proto_attn_qkv.py:63"),
        # the [B, N, H, D] entry's backward runs on the main paths in fp32 only ([7], [9]: "simt")
        "fused_attention_bwd": ("passt_tpu_torch/csrc/attention_bwd_fp32.cu", "passt_tpu/ops/pallas/attention.py:188"),
        "fused_attention_qkv_bwd": ("passt_tpu_torch/csrc/attention_bwd.cu",
                                    "passt_tpu/ops/pallas/attention.py:388, scripts/proto_attn_qkv.py:78"),
        "layer_norm_bwd": ("passt_tpu_torch/csrc/layernorm_bwd.cu", "passt_tpu/ops/pallas/layernorm.py:58"),
        "ln_qkv_f1": ("passt_tpu_torch/csrc/ln_qkv.cu", "passt_tpu/ops/pallas/ln_qkv.py:120"),
        "ln_qkv_b2": ("passt_tpu_torch/csrc/ln_qkv.cu", "passt_tpu/ops/pallas/ln_qkv.py:144"),
        "int8_dense": ("passt_tpu_torch/csrc/int8_gemm.cu", "passt_tpu/ops/pallas/int8_dense.py:68"),
        "int8_dense_gelu": ("passt_tpu_torch/csrc/int8_gemm.cu", "passt_tpu/ops/pallas/int8_dense.py:74"),
        "int8_matmul": ("passt_tpu_torch/csrc/int8_gemm.cu", "scripts/int8_matmul_micro.py:71"),
        "fused_mlp_fwd": ("passt_tpu_torch/csrc/fused_mlp.cu", "scripts/proto_mlp_fused.py:78"),
        "fused_mlp_bwd": ("passt_tpu_torch/csrc/fused_mlp.cu", "scripts/proto_mlp_fused.py:92"),
    }
    check(set(sources) == set(KERNEL_NAMES) == set(rec), "every kernel has a source and a record")
    for name in sources:
        check(launches[name] > 0, f"{name} was launched no time on the main paths")
    # the paths each attention entry takes, by source: its record times the first
    fwd_sources = {"simt": "passt_tpu_torch/csrc/attention_fwd_fp32.cu",
                   "wgmma, short": "passt_tpu_torch/csrc/attention_fwd.cu"}
    paths = {"fused_attention": fwd_sources, "fused_attention_qkv": fwd_sources,
             "fused_attention_bwd": {"simt": "passt_tpu_torch/csrc/attention_bwd_fp32.cu",
                                     "wgmma, resident": "passt_tpu_torch/csrc/attention_bwd.cu"},
             "fused_attention_qkv_bwd": {"wgmma, resident": "passt_tpu_torch/csrc/attention_bwd.cu",
                                         "simt": "passt_tpu_torch/csrc/attention_bwd_fp32.cu"}}
    for name, by_path in paths.items():
        rec[name]["sources_by_path"] = by_path
    kernels = [
        dict(name=name, route="cuda", source=src, replaces=rep, launches=launches[name], **rec[name])
        for name, (src, rep) in sources.items()
    ]
    say(f"[seconds] the whole script {time.perf_counter() - T0:.1f} s; by phase: "
        + ", ".join(f"{label} {t:.1f}" for label, t in marks))
    say(gpu)
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
