"""Device timing on the card, shared by ``chip_smoke.py`` and the tools."""

from __future__ import annotations

import subprocess

import torch

from passt_tpu_torch.graphs import no_collection


def gpu_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA
    events), after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20) -> float:
    """Mean device time of ``fn`` over ``reps`` calls captured in one CUDA
    graph and replayed: the host's dispatch time drops out, which matters
    for calls shorter than their own launch overhead."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with no_collection(), torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_times(fn, reps: int = 10) -> dict:
    """Device time per call of each CUDA kernel ``fn`` launches (ms, by
    kernel name), from a ``torch.profiler`` trace of ``reps`` calls after
    one warm-up call (a trace that comes back with no device events is
    taken again, up to eight times: three in a row came back empty once,
    at a 0.008-ms SDPA call)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(8):  # a trace now and then comes back without its device events: take another
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        times = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                times[e.name] = times.get(e.name, 0.0) + e.time_range.elapsed_us() / 1000.0 / reps
        if times:
            break
    return times


def kernel_ms(fn, reps: int = 10) -> float:
    """The summed device time of the CUDA kernels ``fn`` launches, per call
    (:func:`kernel_times`): the gaps between kernels drop out. For calls
    that a CUDA graph cannot capture: the autograd backward of a forward run
    outside the capture, whose ops run on the forward's stream (a backward
    is captured only together with its forward, as the train step is), and
    SDPA's forward and backward in chip_smoke's phase 3b, whose capture
    fails there with ``cudaErrorStreamCaptureImplicit``."""
    return sum(kernel_times(fn, reps).values())
