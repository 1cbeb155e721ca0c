"""Run one cell of the port's benchmark on the card(s) of this machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as its last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared with the plain
reference beside its limit (also the last lines of standard error).
Without enough CUDA cards, or when a module of JAX or of the JAX package is
loaded, it prints no result and exits with a code other than 0. A cell on
several cards starts one process a card (``--rank`` is for those).
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# Python's bytecode cache at a fixed path inside the checkout, written even
# where the environment forbids it (PYTHONDONTWRITEBYTECODE): without it
# every run compiles torch's modules (and sympy's, under torch._dynamo)
# from source again, most of a run's set-up
sys.pycache_prefix = str(Path(__file__).resolve().parent.parent / "build" / "pycache")
sys.dont_write_bytecode = False
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from benchmark.lib import harness  # noqa: E402

T_HARNESS = time.time()

#: a run's own limit, inside the 360 s a run is given
RUN_TIMEOUT_S = 345.0


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--rank", action="store_true", help="run as one rank of a multi-card cell")
    return p.parse_args(argv)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = parse(argv)
    os.environ.update(harness.cache_env())
    cell = harness.load_cell(args.workload)

    import torch

    t_torch = time.time()
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{cell.name} needs {cell.chips} CUDA card(s); found {found}", file=sys.stderr)
        return 2
    if cell.chips > 1 and not args.rank:
        code, line = harness.spawn_ranks([str(Path(__file__).resolve())] + argv + ["--rank"], cell.chips,
                                         T_START, RUN_TIMEOUT_S)
        bad = harness.forbidden_modules()
        if bad:
            print(f"loaded: {', '.join(bad)}", file=sys.stderr)
            return 3
        if code != 0 or line is None:
            print(f"a rank failed (exit code {code})", file=sys.stderr)
            return code or 1
        harness.print_checks_line(json.loads(line))  # after every rank's own output
        print(line)
        return 0
    world = cell.chips
    rank = int(os.environ.get("RANK", "0")) if args.rank else 0
    t_start = float(os.environ.get("BENCH_T_START", T_START)) if args.rank else T_START
    env = harness.Env(seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                      device=torch.device("cuda", rank), t_start=t_start, rank=rank, world=world)
    torch.cuda.set_device(env.device)
    torch.zeros(1, device=env.device)  # the card's context, a phase of its own
    env.marks += [("python_and_harness", T_HARNESS), ("import_torch", t_torch), ("card_context", time.time())]
    if world > 1:
        import torch.distributed as dist

        dist.init_process_group("nccl", rank=rank, world_size=world, device_id=env.device)
        env.control = dist.new_group(backend="gloo")
    try:
        line = harness.run_rank(cell, env)
    finally:
        if world > 1:
            import torch.distributed as dist

            dist.destroy_process_group()
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    if line is not None:
        harness.print_checks_line(line)
        print(json.dumps(line))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
