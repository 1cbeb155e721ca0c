"""One rank of a gloo run of the training cell data-parallel over
``world`` processes at a tiny size on the CPU, with a fault planted or
not:

    python benchmark/tests/_ddp_worker.py <fault|none> <rank> <world> <port> <out.json>
"""

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from benchmark.lib import harness  # noqa: E402
from benchmark.tests._tiny import tiny_cell  # noqa: E402


def main(fault: str, rank: int, world: int, port: int, out: str) -> None:
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=world)
    control = dist.new_group(backend="gloo")
    if fault == "no_exchange":
        from passt_tpu_torch.parallel import mesh

        mesh.DataParallel.all_reduce_mean = lambda self, tensors, scalars=(): (dict(tensors), list(scalars))
    env = harness.Env(seed=2 ** 31 + 21, seconds=0.5, trace=False, device=torch.device("cpu"),
                      t_start=time.time(), rank=rank, world=world, control=control)
    cell = tiny_cell("passt_s.train.b12")
    cell.workload["chips"] = world
    line = harness.run_rank(cell, env)
    if rank == 0:
        Path(out).write_text(json.dumps(line))
    dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5])
