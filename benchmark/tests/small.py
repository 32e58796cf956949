"""Cells at a size a CPU test run holds, and their runs on the CPU.

`SmallBench` is the benchmark as BENCHMARK.json defines it, with each
configuration's matrix cut to a few thousand rows and each traffic mix
to small rings and short traced stretches; the entries, the checks and
their limits are the real ones.  `run` drives one cell on the CPU (the
program's plain torch paths), `run_ranks` a cell on several gloo ranks,
one process each.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os

import torch

from harness import core

SMALL_MATRIX = {
    "fem_shell_like": {"nx": 24, "ny": 10, "dof": 6, "n_target": 1439},
    "webbase_like": {"n": 4000, "local_scale": 80.0},
}
SMALL_TRAFFIC = {"ring_bytes": 0, "sync_every": 4, "trace_after": 1,
                 "traced_chunks": 2, "traced_solves": 2, "warm_solves": 1}


class SmallBench(core.Bench):
    def config(self, name):
        cfg = super().config(name)
        spec = cfg["matrix"]
        spec["params"].update(SMALL_MATRIX[spec["generator"]])
        return cfg

    def traffic(self, name):
        tr = super().traffic(name)
        tr.update({k: v for k, v in SMALL_TRAFFIC.items() if k in tr})
        return tr


def run(cell, seed=7, seconds=0.3, trace=False, program=None):
    torch.manual_seed(0)
    return core.run_cell(SmallBench(), cell, seed, seconds, trace,
                         torch.device("cpu"), program=program)


BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _rank(rank, world, port, cell, seed, seconds, trace, program, queue):
    torch.set_num_threads(1)
    if callable(program):
        program = program()
    res = core.run_cell(SmallBench(), cell, seed, seconds, trace,
                        torch.device("cpu"), rank, world, port,
                        program=program)
    if rank == 0:
        queue.put(res)


def run_ranks(cell, world=4, seed=7, seconds=0.3, trace=False,
              program=None, timeout=240):
    """Rank 0's result of the cell on `world` gloo ranks; `program` is a
    picklable factory of each rank's program (None: the real one)."""
    import torch.distributed as dist
    store = dist.TCPStore("127.0.0.1", 0, world + 1, True,
                          datetime.timedelta(seconds=120),
                          wait_for_workers=False)
    mp = multiprocessing.get_context("spawn")
    queue = mp.Queue()
    procs = [mp.Process(target=_rank, args=(r, world, store.port, cell, seed,
                                            seconds, trace, program, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        res = queue.get(timeout=timeout)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return res
