"""One run of one cell: find its pieces by name, drive its entry, print
the result line.

A cell (`workloads` in BENCHMARK.json) names a configuration and a
traffic mix.  Everything it needs is found by name:

* the configuration: the file its `configs` entry names;
* the traffic mix: `benchmark/traffic/<traffic>.json`, whose `entry`
  names the general driver in `benchmark/entries/<entry>.py`;
* the limits its check holds outputs to: `benchmark/limits/<cell>.json`;
* each per-layer metric's reader: `benchmark/metrics/<metric>.py`.

An entry's `run(ctx)` builds the inputs from the seed, builds the plan,
warms up, calls `ctx.begin_window()`, drives the window, calls
`ctx.end_window()` (memory peak read, the ranks' numbers gathered, the
process group closed), then checks what the window produced against the
reference (`ctx.check`) and returns its end-to-end numbers.
"""

from __future__ import annotations

import contextlib
import datetime
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch

from . import reference
from .trace import Tracer, top

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
RUN_PY = os.path.join(BENCH_DIR, "run.py")
FORBIDDEN = ("jax", "jaxlib", "flax", "sblas_tpu")
DTYPES = {"float32": (torch.float32, np.float32),
          "float64": (torch.float64, np.float64)}


def load_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is jax, jaxlib, flax or the
    JAX package (whole names: `sblas_tpu_torch` is not `sblas_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Bench:
    """BENCHMARK.json and the files it names."""

    def __init__(self, root: str = ROOT):
        self.root = root
        self.dir = os.path.join(root, "benchmark")
        self.spec = load_json(os.path.join(root, "BENCHMARK.json"))

    def _named(self, key: str, name: str) -> dict:
        for item in self.spec[key]:
            if item["name"] == name:
                return item
        raise KeyError(f"no {key} entry named {name!r}")

    def workload(self, name: str) -> dict:
        return self._named("workloads", name)

    def config(self, name: str) -> dict:
        return load_json(os.path.join(self.root,
                                      self._named("configs", name)["file"]))

    def traffic(self, name: str) -> dict:
        return load_json(os.path.join(self.dir, "traffic", name + ".json"))

    def limits(self, cell: str) -> dict:
        return load_json(os.path.join(self.dir, "limits", cell + ".json"))

    def entry(self, name: str):
        return load_module(os.path.join(self.dir, "entries", name + ".py"),
                           "bench_entry_" + name)

    def reader(self, metric: str):
        return load_module(os.path.join(self.dir, "metrics", metric + ".py"),
                           "bench_metric_" + metric.replace(".", "_"))

    def end_to_end(self, cell: str) -> list:
        return [m for m in self.spec["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell: str) -> list:
        e2e = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.spec["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in e2e)]


def say(*parts) -> None:
    print("[bench]", *parts, file=sys.stderr, flush=True)


class Ctx:
    """What an entry sees of a run (module docstring)."""

    def __init__(self, bench: Bench, cell: str, seed: int, seconds: float,
                 trace: bool, device: torch.device, rank: int = 0,
                 world: int = 1, program=None, t0: Optional[float] = None):
        self.bench, self.cell = bench, cell
        self.workload = bench.workload(cell)
        self.config = bench.config(self.workload["config"])
        self.traffic = bench.traffic(self.workload["traffic"])
        self.limits = bench.limits(cell)["checks"]
        self.seed, self.seconds = int(seed), float(seconds)
        self.device, self.rank, self.world = device, rank, world
        self.dtype, self.np_dtype = DTYPES[self.config["dtype"]]
        if program is None:
            from .program import Program
            program = Program()
        self.program = program
        self.tracer = Tracer(trace, device)
        self.t0 = time.perf_counter() if t0 is None else t0
        self.facts: dict = {}
        self.checks: dict = {}
        self.setup_s: Optional[float] = None
        self.memory_peak = 0
        self.ranks: Optional[np.ndarray] = None

    # -- inputs -------------------------------------------------------
    def pattern(self):
        """((row_ptr, col_idx), shape) of the configuration's matrix."""
        return reference.pattern(self.config["matrix"])

    def matrix(self) -> reference.Csr:
        """The configuration's matrix with values drawn from the seed."""
        (row_ptr, col_idx), shape = self.pattern()
        vals = reference.draw_values(len(col_idx), self.seed, self.np_dtype)
        return reference.Csr(row_ptr, col_idx, vals, shape)

    def generator(self, stream: int) -> torch.Generator:
        """A generator on the device for the seed's stream `stream`."""
        g = torch.Generator(device=self.device)
        g.manual_seed((self.seed * 1_000_003 + stream) % (1 << 63))
        return g

    # -- records ------------------------------------------------------
    def note(self, key: str, value) -> None:
        """A fact for the earlier lines of stderr and the readers."""
        self.facts[key] = value
        if self.rank == 0:
            say(f"t={time.perf_counter() - self.t0:.3f}s {key}: {value}")

    @contextlib.contextmanager
    def timed(self, key: str):
        """Host-clock seconds of a block, kept as fact `key`."""
        t = time.perf_counter()
        yield
        self.note(key, time.perf_counter() - t)

    def check(self, name: str, value: float) -> None:
        """A number compared with its limit (`limits/<cell>.json`)."""
        self.checks[name] = (float(value), float(self.limits[name]))

    # -- the window ---------------------------------------------------
    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def barrier(self) -> None:
        if self.world > 1:
            import torch.distributed as dist
            dist.barrier()

    def begin_window(self) -> None:
        """Set-up ends here: every rank ready, the device idle."""
        self.sync()
        self.barrier()
        self.setup_s = time.perf_counter() - self.t0
        self.note("setup_s", self.setup_s)

    def agree(self, go: bool) -> bool:
        """Whether every rank goes on (one flag, as a solver reads one)."""
        if self.world == 1:
            return go
        import torch.distributed as dist
        flag = torch.tensor([int(go)], dtype=torch.int32, device=self.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)
        return bool(flag.item())

    def end_window(self) -> None:
        """The memory peak read, every rank's numbers gathered on every
        rank (rows: memory peak, busy_s, window_s), the group closed."""
        self.sync()
        if self.device.type == "cuda":
            self.memory_peak = torch.cuda.max_memory_allocated(self.device)
        s = self.tracer.summary or {}
        mine = [float(self.memory_peak), s.get("busy_s", 0.0),
                s.get("window_s", 0.0)]
        if self.world == 1:
            self.ranks = np.array([mine])
            return
        import torch.distributed as dist
        t = torch.tensor(mine, dtype=torch.float64, device=self.device)
        out = [torch.zeros_like(t) for _ in range(self.world)]
        dist.all_gather(out, t)
        self.ranks = np.array([o.cpu().numpy() for o in out])
        dist.barrier()
        dist.destroy_process_group()


def card() -> dict:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        out = []
    return {"nvidia_smi": out[0] if out else "unavailable"}


def run_cell(bench: Bench, cell: str, seed: int, seconds: float,
             trace: bool, device: torch.device, rank: int = 0,
             world: int = 1, store_port: Optional[int] = None,
             program=None, t0: Optional[float] = None,
             on_store=None) -> Optional[dict]:
    """Run one rank of the cell; rank 0 returns the result (module
    docstring), other ranks None.  A world above 1 joins (rank 0: makes)
    a TCP store on `store_port` (0: the OS picks; `on_store(port)` is
    told it, to start the other ranks)."""
    if world > 1:
        import torch.distributed as dist
        # rank 0 of a run makes the store; given a port, every rank joins
        store = dist.TCPStore("127.0.0.1", store_port or 0, world,
                              rank == 0 and store_port is None,
                              datetime.timedelta(seconds=300),
                              wait_for_workers=False)
        if rank == 0 and on_store is not None:
            on_store(store.port)
        kw = dict(backend="nccl" if device.type == "cuda" else "gloo",
                  store=store, rank=rank, world_size=world)
        if device.type == "cuda":
            kw["device_id"] = device
        dist.init_process_group(**kw)
    ctx = Ctx(bench, cell, seed, seconds, trace, device, rank, world,
              program, t0)
    if rank == 0 and device.type == "cuda":
        ctx.note("card", card()["nvidia_smi"])
    outcome = bench.entry(ctx.traffic["entry"]).run(ctx)
    if rank != 0:
        return None
    return result(bench, ctx, outcome, trace)


def _finite(x) -> bool:
    return isinstance(x, (int, float)) and math.isfinite(x)


def result(bench: Bench, ctx: Ctx, outcome: dict, trace: bool) -> dict:
    """The result line's object (the contract's keys, `checks` last)."""
    checks_ok = all(_finite(v) and v <= lim for v, lim in ctx.checks.values())
    correct = bool(ctx.checks) and checks_ok and outcome["failed"] == 0
    metrics = {}
    if trace:
        facts = dict(ctx.facts, trace=ctx.tracer.summary, ctx=ctx)
        for m in bench.per_layer(ctx.cell):
            v = bench.reader(m["name"]).read(facts)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        vals = dict(outcome["metrics"], setup_s=ctx.setup_s)
        for m in bench.end_to_end(ctx.cell):
            metrics[m["name"]] = {"value": vals[m["name"]], "unit": m["unit"]}
    kind = (torch.cuda.get_device_name(ctx.device)
            if ctx.device.type == "cuda" else "cpu")
    device = {"platform": "gpu" if ctx.device.type == "cuda" else "cpu",
              "kind": kind, "count": ctx.world,
              "memory_peak_bytes": int(ctx.ranks[:, 0].max())}
    out = {"correct": correct, "attempted": outcome["attempted"],
           "failed": outcome["failed"], "metrics": metrics,
           "device": device}
    s = ctx.tracer.summary
    if trace and s is not None:
        say(f"traced stretch: {s['device_events']} device operations, busy "
            f"{s['busy_s']!r} s of {s['window_s']!r} s")
        device["busy_s"] = float(ctx.ranks[:, 1].mean())
        device["window_s"] = float(ctx.ranks[:, 2].mean())
        out["breakdown"] = {"device_ops": top(s["ops"]),
                            "idle_gaps": top(s["idle"])}
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in ctx.checks.items()}
    return out


def start_ranks(argv: list, world: int, port: int) -> list:
    """Ranks 1..world-1 of a run, each a process of its own on its card,
    printing to stderr only."""
    return [subprocess.Popen([sys.executable, RUN_PY, *argv, "--rank",
                              str(r), "--store-port", str(port)],
                             stdout=sys.stderr.fileno())
            for r in range(1, world)]


def stop_ranks(procs: list, timeout: float = 120.0) -> list:
    """Wait for every rank process (killing one that outlives the
    timeout); their exit codes."""
    codes = []
    deadline = time.monotonic() + timeout
    for p in procs:
        try:
            codes.append(p.wait(timeout=max(deadline - time.monotonic(), 1)))
        except subprocess.TimeoutExpired:
            p.kill()
            codes.append(p.wait())
    return codes
