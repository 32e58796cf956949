"""Shared CLI machinery.

Port of `sblas_tpu/cli/common.py`.  The reference's test binaries share a
shape: parse positional argv, load operands, run the op, verify against
the CPU oracle, print Load/Run/CPU times and `Validation = True/False`
(spmm_test.cu:19-56, spmv_test.cu:9-42).  The process exit code reflects
validation.  The distributed modes run one process per rank in one
process group (`setup_devices`).
"""

from __future__ import annotations

import contextlib
import os
import sys


def ensure_dtype(dtype_name: str, usage: str):
    """(numpy, torch) value dtypes for "f32" or "f64"; a usage error
    otherwise.  (The JAX package flips jax_enable_x64 here; torch needs no
    switch for f64.)"""
    import numpy as np
    import torch
    dtypes = {"f32": (np.float32, torch.float32),
              "f64": (np.float64, torch.float64)}
    if dtype_name not in dtypes:
        print(usage, file=sys.stderr)
        raise SystemExit(2)
    return dtypes[dtype_name]


def cuda_missing(device: str) -> bool:
    """True (after saying so) when `device` is cuda and there is no card;
    the CLIs then exit non-zero rather than fall back to the CPU."""
    import torch
    if device == "cuda" and not torch.cuda.is_available():
        print("[sblas] --device cuda but no CUDA device is available",
              file=sys.stderr)
        return True
    return False


def run_ms(run, device, times: dict, n: int = 1) -> float:
    """Time `run` into `times` and return the ms per call that throughput
    is taken over: on cuda the median wall time per synchronous call
    (plus the device's busy time from CUDA events, reported beside it),
    on cpu a host time labelled as such."""
    from ..utils.timing import device_time_ms, host_time_ms, wall_time_ms
    if str(device).startswith("cuda"):
        ms = wall_time_ms(run, device=device)
        times[f"{n}-device run time (cuda, wall per call, median)"] = ms
        times[f"{n}-device busy time (cuda events, median)"] = \
            device_time_ms(run, device=device)
    else:
        ms = host_time_ms(run)
        times[f"{n}-device run time (cpu host clock, median)"] = ms
    return ms


def group_of_one() -> dict:
    """`init_process_group` arguments for a group of one on this host: a
    TCP store that binds port 0, so the port is taken in the same call
    that picks it.  (A port found free and bound later can be taken in
    between by any socket on the host, and the bind then fails with
    EADDRINUSE.)"""
    import torch.distributed as dist
    return dict(store=dist.TCPStore("127.0.0.1", 0, 1, True), rank=0,
                world_size=1)


def devices_to_use(n_requested: int, world: int, rank: int = 0) -> int:
    """How many devices the distributed modes run on, given a world of
    `world` ranks.  More than the world: say so (rank 0) and run on the
    world, as the JAX CLI clamps to the devices it sees.  Fewer: a usage
    error, where the JAX CLI runs on the first n devices, since here every
    rank the launcher started holds a shard; launch n ranks instead."""
    if n_requested > world:
        if rank == 0:
            print(f"[sblas] requested {n_requested} devices, have {world}; "
                  f"running on {world} (launch one process per device with "
                  f"torchrun for more)")
        return world
    if n_requested < world:
        print(f"[sblas] requested {n_requested} devices but {world} ranks "
              f"are running: launch one per device, torchrun "
              f"--nproc_per_node={n_requested}", file=sys.stderr)
        raise SystemExit(2)
    return n_requested


@contextlib.contextmanager
def setup_devices(n_requested: int, device: str):
    """Yield (mesh, n) for the distributed modes: the world group on this
    rank's device, and its size n.

    Under `torchrun` (RANK, WORLD_SIZE, LOCAL_RANK in the environment)
    every rank joins the launcher's group; without it the process makes
    a group of one on a free local port.  NCCL serves `--device cuda`
    (rank on card LOCAL_RANK), gloo `--device cpu`; there is no fallback
    between them, and a failed initialisation raises.  When more devices
    are asked for than the world has, it says so and runs on the world;
    fewer is a usage error (`devices_to_use`).  A group it made is
    destroyed on exit; one that was already up (a caller's) is used and
    left alone."""
    import torch
    import torch.distributed as dist

    from ..parallel import init_distributed, make_mesh
    owned = not dist.is_initialized()
    if device == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    if owned:
        if "WORLD_SIZE" in os.environ:
            kw = dict(init_method="env://", rank=int(os.environ["RANK"]),
                      world_size=int(os.environ["WORLD_SIZE"]))
        else:
            kw = group_of_one()
        if device == "cuda":
            kw["device_id"] = dev
        init_distributed(backend="nccl" if device == "cuda" else "gloo",
                         **kw)
    try:
        n = devices_to_use(n_requested, dist.get_world_size(),
                           dist.get_rank())
        yield make_mesh(n, device=dev), n
    finally:
        if owned:
            dist.destroy_process_group()


def all_ranks_ok(ok: bool, mesh) -> bool:
    """True when `ok` holds on every rank of `mesh` (a MIN all-reduce)."""
    import torch
    import torch.distributed as dist
    flag = torch.tensor([1 if ok else 0], dtype=torch.int32,
                        device=mesh.device)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=mesh.group)
    return bool(flag.item())


def finish(ok: bool, times_ms: dict) -> int:
    """Print the reference-style report; return a process exit code."""
    for name, ms in times_ms.items():
        print(f"{name} = {ms:.3f} ms")
    print(f"Validation = {ok}")
    return 0 if ok else 1


def positional(argv, names, casts, usage: str):
    if len(argv) < len(names):
        print(usage, file=sys.stderr)
        raise SystemExit(2)
    return [cast(a) for a, cast in zip(argv, casts)]


def flag_value(rest, name: str, default, cast=str, usage: str = ""):
    """`--name VALUE` lookup with a usage error when the value is
    missing."""
    if name not in rest:
        return default
    i = rest.index(name)
    if i + 1 >= len(rest):
        print(usage or f"missing value for {name}", file=sys.stderr)
        raise SystemExit(2)
    return cast(rest[i + 1])


def trailing(argv, start: int, usage: str):
    """The UM CLIs' optional positionals at `start`: (tuning, dtype
    name), before any flag; a tuning other than 0 or 1 is a usage
    error."""
    extra = []
    for a in argv[start:start + 2]:
        if a.startswith("-"):
            break
        extra.append(a)
    tuning = extra[0] if extra else "0"
    if tuning not in ("0", "1"):
        print(usage, file=sys.stderr)
        raise SystemExit(2)
    return tuning == "1", (extra[1] if len(extra) > 1 else "f32")


def hbm_budget() -> int:
    """The UM CLIs' device-memory budget: SBLAS_HBM_BUDGET bytes, default
    256 MiB (as the JAX CLIs read it)."""
    return int(os.environ.get("SBLAS_HBM_BUDGET", 256 << 20))
