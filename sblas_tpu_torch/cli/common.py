"""Shared CLI machinery.

Port of `sblas_tpu/cli/common.py`.  The reference's test binaries share a
shape: parse positional argv, load operands, run the op, verify against
the CPU oracle, print Load/Run/CPU times and `Validation = True/False`
(spmm_test.cu:19-56, spmv_test.cu:9-42).  The process exit code reflects
validation.
"""

from __future__ import annotations

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


def run_ms(run, device: str, times: dict) -> float:
    """Time `run` into `times` and return the ms per call that throughput
    is taken over: on cuda the median wall time per synchronous call
    (plus the device's busy time from CUDA events, reported beside it),
    on cpu a host time labelled as such."""
    from ..utils.timing import device_time_ms, host_time_ms, wall_time_ms
    if device == "cuda":
        ms = wall_time_ms(run, device=device)
        times["1-device run time (cuda, wall per call, median)"] = ms
        times["1-device busy time (cuda events, median)"] = device_time_ms(
            run, device=device)
    else:
        ms = host_time_ms(run)
        times["1-device run time (cpu host clock, median)"] = ms
    return ms


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
