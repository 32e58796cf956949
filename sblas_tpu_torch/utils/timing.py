"""Phase timing and throughput reporting.

Port of `sblas_tpu/utils/timing.py`.  `timed` is the reference's
`cpu_timer` (gettimeofday, utility.h:142-160) as a context manager that
waits for the device before it stops.  Two clocks for a device op:

* `device_time_ms` is the reference's `gpu_timer` (cudaEvent pair,
  utility.h:163-178): the time the card spends on the op's kernels.  The
  stream is first held busy with `torch.cuda._sleep` for longer than the
  host needs to enqueue the calls, so the event pair measures device work
  back to back and not the host's launch rate (eager PyTorch spends tens
  of microseconds of host time per launch, which a routed SpMV's ~45
  launches turn into most of its call time).
* `wall_time_ms` is what a synchronous caller waits: host clock around
  the call and a `torch.cuda.synchronize()`.

Both take the median of repeated runs after a warm-up.  1 - device/wall
is the device's idle share.  A time from the CPU is taken by
`host_time_ms` and never reported under a device name.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch


def _sync(device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def timed(name: str, results: Optional[Dict[str, float]] = None,
          device=None):
    """Host wall time of the block in ms, stored under `name` in
    `results`; waits for `device` (if CUDA) before stopping the clock."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _sync(device)
        if results is not None:
            results[name] = (time.perf_counter() - t0) * 1e3


def device_time_ms(fn: Callable[[], object], *, warmup: int = 3,
                   reps: int = 20, inner: int = 1, device="cuda") -> float:
    """Median device time (ms) of one `fn()` call on a CUDA device: each
    repetition records an event pair around `inner` back-to-back calls,
    enqueued behind a sleep that outlasts their host-side launch time.
    Raises when there is no card."""
    from .errors import KernelError, require
    require(torch.cuda.is_available(), KernelError,
            "device_time_ms needs a CUDA device")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(inner):
        fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize(device)
    # at most 2e6 cycles per ms (an H100's SM clock peaks at 1.98 GHz), so
    # the sleep lasts at least 2x the measured enqueue time plus 0.1 ms
    sleep_cycles = int((2 * enqueue_ms + 0.1) * 2e6)
    ts = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        for _ in range(inner):
            fn()
        stop.record()
        stop.synchronize()
        ts.append(start.elapsed_time(stop) / inner)
    return float(np.median(ts))


def wall_time_ms(fn: Callable[[], object], *, warmup: int = 3,
                 reps: int = 20, device="cuda") -> float:
    """Median host wall time (ms) of `fn()` followed by a device
    synchronize: what a synchronous caller waits per call."""
    from .errors import KernelError, require
    require(torch.cuda.is_available(), KernelError,
            "wall_time_ms needs a CUDA device")
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(device)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize(device)
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def host_time_ms(fn: Callable[[], object], *, warmup: int = 1,
                 reps: int = 5) -> float:
    """Median host wall time (ms) of one `fn()` call on the CPU."""
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def spmv_flops(nnz: int) -> int:
    """FLOPs of y = beta*y + alpha*A@x: 2 per nnz (the O(m) epilogue is
    left out, as in common SpMV accounting)."""
    return 2 * nnz


def spmm_flops(nnz: int, k: int) -> int:
    return 2 * nnz * k


def gflops(flops: int, ms: float) -> float:
    return flops / (ms * 1e-3) / 1e9 if ms > 0 else float("inf")


def nnz_per_s(nnz: int, ms: float) -> float:
    return nnz / (ms * 1e-3) if ms > 0 else float("inf")
