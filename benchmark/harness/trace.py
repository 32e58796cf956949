"""The traced stretch of a `--trace 1` run, and its reduction.

`Tracer.stretch()` runs `torch.profiler` over a fixed amount of a cell's
work inside its window, recording the device's activity only (kernels,
copies, fills): recording every host operation as well would make the
host, not the device, the bottleneck of the stretch it measures.  The
host side is the benchmark's own spans (`Tracer.span`, around each call
into the program), stamped with the same wall clock the profiler puts
device events on.  The stretch starts and ends with a synchronise, so
every device operation it started lies inside it.  `summarize` reduces
the events to what the per-layer readers read:

* `window_s`: the stretch's length;
* `busy_s`: the union of device activity inside it; `device_sum_s`:
  the activities' summed durations;
* `ops`: device seconds by operation name; `nccl_s`: those of NCCL;
* `idle`: the device's idle gaps inside the stretch, summed by the
  innermost span the host was in when each gap began.

Nothing here reads spans inside the program.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

PREFIX = "bench."


def _device_events(prof):
    """(name, start_ns, end_ns) of the profiler's device activity (the
    profiler's own annotations left out)."""
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CPU:
            continue
        name = e.name()
        if name.startswith(PREFIX):
            continue
        start = e.start_ns()
        out.append((name, start, start + e.duration_ns()))
    return out


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _label(spans, starts, t: int) -> str:
    """The innermost span open at host time t (`host idle` when none
    is).  Spans nest, so the innermost one open is the latest started
    one that has not ended; `spans` are sorted by start."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(i - 257, -1), -1):
        name, a, b = spans[j]
        if b > t:
            return name
    return "host idle"


def summarize(window: Tuple[int, int], device, spans) -> dict:
    """The traced stretch's numbers (module docstring).  `window` is its
    (start, end) and `device` and `spans` are (name, start, end), all in
    wall-clock nanoseconds."""
    w0, w1 = window
    dev = [(name, max(a, w0), min(b, w1)) for name, a, b in device
           if b > w0 and a < w1]
    spans = sorted(spans, key=lambda s: s[1])
    starts = [a for _, a, _ in spans]
    busy = _union([(a, b) for _, a, b in dev if b > a])
    ops: Dict[str, float] = defaultdict(float)
    for name, a, b in dev:
        ops[name] += (b - a) * 1e-9
    idle: Dict[str, float] = defaultdict(float)
    t = w0
    for a, b in busy + [(w1, w1)]:
        if a > t:
            idle[_label(spans, starts, t)] += (a - t) * 1e-9
        t = max(t, b)
    return {
        "device_events": len(dev),
        "window_s": (w1 - w0) * 1e-9,
        "busy_s": sum(b - a for a, b in busy) * 1e-9,
        "device_sum_s": sum(ops.values()),
        "ops": dict(ops),
        "nccl_s": sum(s for name, s in ops.items() if "nccl" in name.lower()),
        "idle": dict(idle),
    }


def top(d: Dict[str, float], n: int = 10):
    """The n largest entries of d as [name, seconds] pairs."""
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]


class _Span:
    __slots__ = ("spans", "name", "t")

    def __init__(self, spans, name):
        self.spans, self.name = spans, name

    def __enter__(self):
        self.t = time.time_ns()

    def __exit__(self, *exc):
        self.spans.append((self.name, self.t, time.time_ns()))


class Tracer:
    """Spans around the calls into the program, and one profiled
    stretch when tracing is on (`summary` holds its reduction)."""

    def __init__(self, enabled: bool, device: torch.device):
        self.enabled = enabled
        self.device = device
        self.summary: Optional[dict] = None
        self.spans: Optional[list] = None

    def span(self, name: str):
        """Stamp the block as span `name` while a stretch is traced."""
        if self.spans is None:
            return contextlib.nullcontext()
        return _Span(self.spans, PREFIX + name)

    @contextlib.contextmanager
    def stretch(self):
        """Profile the block (a no-op when tracing is off)."""
        if not self.enabled:
            yield
            return
        from torch.profiler import ProfilerActivity, profile
        acts = ([ProfilerActivity.CUDA] if self.device.type == "cuda"
                else [ProfilerActivity.CPU])
        self.spans = []
        with profile(activities=acts) as prof:
            self._sync()
            w0 = time.time_ns()
            yield
            self._sync()
            w1 = time.time_ns()
        spans, self.spans = self.spans, None
        dev = _device_events(prof) if self.device.type == "cuda" else []
        self.summary = summarize((w0, w1), dev, spans)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
