"""The program's own spans and counters beside a traced stretch.

`sblas_tpu_torch.utils.trace` records spans inside the program, each
`(name, start_ns, end_ns, parent_index, attrs)` on the wall clock that
the profiler puts device events on, and counters (`host_syncs`,
`collective_bytes`, ...).  Here a cell runs with that recorder on in two
windows of a traced run: set-up (from the run's context to
`begin_window`) and the traced stretch.  `summarize_program` reduces
the stretch's spans:

* `spans`: each span name's count, total and self milliseconds (a
  span's duration less what its children cover);
* `counters`: the program's counters, with `launches`, the hand-written
  kernel launches;
* `idle`: the device's idle gaps inside the stretch, summed by the
  innermost program span open when each gap began (found by walking the
  parent indices, however deep), or by the benchmark's span open then
  (`trace._label`) where no program span was.

The set-up spans are summed by name alone (`by_name`).  The readers of
`benchmark/metrics/` that read the program (`dispatch_ms.stream`,
`host_syncs_per_solve`, `solver_idle_ms.solve`, `collective_mb.dist`,
`plan_route_s`) read these under `program` and `program_setup`.

`benchmark/run.py` runs nothing of this; `benchmark/trace_program.py`
runs a cell through it (`installed`).  A program without the recorder
(an older checkout) records nothing, and the readers then read None.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict
from typing import Dict, Optional, Tuple

import torch

from . import core
from .trace import Tracer, _device_events, _label, _union, summarize


def by_name(spans) -> Dict[str, dict]:
    """{name: {"count", "total_ms", "self_ms"}} of recorded spans."""
    covered = [0] * len(spans)
    for _, a, b, parent, _ in spans:
        if parent >= 0 and b is not None:
            covered[parent] += b - a
    out: Dict[str, dict] = {}
    for i, (name, a, b, _, _) in enumerate(spans):
        if b is None:
            continue
        d = out.setdefault(name, {"count": 0, "total_ms": 0.0,
                                  "self_ms": 0.0})
        d["count"] += 1
        d["total_ms"] += (b - a) * 1e-6
        d["self_ms"] += (b - a - covered[i]) * 1e-6
    return out


def innermost(spans, starts, t: int) -> Optional[str]:
    """The innermost program span open at host time t, or None.  Spans
    are in start order and nest, so the latest one started by t is
    either open at t or closed inside an ancestor that may be: walk the
    parents."""
    j = bisect.bisect_right(starts, t) - 1
    while j >= 0:
        name, _, b, parent, _ = spans[j]
        if b is None or b > t:
            return name
        j = parent
    return None


def summarize_program(window: Tuple[int, int], device, program_spans,
                      counters: dict, bench_spans=()) -> dict:
    """The stretch's program numbers (module docstring).  `window` is
    its (start, end), `device` and `bench_spans` (name, start, end), and
    `program_spans` the recorder's, all in wall-clock nanoseconds."""
    w0, w1 = window
    dev = [(a, b) for _, a, b in device if b > w0 and a < w1]
    busy = _union([(max(a, w0), min(b, w1)) for a, b in dev if b > a])
    starts = [s[1] for s in program_spans]
    bench = sorted(bench_spans, key=lambda s: s[1])
    bench_starts = [a for _, a, _ in bench]
    idle: Dict[str, float] = defaultdict(float)
    t = w0
    for a, b in busy + [(w1, w1)]:
        if a > t:
            name = (innermost(program_spans, starts, t)
                    or _label(bench, bench_starts, t))
            idle[name] += (a - t) * 1e-9
        t = max(t, b)
    return {"spans": by_name(program_spans), "counters": dict(counters),
            "idle": dict(idle)}


class Recorder:
    """The program's recorder opened and closed across calls; records
    nothing where the program has none."""

    def __init__(self):
        self._cm = self._rec = None

    def begin(self) -> None:
        try:
            from sblas_tpu_torch.utils import trace
        except ImportError:
            return
        self._cm = trace.recording()
        self._rec = self._cm.__enter__()

    def end(self) -> Tuple[list, dict]:
        """(spans, counters) since `begin`, `launches` among the
        counters; empty where nothing was recorded."""
        if self._cm is None:
            return [], {}
        self._cm.__exit__(None, None, None)
        rec, self._cm = self._rec, None
        return rec.spans, dict(rec.counters, launches=rec.launches)


class ProgramTracer(Tracer):
    """`Tracer` whose stretch also records the program, reduced into
    `program`."""

    def __init__(self, enabled: bool, device: torch.device):
        super().__init__(enabled, device)
        self.recorder = Recorder()
        self.program: Optional[dict] = None

    @contextlib.contextmanager
    def stretch(self):
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
            self.recorder.begin()
            yield
            self._sync()
            spans, counters = self.recorder.end()
            w1 = time.time_ns()
        bench, self.spans = self.spans, None
        dev = _device_events(prof) if self.device.type == "cuda" else []
        self.summary = summarize((w0, w1), dev, bench)
        self.program = summarize_program((w0, w1), dev, spans, counters,
                                         bench)


class TracedCtx(core.Ctx):
    """`core.Ctx` recording the program in set-up and in the stretch of
    a traced run; `last` is the newest one made."""

    last: Optional["TracedCtx"] = None

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.tracer = ProgramTracer(self.tracer.enabled, self.device)
        self._setup = Recorder()
        if self.tracer.enabled:
            self._setup.begin()
        TracedCtx.last = self

    def begin_window(self) -> None:
        if self.tracer.enabled:
            spans, counters = self._setup.end()
            self.facts["program_setup"] = by_name(spans)
            self.note("program_setup_spans", {
                k: round(v["total_ms"], 3) for k, v in sorted(
                    self.facts["program_setup"].items(),
                    key=lambda kv: -kv[1]["total_ms"])[:12]})
            self.note("program_setup_counters", counters)
        super().begin_window()

    def program_facts(self) -> dict:
        """The facts a reader of the program reads (`core.result`'s, with
        the stretch's reduction under `program`)."""
        return dict(self.facts, trace=self.tracer.summary,
                    program=self.tracer.program, ctx=self)


@contextlib.contextmanager
def installed():
    """Within the block, every run of a cell makes a `TracedCtx`."""
    prev, core.Ctx = core.Ctx, TracedCtx
    try:
        yield
    finally:
        core.Ctx = prev
