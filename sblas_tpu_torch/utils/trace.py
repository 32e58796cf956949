"""Spans and counters at the port's layer boundaries, kept in memory.

Every layer marks the work it does with

    with trace.span("sblas.<layer>.<what>", key=value, ...):
        ...
    trace.count("<counter>", n)

and a caller that wants them opens a recorder:

    with trace.recording() as rec:
        ...                        # calls into the package
    rec.spans      # (name, start_ns, end_ns, parent_index, attrs), in
                   # start order; parent_index -1 for a span opened
                   # outside any other
    rec.counters   # {name: total}
    rec.launches   # hand-written kernel launches (`_kernels.LAUNCHED`)
                   # over the block, set when it ends

**Off** (no recorder open, the default) a span or a count costs one test
of a module global: no clock is read, nothing is appended, no profiler
range is opened.  Names are constants; what varies (a band, a plan kind,
a byte count) goes in the attributes, which are formatted only by a
reader.  **On**, spans are stamped with `time.time_ns()`, the wall clock
that `torch.profiler` puts device events on, so a span and the device
work it enqueued can be laid side by side.  Nothing is written out: the
caller reads the recorder when its block ends.

`recording(ranges=True)` also opens a `torch.profiler.record_function`
range for every span, and an NVTX range when CUDA is available, named
`<name> key=value ...` (`profiling.py`'s Chrome traces; `nsys
--trace=cuda,nvtx`).

One recorder is open at a time (an inner `recording` block hides the
outer one until it ends), and spans nest by the order they open, so
record from one thread.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch

_REC: Optional["Recorder"] = None


def _launched() -> int:
    from .. import _kernels
    return sum(_kernels.LAUNCHED.values())


class Recorder:
    """What a `recording` block saw (module docstring)."""

    def __init__(self, ranges: bool = False):
        self.spans: list = []
        self.counters: dict = {}
        self.ranges = ranges
        self.nvtx = ranges and torch.cuda.is_available()
        self.launches: Optional[int] = None
        self._open: list = []
        self._launched0 = _launched()


class _Off:
    """The span handed out while no recorder is open."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("rec", "name", "attrs", "index", "range")

    def __init__(self, rec: Recorder, name: str, attrs: dict):
        self.rec, self.name, self.attrs = rec, name, attrs

    def set(self, **attrs) -> None:
        """Add attributes known only inside the block."""
        self.attrs.update(attrs)

    def __enter__(self):
        rec = self.rec
        if rec.ranges:
            label = " ".join([self.name] + [f"{k}={v}" for k, v in
                                            self.attrs.items()])
            self.range = torch.profiler.record_function(label)
            self.range.__enter__()
            if rec.nvtx:
                torch.cuda.nvtx.range_push(label)
        self.index = len(rec.spans)
        parent = rec._open[-1].index if rec._open else -1
        rec.spans.append((self.name, time.time_ns(), None, parent,
                          self.attrs))
        rec._open.append(self)
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        rec = self.rec
        rec._open.pop()
        name, start, _, parent, attrs = rec.spans[self.index]
        rec.spans[self.index] = (name, start, end, parent, attrs)
        if rec.ranges:
            if rec.nvtx:
                torch.cuda.nvtx.range_pop()
            self.range.__exit__(*exc)
        return False


def span(name: str, **attrs):
    """A context manager marking its block as span `name` while a
    recorder is open; `set(**attrs)` on what it yields adds attributes."""
    if _REC is None:
        return _OFF
    return _Span(_REC, name, attrs)


def count(name: str, n: int = 1) -> None:
    """Add `n` to counter `name` while a recorder is open."""
    if _REC is not None:
        _REC.counters[name] = _REC.counters.get(name, 0) + n


def current():
    """The innermost open span, to `set` attributes that only code deeper
    down knows (a no-op while no recorder or no span is open)."""
    if _REC is None or not _REC._open:
        return _OFF
    return _REC._open[-1]


@contextlib.contextmanager
def recording(ranges: bool = False):
    """Record spans and counters within the block; yields the
    `Recorder` (module docstring)."""
    global _REC
    prev = _REC
    rec = _REC = Recorder(ranges)
    try:
        yield rec
    finally:
        rec.launches = _launched() - rec._launched0
        _REC = prev
