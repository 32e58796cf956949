"""Pieces the stream entries share: the operand ring, the closed loop of
synchronised chunks, the sample of answers, and the check of sampled
products against the float64 reference.
"""

from __future__ import annotations

import math
import random
import time

import torch

from . import reference


def worse(a: float, b: float) -> float:
    """The larger of two readings, where a reading that is not finite
    (a NaN or an overflow in the answer) is the worst of all."""
    return max(a, b) if math.isfinite(b) else math.inf


class Sample:
    """The answers kept for the check: the window's first and last, and
    `k` more drawn from the seed over all of them (a reservoir)."""

    def __init__(self, seed: int, k: int):
        self.rng = random.Random(seed)
        self.k = k
        self.seen = 0
        self.first = self.last = None
        self.drawn = []

    def offer(self, i: int, item) -> None:
        if self.first is None:
            self.first = (i, item)
        self.last = (i, item)
        if len(self.drawn) < self.k:
            self.drawn.append((i, item))
        else:
            j = self.rng.randrange(self.seen + 1)
            if j < self.k:
                self.drawn[j] = (i, item)
        self.seen += 1

    def items(self) -> dict:
        """index -> answer, each kept answer once."""
        kept = [self.first, *self.drawn, self.last]
        return {i: item for i, item in (p for p in kept if p is not None)}


def operand_ring(ctx, m: int, n: int, k: int):
    """[(B, C), ...]: B (n, k) and C (m, k) uniform in [-1, 1) from the
    seed, on the device, as many sets as the traffic's `ring_bytes`
    asks for (at least `ring_sets`), so that no call finds its operands
    in the 50 MB L2 left by the call before."""
    tr = ctx.traffic
    per_set = (n + m) * k * torch.empty((), dtype=ctx.dtype).element_size()
    sets = max(int(tr["ring_sets"]), math.ceil(tr["ring_bytes"] / per_set))
    g = ctx.generator(1)
    ring = []
    for _ in range(sets):
        B = torch.rand((n, k), generator=g, device=ctx.device,
                       dtype=ctx.dtype) * 2 - 1
        C = torch.rand((m, k), generator=g, device=ctx.device,
                       dtype=ctx.dtype) * 2 - 1
        ring.append((B, C))
    ctx.note("operand_sets", sets)
    ctx.note("operand_bytes", sets * per_set)
    return ring


def warm_up(ctx, call, chunk: int, ring: int, keep: int) -> None:
    """Every operand set once, then two chunks holding `keep` answers
    as the window's sample does: every shape and allocation the window
    uses is made before it."""
    held = []
    for i in range(max(ring, 2 * chunk)):
        held = (held + [call(i)])[-keep:]
    ctx.sync()


def closed_stream(ctx, call, chunk: int, sample: Sample):
    """Call `call(i)` back to back, `chunk` calls between synchronises,
    until `ctx.seconds` have passed on every rank.  The traffic's
    `traced_chunks` chunks from chunk `trace_after` run under the
    profiler when tracing.  Returns (calls, window seconds)."""
    tr = ctx.traffic
    calls = chunks = 0

    def run_chunk():
        nonlocal calls, chunks
        with ctx.tracer.span("chunk"):
            for _ in range(chunk):
                sample.offer(calls, call(calls))
                calls += 1
            with ctx.tracer.span("sync"):
                ctx.sync()
        chunks += 1

    ctx.begin_window()
    t0 = time.perf_counter()
    while True:
        if ctx.tracer.enabled and chunks == tr["trace_after"]:
            with ctx.tracer.stretch():
                for _ in range(tr["traced_chunks"]):
                    run_chunk()
            ctx.facts["traced_calls"] = tr["traced_chunks"] * chunk
        run_chunk()
        untraced = ctx.tracer.enabled and chunks <= tr["trace_after"]
        if not ctx.agree(time.perf_counter() - t0 < ctx.seconds
                         or untraced):
            break
    return calls, time.perf_counter() - t0


def check_products(ctx, A: reference.Csr, ring, sample: Sample,
                   alpha: float, beta: float) -> int:
    """`max_rel_err`: the largest error of any element of a sampled
    answer, |C'_ij - ref_ij| / (|beta||C_ij| + |alpha|(|A||B|)_ij),
    against the float64 reference worked out from the benchmark's own A,
    B and C.  Returns the number of answers compared."""
    dA = reference.DeviceCsr(A, ctx.device)
    worst = 0.0
    items = sample.items()
    for i, out in items.items():
        B, C = ring[i % len(ring)]
        ref, scale = reference.spmm(dA, B, C, alpha, beta)
        worst = worse(worst, float(
            ((out.to(torch.float64) - ref).abs() / scale).max()))
        del ref, scale
    ctx.check("max_rel_err", worst)
    ctx.note("answers_compared", len(items))
    return len(items)
