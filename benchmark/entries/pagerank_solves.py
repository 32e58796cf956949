"""Back-to-back PageRank solves on one card.

Set-up: P^T of the configuration's graph (`reference.transition`, the
benchmark's own copy), its plan from `make_plan(op=<plan_op>)` unforced
(timed as `plan_build_s`), and `warm_solves` solves, the first of which
captures the solver's CUDA graph.  The window: `solvers.pagerank(plan,
n, dangling, r0=r0_i, damping, tol, maxiter)` one after another, each
from its own positive r0_i summing to 1, drawn from the seed; each
solve is timed on the host from the call to its return.  `solve_ms` is
the window's seconds over the solves it completed, `solve_ms_p95` the
95th percentile of every solve's time.

The check, on a sample of the window's solves: the L1 distance of the
ranks to the float64 PageRank vector (`l1_to_fixed_point`, the accuracy
the tolerance buys), and to float64 steps from the same r0_i, as many
as the solve reports (`l1_to_same_steps`, the rounding of the steps
alone).  A solve that reports no convergence counts as failed.
"""

import statistics
import time

import torch

from harness import reference, stream, work


def start(ctx, i: int, n: int) -> torch.Tensor:
    """Solve i's r0: positive, summing to 1, from the seed."""
    r0 = torch.rand(n, generator=ctx.generator(1000 + i), device=ctx.device,
                    dtype=ctx.dtype) + 0.5
    return r0 / r0.sum()


def run(ctx):
    tr = ctx.traffic
    (row_ptr, col_idx), (n, _) = ctx.pattern()
    PT, dangling = reference.transition(row_ptr, col_idx, n, ctx.np_dtype)
    ctx.note("nnz", PT.nnz)
    with ctx.timed("plan_build_s"):
        plan = ctx.program.make_plan(PT, ctx.dtype, tr["plan_op"],
                                     ctx.device)
    ctx.note("plan_kind", ctx.program.kind(plan))
    dang = torch.as_tensor(dangling, device=ctx.device)
    damping, tol, maxiter = tr["damping"], tr["tol"], tr["maxiter"]

    def solve(i):
        r0 = start(ctx, i, n)
        with ctx.tracer.span("solve"):
            t = time.perf_counter()
            x, it, conv = ctx.program.pagerank(plan, n, dang, r0, damping,
                                               tol, maxiter)
            return x, it, conv, time.perf_counter() - t

    for i in range(tr["warm_solves"]):
        solve(-1 - i)
    ctx.sync()

    chunk = ctx.program.chunk()
    sample = stream.Sample(ctx.seed, tr["sample"])
    times, iters, failed = [], [], 0
    traced = None

    def one():
        nonlocal failed
        i = len(times)
        x, it, conv, dt = solve(i)
        times.append(dt)
        iters.append(it)
        failed += not conv
        sample.offer(i, (x, it))

    ctx.begin_window()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < ctx.seconds or (
            ctx.tracer.enabled and traced is None):
        if ctx.tracer.enabled and len(times) == tr["trace_after"]:
            with ctx.tracer.stretch():
                for _ in range(tr["traced_solves"]):
                    one()
            traced = iters[-tr["traced_solves"]:]
        one()
    seconds = time.perf_counter() - t0
    ctx.end_window()
    del plan
    ctx.program.release()

    ctx.note("iterations_real", f"min {min(iters)} median "
             f"{statistics.median(iters)} max {max(iters)}")
    executed = [-(-it // chunk) * chunk for it in iters]
    ctx.note("iterations_executed", f"min {min(executed)} max "
             f"{max(executed)} (chunks of {chunk})")
    if traced is not None:
        ctx.facts["traced_solves"] = len(traced)
        ctx.facts["traced_iterations"] = sum(
            -(-it // chunk) * chunk for it in traced)
    ctx.facts["iters_per_solve"] = sum(executed) / len(executed)
    ctx.facts["work_per_iteration"] = work.pagerank_iteration(
        n, PT.nnz, ctx.dtype.itemsize)

    dPT = reference.DeviceCsr(PT, ctx.device)
    star = reference.pagerank_fixed_point(dPT, dang, damping)
    to_star = to_steps = 0.0
    for i, (x, it) in sample.items().items():
        x = x.to(torch.float64)
        to_star = stream.worse(to_star, float((x - star).abs().sum()))
        ref = reference.pagerank_steps(dPT, start(ctx, i, n), dang, damping,
                                       it)
        to_steps = stream.worse(to_steps, float((x - ref).abs().sum()))
    ctx.check("l1_to_fixed_point", to_star)
    ctx.check("l1_to_same_steps", to_steps)
    ctx.note("answers_compared", len(sample.items()))
    q = len(times) // 4
    ctx.note("solve_ms_by_quarter", [
        round(1e3 * sum(times[j * q:(j + 1) * q]) / q, 4) for j in range(4)])
    times_ms = sorted(t * 1e3 for t in times)
    ctx.note("solve_ms_quartiles", [round(x, 4) for x in
                                    statistics.quantiles(times_ms, n=4)])
    return {"metrics": {
        "solve_ms": seconds * 1e3 / len(times),
        "solve_ms_p95": statistics.quantiles(times_ms, n=20)[18]},
        "attempted": len(times), "failed": failed}
