"""Back-to-back Jacobi-preconditioned CG solves on one card.

Set-up: the configuration's pattern with the SPD values of
`pcg.spd_values` drawn from the seed, its plan from
`make_plan(op=<plan_op>)` unforced (timed as `plan_build_s`), the
program's inverse diagonal (`jacobi_inv_diag`), and solves for at least
`warm_seconds` and `warm_solves`, the first of which captures the
solver's CUDA graph.  The window: `solvers.cg(plan, b_i, tol, maxiter,
M=inv_diag)` one after another from x0 = 0, each b_i
uniform in [-1, 1) drawn on the device from the seed; each solve is
timed on the host from the call to its return.  `solve_ms` is the
window's seconds over the solves it completed.

The check, on a sample of the window's solves, in float64 on the
benchmark's own CSR: the relative residual ||b - A x|| / ||b||
(`rel_residual`, what the tolerance asks for) and the distance to the
float64 solution x* of a reference Jacobi-PCG run to a relative residual
of 1e-12, ||x - x*|| / ||x*|| (`rel_err_to_x64`).  A solve that reports
no convergence counts as failed.
"""

import statistics
import time

import torch

from harness import pcg, reference, stream


def rhs(ctx, i: int, n: int) -> torch.Tensor:
    """Solve i's b: uniform in [-1, 1), from the seed."""
    return torch.rand(n, generator=ctx.generator(1000 + i),
                      device=ctx.device, dtype=ctx.dtype) * 2 - 1


def run(ctx):
    tr = ctx.traffic
    (row_ptr, col_idx), (n, _) = ctx.pattern()
    vals = pcg.spd_values(row_ptr, col_idx, ctx.seed, ctx.np_dtype,
                          ctx.config["values"]["shift"])
    A = reference.Csr(row_ptr, col_idx, vals, (n, n))
    ctx.note("nnz", A.nnz)
    with ctx.timed("plan_build_s"):
        plan = ctx.program.make_plan(A, ctx.dtype, tr["plan_op"],
                                     ctx.device)
    ctx.note("plan_kind", ctx.program.kind(plan))
    M = pcg.inv_diag(ctx.program, A, ctx.dtype, ctx.device)
    tol, maxiter = tr["tol"], tr["maxiter"]

    def solve(i):
        b = rhs(ctx, i, n)
        with ctx.tracer.span("solve"):
            t = time.perf_counter()
            x, it, conv = pcg.cg(ctx.program, plan, b, M, tol, maxiter)
            return x, it, conv, time.perf_counter() - t

    # the first solve captures the solver's graph; after it the card runs
    # graphs of small kernels 11-13 % slower for a spell of up to about
    # 25 s, so set-up solves on for `warm_seconds`
    t_warm, i = time.perf_counter(), 0
    while (i < tr["warm_solves"]
           or time.perf_counter() - t_warm < tr["warm_seconds"]):
        solve(-1 - i)
        i += 1
    ctx.note("warm_solves", i)
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
        sample.offer(i, x)

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
    ctx.facts["work_per_iteration"] = pcg.pcg_iteration(
        n, A.nnz, ctx.dtype.itemsize)

    dA = reference.DeviceCsr(A, ctx.device)
    M64 = pcg.reference_inv_diag(A, torch.float64, ctx.device)
    residual = err = 0.0
    ref_iters = []
    for i, x in sample.items().items():
        b = rhs(ctx, i, n).to(torch.float64)
        star, it, conv = pcg.reference_pcg(dA, b, M64)
        if not conv:
            raise RuntimeError(f"the float64 reference did not converge "
                               f"for solve {i} in {it} iterations")
        ref_iters.append(it)
        x = x.to(torch.float64)
        residual = stream.worse(residual, float(
            torch.linalg.vector_norm(b - dA.matmul(x))
            / torch.linalg.vector_norm(b)))
        err = stream.worse(err, float(torch.linalg.vector_norm(x - star)
                                      / torch.linalg.vector_norm(star)))
    ctx.check("rel_residual", residual)
    ctx.check("rel_err_to_x64", err)
    ctx.note("answers_compared", len(ref_iters))
    ctx.note("reference_iterations", ref_iters)
    if len(times) >= 4:
        q = len(times) // 4
        ctx.note("solve_ms_by_quarter", [
            round(1e3 * sum(times[j * q:(j + 1) * q]) / q, 4)
            for j in range(4)])
    return {"metrics": {"solve_ms": seconds * 1e3 / len(times)},
            "attempted": len(times), "failed": failed}
