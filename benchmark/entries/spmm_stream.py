"""A closed stream of SpMM calls on one card.

Set-up: the configuration's matrix with values from the seed, its plan
from `make_plan(op=<plan_op>)` unforced (timed as `plan_build_s`), a
ring of (B, C) operand sets larger than the L2, and a warm-up of every
set.  The window: `spmm(plan, B_i, alpha, beta, C_i)` back to back over
the ring, one synchronise every `sync_every` calls, as a solver reads
one flag a chunk.  `gflops` is 2 nnz K for every call the window
completed, over the window's seconds.  The check: a sample of the
window's answers against the float64 reference.
"""

from harness import stream, work


def run(ctx):
    cfg, tr = ctx.config, ctx.traffic
    A = ctx.matrix()
    m, n = A.shape
    k, alpha, beta = cfg["k"], cfg["alpha"], cfg["beta"]
    with ctx.timed("plan_build_s"):
        plan = ctx.program.make_plan(A, ctx.dtype, tr["plan_op"], ctx.device)
    ctx.note("plan_kind", ctx.program.kind(plan))
    ring = stream.operand_ring(ctx, m, n, k)

    def call(i):
        B, C = ring[i % len(ring)]
        with ctx.tracer.span("spmm"):
            return ctx.program.spmm(plan, B, alpha, beta, C)

    chunk = tr["sync_every"]
    stream.warm_up(ctx, call, chunk, len(ring), tr["sample"] + 2)
    sample = stream.Sample(ctx.seed, tr["sample"])
    calls, seconds = stream.closed_stream(ctx, call, chunk, sample)
    w = work.spmm(m, n, A.nnz, k, ctx.dtype.itemsize)
    ctx.facts["work_per_call"] = w
    ctx.end_window()
    del plan
    ctx.program.release()
    stream.check_products(ctx, A, ring, sample, alpha, beta)
    return {"metrics": {"gflops": calls * w.flops / seconds / 1e9},
            "attempted": calls, "failed": 0}
