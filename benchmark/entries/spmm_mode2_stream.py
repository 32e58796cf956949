"""A closed stream of distributed SpMM calls, one process a card: the
reference's mode 2.

Set-up, on every rank: the configuration's matrix with values from the
seed (the same on every rank), split by rows into `shards` per-shard
fast plans by `partition_row_plans` with the shard kind unforced (timed
as `plan_build_s`; each rank keeps its own shard on its card), the same
ring of (B, C) operand sets on every card, and a warm-up of every set.
The window: `spmm_mode2_planned(shards, B_i, alpha, beta, C_i, mesh,
reduce="psum")` back to back, each rank multiplying its rows into a
full-height partial that an all-reduce sums, one synchronise and one
agreed flag every `sync_every` calls.  `dist_gflops` is 2 nnz K of the
whole matrix for every call rank 0 completed, over its window's
seconds.  The check, on rank 0: a sample of its answers (the whole C'
every rank holds) against the float64 reference.
"""

from harness import stream, work


def run(ctx):
    cfg, tr = ctx.config, ctx.traffic
    A = ctx.matrix()
    m, n = A.shape
    k, alpha, beta = cfg["k"], cfg["alpha"], cfg["beta"]
    if cfg["shards"] != ctx.world:
        raise ValueError(f"{cfg['shards']} shards need as many ranks; "
                         f"the run has {ctx.world}")
    mesh = ctx.program.mesh(ctx.world, ctx.device)
    with ctx.timed("plan_build_s"):
        shards = ctx.program.partition_row_plans(
            A, cfg["shards"], ctx.dtype, tr["plan_op"], ctx.device,
            ctx.rank)
    ctx.note("plan_kind", ctx.program.kind(shards))
    ring = stream.operand_ring(ctx, m, n, k)

    def call(i):
        B, C = ring[i % len(ring)]
        with ctx.tracer.span("spmm_mode2"):
            return ctx.program.spmm_mode2(shards, B, alpha, beta, C, mesh)

    chunk = tr["sync_every"]
    stream.warm_up(ctx, call, chunk, len(ring), tr["sample"] + 2)
    sample = stream.Sample(ctx.seed, tr["sample"])
    calls, seconds = stream.closed_stream(ctx, call, chunk, sample)
    ctx.end_window()
    del shards
    ctx.program.release()
    if ctx.rank != 0:
        return None
    stream.check_products(ctx, A, ring, sample, alpha, beta)
    w = work.spmm(m, n, A.nnz, k, ctx.dtype.itemsize)
    return {"metrics": {"dist_gflops": calls * w.flops / seconds / 1e9},
            "attempted": calls, "failed": 0}
