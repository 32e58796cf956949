"""Run one cell traced, with the program's own spans and counters.

    python3 benchmark/trace_program.py --workload <cell> --seed <n>
        --seconds <s>

from the root of a checkout: the run of `benchmark/run.py ... --trace
1`, whose result line it prints as that prints it, with the recorder of
`sblas_tpu_torch` (`utils/trace.py`) on in set-up and in the traced
stretch (`harness/program_trace.py`).  Then one more line, last: the
readings of the metrics that read the program (`METRICS`, each in the
cells it reads in), the stretch's reduction (`program`: spans by name,
counters, the device's idle gaps by program span), the set-up's spans
by name (`program_setup`), and what a span site and a count cost on this
host, off and on (`recorder_ns`).  Standard error notes the set-up's
span totals and the program's idle gaps.  A cell on several cards
records on rank 0 only; its other ranks run `run.py`.
"""

import time

T0 = time.perf_counter()

import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.util.spec_from_file_location(
    "bench_run", os.path.join(HERE, "run.py"))
run = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(run)
run.T0 = T0

# metric -> (unit, the cells it reads in)
METRICS = {
    "dispatch_ms.stream": ("ms", ("s3dkq4m2.spmm_k64", "webbase1m.spmm_k64")),
    "host_syncs_per_solve": ("syncs", ("webbase1m.pagerank",)),
    "solver_idle_ms.solve": ("ms", ("webbase1m.pagerank",)),
    "collective_mb.dist": ("MB", ("webbase1m_4gpu.spmm_mode2_k64",)),
    "plan_route_s": ("s", ("webbase1m.pagerank",)),
}


def recorder_ns(reps: int = 200_000) -> dict:
    """Host ns a span site (`with span(name, band=i): pass`) and a count
    take, off and on, each beside the bare loop's ns."""
    from sblas_tpu_torch.utils import trace

    def per(body):
        t = time.perf_counter_ns()
        body()
        return (time.perf_counter_ns() - t) / reps

    def loop():
        for i in range(reps):
            pass

    def spans():
        for i in range(reps):
            with trace.span("sblas.cost", band=i):
                pass

    def counts():
        for _ in range(reps):
            trace.count("cost")

    out = {"loop": per(loop), "span_off": per(spans),
           "count_off": per(counts)}
    with trace.recording():
        out["span_on"], out["count_on"] = per(spans), per(counts)
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    from harness import core, program_trace
    with program_trace.installed():
        rc = run.main(argv + ["--trace", "1"])
    ctx = program_trace.TracedCtx.last
    if rc != 0 or ctx is None or ctx.rank != 0:
        return rc
    facts = ctx.program_facts()
    bench = core.Bench(run.ROOT)
    metrics = {}
    for name, (unit, cells) in METRICS.items():
        if ctx.cell in cells:
            v = bench.reader(name).read(facts)
            if v is not None:
                metrics[name] = {"value": v, "unit": unit}
    program = facts["program"]
    if program is not None:
        core.say("program idle gaps (s): "
                 f"{core.top(program['idle'])}")
    print(json.dumps({"metrics": metrics, "program": program,
                      "program_setup": facts.get("program_setup"),
                      "recorder_ns": recorder_ns()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
