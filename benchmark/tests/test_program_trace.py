"""The program's spans beside a traced stretch: `summarize_program` on
synthetic spans, and small traced runs with the program's recorder on
(`harness/program_trace.py`, `trace_program.py`)."""

import importlib.util
import os
import random

import pytest

import small
from harness import core, program_trace
from harness.program_trace import by_name, innermost, summarize_program
from harness.trace import summarize
from test_harness_run import _line_ok

MS = 1_000_000


def _tool():
    spec = importlib.util.spec_from_file_location(
        "bench_trace_program", os.path.join(core.BENCH_DIR,
                                            "trace_program.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_self_time_leaves_out_the_children():
    spans = [("a", 0, 100 * MS, -1, {}), ("b", 10 * MS, 30 * MS, 0, {}),
             ("c", 40 * MS, 50 * MS, 0, {}), ("b", 60 * MS, 70 * MS, 0, {}),
             ("d", 62 * MS, 65 * MS, 3, {})]
    got = by_name(spans)
    assert got["a"] == {"count": 1, "total_ms": 100.0, "self_ms": 60.0}
    assert got["b"] == {"count": 2, "total_ms": 30.0, "self_ms": 27.0}
    assert got["c"]["self_ms"] == 10.0 and got["d"]["self_ms"] == 3.0


def test_innermost_span_past_256_deep_and_past_256_siblings():
    deep = [(f"s{i}", i, 10_000 - i, i - 1, {}) for i in range(300)]
    # s295 to s299 closed before t = 9_705: s294 is the innermost open
    starts = [s[1] for s in deep]
    assert innermost(deep, starts, 9_705) == "s294"
    assert innermost(deep, starts, 150) == "s150"
    wide = [("outer", 0, 10_000, -1, {})] + [
        (f"c{i}", 1 + 2 * i, 2 + 2 * i, 0, {}) for i in range(300)]
    starts = [s[1] for s in wide]
    assert innermost(wide, starts, 5_000) == "outer"
    assert innermost(wide, starts, 11) == "c5"
    assert innermost(wide, starts, 20_000) is None


def test_labelled_gaps_sum_to_the_stretch_idle():
    rng = random.Random(3)
    spans, stack, t = [], [], 0
    for _ in range(400):
        t += rng.randint(1, 50)
        if stack and rng.random() < 0.5:
            i = stack.pop()
            name, a, _, parent, attrs = spans[i]
            spans[i] = (name, a, t, parent, attrs)
        else:
            spans.append((rng.choice("pqr"), t, None,
                          stack[-1] if stack else -1, {}))
            stack.append(len(spans) - 1)
    for i in stack:
        name, a, _, parent, attrs = spans[i]
        spans[i] = (name, a, t + 1, parent, attrs)
    device = []
    for _ in range(200):
        a = rng.randint(0, t)
        device.append(("k", a, a + rng.randint(1, 30)))
    bench = [("bench.chunk", 0, t // 2), ("bench.sync", t // 2, t)]
    window = (5, t - 5)
    want = summarize(window, device, bench)
    got = summarize_program(window, device, spans, {"n": 1}, bench)
    assert sum(got["idle"].values()) == pytest.approx(
        sum(want["idle"].values()), rel=1e-12)
    assert sum(want["idle"].values()) == pytest.approx(
        want["window_s"] - want["busy_s"], rel=1e-12)
    assert set(got["idle"]) <= {"p", "q", "r", "bench.chunk", "bench.sync"}
    assert got["counters"] == {"n": 1}


def test_a_gap_outside_every_program_span_takes_the_bench_label():
    spans = [("sblas.spmm", 10, 20, -1, {})]
    device = [("k", 0, 12), ("k", 30, 40)]
    got = summarize_program((0, 50), device, spans, {},
                            [("bench.sync", 25, 45)])
    assert got["idle"] == pytest.approx({"sblas.spmm": 18e-9,
                                         "bench.sync": 10e-9})


@pytest.mark.parametrize("cell", ["s3dkq4m2.spmm_k64", "webbase1m.spmm_k64",
                                  "webbase1m.pagerank"])
def test_small_traced_run_reads_the_program(cell):
    tool = _tool()
    with program_trace.installed():
        res = small.run(cell, trace=True)
    _line_ok(res, cell, True)
    ctx = program_trace.TracedCtx.last
    facts = ctx.program_facts()
    bench = core.Bench()
    got = {name: bench.reader(name).read(facts)
           for name, (_, cells) in tool.METRICS.items() if cell in cells}
    setup = facts["program_setup"]
    assert setup["sblas.plan"]["count"] >= 1
    if cell == "webbase1m.pagerank":
        # an entry check, a flag a chunk of 16, the two result reads
        chunks = facts["traced_iterations"] / 16 / facts["traced_solves"]
        assert got["host_syncs_per_solve"] == pytest.approx(3 + chunks)
        # the CPU has no device trace to find idle gaps in
        assert got["solver_idle_ms.solve"] is None
        # the small graph takes a WCOO plan, which builds no route
        if facts["plan_kind"] == "RoutedPlan":
            assert 0 < got["plan_route_s"] <= facts["plan_build_s"]
        else:
            assert got["plan_route_s"] is None
        spans = facts["program"]["spans"]
        assert spans["sblas.solve"]["count"] == facts["traced_solves"]
    else:
        assert got["dispatch_ms.stream"] > 0
        spans = facts["program"]["spans"]
        assert spans["sblas.spmm"]["count"] == facts["traced_calls"]


def test_the_tool_lists_only_cells_and_units_the_benchmark_has():
    cells = {w["name"] for w in core.Bench().spec["workloads"]}
    for name, (unit, where) in _tool().METRICS.items():
        assert os.path.isfile(os.path.join(core.BENCH_DIR, "metrics",
                                           name + ".py"))
        assert set(where) <= cells and unit


def test_readers_of_the_program_read_none_without_it():
    for name in _tool().METRICS:
        assert core.Bench().reader(name).read({"trace": None}) is None


def test_readers_of_the_program_on_a_known_run():
    bench = core.Bench()
    facts = {
        "trace": {"busy_s": 0.9, "window_s": 1.0},
        "traced_calls": 4, "traced_solves": 2,
        "program": {
            "spans": {"sblas.spmm": {"count": 4, "total_ms": 2.0,
                                     "self_ms": 1.0}},
            "counters": {"host_syncs": 14, "collective_bytes": 8_000_000},
            "idle": {"sblas.solve.flag": 0.002, "sblas.solve": 0.001,
                     "sblas.solver": 0.5, "bench.solve": 0.5}},
        "program_setup": {"sblas.plan.route": {"count": 3,
                                               "total_ms": 1500.0,
                                               "self_ms": 1500.0}}}
    want = {"dispatch_ms.stream": 0.5, "host_syncs_per_solve": 7.0,
            "solver_idle_ms.solve": 1.5, "collective_mb.dist": 2.0,
            "plan_route_s": 1.5}
    for name, value in want.items():
        assert bench.reader(name).read(facts) == pytest.approx(value)
