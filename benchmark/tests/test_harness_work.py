"""The operations and bytes each cell is measured against, the readers'
arithmetic, and the reduction of a traced stretch."""

import types

import pytest
import torch

from harness import core, trace, work

BENCH = core.Bench()
H100 = work.peaks("NVIDIA H100 80GB HBM3")


@pytest.mark.parametrize("config,mb,gflop", [
    ("s3dkq4m2_f32", 108.553136, 0.61962406),
    ("webbase1m_f32", 795.921068, 0.38273702),
    ("webbase1m_f32_4gpu", 795.921068, 0.38273702)])
def test_spmm_counts_of_each_cell(config, mb, gflop):
    cfg = BENCH.config(config)
    w = work.spmm(cfg["rows"], cfg["cols"], cfg["nnz"], cfg["k"])
    assert w.flops / 1e9 == pytest.approx(gflop, rel=1e-7)
    assert w.bytes / 1e6 == pytest.approx(mb, rel=1e-6)
    # nnz * (value + index) + (m + 1) row pointers + B, C and C'
    m, n, nnz, k = cfg["rows"], cfg["cols"], cfg["nnz"], cfg["k"]
    assert w.bytes == nnz * 8 + (m + 1) * 4 + (n * k + 2 * m * k) * 4


def test_pagerank_counts():
    w = work.pagerank_iteration(1_000_000, 2_990_133)
    assert w.bytes == 2_990_133 * 8 + 1_000_001 * 4 + 3 * 1_000_000 * 4
    assert w.flops == 2 * 2_990_133 + 7 * 1_000_000
    assert work.bound_s(w, H100) == pytest.approx(w.bytes / 3.35e12)


def test_bounds_take_the_longer_side():
    assert work.bound_s(work.Work(67e12, 1.0), H100) == pytest.approx(1.0)
    assert work.bound_s(work.Work(1.0, 3.35e12), H100) == pytest.approx(1.0)
    assert work.peaks("a card with no row") is None


def _facts(summary, **kw):
    ctx = types.SimpleNamespace(device=torch.device("cpu"))
    return dict(kw, trace=summary, ctx=ctx)


def test_readers_return_nothing_without_a_trace_or_a_card():
    empty = {"window_s": 0.1, "busy_s": 0.0, "device_sum_s": 0.0, "ops": {},
             "nccl_s": 0.0, "idle": {}}
    for name in ("spmm_roofline", "pagerank_iter_roofline",
                 "idle_share.stream", "idle_share.solve", "idle_share.dist",
                 "allreduce_ms.dist"):
        read = BENCH.reader(name).read
        assert read(_facts(None)) is None
        assert read(_facts(empty, traced_calls=4, traced_iterations=64,
                           work_per_call=work.Work(1, 1),
                           work_per_iteration=work.Work(1, 1))) is None


def test_readers_arithmetic(monkeypatch):
    s = {"window_s": 0.5, "busy_s": 0.4, "device_sum_s": 0.4,
         "ops": {"k": 0.3, "ncclKernel_AllReduce": 0.1}, "nccl_s": 0.1,
         "idle": {"bench.sync": 0.1}}
    w = work.spmm(1_000_000, 1_000_000, 2_990_133, 64)
    facts = _facts(s, traced_calls=100, work_per_call=w, plan_build_s=9.5,
                   iters_per_solve=64.0)
    assert BENCH.reader("idle_share.stream").read(facts) == pytest.approx(20)
    assert BENCH.reader("allreduce_ms.dist").read(facts) == pytest.approx(1.0)
    assert BENCH.reader("plan_build_s").read(facts) == 9.5
    assert BENCH.reader("iters_per_solve").read(facts) == 64.0
    monkeypatch.setattr(work, "peaks", lambda kind: H100)
    facts["ctx"].device = torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d: "H100")
    share = BENCH.reader("spmm_roofline").read(facts)
    # 795.9 MB at 3.35 TB/s is 0.2376 ms, against 4 ms a call
    assert share == pytest.approx(100 * 0.23759 / 4.0, rel=1e-3)


def _us(name, a, b):
    return (name, int(a * 1e3), int(b * 1e3))


def test_summarize_union_idle_and_labels():
    device = [_us("k1", 10, 30), _us("k2", 20, 50),
              _us("ncclKernel_AllReduce", 70, 80), _us("before", -10, 5),
              _us("after", 120, 130)]
    spans = [_us("bench.sync", 60, 90), _us("bench.chunk", 0, 90),
             _us("bench.spmm", 1, 5)]
    s = trace.summarize((0, 100_000), device, spans)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["device_events"] == 4
    # union: [0,5] [10,50] [70,80] -> 55 us; summed: 5 + 20 + 30 + 10
    assert s["busy_s"] == pytest.approx(55e-6)
    assert s["device_sum_s"] == pytest.approx(65e-6)
    assert s["nccl_s"] == pytest.approx(10e-6)
    # gaps, by the span open where each starts: [5,10] and [50,70] under
    # bench.chunk, [80,100] under bench.sync
    assert s["idle"]["bench.chunk"] == pytest.approx(25e-6)
    assert s["idle"]["bench.sync"] == pytest.approx(20e-6)
    assert trace.top(s["ops"], 2) == [["k2", pytest.approx(30e-6)],
                                      ["k1", pytest.approx(20e-6)]]


def test_summarize_an_idle_stretch():
    s = trace.summarize((0, 1000), [], [_us("bench.solve", 0, 0.5)])
    assert s["busy_s"] == 0 and list(s["idle"]) == ["bench.solve"]
    assert s["idle"]["bench.solve"] == pytest.approx(1e-6)


def test_spans_only_inside_a_traced_stretch():
    t = trace.Tracer(True, torch.device("cpu"))
    with t.span("outside"):
        pass
    with t.stretch():
        with t.span("spmm"):
            pass
    assert t.summary is not None and t.summary["busy_s"] == 0
    assert set(t.summary["idle"]) <= {"bench.spmm", "host idle"}
    off = trace.Tracer(False, torch.device("cpu"))
    with off.stretch():
        pass
    assert off.summary is None
