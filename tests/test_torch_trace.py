"""The port's recorder (`sblas_tpu_torch/utils/trace.py`) and the spans
and counters each layer records: nothing touched while it is off; spans
nested through their parent index, with their names and attributes,
while it is on; the solver's blocking reads, the plan's route builds,
mode 2's collective bytes on four gloo ranks, the native library's load
and fallbacks; and the clock spans share with `time.time_ns()`."""

import contextlib
import multiprocessing
import time
import types
from collections import Counter

import numpy as np
import pytest
import torch

from sblas_tpu_torch import _kernels, ops, solvers
from sblas_tpu_torch.containers import CsrMatrix
from sblas_tpu_torch.io import native
from sblas_tpu_torch.io.generate import webbase_like
from sblas_tpu_torch.memory import host_resident_plan, spmm_um
from sblas_tpu_torch.ops import route
from sblas_tpu_torch.utils import trace


def _web(n=3000):
    return webbase_like(n=n, dtype=np.float32)


def _laplacian(n=400) -> CsrMatrix:
    """The SPD 1-D Laplacian (2 on the diagonal, -1 beside it)."""
    rows = [(i, j, 2.0 if i == j else -1.0) for i in range(n)
            for j in (i - 1, i, i + 1) if 0 <= j < n]
    row_ptr = np.searchsorted([r for r, _, _ in rows], np.arange(n + 1))
    return CsrMatrix(row_ptr.astype(np.int64),
                     np.array([c for _, c, _ in rows], dtype=np.int64),
                     np.array([v for _, _, v in rows]), (n, n))


def _stub_launches(monkeypatch):
    """`_kernels.launch` on the CPU: a library whose every launcher
    returns 0, the CUDA stream calls stood in for, a fresh counter."""
    lib = types.SimpleNamespace(sblas_lane_shuffle_f32=lambda *a: 0)
    monkeypatch.setattr(_kernels, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(_kernels, "LAUNCHED", Counter())


def _launch():
    _kernels.launch("sblas_lane_shuffle_f32", torch.device("cpu"),
                    torch.zeros(4), 4)


def test_off_touches_no_range_clock_or_span_list(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("touched while the recorder is off")

    A = _web(2000)
    hp = host_resident_plan(A, dtype=torch.float32,
                            hbm_budget_bytes=16 << 10, device="cpu")
    assert hp.n_bands > 3
    plan = ops.make_plan(A, op="spmm", device="cpu")
    vplan = ops.make_plan(A, op="spmv", device="cpu")
    _stub_launches(monkeypatch)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push", refuse)
    monkeypatch.setattr(trace, "time", types.SimpleNamespace(time_ns=refuse))
    monkeypatch.setattr(trace, "_Span", refuse)
    monkeypatch.setattr(trace, "Recorder", refuse)
    B = torch.rand((A.shape[1], 8))
    C = torch.rand((A.shape[0], 8))
    spmm_um(hp, B, 1.0, 1.0, C)
    ops.spmm(plan, B, 2.0, 1.0, C)
    res = solvers.pagerank(vplan, A.shape[0], tol=1e-6)
    _launch()
    assert res.iterations > 0 and hp.last_stream.bands == hp.n_bands


def test_on_spans_nest_with_names_and_attrs(monkeypatch):
    A = _web()
    _stub_launches(monkeypatch)
    with trace.recording() as rec:
        vplan = ops.make_plan(A, op="spmv", device="cpu")
        res = solvers.pagerank(vplan, A.shape[0], tol=1e-6, graph=False)
        plan = ops.make_plan(A, op="spmm", device="cpu", force="wcoo")
        ops.spmm(plan, torch.rand((A.shape[1], 8)), 1.0, 0.0)
        _launch()
    spans = rec.spans
    names = [s[0] for s in spans]
    assert all(end >= start for _, start, end, _, _ in spans)

    first = names.index("sblas.plan")
    assert spans[first][3] == -1
    assert spans[first][4] == {"op": "spmv", "dtype": torch.float32,
                               "kind": ops.choose_kind(A, op="spmv")}
    assert spans[first + 1][:1] == ("sblas.plan.choose",)
    assert spans[first + 1][3] == first

    solve = names.index("sblas.solve")
    assert spans[solve][3] == -1
    assert spans[solve][4] == {"solver": "pagerank", "graph": False,
                               "iterations": res.iterations,
                               "precond": None,
                               "executed": -(-res.iterations // 16) * 16}
    kids = {s[0] for s in spans if s[3] == solve}
    assert kids == {"sblas.solve.check", "sblas.solve.chunk",
                    "sblas.solve.flag", "sblas.solve.result"}
    for i, s in enumerate(spans):
        if s[0] == "sblas.spmv":
            assert spans[s[3]][0] == "sblas.solve.chunk"
            assert s[4] == {"plan": type(vplan).__name__}
        if s[3] >= 0:
            p = spans[s[3]]
            assert p[1] <= s[1] and s[2] <= p[2] and s[3] < i

    mm = names.index("sblas.spmm")
    assert spans[mm][4] == {"plan": "WcooPlan"} and spans[mm][3] == -1
    launch = spans[names.index("sblas.launch")]
    assert launch[4] == {"launcher": "sblas_lane_shuffle_f32"}
    assert rec.launches == 1 and rec.counters["host_syncs"] > 3


@pytest.mark.parametrize("chunk", [4, 16])
def test_pagerank_counts_its_blocking_reads(chunk):
    A = _web()
    plan = ops.make_plan(A, op="spmv", device="cpu")
    with trace.recording() as rec:
        res = solvers.pagerank(plan, A.shape[0], tol=1e-6, chunk=chunk)
    chunks = -(-res.iterations // chunk)
    # the entry check, a flag a chunk, the residual and the count
    assert rec.counters == {"host_syncs": 3 + chunks}
    flags = [s for s in rec.spans if s[0] == "sblas.solve.flag"]
    assert len(flags) == chunks


def test_cg_counts_its_blocking_reads():
    A = _laplacian()
    b = torch.ones(A.shape[0], dtype=torch.float64)
    with trace.recording() as rec:
        res = solvers.cg(A, b, tol=1e-8, chunk=8)
    assert res.converged
    assert rec.counters["host_syncs"] == 3 + -(-res.iterations // 8)
    solve = [s for s in rec.spans if s[0] == "sblas.solve"]
    assert solve[0][4]["solver"] == "cg"
    # the raw matrix is planned inside the solve
    kids = [s[0] for s in rec.spans if s[3] == rec.spans.index(solve[0])]
    assert kids[0] == "sblas.plan" and "sblas.solve.check" in kids


def test_routed_plan_records_its_route_builds_inside_the_plan():
    A = _web()
    with trace.recording() as rec:
        plan = ops.make_plan(A, force="routed", device="cpu")
    spans = rec.spans
    top = [i for i, s in enumerate(spans) if s[0] == "sblas.plan"]
    assert len(top) == 1 and spans[top[0]][4]["kind"] == "routed"
    assert "sblas.plan.choose" not in {s[0] for s in spans}
    routes = [s for s in spans if s[0] == "sblas.plan.route"]
    assert routes and all(s[4]["n"] > 0 for s in routes)
    for s in routes + [s for s in spans if s[0] == "sblas.plan.place"]:
        j = s[3]
        while spans[j][3] >= 0:
            j = spans[j][3]
        assert j == top[0]
    assert plan.shape == A.shape


def _mode2_rank(rank, world, store, k, queue):
    import torch.distributed as dist

    from sblas_tpu_torch.parallel import make_mesh, planned
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        A = webbase_like(n=3000, dtype=np.float32)
        shards = planned.partition_row_plans(A, world, op="spmm",
                                             device="cpu", rank=rank)
        mesh = make_mesh(world, device="cpu")
        B = torch.rand((A.shape[1], k), generator=torch.Generator()
                       .manual_seed(1))
        C = torch.rand((A.shape[0], k), generator=torch.Generator()
                       .manual_seed(2))
        got = {}
        for reduce in ("psum", "psum_scatter"):
            with trace.recording() as rec:
                planned.spmm_mode2_planned(shards, B, 1.0, 1.0, C, mesh,
                                           reduce=reduce)
            names = [s[0] for s in rec.spans]
            top = names.index("sblas.mode2")
            coll = ("sblas.dist.all_reduce" if reduce == "psum"
                    else "sblas.dist.reduce_scatter")
            kids = [s[0] for s in rec.spans if s[3] == top]
            got[reduce] = (rec.counters["collective_bytes"],
                           rec.spans[names.index(coll)][4]["bytes"], kids)
        queue.put((rank, A.shape[0], shards.band_rows, got))
    finally:
        dist.destroy_process_group()


def test_mode2_counts_its_collective_bytes_on_four_ranks(tmp_path):
    world, k = 4, 8
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_mode2_rank,
                         args=(r, world, str(tmp_path / "store"), k, queue))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        results = [queue.get(timeout=240) for _ in range(world)]
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    assert [p.exitcode for p in procs] == [0] * world
    for rank, m, band_rows, got in results:
        # the full-height partial: m + band_rows rows rounded up to
        # world x 128, k float32 columns
        m_full = -(-(m + band_rows) // (world * 128)) * (world * 128)
        for reduce, coll in (("psum", "sblas.dist.all_reduce"),
                             ("psum_scatter", "sblas.dist.reduce_scatter")):
            counted, attr, kids = got[reduce]
            assert counted == attr == m_full * k * 4
            assert kids == ["sblas.mode2.local", "sblas.mode2.partial",
                            coll, "sblas.mode2.fold"]


def test_native_load_records_whether_it_built(monkeypatch):
    ran = []
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_stale", lambda: True)
    monkeypatch.delenv("SBLAS_NO_NATIVE_BUILD", raising=False)
    monkeypatch.setattr(native.subprocess, "run",
                        lambda cmd, **kw: ran.append(cmd))
    with trace.recording() as rec:
        lib = native._load()
        native._load()
    assert len(ran) == 1 and ran[0][0] == "make"
    loads = [s for s in rec.spans if s[0] == "sblas.native.load"]
    assert len(loads) == 1
    assert loads[0][4] == {"built": True, "available": lib is not None}
    assert rec.counters["library_builds"] == 1


def test_native_load_without_a_build(monkeypatch):
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setenv("SBLAS_NO_NATIVE_BUILD", "1")
    monkeypatch.setattr(native, "_LIB_PATH", "/nonexistent/libsblasio.so")
    with trace.recording() as rec:
        assert native._load() is None
    assert rec.spans[0][4] == {"built": False, "available": False}
    assert "library_builds" not in rec.counters


def test_each_numpy_fallback_counts_once(monkeypatch):
    monkeypatch.setenv("SBLAS_NO_NATIVE", "1")
    src = np.array([0, 1], dtype=np.int32)
    with trace.recording() as rec:
        color = route.edge_color(src, src[::-1].copy(), 2, 2, 1)
    assert rec.counters == {"native_unavailable": 1}
    assert color.tolist() == [0, 0]
    out = np.zeros(4, dtype=np.int32)
    with trace.recording() as rec:
        native.scatter(out, np.array([2, 0]), np.array([5, 6], np.int32))
    assert rec.counters == {"native_unavailable": 1}
    assert out.tolist() == [6, 0, 5, 0]


def test_span_lies_between_two_clock_reads():
    with trace.recording() as rec:
        before = time.time_ns()
        with trace.span("sblas.test", n=1):
            time.sleep(0.01)
        after = time.time_ns()
    (name, start, end, parent, attrs), = rec.spans
    assert before <= start and end <= after and end - start >= 10_000_000
    assert (name, parent, attrs) == ("sblas.test", -1, {"n": 1})


def test_ranges_name_profiler_events_with_their_attrs():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof, \
            trace.recording(ranges=True) as rec:
        with trace.span("sblas.test", band=3):
            with trace.span("sblas.test.inner"):
                torch.ones(8).sum()
    names = {e.name for e in prof.events()}
    assert {"sblas.test band=3", "sblas.test.inner"} <= names
    assert [s[3] for s in rec.spans] == [-1, 0]


def test_recording_blocks_nest_and_restore():
    with trace.recording() as outer:
        trace.count("a")
        with trace.recording() as inner:
            trace.count("a", 2)
            with trace.span("sblas.x"):
                trace.current().set(k=1)
        trace.count("a")
    assert outer.counters == {"a": 2} and inner.counters == {"a": 2}
    assert inner.spans[0][0::4] == ("sblas.x", {"k": 1}) and not outer.spans
    # off again: nothing is kept, and setting attributes does nothing
    trace.count("a")
    with trace.span("sblas.y") as sp:
        sp.set(k=2)
        trace.current().set(k=3)
    assert outer.counters == {"a": 2} and not outer.spans
