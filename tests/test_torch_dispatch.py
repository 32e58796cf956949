"""Every product of a part goes through the one ops-level table.

A part is a shard, a band, a grid cell, a mode-1 block or a halo window.
Each path below multiplies its parts with `ops.spmm` / `ops.spmv` (or
`parallel.planned._local_spmm` / `_local_spmv`, which call them), so the
plan type alone picks the product's function and kernel (`ops._SPMM`,
`ops._SPMV`).  Each case wraps every entry of both tables with a recorder,
runs the path on the CPU at world size 1 (a collective over one rank
leaves its tensor as it is), and holds the result to the unwrapped run
bitwise and to a dense f64 oracle.
"""

import numpy as np
import pytest
import torch

from sblas_tpu_torch import memory, ops, parallel
from sblas_tpu_torch.io.generate import fem_banded_like, uniform_random
from sblas_tpu_torch.memory import dense as mdense
from sblas_tpu_torch.memory import dist as mdist
from sblas_tpu_torch.parallel import hier, planned
from sblas_tpu_torch.parallel.mesh import Mesh

F64 = torch.float64
CPU = torch.device("cpu")
ALPHA, BETA, K = 3.0, 4.0, 5
MESH = Mesh(None, 0, 1, CPU)


def _banded():
    return fem_banded_like(n=640, half_band=3, seed=5)


def _unstructured():
    return uniform_random(640, 520, nnz_per_row=4, seed=6)


def _operands(A, op):
    g = torch.Generator().manual_seed(A.nnz)
    m, n = A.shape
    if op == "spmv":
        return (torch.rand(n, generator=g, dtype=F64),
                torch.rand(m, generator=g, dtype=F64))
    return (torch.rand((n, K), generator=g, dtype=F64),
            torch.rand((m, K), generator=g, dtype=F64))


def _oracle(A, X, Y):
    return BETA * Y.numpy() + ALPHA * (A.to_dense() @ X.numpy())


def _mode1(A):
    plan = ops.make_plan(A, dtype=F64, force="coo", device=CPU)
    B, C = _operands(A, "spmm")
    return (lambda: parallel.spmm_mode1(plan, B, ALPHA, BETA, C, MESH),
            B, C)


def _mode2(kind, op):
    def build(A):
        sh = parallel.partition_row_plans(A, 1, dtype=F64, kind=kind,
                                          device=CPU)
        X, Y = _operands(A, op)
        fn = (parallel.spmm_mode2_planned if op == "spmm"
              else parallel.spmv_dist_planned)
        return lambda: fn(sh, X, ALPHA, BETA, Y, MESH), X, Y
    return build


def _hier(kind, op):
    def build(A):
        sh = parallel.partition_row_plans(A, 1, dtype=F64, kind=kind,
                                          device=CPU)
        mesh2 = hier.Mesh2(slices=MESH, chips=MESH, rank=0)
        X, Y = _operands(A, op)
        fn = (parallel.spmm_mode2_hier if op == "spmm"
              else parallel.spmv_dist_hier)
        return lambda: fn(sh, X, ALPHA, BETA, Y, mesh2), X, Y
    return build


def _halo(op):
    def build(A):
        sh = parallel.partition_halo_dia(A, 1, dtype=F64, device=CPU)
        X, Y = _operands(A, op)
        fn = (parallel.spmm_halo_planned if op == "spmm"
              else parallel.spmv_halo_planned)
        return lambda: fn(sh, X, ALPHA, BETA, Y, MESH), X, Y
    return build


def _um(kind, op):
    def build(A):
        hp = memory.host_resident_plan(A, dtype=F64, kind=kind,
                                       hbm_budget_bytes=48 << 10,
                                       device=CPU)
        assert hp.n_bands > 1
        X, Y = _operands(A, op)
        fn = memory.spmm_um if op == "spmm" else memory.spmv_um
        return lambda: fn(hp, X, ALPHA, BETA, Y), X, Y
    return build


def _hostdense(A):
    grid = mdense.host_resident_grid(A, dtype=F64, hbm_budget_bytes=48 << 10,
                                     k=K, kind="wcoo", device=CPU)
    assert grid.n_bands > 1
    B, C = _operands(A, "spmm")
    Bh, Ch = (mdense.HostDense.from_array(t, device=CPU) for t in (B, C))
    return (lambda: mdense.spmm_um_hostdense(grid, Bh, ALPHA, BETA,
                                             Ch).values, B, C)


def _um_dist(kind, op):
    def build(A):
        hs = mdist.host_resident_shards(A, 1, dtype=F64,
                                        hbm_budget_bytes=48 << 10,
                                        kind=kind, device=CPU)
        assert hs.n_bands > 1
        X, Y = _operands(A, op)
        fn = mdist.spmm_um_dist if op == "spmm" else mdist.spmv_um_dist
        return lambda: fn(hs, X, ALPHA, BETA, Y, MESH), X, Y
    return build


# name -> (matrix, path builder, the plan types its products must take)
PATHS = {
    "mode1": (_unstructured, _mode1, {("spmm", "CooPlan")}),
    "mode2_planned_spmm": (_unstructured, _mode2("ell", "spmm"),
                           {("spmm", "EllPlan")}),
    "mode2_planned_spmv": (_banded, _mode2("bsr", "spmv"),
                           {("spmv", "BsrPlan")}),
    "hier_spmm": (_unstructured, _hier("wcoo", "spmm"),
                  {("spmm", "WcooPlan")}),
    "hier_spmv": (_banded, _hier("dia", "spmv"), {("spmv", "DiaPlan")}),
    "halo_planned_spmv": (_banded, _halo("spmv"), {("spmv", "DiaPlan")}),
    "halo_planned_spmm": (_banded, _halo("spmm"), {("spmm", "DiaPlan")}),
    "spmm_um_bands": (_banded, _um("bsr", "spmm"), {("spmm", "BsrPlan")}),
    "spmv_um_bands": (_unstructured, _um("ell", "spmv"),
                      {("spmv", "EllPlan")}),
    "hostdense_grid": (_unstructured, _hostdense, {("spmm", "WcooPlan")}),
    "spmv_um_dist": (_unstructured, _um_dist("wcoo", "spmv"),
                     {("spmv", "WcooPlan")}),
    "spmm_um_dist": (_unstructured, _um_dist("coo", "spmm"),
                     {("spmm", "CooPlan")}),
}


@pytest.fixture
def one_rank(monkeypatch):
    """Collectives over the one-rank mesh: the sum of one partial."""
    for mod in (planned, hier, mdist):
        monkeypatch.setattr(mod, "all_reduce", lambda t, mesh: t)
    for mod in (planned, hier):
        monkeypatch.setattr(mod, "reduce_scatter", lambda t, mesh: t)


def _recorded_tables(monkeypatch) -> list:
    """Wrap every entry of `ops._SPMM` and `ops._SPMV`; returns the list
    of (op, plan type name) the wrapped entries see."""
    calls = []
    for op, table in (("spmm", ops._SPMM), ("spmv", ops._SPMV)):
        for cls, fn in list(table.items()):
            def wrapped(plan, *args, _fn=fn, _op=op):
                calls.append((_op, type(plan).__name__))
                return _fn(plan, *args)
            monkeypatch.setitem(table, cls, wrapped)
    return calls


@pytest.mark.parametrize("path", sorted(PATHS))
def test_part_products_go_through_the_ops_table(path, one_rank,
                                                monkeypatch):
    matrix, build, through = PATHS[path]
    A = matrix()
    run, X, Y = build(A)
    want = run()
    calls = _recorded_tables(monkeypatch)
    got = run()
    assert calls and set(calls) == through
    assert torch.equal(got, want)
    np.testing.assert_allclose(got.numpy(), _oracle(A, X, Y), rtol=1e-12,
                               atol=1e-12)


def _bell(path):
    def build(A):
        plan = ops.make_plan(A, dtype=F64, force="bsr", device=CPU)
        B, C = _operands(A, "spmm")
        if path == "single":
            return lambda: ops.spmm(plan, B, ALPHA, BETA, C)
        return lambda: parallel.spmm_mode1(plan, B, ALPHA, BETA, C, MESH)
    return build


# every BELL path, each product of its parts at K columns
BELL_PATHS = {
    "single": _bell("single"),
    "mode1": _bell("mode1"),
    "mode2_planned": lambda A: _mode2("bsr", "spmm")(A)[0],
    "hier": lambda A: _hier("bsr", "spmm")(A)[0],
    "bands": lambda A: _um("bsr", "spmm")(A)[0],
}


@pytest.mark.parametrize("path", sorted(BELL_PATHS))
def test_bell_parts_read_the_k4_gate(path, one_rank, monkeypatch):
    """Every BELL product, whole or of a part, asks `bsr.takes_k4` (K4's
    one gate) with its own K and device, and on a yes runs K4's entry
    (`spmm_bsr_pallas`, here recorded and answered by the plain
    version)."""
    from sblas_tpu_torch.ops import bsr
    asked, ran = [], []

    def gate(plan, k, on_cuda):
        asked.append((k, on_cuda))
        return True

    def k4(plan, *args):
        ran.append(type(plan).__name__)
        return bsr.spmm_bsr_plain(plan, *args)
    monkeypatch.setattr(bsr, "takes_k4", gate)
    monkeypatch.setattr(bsr, "spmm_bsr_pallas", k4)
    BELL_PATHS[path](_banded())()
    assert asked and set(asked) == {(K, False)}
    assert ran == ["BsrPlan"] * len(asked)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_coo_spmm_sums_into_one_rounding(dtype, one_rank):
    """`spmm_coo` keeps a bf16 plan's sums in f32 into the epilogue, which
    rounds once (`plans.fold`), as mode 1's COO blocks did; f32 is the
    plain expression beta*C + alpha*A@B, bit for bit."""
    from sblas_tpu_torch.ops.plans import fold
    from sblas_tpu_torch.ops.spmm import segment_spmm
    A = _unstructured()
    plan = ops.make_plan(A, dtype=dtype, force="coo", device=CPU)
    B, C = (t.to(dtype) for t in _operands(A, "spmm"))
    got = ops.spmm(plan, B, ALPHA, BETA, C)
    args = (plan.rows, plan.cols, plan.vals, B, A.shape[0])
    if dtype == torch.float32:
        want = BETA * C + ALPHA * segment_spmm(*args)
    else:
        want = fold(ALPHA, segment_spmm(*args, keep_sum=True), BETA, C,
                    dtype)
    assert got.dtype == dtype
    assert torch.equal(got, want)
    assert torch.equal(parallel.spmm_mode1(plan, B, ALPHA, BETA, C, MESH),
                       got)
