"""Port parity: `sblas_tpu_torch.solvers` against `sblas_tpu.solvers`
(mirrors tests/test_solvers.py), in float64 on the CPU.

The same systems go through both packages: the iteration counts are
equal and the solutions agree to 1e-10 relative, for a single plan, for
routed `RowPlanShards` and for `XFootShards` in a gloo group of one.  The
port's chunked loop (masked iterations past convergence) gives the
while_loop's answer whatever the chunk, the maxiter cap included."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from sblas_tpu import solvers as js
from sblas_tpu.config import SBlasConfig as JConfig
from sblas_tpu.containers import CooMatrix
from sblas_tpu.io.generate import fem_banded_like, webbase_like
from sblas_tpu.ops import make_plan as jmake_plan
from sblas_tpu.parallel import make_mesh as jmake_mesh
from sblas_tpu.parallel import partition_row_plans as jpartition_row_plans
from sblas_tpu.parallel import partition_xfoot as jpartition_xfoot
import sblas_tpu_torch.parallel as tpar
from sblas_tpu_torch import solvers as ts
from sblas_tpu_torch.config import SBlasConfig as TConfig
from sblas_tpu_torch.containers import CsrMatrix
from sblas_tpu_torch.ops import make_plan, spmv
from sblas_tpu_torch.utils.errors import KernelError, PartitionError

# routed shards at these small sizes (tests/test_torch_parallel.py's)
ROUTED = dict(routed_min_nnz=1000, routed_min_width=512)
F64 = torch.float64


def _port(A):
    return CsrMatrix(A.row_ptr, A.col_idx, A.values, A.shape)


def _spd(n=600, half_band=4):
    """Banded pattern symmetrized + diagonally dominant shift."""
    A = fem_banded_like(n=n, half_band=half_band, dtype=np.float64)
    coo = A.to_coo()
    rows = np.concatenate([coo.row_idx, coo.col_idx])
    cols = np.concatenate([coo.col_idx, coo.row_idx])
    vals = np.concatenate([coo.values, coo.values])
    rowsum = np.zeros(n)
    np.add.at(rowsum, rows, np.abs(vals))
    d = np.arange(n)
    return CooMatrix(np.concatenate([rows, d]), np.concatenate([cols, d]),
                     np.concatenate([vals, 1.0 + rowsum]),
                     (n, n)).to_csr()


def _nonsym(n=800, seed=5):
    """Nonsymmetric directed-graph pattern + diagonal dominance."""
    G = webbase_like(n=n, avg_deg=4.0, seed=seed, local_scale=40.0,
                     dtype=np.float64)
    coo = G.to_coo()
    rowsum = np.zeros(n)
    np.add.at(rowsum, coo.row_idx, np.abs(coo.values))
    d = np.arange(n)
    return CooMatrix(np.concatenate([coo.row_idx, d]),
                     np.concatenate([coo.col_idx, d]),
                     np.concatenate([coo.values, 1.0 + rowsum]),
                     (n, n)).to_csr()


def _web(n=3000):
    """(P^T, dangling) of a small webbase graph."""
    G = webbase_like(n=n, avg_deg=3.0, seed=11, local_scale=60.0,
                     dtype=np.float64)
    coo = G.to_coo()
    outdeg = np.maximum(G.row_nnz, 1).astype(np.float64)
    PT = CooMatrix(coo.col_idx, coo.row_idx, 1.0 / outdeg[coo.row_idx],
                   (n, n)).to_csr()
    return PT, (G.row_nnz == 0).astype(np.float64)


@functools.lru_cache(maxsize=None)
def _system(name):
    A = {"spd": _spd, "nonsym": _nonsym}[name]()
    rng = np.random.RandomState(7)
    x_true = rng.standard_normal(A.shape[0])
    return A, x_true, A.to_dense() @ x_true


def _same(port, jax_res, rel=1e-10):
    """Equal iteration counts and converged flags; x within rel."""
    want = np.asarray(jax_res.x)
    got = port.x.numpy()
    assert port.iterations == int(jax_res.iterations)
    assert port.converged == bool(jax_res.converged)
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """A gloo group of one made through a FileStore, destroyed at
    teardown."""
    store = tmp_path_factory.mktemp("store") / "s"
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        yield tpar.make_mesh(1, device="cpu")
    finally:
        dist.destroy_process_group()


def _forms(form, A, mesh):
    """(port operand, JAX operand, JAX mesh) for a single plan, routed
    row-plan shards or xfoot shards."""
    T = _port(A)
    if form == "plan":
        return (make_plan(T, dtype=F64, op="spmv", device="cpu"),
                jmake_plan(A, dtype=jnp.float64, op="spmv"), None)
    jmesh = jmake_mesh(1)
    if form == "rowplan_routed":
        return (tpar.partition_row_plans(T, 1, dtype=F64, kind="routed",
                                         config=TConfig(**ROUTED),
                                         device="cpu"),
                jpartition_row_plans(A, 1, dtype=jnp.float64, kind="routed",
                                     config=JConfig(**ROUTED)), jmesh)
    return (tpar.partition_xfoot(T, 1, dtype=F64, device="cpu"),
            jpartition_xfoot(A, 1, dtype=jnp.float64), jmesh)


@pytest.mark.parametrize("form", ["plan", "rowplan_routed", "xfoot"])
@pytest.mark.parametrize("solver", ["cg", "bicgstab", "pagerank"])
def test_solver_matches_jax(world1, solver, form):
    mesh = world1 if form != "plan" else None
    if solver == "pagerank":
        PT, dang = _web()
        op, jop, jmesh = _forms(form, PT, mesh)
        n = PT.shape[0]
        got = ts.pagerank(op, n, dangling=torch.from_numpy(dang),
                          tol=1e-12, maxiter=500, mesh=mesh,
                          r0=torch.full((n,), 1.0 / n, dtype=F64))
        want = js.pagerank(jop, n, dangling=jnp.asarray(dang), tol=1e-12,
                           maxiter=500, mesh=jmesh,
                           r0=jnp.full(n, 1.0 / n, jnp.float64))
        assert got.converged and abs(got.x.sum().item() - 1.0) < 1e-9
    else:
        A, x_true, b = _system("spd")
        op, jop, jmesh = _forms(form, A, mesh)
        fn = {"cg": (ts.cg, js.cg), "bicgstab": (ts.bicgstab,
                                                 js.bicgstab)}[solver]
        got = fn[0](op, torch.from_numpy(b), tol=1e-10, maxiter=3000,
                    mesh=mesh)
        want = fn[1](jop, jnp.asarray(b), tol=1e-10, maxiter=3000,
                     mesh=jmesh)
        assert got.converged
        np.testing.assert_allclose(got.x.numpy(), x_true, rtol=1e-6,
                                   atol=1e-8)
    _same(got, want)


def test_cg_single_chip():
    A, x_true, b = _system("spd")
    plan = make_plan(_port(A), dtype=F64, op="spmv", device="cpu")
    res = ts.cg(plan, torch.from_numpy(b), tol=1e-10, maxiter=3000)
    assert isinstance(res, ts.SolveResult)
    assert res.converged and 0 < res.iterations < 3000
    assert res.residual <= 1e-10 * 1.01
    np.testing.assert_allclose(res.x.numpy(), x_true, rtol=1e-6, atol=1e-8)


@pytest.mark.parametrize("maxiter", [2, 7, 16, 21])
def test_cg_maxiter_cap_and_chunk_boundary(maxiter):
    """The cap stops at exactly maxiter whether or not it falls on a
    chunk boundary (16), with the JAX package's iterate."""
    A, _, b = _system("spd")
    plan = make_plan(_port(A), dtype=F64, op="spmv", device="cpu")
    res = ts.cg(plan, torch.from_numpy(b), tol=1e-14, maxiter=maxiter)
    assert res.iterations == maxiter and not res.converged
    _same(res, js.cg(jmake_plan(A, dtype=jnp.float64, op="spmv"),
                     jnp.asarray(b), tol=1e-14, maxiter=maxiter))


@pytest.mark.parametrize("chunk", [1, 5, 64])
def test_chunk_size_does_not_change_the_answer(chunk):
    A, _, b = _system("nonsym")
    plan = make_plan(_port(A), dtype=F64, op="spmv", device="cpu")
    ref = ts.bicgstab(plan, torch.from_numpy(b), tol=1e-10, maxiter=2000)
    res = ts.bicgstab(plan, torch.from_numpy(b), tol=1e-10, maxiter=2000,
                      chunk=chunk)
    assert res.iterations == ref.iterations and torch.equal(res.x, ref.x)


def test_cg_callable_and_jacobi_preconditioner():
    A, x_true, b = _system("spd")
    plan = make_plan(_port(A), dtype=F64, op="spmv", device="cpu")

    def mv(v):
        return spmv(plan, v, 1.0, 0.0, torch.zeros_like(v))

    coo = A.to_coo()
    diag = np.zeros(A.shape[0])
    sel = coo.row_idx == coo.col_idx
    diag[coo.row_idx[sel]] = coo.values[sel]
    inv_d = torch.from_numpy(1.0 / diag)
    bt = torch.from_numpy(b)
    plain = ts.cg(mv, bt, tol=1e-10, maxiter=3000)
    pre = ts.cg(mv, bt, tol=1e-10, maxiter=3000, M=lambda v: inv_d * v)
    assert plain.converged and pre.converged
    assert pre.iterations <= plain.iterations  # Jacobi can't hurt here
    np.testing.assert_allclose(pre.x.numpy(), x_true, rtol=1e-6, atol=1e-8)
    jinv = jnp.asarray(1.0 / diag)
    _same(pre, js.cg(jmake_plan(A, dtype=jnp.float64, op="spmv"),
                     jnp.asarray(b), tol=1e-10, maxiter=3000,
                     M=lambda v: jinv * v))


def test_cg_array_M_and_jacobi_helper():
    A, x_true, b = _system("spd")
    plan = make_plan(_port(A), dtype=F64, op="spmv", device="cpu")
    inv_d = ts.jacobi_inv_diag(_port(A), dtype=F64, device="cpu")
    np.testing.assert_array_equal(
        inv_d.numpy(), np.asarray(js.jacobi_inv_diag(A, dtype=jnp.float64)))
    bt = torch.from_numpy(b)
    res_arr = ts.cg(plan, bt, tol=1e-10, maxiter=3000, M=inv_d)
    res_fn = ts.cg(plan, bt, tol=1e-10, maxiter=3000,
                   M=lambda v: inv_d * v)
    assert res_arr.converged and res_arr.iterations == res_fn.iterations
    np.testing.assert_allclose(res_arr.x.numpy(), x_true, rtol=1e-6,
                               atol=1e-8)


def test_cg_distributed_shards(world1):
    A, x_true, b = _system("spd")
    shards = tpar.partition_row_plans(_port(A), 1, dtype=F64, op="spmv",
                                      device="cpu")
    res = ts.cg(shards, torch.from_numpy(b), tol=1e-10, maxiter=3000,
                mesh=world1)
    assert res.converged
    np.testing.assert_allclose(res.x.numpy(), x_true, rtol=1e-6, atol=1e-8)
    with pytest.raises(PartitionError, match="mesh="):
        ts.cg(shards, torch.from_numpy(b))


def test_cg_xfoot_shards(world1):
    A, x_true, b = _system("spd")
    shards = tpar.partition_xfoot(_port(A), 1, dtype=F64, device="cpu")
    res = ts.cg(shards, torch.from_numpy(b), tol=1e-10, maxiter=3000,
                mesh=world1)
    assert res.converged
    np.testing.assert_allclose(res.x.numpy(), x_true, rtol=1e-6, atol=1e-8)


def test_pagerank_matches_numpy_power_iteration():
    PT, dangling = _web()
    n = PT.shape[0]
    plan = make_plan(_port(PT), dtype=F64, op="spmv", device="cpu")
    res = ts.pagerank(plan, n, dangling=torch.from_numpy(dangling),
                      damping=0.85, tol=1e-12, maxiter=500,
                      r0=torch.full((n,), 1.0 / n, dtype=F64))
    assert res.converged and res.iterations < 500
    r = res.x.numpy()
    assert abs(r.sum() - 1.0) < 1e-9
    dense = PT.to_dense()
    rr = np.full(n, 1.0 / n)
    for _ in range(500):
        r_new = 0.85 * (dense @ rr + dangling @ rr / n) + 0.15 / n
        if np.abs(r_new - rr).sum() <= 1e-12:
            rr = r_new
            break
        rr = r_new
    np.testing.assert_allclose(r, rr, rtol=1e-8, atol=1e-12)


def test_bicgstab_nonsymmetric():
    A, x_true, b = _system("nonsym")
    dense = A.to_dense()
    assert not np.allclose(dense, dense.T)  # genuinely nonsymmetric
    plan = make_plan(_port(A), dtype=F64, op="spmv", device="cpu")
    # at tol 1e-10 the two packages' iterates (their sums run in other
    # orders) still differ by 9e-10; at 1e-12 both are that close to x
    res = ts.bicgstab(plan, torch.from_numpy(b), tol=1e-12, maxiter=2000)
    assert res.converged and res.iterations < 2000
    np.testing.assert_allclose(res.x.numpy(), x_true, rtol=1e-6, atol=1e-8)
    _same(res, js.bicgstab(jmake_plan(A, dtype=jnp.float64, op="spmv"),
                           jnp.asarray(b), tol=1e-12, maxiter=2000))


def test_bicgstab_distributed_matches_cg_on_spd(world1):
    A, x_true, b = _system("spd")
    shards = tpar.partition_xfoot(_port(A), 1, dtype=F64, device="cpu")
    res = ts.bicgstab(shards, torch.from_numpy(b), tol=1e-10, maxiter=3000,
                      mesh=world1)
    assert res.converged
    np.testing.assert_allclose(res.x.numpy(), x_true, rtol=1e-6, atol=1e-8)


def test_cg_accepts_raw_csr():
    """A raw CsrMatrix is planned on b's device (dtype follows b)."""
    A = _spd(n=400)
    rng = np.random.RandomState(1)
    x_true = rng.standard_normal(A.shape[0])
    res = ts.cg(_port(A), torch.from_numpy(A.to_dense() @ x_true),
                tol=1e-10, maxiter=2000)
    assert res.converged
    np.testing.assert_allclose(res.x.numpy(), x_true, rtol=1e-6, atol=1e-8)


def test_cg_repeat_solves_reuse_the_program():
    """cg() in a loop over right-hand sides: each solve is right, and the
    CPU, which never captures, caches nothing (on a card the loop reuses
    one captured graph: tests/test_torch_kernels_cuda.py)."""
    A, x_true, b = _system("spd")
    plan = make_plan(_port(A), dtype=F64, op="spmv", device="cpu")
    ts.clear_programs()
    r1 = ts.cg(plan, torch.from_numpy(b), tol=1e-10, maxiter=3000)
    r2 = ts.cg(plan, torch.from_numpy(b * 2.0), tol=1e-10, maxiter=3000)
    assert r1.converged and r2.iterations == r1.iterations
    np.testing.assert_allclose(r2.x.numpy(), 2.0 * x_true, rtol=1e-6,
                               atol=1e-8)
    assert not ts._PROGRAMS and ts.captures() == 0


def _small_plans(k):
    A = _port(_spd(n=200))
    return [make_plan(A, dtype=F64, op="spmv", device="cpu")
            for _ in range(k)]


def _cache_key(plan):
    return ts._key("cg", ts._matvec_of(plan), (200,), F64, "cuda:0")


def test_program_cache_holds_no_plan():
    """A cached capture lives as long as its plan: the cache keeps no
    reference to it, and the plan's collection drops its entries."""
    import gc
    import weakref
    ts.clear_programs()
    plans = _small_plans(3)
    progs = [ts._graph_program(_cache_key(p), (p,)) for p in plans]
    assert len(ts._PROGRAMS) == 3
    assert ts._graph_program(_cache_key(plans[1]), (plans[1],)) is progs[1]
    gone = weakref.ref(plans[1])
    del plans[1]
    gc.collect()
    assert gone() is None and len(ts._PROGRAMS) == 2
    assert progs[1] not in ts._PROGRAMS.values()
    plans.clear()
    gc.collect()
    assert not ts._PROGRAMS and not ts._WATCHED


def test_program_cache_over_many_plans_is_bounded():
    """Solving over more live plans than MAX_PROGRAMS keeps the most
    recently used captures only."""
    ts.clear_programs()
    plans = _small_plans(ts.MAX_PROGRAMS + 3)
    keys = [_cache_key(p) for p in plans]
    for k, p in zip(keys, plans):
        ts._graph_program(k, (p,))
    assert len(ts._PROGRAMS) == ts.MAX_PROGRAMS
    assert list(ts._PROGRAMS) == keys[3:]
    ts._graph_program(keys[3], (plans[3],))       # used again: kept last
    ts._graph_program(keys[0], (plans[0],))       # back in, keys[4] out
    assert list(ts._PROGRAMS)[-2:] == [keys[3], keys[0]]
    assert keys[4] not in ts._PROGRAMS
    ts.clear_programs()


@pytest.mark.parametrize("form", ["raw_csr", "shards", "no_weakref",
                                  "precond_dies"])
def test_program_cache_skips_what_it_cannot_keep(form, world1):
    """A raw CsrMatrix (planned inside the call) and distributed shards
    have no cache key; an owner without weak references gets a capture
    for its solve only; a preconditioner callable's collection drops the
    captures that read it."""
    import gc
    ts.clear_programs()
    A = _port(_spd(n=200))
    plan = _small_plans(1)[0]
    if form == "raw_csr":
        f = ts._matvec_of(A, device="cpu", dtype=F64)
        assert f.key is None and ts._key("cg", f) is None
        ts._graph_program(ts._key("cg", f), (f.owner,))
    elif form == "shards":
        sh = tpar.partition_row_plans(A, 1, dtype=F64, device="cpu")
        f = ts._matvec_of(sh, mesh=world1)
        assert f.key is None and not f.local
    elif form == "no_weakref":
        prog = ts._graph_program(("cg", ("user", 7)), (7,))
        assert prog not in ts._PROGRAMS.values()
    else:
        def M(v):
            return v
        ts._graph_program(_cache_key(plan) + (id(M),), (plan, M))
        assert len(ts._PROGRAMS) == 1
        del M
        gc.collect()
    assert not ts._PROGRAMS
    ts.clear_programs()


def test_graph_requests_that_cannot_hold_raise(world1):
    A, _, b = _system("spd")
    bt = torch.from_numpy(b)
    shards = tpar.partition_xfoot(_port(A), 1, dtype=F64, device="cpu")
    with pytest.raises(PartitionError, match="graph=True"):
        ts.cg(shards, bt, mesh=world1, graph=True)
    plan = make_plan(_port(A), dtype=F64, op="spmv", device="cpu")
    with pytest.raises(KernelError, match="CUDA"):
        ts.cg(plan, bt, graph=True)
