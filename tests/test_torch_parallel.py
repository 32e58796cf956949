"""Port parity of the distribution layer: kernel K2' (tile gather), every
distributed mode per rank, in a group of one and in a group of four
(gloo on the CPU), the process-group bootstrap and the distributed CLIs.

Results are held against the JAX package (make_mesh(1), make_mesh(4),
make_mesh2(2, 2)) to 1e-12 in f64, and against the numpy oracle; the
bf16-transport cases (f32 values, bf16 contributions) to f32 summation
order, 1e-5 relative, and the oracle at the transport's 1e-2 relative; the
`bf16_*` cases (bf16 values) on the bf16 grid, within 2^-7 normwise of the
JAX package's bf16 result, both at the oracle's rtol = atol = 0.15.  The
four-rank results come from one spawned run of
`sblas_tpu_torch.parallel.dryrun.dryrun_multichip(4)`, which also checks
every case against the oracle on every rank."""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.experimental import pallas as pl

import sblas_tpu.memory as jmem
import sblas_tpu.ops as jops
from sblas_tpu import parallel as jpar
from sblas_tpu.config import SBlasConfig as JConfig
from sblas_tpu.containers import CsrMatrix as JCsrMatrix
from sblas_tpu.containers import DenseMatrix, DenseVector
from sblas_tpu.io import generate as jgen
from sblas_tpu.io.mmio import write_mtx
from sblas_tpu.ops import rspmv as jr
from sblas_tpu.ops.cpu_reference import spmm_cpu, spmv_cpu
from sblas_tpu.partition import (partition_nnz_balanced as j_nnz_balanced,
                                 partition_row_blocks as j_row_blocks)
from sblas_tpu_torch import parallel as tpar
from sblas_tpu_torch.cli import spmm_test, spmv_test
from sblas_tpu_torch.cli.common import devices_to_use
from sblas_tpu_torch.config import SBlasConfig as TConfig
from sblas_tpu_torch.containers import CsrMatrix
from sblas_tpu_torch.ops import rspmv as tr
from sblas_tpu_torch.parallel import dryrun
from sblas_tpu_torch.parallel.mesh import Mesh, ring_exchange
from sblas_tpu_torch.partition import partition_nnz_balanced
from sblas_tpu_torch.utils.errors import KernelError, PartitionError
from sblas_tpu_torch.utils.verify import check_equal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
A_, B_ = dryrun.ALPHA, dryrun.BETA
F64 = jnp.float64

# every case of dryrun.run_cases and the oracle it is held against
ORACLE = {
    "mode1": "mm", "mode1_wcoo": "mmU",
    "mode2_psum": "mm", "mode2_psum_scatter": "mm",
    "dist_psum": "mv", "dist_psum_scatter": "mv", "halo": "mv",
    **{f"planned_{k}_spmm": "mm" for k in dryrun.PLANNED_KINDS},
    **{f"planned_{k}_spmv": "mv" for k in dryrun.PLANNED_KINDS},
    "planned_routed_psum": "mvU", "planned_routed_psum_scatter": "mvU",
    "halo_planned_spmv": "mv", "halo_planned_spmm": "mm",
    "hier_spmm": "mm", "hier_spmv": "mv", "hier_routed_spmv": "mvU",
    "xfoot": "mv", "xfoot_route": "mvW", "xfoot_routed": "mvU",
    "planned_routed_bf16": "mvU", "hier_routed_bf16": "mvU",
    "xfoot_routed_bf16": "mvU",
    **{f"um_{op}_t{t}": oracle for t in (0, 1)
       for op, oracle in (("spmv_dist", "mvW"), ("spmm_dist", "mmW"),
                          ("mode1", "mm"))},
    "bf16_mode1_wcoo": "mmU", "bf16_mode2_psum": "mm",
    "bf16_dist_psum_scatter": "mv", "bf16_halo": "mv",
    **{f"bf16_planned_{k}_spmm": "mm" for k in dryrun.PLANNED_KINDS},
    "bf16_planned_routed_spmv": "mvU", "bf16_hier_routed_spmv": "mvU",
    "bf16_hier_spmm": "mm", "bf16_halo_planned_spmm": "mm",
    "bf16_xfoot": "mv", "bf16_xfoot_routed": "mvU",
    "bf16_um_spmv_dist": "mvW", "bf16_um_spmm_dist": "mmW",
    "bf16_um_mode1": "mm",
}
# bf16_* cases: the port's result against the JAX package's, normwise
BF16_NORMWISE = 2.0 ** -7
CASES = sorted(ORACLE)


def _jax_csr(A):
    return JCsrMatrix(A.row_ptr, A.col_idx, A.values, A.shape)


def _port(A):
    return CsrMatrix(A.row_ptr, A.col_idx, A.values, A.shape)


@functools.lru_cache(maxsize=None)
def _operands(n):
    op = dryrun.case_operands(n)
    A, U, W = (_jax_csr(op[k]) for k in ("A", "U", "W"))
    d = {k: jnp.asarray(v.values) for k, v in op.items()
         if k not in ("A", "U", "W")}
    want = dict(mm=spmm_cpu(A, op["B"], A_, B_, op["C"]),
                mv=spmv_cpu(A, op["x"], A_, B_, op["y"]),
                mmU=spmm_cpu(U, op["BU"], A_, B_, op["CU"]),
                mvU=spmv_cpu(U, op["xU"], A_, B_, op["yU"]),
                mvW=spmv_cpu(W, op["xW"], A_, B_, op["yW"]),
                mmW=spmm_cpu(W, op["BW"], A_, B_, op["CW"]))
    return A, U, W, d, want


@functools.lru_cache(maxsize=None)
def _jax_cases(n):
    """The JAX package's result of every dryrun case on n devices."""
    A, U, W, d, _ = _operands(n)
    mesh = jpar.make_mesh(n)
    B, C, x, y = d["B"], d["C"], d["x"], d["y"]
    xU, yU = d["xU"], d["yU"]
    out = {
        "mode1": jpar.spmm_mode1(jops.make_plan(A, dtype=F64), B, A_, B_, C,
                                 mesh),
        "mode1_wcoo": jpar.spmm_mode1(
            jops.make_plan(U, dtype=F64, force="wcoo"), d["BU"], A_, B_,
            d["CU"], mesh),
    }
    segs = j_nnz_balanced(A, n, dtype=F64)
    for reduce in ("psum", "psum_scatter"):
        out[f"mode2_{reduce}"] = jpar.spmm_mode2(segs, B, A_, B_, C, mesh,
                                                 reduce=reduce)
        out[f"dist_{reduce}"] = jpar.spmv_dist(segs, x, A_, B_, y, mesh,
                                               reduce=reduce)
    out["halo"] = jpar.spmv_halo(j_row_blocks(A, n, dtype=F64), x, A_, B_,
                                 y, mesh)
    for kind in dryrun.PLANNED_KINDS:
        sh = jpar.partition_row_plans(A, n, dtype=F64, kind=kind)
        out[f"planned_{kind}_spmm"] = jpar.spmm_mode2_planned(
            sh, B, A_, B_, C, mesh, reduce="psum")
        out[f"planned_{kind}_spmv"] = jpar.spmv_dist_planned(
            sh, x, A_, B_, y, mesh, reduce="psum_scatter")
    routed = jpar.partition_row_plans(U, n, dtype=F64, kind="routed",
                                      config=JConfig(**dryrun.ROUTED_CONFIG))
    for reduce in ("psum", "psum_scatter"):
        out[f"planned_routed_{reduce}"] = jpar.spmv_dist_planned(
            routed, xU, A_, B_, yU, mesh, reduce=reduce)
    hs = jpar.partition_halo_dia(A, n, dtype=F64)
    out["halo_planned_spmv"] = jpar.spmv_halo_planned(hs, x, A_, B_, y, mesh)
    out["halo_planned_spmm"] = jpar.spmm_halo_planned(hs, B, A_, B_, C, mesh)
    mesh2 = jpar.make_mesh2(*dryrun.hier_split(n))
    sh = jpar.partition_row_plans(A, n, dtype=F64)
    out["hier_spmm"] = jpar.spmm_mode2_hier(sh, B, A_, B_, C, mesh2)
    out["hier_spmv"] = jpar.spmv_dist_hier(sh, x, A_, B_, y, mesh2)
    out["hier_routed_spmv"] = jpar.spmv_dist_hier(routed, xU, A_, B_, yU,
                                                  mesh2)
    out["xfoot"] = jpar.spmv_xfoot(jpar.partition_xfoot(A, n, dtype=F64),
                                   x, A_, B_, y, mesh)
    out["xfoot_route"] = jpar.spmv_xfoot(
        jpar.partition_xfoot(W, n, dtype=F64, kind="coo", extract="route"),
        d["xW"], A_, B_, d["yW"], mesh)
    out["xfoot_routed"] = jpar.spmv_xfoot(
        jpar.partition_xfoot(U, n, dtype=F64, kind="routed", extract="route",
                             config=JConfig(**dryrun.ROUTED_CONFIG)),
        xU, A_, B_, yU, mesh)
    cfg16 = JConfig(routed_transport="bf16", **dryrun.ROUTED_CONFIG)
    xU32, yU32 = xU.astype(jnp.float32), yU.astype(jnp.float32)
    r16 = jpar.partition_row_plans(U, n, dtype=jnp.float32, kind="routed",
                                   config=cfg16)
    out["planned_routed_bf16"] = jpar.spmv_dist_planned(
        r16, xU32, A_, B_, yU32, mesh)
    out["hier_routed_bf16"] = jpar.spmv_dist_hier(r16, xU32, A_, B_, yU32,
                                                  mesh2)
    out["xfoot_routed_bf16"] = jpar.spmv_xfoot(
        jpar.partition_xfoot(U, n, dtype=jnp.float32, kind="routed",
                             extract="route", config=cfg16),
        xU32, A_, B_, yU32, mesh)
    hs = jmem.host_resident_shards(W, n, dtype=F64,
                                   hbm_budget_bytes=dryrun.UM_BUDGET["W"])
    hp = jmem.host_resident_plan(A, dtype=F64,
                                 hbm_budget_bytes=dryrun.UM_BUDGET["A"])
    for t in (0, 1):
        out[f"um_spmv_dist_t{t}"] = jmem.spmv_um_dist(
            hs, d["xW"], A_, B_, d["yW"], mesh, tuning=bool(t))
        out[f"um_spmm_dist_t{t}"] = jmem.spmm_um_dist(
            hs, d["BW"], A_, B_, d["CW"], mesh, tuning=bool(t))
        out[f"um_mode1_t{t}"] = jmem.spmm_um_mode1(hp, B, A_, B_, C, mesh,
                                                   tuning=bool(t))
    out.update(_jax_bf16_cases(n, mesh, mesh2))
    return {k: np.asarray(jax.device_get(v)) for k, v in out.items()}


def _jax_bf16_cases(n, mesh, mesh2):
    """The JAX package's result of every `bf16_*` case (dryrun.bf16_cases),
    the dense operands rounded to bf16 through f32."""
    A, U, W, d, _ = _operands(n)
    bf = jnp.bfloat16
    d = {k: v.astype(jnp.float32).astype(bf) for k, v in d.items()}
    B, C, x, y = d["B"], d["C"], d["x"], d["y"]
    routed = JConfig(**dryrun.ROUTED_CONFIG)
    out = {"bf16_mode1_wcoo": jpar.spmm_mode1(
        jops.make_plan(U, dtype=bf, force="wcoo"), d["BU"], A_, B_, d["CU"],
        mesh)}
    segs = j_nnz_balanced(A, n, dtype=bf)
    out["bf16_mode2_psum"] = jpar.spmm_mode2(segs, B, A_, B_, C, mesh)
    out["bf16_dist_psum_scatter"] = jpar.spmv_dist(
        segs, x, A_, B_, y, mesh, reduce="psum_scatter")
    out["bf16_halo"] = jpar.spmv_halo(j_row_blocks(A, n, dtype=bf), x, A_,
                                      B_, y, mesh)
    for kind in dryrun.PLANNED_KINDS:
        out[f"bf16_planned_{kind}_spmm"] = jpar.spmm_mode2_planned(
            jpar.partition_row_plans(A, n, dtype=bf, kind=kind), B, A_, B_,
            C, mesh)
    sh = jpar.partition_row_plans(U, n, dtype=bf, kind="routed",
                                  config=routed)
    out["bf16_planned_routed_spmv"] = jpar.spmv_dist_planned(
        sh, d["xU"], A_, B_, d["yU"], mesh, reduce="psum_scatter")
    out["bf16_hier_routed_spmv"] = jpar.spmv_dist_hier(
        sh, d["xU"], A_, B_, d["yU"], mesh2)
    out["bf16_hier_spmm"] = jpar.spmm_mode2_hier(
        jpar.partition_row_plans(A, n, dtype=bf), B, A_, B_, C, mesh2)
    out["bf16_halo_planned_spmm"] = jpar.spmm_halo_planned(
        jpar.partition_halo_dia(A, n, dtype=bf), B, A_, B_, C, mesh)
    out["bf16_xfoot"] = jpar.spmv_xfoot(jpar.partition_xfoot(A, n, dtype=bf),
                                        x, A_, B_, y, mesh)
    out["bf16_xfoot_routed"] = jpar.spmv_xfoot(
        jpar.partition_xfoot(U, n, dtype=bf, kind="routed", extract="route",
                             config=routed), d["xU"], A_, B_, d["yU"], mesh)
    hs = jmem.host_resident_shards(W, n, dtype=bf,
                                   hbm_budget_bytes=dryrun.UM_BUDGET["W"])
    out["bf16_um_spmv_dist"] = jmem.spmv_um_dist(hs, d["xW"], A_, B_,
                                                 d["yW"], mesh)
    out["bf16_um_spmm_dist"] = jmem.spmm_um_dist(hs, d["BW"], A_, B_,
                                                 d["CW"], mesh)
    hp = jmem.host_resident_plan(A, dtype=bf,
                                 hbm_budget_bytes=dryrun.UM_BUDGET["A"])
    out["bf16_um_mode1"] = jmem.spmm_um_mode1(hp, B, A_, B_, C, mesh)
    assert all(v.dtype == bf for v in out.values())
    return out


def _assert_case(n, name, got):
    want_j = _jax_cases(n)[name]
    oracle = _operands(n)[4][ORACLE[name]]
    assert got.shape == want_j.shape == oracle.shape
    if name.startswith("bf16_"):
        # bf16 results come back as float32 (numpy has no bfloat16)
        assert got.dtype == np.float32
        assert np.array_equal(got, got.astype(jnp.bfloat16).astype(
            np.float32))
        want_j = want_j.astype(np.float32)
        gap = np.linalg.norm(got - want_j) / np.linalg.norm(want_j)
        assert gap <= BF16_NORMWISE, gap
        for v in (got, want_j):
            assert np.all(np.abs(v - oracle)
                          <= dryrun.BF16_TOL * (1 + np.abs(oracle)))
        return
    if name.endswith("_bf16"):
        assert got.dtype == np.float32
        assert check_equal(got, want_j, error_bar=1e-5, relative=True).ok
        assert all(check_equal(v, oracle, error_bar=dryrun.TRANSPORT_BAR,
                               relative=True).ok for v in (got, want_j))
        return
    np.testing.assert_allclose(got, want_j, rtol=1e-12, atol=1e-12)
    assert check_equal(got, oracle).ok and check_equal(want_j, oracle).ok


# ---- kernel K2': the tile gather ----

def _jax_tile_gather(x_tiles, gidx, gvals):
    """JAX's `_tile_gather_kernel` with the block specs of its
    `pallas_call` (sblas_tpu/ops/rspmv.py:630-642), in interpret mode."""
    T = x_tiles.shape[0]
    spec = pl.BlockSpec((1, 128, 128), lambda t: (t, 0, 0))
    return pl.pallas_call(
        jr._tile_gather_kernel, grid=(T,), in_specs=[spec] * 3,
        out_specs=spec,
        out_shape=jax.ShapeDtypeStruct((T, 128, 128), x_tiles.dtype),
        interpret=True)(x_tiles, gidx, gvals)


@pytest.mark.parametrize("np_dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n_tiles", [1, 3])
def test_tile_gather_plain_bitwise_equals_jax_kernel(np_dtype, n_tiles):
    rng = np.random.RandomState(n_tiles)
    x_tiles = rng.standard_normal((n_tiles, 128, 128)).astype(np_dtype)
    gidx = rng.randint(0, 128, (n_tiles, 128, 128)).astype(np.int32)
    gvals = rng.standard_normal((n_tiles, 128, 128)).astype(np_dtype)
    want = np.asarray(_jax_tile_gather(jnp.asarray(x_tiles),
                                       jnp.asarray(gidx),
                                       jnp.asarray(gvals)))
    before = tr.tile_gather.launches
    got = tr.tile_gather(*(torch.from_numpy(a)
                           for a in (x_tiles, gidx, gvals)))
    assert tr.tile_gather.launches == before   # the CPU takes the plain one
    assert got.dtype == torch.from_numpy(x_tiles).dtype
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(tr.tile_gather_plain(
        *(torch.from_numpy(a) for a in (x_tiles, gidx, gvals))).numpy(),
        want)


def test_tile_gather_refuses_other_devices():
    t = torch.zeros((1, 128, 128), device="meta")
    with pytest.raises(KernelError):
        tr.tile_gather(t, t.int(), t)


def test_pregathered_contrib_is_exact():
    """The pre-gathered branch (K2') gives the same contributions as the
    slab gather (K2) and the JAX package, bitwise."""
    A = jgen.webbase_like(n=30_000, avg_deg=4.0)
    jp = jr.RoutedPlan.from_csr(A, dtype=F64)
    tp = tr.RoutedPlan.from_csr(_port(A), dtype=torch.float64, device="cpu")
    x = DenseVector.random(A.width).values
    want = np.asarray(jr._gathered_contrib(jp, jnp.asarray(x)))
    xt = torch.from_numpy(x)
    assert np.array_equal(tr._gathered_contrib(tp, xt, True).numpy(), want)
    assert np.array_equal(tr._gathered_contrib(tp, xt).numpy(), want)


# ---- per-rank compute: the nocomm twins with no process group ----

ROUTED = dict(routed_min_nnz=1000, routed_min_width=512)
NOCOMM = {
    "bsr": (lambda: jgen.fem_banded_like(n=1100, half_band=6), {}),
    "ell": (lambda: jgen.uniform_random(900, 700, nnz_per_row=5, seed=11),
            {}),
    "dia": (lambda: jgen.fem_banded_like(n=1100, half_band=6), {}),
    "wcoo": (lambda: jgen.webbase_like(n=9000, avg_deg=3.0, seed=17,
                                       local_scale=120.0), {}),
    "routed": (lambda: jgen.uniform_random(1500, 1024, nnz_per_row=4,
                                           seed=3), ROUTED),
}


@pytest.mark.parametrize("kind,op", [
    (k, op) for k in sorted(NOCOMM) for op in ("spmv", "spmm")
    if (k, op) != ("routed", "spmm")])   # routed shards are SpMV-only
def test_planned_nocomm_per_rank_matches_jax(kind, op):
    A = NOCOMM[kind][0]()
    cfg = NOCOMM[kind][1]
    js = jpar.partition_row_plans(A, 4, dtype=F64, kind=kind,
                                  config=JConfig(**cfg))
    ts = tpar.partition_row_plans(_port(A), 4, dtype=torch.float64,
                                  kind=kind, config=TConfig(**cfg),
                                  device="cpu")
    if op == "spmv":
        v = DenseVector.random(A.width).values
        want = np.asarray(jpar.spmv_dist_planned_nocomm(
            js, jnp.asarray(v), jpar.make_mesh(4)))
        twin = tpar.spmv_dist_planned_nocomm
    else:
        v = DenseMatrix.random(A.width, 5).values
        want = np.asarray(jpar.spmm_mode2_planned_nocomm(
            js, jnp.asarray(v), jpar.make_mesh(4)))
        twin = tpar.spmm_mode2_planned_nocomm
    L = ts.band_rows
    before = tr.tile_gather.launches
    for s in range(4):
        got = twin(ts, torch.from_numpy(v), Mesh(None, s, 4, "cpu")).numpy()
        np.testing.assert_allclose(got, want[s * L:(s + 1) * L],
                                   rtol=1e-12, atol=1e-12)
    assert tr.tile_gather.launches == before


@pytest.mark.parametrize("op", ["spmv", "spmm"])
def test_coo_segments_nocomm_per_rank_matches_jax(op):
    A = jgen.uniform_random(900, 700, nnz_per_row=5, seed=11)
    jsegs = j_nnz_balanced(A, 4, dtype=F64)
    tsegs = partition_nnz_balanced(_port(A), 4, dtype=torch.float64,
                                   device="cpu")
    mesh = jpar.make_mesh(4)
    if op == "spmv":
        v = DenseVector.random(A.width).values
        want = np.asarray(jpar.spmv_dist_nocomm(jsegs, jnp.asarray(v), mesh))
        twin = tpar.spmv_dist_nocomm
    else:
        v = DenseMatrix.random(A.width, 6).values
        want = np.asarray(jpar.spmm_mode2_nocomm(jsegs, jnp.asarray(v),
                                                 mesh))
        twin = tpar.spmm_mode2_nocomm
    m = A.shape[0]
    for s in range(4):
        got = twin(tsegs, torch.from_numpy(v), Mesh(None, s, 4, "cpu"))
        np.testing.assert_allclose(got.numpy(), want[s * m:(s + 1) * m],
                                   rtol=1e-12, atol=1e-12)


def test_collectives_need_a_group():
    segs = partition_nnz_balanced(_port(jgen.pattern_symmetric()), 2,
                                  dtype=torch.float64, device="cpu")
    x = torch.ones(segs.shape[1], dtype=torch.float64)
    with pytest.raises(PartitionError, match="no process group"):
        tpar.spmv_dist(segs, x, 1.0, 0.0, x, Mesh(None, 0, 2, "cpu"))
    with pytest.raises(PartitionError, match="no process group"):
        tpar.sync_to_host(x, Mesh(None, 0, 2, "cpu"), 0)


def test_ring_of_one_is_the_rank_itself():
    blk = torch.arange(4.0)
    left, right = ring_exchange(blk, Mesh(None, 0, 1, "cpu"))
    assert torch.equal(left, blk) and torch.equal(right, blk)


def test_placement_helpers():
    mesh = Mesh(None, 1, 4, torch.device("cpu"))
    arr = np.arange(24.0).reshape(8, 3)
    assert np.array_equal(tpar.shard_along(arr, mesh, 0).numpy(), arr[2:4])
    assert np.array_equal(tpar.replicate(arr, mesh).numpy(), arr)
    from sblas_tpu_torch.containers import SharePolicy
    assert tpar.place_dense(arr, mesh, SharePolicy.SEGMENT).shape == (2, 3)
    with pytest.raises(PartitionError, match="pad first"):
        tpar.shard_along(arr, mesh, 1)
    assert np.array_equal(tpar.pad_to_shards(arr, 4, 1, 2),
                          jpar.pad_to_shards(arr, 4, 1, 2))


# ---- a group of one, in this process ----

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


@pytest.fixture(scope="module")
def world1_cases(world1):
    return dryrun.run_cases(world1)


@pytest.mark.parametrize("name", CASES)
def test_world1_case_matches_jax(world1_cases, name):
    _assert_case(1, name, world1_cases[name])


def test_case_table_is_complete(world1_cases):
    assert sorted(world1_cases) == CASES


def test_world1_meshes_and_checks(world1):
    with pytest.raises(PartitionError, match="requested 2 devices"):
        tpar.make_mesh(2, device="cpu")
    with pytest.raises(PartitionError, match="2x2"):
        tpar.make_mesh2(2, 2, device="cpu")
    A = _port(jgen.fem_banded_like(n=300, half_band=3))
    segs = partition_nnz_balanced(A, 2, dtype=torch.float64, device="cpu")
    x = torch.ones(300, dtype=torch.float64)
    with pytest.raises(PartitionError, match="built for 2"):
        tpar.spmv_dist(segs, x, 1.0, 0.0, x, world1)
    segs1 = partition_nnz_balanced(A, 1, dtype=torch.float64, device="cpu")
    with pytest.raises(PartitionError, match="bad reduce"):
        tpar.spmv_dist(segs1, x, 1.0, 0.0, x, world1, reduce="sum")
    routed = tpar.partition_row_plans(
        _port(jgen.uniform_random(1500, 1024, nnz_per_row=4, seed=3)), 1,
        dtype=torch.float64, kind="routed", config=TConfig(**ROUTED),
        device="cpu")
    with pytest.raises(PartitionError, match="SpMV-only"):
        tpar.spmm_mode2_planned(routed, torch.ones((1024, 2)), 1.0, 0.0,
                                torch.ones((1500, 2)), world1)
    tpar.init_distributed(backend="gloo")   # idempotent while a group is up


def test_world1_routed_launch_counts(world1, monkeypatch):
    """The distributed routed SpMV goes through K2' once and never through
    K2 (the single-device kernel)."""
    A = _port(jgen.uniform_random(1500, 1024, nnz_per_row=4, seed=3))
    sh = tpar.partition_row_plans(A, 1, dtype=torch.float64, kind="routed",
                                  config=TConfig(**ROUTED), device="cpu")
    calls = []
    for name in ("tile_gather", "slab_gather"):
        orig = getattr(tr, name)
        monkeypatch.setattr(tr, name, lambda *a, _f=orig, _n=name:
                            calls.append(_n) or _f(*a))
    x = torch.ones(1024, dtype=torch.float64)
    tpar.spmv_dist_planned(sh, x, 1.0, 0.0,
                           torch.zeros(1500, dtype=torch.float64), world1)
    assert calls == ["tile_gather"]


# ---- a group of four: one spawned run of the dry run ----

@pytest.fixture(scope="module")
def world4_cases(tmp_path_factory):
    out = tmp_path_factory.mktemp("world4")
    dryrun.dryrun_multichip(4, save_dir=str(out))
    with np.load(out / "cases.npz") as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("name", CASES)
def test_world4_case_matches_jax(world4_cases, name):
    _assert_case(4, name, world4_cases[name])


# ---- bootstrap failures are loud ----

_BAD_INIT = r"""
import os, sys
from datetime import timedelta
from sblas_tpu_torch.parallel import init_distributed
try:
    init_distributed(backend="gloo", init_method="tcp://127.0.0.1:9",
                     rank=1, world_size=2, timeout=timedelta(seconds=3))
except Exception as e:
    print("RAISED-UNREACHABLE", type(e).__name__, flush=True)
else:
    print("UNEXPECTED-CONTINUED", flush=True)
    sys.exit(1)
for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
    os.environ.pop(k, None)
try:
    init_distributed(backend="gloo")
except Exception as e:
    print("RAISED-NOENV", type(e).__name__, flush=True)
else:
    print("UNEXPECTED-CONTINUED", flush=True)
    sys.exit(1)
"""


def test_init_distributed_fails_loudly():
    env = {**os.environ, "PYTHONPATH": REPO}
    r = subprocess.run([sys.executable, "-c", _BAD_INIT], capture_output=True,
                       text=True, timeout=120, env=env, cwd=REPO)
    assert r.returncode == 0, (r.stdout, r.stderr[-1000:])
    assert "RAISED-UNREACHABLE" in r.stdout and "RAISED-NOENV" in r.stdout
    assert "UNEXPECTED" not in r.stdout


# ---- the distributed CLIs, one rank on the CPU ----

@functools.lru_cache(maxsize=None)
def _mtx(tmp_dir, name):
    A = {"band": lambda: jgen.fem_banded_like(n=2000, half_band=5),
         "web": lambda: jgen.webbase_like(n=20_000, avg_deg=4.0)}[name]()
    coo = A.to_coo()
    path = os.path.join(tmp_dir, f"{name}.mtx")
    write_mtx(path, A.height, A.width, coo.row_idx, coo.col_idx, coo.values)
    return path


@pytest.fixture(scope="module")
def mtx_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("mtx"))


@pytest.mark.parametrize("mode,name,dtype", [
    ("dist", "web", "f64"), ("distp", "web", "f32"), ("halo", "band", "f64"),
    ("halop", "band", "f32"), ("hier", "band", "f64")])
def test_spmv_cli_modes_one_rank(mtx_dir, capsys, mode, name, dtype):
    rc = spmv_test.main([_mtx(mtx_dir, name), "3", "4", "1", dtype,
                         "--mode", mode, "--slices", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and "Validation = True" in out, out
    assert f"mode {mode}" in out and "1-device run time (cpu host" in out


@pytest.mark.parametrize("method", ["1", "2", "2p", "halo"])
def test_spmm_cli_methods_one_rank(mtx_dir, capsys, method):
    rc = spmm_test.main([method, _mtx(mtx_dir, "band"), "8", "3", "4", "1",
                         "f64", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and "Validation = True" in out, out
    assert f"method {method}" in out and "GFLOPS" in out


def test_cli_clamps_to_the_world(mtx_dir, capsys):
    rc = spmv_test.main([_mtx(mtx_dir, "band"), "3", "4", "4", "f64",
                         "--mode", "distp", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and "Validation = True" in out
    assert "[sblas] requested 4 devices, have 1; running on 1" in out


def test_cli_fewer_devices_than_ranks_is_a_usage_error(mtx_dir, capsys):
    with pytest.raises(SystemExit) as exc:
        spmv_test.main([_mtx(mtx_dir, "band"), "3", "4", "0", "f64",
                        "--mode", "distp", "--device", "cpu"])
    assert exc.value.code == 2
    assert "--nproc_per_node=0" in capsys.readouterr().err


@pytest.mark.parametrize("requested,world,used", [
    (1, 1, 1), (4, 4, 4), (8, 4, 4), (2, 4, None), (1, 2, None)])
def test_devices_to_use(capsys, requested, world, used):
    if used is None:
        with pytest.raises(SystemExit) as exc:
            devices_to_use(requested, world)
        assert exc.value.code == 2
        err = capsys.readouterr().err
        assert f"torchrun --nproc_per_node={requested}" in err
        return
    assert devices_to_use(requested, world) == used
    said = capsys.readouterr().out
    assert (f"running on {world}" in said) == (requested > world)
    devices_to_use(requested, world, rank=1)     # only rank 0 says it
    assert capsys.readouterr().out == ""


def test_dryrun_cli_has_no_default_device(capsys):
    assert dryrun.main(["4"]) == 2
    assert dryrun.main(["4", "--device", "tpu"]) == 2
    assert "--device cuda|cpu" in capsys.readouterr().err


def test_cli_hier_slices_must_divide(mtx_dir):
    with pytest.raises(PartitionError, match="--slices 2"):
        spmv_test.main([_mtx(mtx_dir, "band"), "3", "4", "1", "--mode",
                        "hier", "--device", "cpu"])

