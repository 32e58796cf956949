"""The port's 16-bit half against the JAX package's, on the CPU.

* The opt-in bf16 route transport (`config.routed_transport="bf16"`),
  case for case with `TestBf16Transport` (tests/test_rspmv.py), on the
  same seeded webbase n=50000: the int16 tables are byte-identical to the
  JAX package's, the contributions after the main route are bitwise
  equal (both round the f32 product once, to nearest even), y agrees to
  f32 summation order, and the oracle bar is the JAX test's 1e-2
  relative.
* The plain bf16 versions of K1, K2, K2', K3 and K4 against the JAX
  kernels in interpret mode.  K1, K2 and K2' are bitwise equal.  K3 and
  K4 sum in f32 and round once, where the JAX kernels accumulate in their
  bf16 output blocks: each port result is within one bf16 ulp of the
  exact sum rounded to bf16, and no further from it than the JAX one.
* bf16-valued plans of all six kinds, SpMV and SpMM: values bitwise the
  JAX package's, results against it and the f64 oracle at the JAX test's
  own bound (rtol 0.15, atol 0.15), and `make_plan`'s kind choice at
  bf16.
* `save_plan` of a bf16-valued plan raises `FormatError`; the CLI's
  `--transport bf16` (with `--plan-cache` re-aiming a cached plan) and
  `--progressive`; the bench's bf16-transport line.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import sblas_tpu.ops as jops
from sblas_tpu.config import SBlasConfig as JConfig
from sblas_tpu.containers import DenseMatrix as JDenseMatrix
from sblas_tpu.containers import DenseVector as JDenseVector
from sblas_tpu.io import generate as jgen
from sblas_tpu.io.mmio import write_mtx
from sblas_tpu.io.plancache import save_plan as j_save_plan
from sblas_tpu.ops import route as jroute
from sblas_tpu.ops import rspmv as jr
from sblas_tpu.ops import wcoo as jw
from sblas_tpu.ops.bsr_pallas import spmm_bsr_pallas as j_spmm_bsr_pallas
from sblas_tpu.ops.cpu_reference import spmm_cpu, spmv_cpu
import sblas_tpu_torch.ops as tops
from sblas_tpu_torch import bench
from sblas_tpu_torch.cli import spmv_test
from sblas_tpu_torch.config import SBlasConfig as TConfig
from sblas_tpu_torch.containers import CsrMatrix
from sblas_tpu_torch.io.plancache import load_plan, save_plan
from sblas_tpu_torch.ops import bsr_pallas as tbp
from sblas_tpu_torch.ops import route as troute
from sblas_tpu_torch.ops import rspmv as tr
from sblas_tpu_torch.ops import wcoo as tw
from sblas_tpu_torch.utils.errors import FormatError, PlanError
from sblas_tpu_torch.utils.verify import check_equal

BF16 = torch.bfloat16
ALPHA, BETA = 2.0, 3.0
# the JAX test's bars: 1e-2 relative for the bf16 transport against the
# oracle (tests/test_rspmv.py), rtol/atol 0.15 for bf16-valued plans
# (tests/test_ops_single_chip.py::test_bfloat16_plans_run)
TRANSPORT_BAR = 1e-2
PLAN_TOL = 0.15
# f32 sums in another order (JAX segment_sum, the port's segment_reduce)
F32_ORDER = 1e-5


def _port(A):
    return CsrMatrix(A.row_ptr, A.col_idx, A.values, A.shape)


@functools.lru_cache(maxsize=None)
def _web():
    return jgen.webbase_like(n=50000, avg_deg=3.0, seed=31)


@functools.lru_cache(maxsize=None)
def _transport_plans(transport):
    """(JAX plan, port plan) of `_web()` with f32 values at `transport`."""
    A = _web()
    return (jr.RoutedPlan.from_csr(A, dtype=jnp.float32,
                                   config=JConfig(routed_transport=transport)),
            tr.RoutedPlan.from_csr(_port(A), dtype=torch.float32,
                                   config=TConfig(routed_transport=transport),
                                   device="cpu"))


def _xy(A):
    x = JDenseVector.random(A.width)
    y = JDenseVector.constant(A.height, 1.0)
    return x, y


def _f32(v):
    return v.values.astype(np.float32)


def _bits(t):
    """A bf16 tensor's bit patterns as numpy uint16."""
    return t.contiguous().view(torch.int16).numpy().view(np.uint16)


def _jbits(a):
    return np.asarray(a).view(np.uint16)


def _tables(plan, field):
    return [np.asarray(t) for t in getattr(plan, field)]


class TestBf16Transport:
    """Case for case with tests/test_rspmv.py::TestBf16Transport."""

    def test_verifies_against_f64_oracle(self):
        A = _web()
        jp, tp = _transport_plans("bf16")
        assert tp.transport == "bf16"
        x, y = _xy(A)
        got = tr.spmv_routed(tp, torch.from_numpy(_f32(x)), ALPHA, BETA,
                             torch.from_numpy(_f32(y))).numpy()
        want = spmv_cpu(A, x, ALPHA, BETA, y)
        assert check_equal(got, want, error_bar=TRANSPORT_BAR,
                           relative=True).ok
        jgot = np.asarray(jr.spmv_routed(jp, jnp.asarray(_f32(x)), ALPHA,
                                         BETA, jnp.asarray(_f32(y))))
        assert check_equal(got, jgot, error_bar=F32_ORDER,
                           relative=True).ok

    def test_f32_plan_unchanged_by_default(self):
        _, tp = _transport_plans("f32")
        assert tp.transport == "f32"
        assert all(t.dtype == torch.int32 for t in tp.tables)

    def test_rejects_non_f32_values(self):
        cfg = TConfig(routed_transport="bf16")
        for dtype in (torch.float64, BF16):
            with pytest.raises(PlanError):
                tr.RoutedPlan.from_csr(_port(_web()), dtype=dtype,
                                       config=cfg, device="cpu")
        with pytest.raises(Exception):   # the JAX package refuses too
            jr.RoutedPlan.from_csr(_web(), dtype=jnp.float64,
                                   config=JConfig(routed_transport="bf16"))

    def test_rejects_unknown_transport(self):
        with pytest.raises(PlanError):
            tr.RoutedPlan.from_csr(_port(_web()), dtype=torch.float32,
                                   config=TConfig(routed_transport="f16"),
                                   device="cpu")

    def test_plancache_roundtrip_preserves_transport(self, tmp_path):
        """The port's file and the JAX package's file of the same plan
        both load with the bf16 transport and int16 tables, and run
        bitwise like the plan they were saved from."""
        A = _web()
        jp, tp = _transport_plans("bf16")
        mine, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
        save_plan(mine, tp)
        j_save_plan(theirs, jp)
        x, y = _xy(A)
        xt, yt = torch.from_numpy(_f32(x)), torch.from_numpy(_f32(y))
        want = tr.spmv_routed(tp, xt, 1.0, 0.0, yt)
        for path in (mine, theirs):
            loaded = load_plan(path, "cpu")
            assert loaded.transport == "bf16"
            assert all(t.dtype == torch.int16 for t in loaded.tables)
            assert torch.equal(tr.spmv_routed(loaded, xt, 1.0, 0.0, yt),
                               want)

    def test_bf16_tables_are_int16(self):
        """The main route's tables are int16 and byte-identical to the JAX
        package's; the unrank and x routes keep int32."""
        jp, tp = _transport_plans("bf16")
        assert all(t.dtype == torch.int16 for t in tp.tables)
        assert all(t.dtype == torch.int32 for t in tp.unrank_tables)
        assert all(t.dtype == torch.int32 for t in tp.xroute_tables)
        for field in ("tables", "unrank_tables", "xroute_tables"):
            want = _tables(jp, field)
            got = [t.numpy() for t in getattr(tp, field)]
            assert len(got) == len(want)
            for u, v in zip(want, got):
                assert u.dtype == v.dtype and np.array_equal(u, v), field
        for field in ("gslab", "gidx", "gvals", "pvals", "prow_col",
                      "brow_ids", "merge_ids"):
            assert np.array_equal(np.asarray(getattr(jp, field)),
                                  getattr(tp, field).numpy()), field

    def test_with_transport_switches_both_ways(self):
        A = _web()
        _, plan32 = _transport_plans("f32")
        _, native16 = _transport_plans("bf16")
        plan16 = plan32.with_transport("bf16")
        assert plan16.transport == "bf16"
        assert all(t.dtype == torch.int16 for t in plan16.tables)
        back = plan16.with_transport("f32")
        assert back.transport == "f32"
        assert all(t.dtype == torch.int32 for t in back.tables)
        assert plan32.with_transport("f32") is plan32
        x, y = _xy(A)
        xt, yt = torch.from_numpy(_f32(x)), torch.from_numpy(_f32(y))
        # re-widening the tables preserves values: f32 -> bf16 -> f32
        # gives the f32 plan's result bitwise
        assert torch.equal(tr.spmv_routed(back, xt, 2.0, 3.0, yt),
                           tr.spmv_routed(plan32, xt, 2.0, 3.0, yt))
        # and the converted plan runs as a natively built bf16 plan
        assert torch.equal(tr.spmv_routed(plan16, xt, 2.0, 3.0, yt),
                           tr.spmv_routed(native16, xt, 2.0, 3.0, yt))

    def test_with_transport_rejects_f64(self):
        A = _web()
        plan = tr.RoutedPlan.from_csr(_port(A), dtype=torch.float64,
                                      device="cpu")
        with pytest.raises(PlanError):
            plan.with_transport("bf16")
        with pytest.raises(PlanError):
            plan.with_transport("f16")


def _jax_routed_contrib(jp, x):
    """The JAX package's contributions in gather order, then after the
    main route (the steps of `spmv_routed` up to the stack)."""
    c = jr._gathered_contrib(jp, x)
    if jp.n_prows:
        xp = jnp.take(x, jp.prow_col, axis=0)
        pc = (jp.pvals.astype(x.dtype) * xp[:, None]).astype(c.dtype)
        c = jnp.concatenate([c, pc.reshape(-1)])
    c = jnp.pad(c, (0, jp.route_n - c.shape[0]))
    return c, jroute.apply_route(jp.schedule, c, jp.tables)


def _port_routed_contrib(tp, x):
    c = tr._gathered_contrib(tp, x)
    if tp.n_prows:
        c = torch.cat([c, tr.peel_contrib(tp, x).reshape(-1)])
    c = torch.nn.functional.pad(c, (0, tp.route_n - c.shape[0]))
    return c, troute.apply_route(tp.schedule, c, tp.tables)


def test_transport_contributions_bitwise_equal_jax():
    """K2's bf16 store (and the peeled rows') and the main route over
    int16 tables: bitwise the JAX package's, before and after the route."""
    A = _web()
    jp, tp = _transport_plans("bf16")
    x = _f32(_xy(A)[0])
    jc, jrouted = _jax_routed_contrib(jp, jnp.asarray(x))
    tc, trouted = _port_routed_contrib(tp, torch.from_numpy(x))
    assert tc.dtype == trouted.dtype == BF16
    assert np.array_equal(_bits(tc), _jbits(jc))
    assert np.array_equal(_bits(trouted), _jbits(jrouted))


# ---- plain bf16 kernels against the JAX kernels (interpret mode) ----

def _rand_bf16(rng, shape):
    """The same bf16 values for both packages (f32 rounded to bf16)."""
    v = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(v, jnp.bfloat16), torch.from_numpy(v).to(BF16)


@pytest.mark.parametrize("idx_dtype", [np.int16, np.int32])
@pytest.mark.parametrize("rows", [1, 37])
def test_k1_bf16_plain_bitwise_equals_jax_kernel(idx_dtype, rows):
    rng = np.random.RandomState(rows)
    jx, tx = _rand_bf16(rng, (rows, 128))
    idx = rng.randint(0, 128, (rows, 128)).astype(idx_dtype)
    assert np.array_equal(_bits(tx), _jbits(jx))
    want = jroute.lane_shuffle(jx, jnp.asarray(idx))
    got = troute.lane_shuffle(tx, torch.from_numpy(idx))
    assert got.dtype == BF16
    assert np.array_equal(_bits(got), _jbits(want))


@functools.lru_cache(maxsize=None)
def _bf16_routed():
    """(JAX plan, port plan) of a webbase n=20000 with bf16 values."""
    A = jgen.webbase_like(n=20000, avg_deg=4.0)
    return (A, jr.RoutedPlan.from_csr(A, dtype=jnp.bfloat16),
            tr.RoutedPlan.from_csr(_port(A), dtype=BF16, device="cpu"))


def test_k2_bf16_values_bitwise_equal_jax_kernel():
    """K2 with bf16 values and x (a bf16-valued plan, f32 transport): the
    product formed in f32 and rounded once, bitwise the JAX kernel's; the
    routes move the bf16 contributions over int32 tables."""
    A, jp, tp = _bf16_routed()
    assert np.array_equal(_jbits(jp.gvals), _bits(tp.gvals))
    assert all(t.dtype == torch.int32 for t in tp.tables)
    x = _f32(_xy(A)[0])
    jc, jrouted = _jax_routed_contrib(jp, jnp.asarray(x, jnp.bfloat16))
    tc, trouted = _port_routed_contrib(tp, torch.from_numpy(x).to(BF16))
    assert np.array_equal(_bits(tc), _jbits(jc))
    assert np.array_equal(_bits(trouted), _jbits(jrouted))


def _jax_tile_gather(x_tiles, gidx, gvals, out_dtype):
    """The JAX package's K2' (`_tile_gather_kernel`) with its out dtype,
    as `_gathered_contrib` calls it inside `shard_map`, interpret mode."""
    T = x_tiles.shape[0]
    spec = pl.BlockSpec((1, 128, 128), lambda t: (t, 0, 0))
    return pl.pallas_call(
        jr._tile_gather_kernel, grid=(T,), in_specs=[spec] * 3,
        out_specs=spec,
        out_shape=jax.ShapeDtypeStruct((T, 128, 128), out_dtype),
        interpret=True)(x_tiles, gidx, gvals)


@pytest.mark.parametrize("variant", ["f32_bf16", "bf16"])
@pytest.mark.parametrize("n_tiles", [1, 3])
def test_k2p_bf16_plain_bitwise_equals_jax_kernel(variant, n_tiles):
    rng = np.random.RandomState(n_tiles)
    gidx = rng.randint(0, 128, (n_tiles, 128, 128)).astype(np.int32)
    if variant == "bf16":
        jt, tt = _rand_bf16(rng, (n_tiles, 128, 128))
        jv, tv = _rand_bf16(rng, (n_tiles, 128, 128))
    else:
        t32 = rng.standard_normal((n_tiles, 128, 128)).astype(np.float32)
        v32 = rng.standard_normal((n_tiles, 128, 128)).astype(np.float32)
        jt, tt = jnp.asarray(t32), torch.from_numpy(t32)
        jv, tv = jnp.asarray(v32), torch.from_numpy(v32)
    want = _jax_tile_gather(jt, jnp.asarray(gidx), jv, jnp.bfloat16)
    got = tr.tile_gather(tt, torch.from_numpy(gidx), tv, BF16)
    assert got.dtype == BF16
    assert np.array_equal(_bits(got), _jbits(want))
    # K2 on the same tiles (one slab per tile) stores the same bits
    slab = tr.slab_gather(torch.arange(n_tiles, dtype=torch.int32), tt,
                          torch.from_numpy(gidx), tv, BF16)
    assert torch.equal(slab, got)


def _bf16_ulps(got, exact):
    """Per-element distance in bf16 ulps between bf16 tensor `got` and
    the f64 array `exact` rounded to bf16 (ordered bit patterns)."""
    def key(bits):
        b = bits.astype(np.int32)
        return np.where(b & 0x8000, -(b & 0x7FFF), b)
    rounded = torch.from_numpy(exact).to(torch.float32).to(BF16)
    return np.abs(key(_bits(got)) - key(_bits(rounded)))


def _err(got, exact):
    return np.abs(got.astype(np.float64) - exact).max()


@pytest.mark.parametrize("name", ["web", "one_window"])
def test_k3_bf16_plain_vs_jax_kernel(name):
    """K3's plain version sums in f32 and rounds once: within one bf16 ulp
    of the exact sum, and no further from it than the JAX kernel."""
    if name == "web":
        A = jgen.webbase_like(n=2000, avg_deg=3.0)
    else:
        rng = np.random.RandomState(3)
        rows = rng.randint(0, 128, size=5000).astype(np.int64)
        cols = rng.randint(0, 2048, size=5000).astype(np.int64)
        from sblas_tpu.containers import CooMatrix
        A = CooMatrix(rows, cols, rng.random_sample(5000),
                      (256, 2048)).to_csr()
    jp = jw.WcooPlan.from_csr(A, dtype=jnp.bfloat16)
    tp = tw.WcooPlan.from_csr(_port(A), dtype=BF16, device="cpu")
    assert np.array_equal(_jbits(jp.vals), _bits(tp.vals))
    assert tp.visit0.dtype == BF16
    k, k0, kc = 12, 5, 4
    B32 = JDenseMatrix.random(A.width, k).values.astype(np.float32)
    Bj, Bt = jnp.asarray(B32, jnp.bfloat16), torch.from_numpy(B32).to(BF16)
    cols = np.asarray(jp.xblk) * 128 + np.asarray(jp.lane)
    want = np.asarray(jw._window_reduce_range(
        jp.wb, jp.vals, jp.relrow, jp.visit0, jp.visit1, Bj[cols, k0:k0 + kc],
        kc, jp.n_row_blocks)).reshape(-1, kc)
    got = tw.window_reduce_plain(tp.k3, tp.wb, tp.relrow, tp.vals, tp.xblk,
                                 tp.lane, Bt, k0, kc)
    assert got.dtype == BF16 and got.shape == (tp.n_row_blocks * 128, kc)
    exact = tw.window_reduce_plain(tp.k3, tp.wb, tp.relrow,
                                   tp.vals.double(), tp.xblk, tp.lane,
                                   Bt.double(), k0, kc).numpy()
    assert _bf16_ulps(got, exact).max() <= 1
    assert _err(got.float().numpy(), exact) <= _err(
        want.astype(np.float32), exact)


@pytest.mark.parametrize("name,k,k_chunk", [("web", 12, None),
                                            ("web", 12, 5),
                                            ("one_window", 8, None)])
def test_k3_bf16_fused_plain_vs_jax_spmm(name, k, k_chunk):
    """The WCOO SpMM on a bf16 plan through K3's fused plain version: the
    sum and the epilogue in f32, one rounding, so within one bf16 ulp of
    the exact beta*C + alpha*A@B rounded to bf16, and no further from it
    than the JAX package's spmm_wcoo (a bf16 block per tile run, then a
    bf16 epilogue)."""
    if name == "web":
        A = jgen.webbase_like(n=2000, avg_deg=3.0)
    else:
        rng = np.random.RandomState(3)
        rows = rng.randint(0, 128, size=5000).astype(np.int64)
        cols = rng.randint(0, 2048, size=5000).astype(np.int64)
        from sblas_tpu.containers import CooMatrix
        A = CooMatrix(rows, cols, rng.random_sample(5000),
                      (256, 2048)).to_csr()
    jp = jw.WcooPlan.from_csr(A, dtype=jnp.bfloat16)
    tp = tw.WcooPlan.from_csr(_port(A), dtype=BF16, device="cpu")
    rng = np.random.RandomState(k)
    B32 = rng.random_sample((A.width, k)).astype(np.float32)
    C32 = rng.random_sample((A.height, k)).astype(np.float32)
    Bt, Ct = torch.from_numpy(B32).to(BF16), torch.from_numpy(C32).to(BF16)
    want = np.asarray(jw.spmm_wcoo(
        jp, jnp.asarray(B32, jnp.bfloat16), 3.0, 4.0,
        jnp.asarray(C32, jnp.bfloat16), k_chunk=k_chunk)).astype(np.float32)
    got = tw.spmm_wcoo(tp, Bt, 3.0, 4.0, Ct, k_chunk=k_chunk)
    assert got.dtype == BF16 and got.shape == (A.height, k)
    exact = tw.window_reduce_plain(
        tp.k3, tp.wb, tp.relrow, tp.vals.double(), tp.xblk, tp.lane,
        Bt.double(), 0, k, C=Ct.double(), alpha=3.0, beta=4.0).numpy()
    assert _bf16_ulps(got, exact).max() <= 1
    assert _err(got.float().numpy(), exact) <= _err(want, exact)


@pytest.mark.parametrize("k", [8, 256])
def test_k4_bf16_plain_vs_jax_kernel(k):
    """K4's plain version folds alpha/beta in f32 and rounds once: within
    one bf16 ulp of the exact result, no further from it than the JAX
    kernel (which accumulates the slots in its bf16 output block)."""
    A = jgen.fem_banded_like(n=700, half_band=9)
    jp = jops.BsrPlan.from_csr(A, dtype=jnp.bfloat16)
    tp = tops.BsrPlan.from_csr(_port(A), dtype=BF16, device="cpu")
    assert np.array_equal(_jbits(jp.vals), _bits(tp.vals))
    rng = np.random.RandomState(k)
    B32 = rng.random_sample((A.width, k)).astype(np.float32)
    C32 = rng.random_sample((A.height, k)).astype(np.float32)
    Bt, Ct = torch.from_numpy(B32).to(BF16), torch.from_numpy(C32).to(BF16)
    want = np.asarray(j_spmm_bsr_pallas(
        jp, jnp.asarray(B32, jnp.bfloat16), 3.0, 4.0,
        jnp.asarray(C32, jnp.bfloat16))).astype(np.float32)
    got = tbp.spmm_bsr_pallas(tp, Bt, 3.0, 4.0, Ct)
    assert got.dtype == BF16
    exact = tbp.bell_spmm_plain(tp.vals.double(), tp.bcol, Bt.double(),
                                Ct.double(), 3.0, 4.0).numpy()
    assert _bf16_ulps(got, exact).max() <= 1
    assert _err(got.float().numpy(), exact) <= _err(want, exact)


# ---- bf16-valued plans of every kind ----

@functools.lru_cache(maxsize=None)
def _plan_matrix(kind):
    if kind in ("routed", "wcoo"):
        return jgen.webbase_like(n=20000, avg_deg=4.0)
    return jgen.fem_banded_like(n=400, half_band=3, dtype=np.float64)


def _bf16(v):
    return jnp.asarray(v, jnp.bfloat16), torch.from_numpy(
        v.astype(np.float32)).to(BF16)


@pytest.mark.parametrize("kind,op", [
    (kind, op) for kind in ("bsr", "ell", "coo", "dia", "wcoo", "routed")
    for op in ("spmv", "spmm") if not (kind == "routed" and op == "spmm")])
def test_bf16_plans_match_jax_and_oracle(kind, op):
    """`make_plan(force=kind, dtype=bf16)`: values bitwise the JAX
    package's, results against it and the f64 oracle at the JAX test's
    bound."""
    A = _plan_matrix(kind)
    jp = (_bf16_routed()[1] if kind == "routed"
          else jops.make_plan(A, dtype=jnp.bfloat16, force=kind))
    tp = (_bf16_routed()[2] if kind == "routed"
          else tops.make_plan(_port(A), dtype=BF16, force=kind,
                              device="cpu"))
    assert tp.dtype == BF16
    jvals = jp.gvals if kind == "routed" else jp.vals
    assert np.array_equal(_jbits(jvals), _bits(
        tp.gvals if kind == "routed" else tp.vals))
    if op == "spmv":
        x, y = _xy(A)
        (jx, tx), (jy, ty) = _bf16(x.values), _bf16(y.values)
        jgot = jops.spmv(jp, jx, 1.0, 1.0, jy)
        got = tops.spmv(tp, tx, 1.0, 1.0, ty)
        want = spmv_cpu(A, x, 1.0, 1.0, y)
    else:
        B = JDenseMatrix.random(A.width, 8)
        C = JDenseMatrix.constant(A.height, 8, 1.0)
        (jB, tB), (jC, tC) = _bf16(B.values), _bf16(C.values)
        jgot = jops.spmm(jp, jB, 1.0, 1.0, jC)
        got = tops.spmm(tp, tB, 1.0, 1.0, tC)
        want = spmm_cpu(A, B, 1.0, 1.0, C)
    assert got.dtype == BF16
    got = got.double().numpy()
    jgot = np.asarray(jgot).astype(np.float64)
    np.testing.assert_allclose(got, want, rtol=PLAN_TOL, atol=PLAN_TOL)
    np.testing.assert_allclose(got, jgot, rtol=PLAN_TOL, atol=PLAN_TOL)


@pytest.mark.parametrize("kind", ["coo", "wcoo"])
def test_bf16_scatter_sums_run_in_f32(kind):
    """A bf16 plan's scatter sums run in f32 and round once: on a webbase
    row of 3,210 entries (its sum near 1,200, where a bf16 ulp is 8) the
    port stays within the JAX test's bound.  The JAX package's bf16 COO
    SpMV sums in bf16 and does not: the sum stops growing (a reference
    fault the port does not carry over, ROADMAP Queue 3)."""
    A = jgen.webbase_like(n=20000, avg_deg=4.0)
    assert int(A.row_nnz.max()) == 3210
    x, y = _xy(A)
    want = spmv_cpu(A, x, 1.0, 1.0, y)
    (jx, tx), (jy, ty) = _bf16(x.values), _bf16(y.values)
    tp = tops.make_plan(_port(A), dtype=BF16, force=kind, device="cpu")
    got = tops.spmv(tp, tx, 1.0, 1.0, ty).double().numpy()
    np.testing.assert_allclose(got, want, rtol=PLAN_TOL, atol=PLAN_TOL)
    B = JDenseMatrix.random(A.width, 4)
    C = JDenseMatrix.constant(A.height, 4, 1.0)
    gotm = tops.spmm(tp, _bf16(B.values)[1], 1.0, 1.0,
                     _bf16(C.values)[1]).double().numpy()
    np.testing.assert_allclose(gotm, spmm_cpu(A, B, 1.0, 1.0, C),
                               rtol=PLAN_TOL, atol=PLAN_TOL)
    if kind == "coo":
        jp = jops.make_plan(A, dtype=jnp.bfloat16, force="coo")
        err = np.abs(np.asarray(jops.spmv(jp, jx, 1.0, 1.0, jy)).astype(
            np.float64) - want)
        assert (err > PLAN_TOL + PLAN_TOL * np.abs(want)).any()
        assert (err / np.maximum(1.0, np.abs(want))).max() > 0.5


MATRICES = {
    "webbase100k": lambda: jgen.webbase_like(n=100_000, avg_deg=4.0),
    "band": lambda: jgen.fem_banded_like(n=2000, half_band=5),
    "blocks": lambda: jgen.block_dominant(n_brows=8, blocks_per_row=2),
    "uniform": lambda: jgen.uniform_random(3000, 3000, 8, seed=4),
    "scattered": lambda: jgen.scattered_sparse(n=50_000, nnz=2000),
    "tiny": lambda: jgen.pattern_symmetric(),
}
_KIND = {"RoutedPlan": "routed", "CooPlan": "coo", "DiaPlan": "dia",
         "BsrPlan": "bsr", "EllPlan": "ell", "WcooPlan": "wcoo"}


@functools.lru_cache(maxsize=None)
def _choice_matrix(name):
    return MATRICES[name]()


@pytest.mark.parametrize("name", list(MATRICES))
@pytest.mark.parametrize("op", ["spmv", None, "spmm"])
def test_make_plan_bf16_chooses_like_jax(name, op):
    """At bf16 the BELL byte caps halve against f32: the port picks the
    JAX package's kind for every matrix of the slice's set."""
    A = _choice_matrix(name)
    kind = _KIND[type(jops.make_plan(A, dtype=jnp.bfloat16,
                                     op=op)).__name__]
    assert tops.choose_kind(_port(A), BF16, op=op) == kind
    plan = tops.make_plan(_port(A), dtype=BF16, op=op, device="cpu")
    assert _KIND[type(plan).__name__] == kind and plan.dtype == BF16


def test_make_plan_fast_takes_bf16():
    A = _port(_plan_matrix("coo"))
    plan = tops.make_plan_fast(A, dtype=BF16, device="cpu")
    assert plan.dtype == BF16 and type(plan).__name__ in ("EllPlan",
                                                          "CooPlan")


@pytest.mark.parametrize("kind", ["coo", "wcoo", "routed"])
def test_save_plan_refuses_bf16_values(tmp_path, kind):
    A = _port(_plan_matrix(kind))
    plan = (_bf16_routed()[2] if kind == "routed"
            else tops.make_plan(A, dtype=BF16, force=kind, device="cpu"))
    path = tmp_path / "p.npz"
    with pytest.raises(FormatError, match="bfloat16"):
        save_plan(str(path), plan)
    assert not path.exists()


def test_jax_cannot_load_its_bf16_value_file(tmp_path):
    """The reference fault the port does not carry over: the JAX package
    saves a bf16-valued plan its own `load_plan` refuses."""
    from sblas_tpu.io.plancache import load_plan as j_load_plan
    from sblas_tpu.utils.errors import FormatError as JFormatError
    jp = jops.make_plan(_plan_matrix("coo"), dtype=jnp.bfloat16,
                        force="coo")
    path = str(tmp_path / "j.npz")
    j_save_plan(path, jp)
    with pytest.raises(JFormatError):
        j_load_plan(path)
    with pytest.raises(FormatError):
        load_plan(path, "cpu")


# ---- the CLI ----

def _write(tmp_path, A, name):
    coo = A.to_coo()
    path = str(tmp_path / name)
    write_mtx(path, A.height, A.width, coo.row_idx, coo.col_idx, coo.values)
    return path


@pytest.fixture(scope="module")
def band_mtx(tmp_path_factory):
    """tests/test_cli.py's banded fixture."""
    A = jgen.fem_banded_like(n=300, half_band=4, dtype=np.float64)
    return _write(tmp_path_factory.mktemp("cli"), A, "band.mtx")


@pytest.fixture(scope="module")
def web_mtx(tmp_path_factory):
    """A webbase large enough for `make_plan` to route it."""
    return _write(tmp_path_factory.mktemp("cli"),
                  _choice_matrix("webbase100k"), "web.mtx")


def _cli(argv, capsys):
    rc = spmv_test.main([*argv, "--device", "cpu"])
    return rc, capsys.readouterr().out


def test_cli_transport_flag(band_mtx, capsys):
    """tests/test_cli.py::test_spmv_cli_transport_flag: the banded
    fixture picks DIA, where the flag is inert."""
    rc, out = _cli([band_mtx, "3.0", "4.0", "1", "f32", "--mode", "single",
                    "--transport", "bf16"], capsys)
    assert rc == 0 and "Validation = True" in out and "plan DiaPlan" in out


def test_cli_transport_bf16_routed_and_cache(web_mtx, capsys, tmp_path):
    """On a routed plan the flag routes bf16 and checks at 2e-3; a cached
    plan of the other transport is re-aimed, both ways."""
    base = [web_mtx, "3", "4", "1", "f32", "--mode", "single"]
    cache = str(tmp_path / "w.npz")
    rc, out = _cli([*base, "--transport", "bf16", "--plan-cache", cache],
                   capsys)
    assert rc == 0 and "plan RoutedPlan" in out and "saved" in out
    max_rel = float(out.split("max_rel=")[1].split(",")[0])
    assert 0 < max_rel <= 2e-3
    assert load_plan(cache, "cpu").transport == "bf16"
    rc, out = _cli([*base, "--plan-cache", cache], capsys)
    assert rc == 0 and "Validation = True" in out
    assert "plan cache: converted transport 'bf16' -> 'f32'" in out
    rc, out = _cli([*base, "--transport", "bf16", "--plan-cache", cache],
                   capsys)
    assert rc == 0 and "converted" not in out and "loaded" in out


def test_cli_cached_shards_of_another_transport_raise(web_mtx, capsys,
                                                      tmp_path):
    """Shards have no `with_transport`: a cached file of the other
    transport raises `FormatError`, as in the JAX CLI."""
    cache = str(tmp_path / "s.npz")
    base = [web_mtx, "3", "4", "1", "f32", "--mode", "distp",
            "--plan-cache", cache]
    rc, out = _cli([*base, "--transport", "bf16"], capsys)
    assert rc == 0 and "kind=routed" in out and "Validation = True" in out
    with pytest.raises(FormatError, match="routed_transport"):
        _cli([*base, "--transport", "f32"], capsys)


def test_cli_progressive(band_mtx, capsys):
    """tests/test_cli.py::test_spmv_cli_progressive: a validated first
    result from the fast plan before the steady state, which is the plain
    run's."""
    rc, out = _cli([band_mtx, "3.0", "4.0", "1", "f64", "--mode", "single",
                    "--progressive"], capsys)
    assert rc == 0, out
    first = [ln for ln in out.splitlines() if ln.startswith("First result")]
    assert len(first) == 1 and "Validation = True" in first[0], out
    assert out.index("First result") < out.rindex("Validation = True")
    rc2, out2 = _cli([band_mtx, "3.0", "4.0", "1", "f64", "--mode",
                      "single"], capsys)
    assert rc2 == 0 and "First result" not in out2
    assert (out.split("max_abs")[-1].split()[0]
            == out2.split("max_abs")[-1].split()[0])


def test_cli_progressive_non_single_ignored(band_mtx, capsys):
    rc, out = _cli([band_mtx, "3.0", "4.0", "1", "f64", "--mode", "dist",
                    "--progressive"], capsys)
    assert rc == 0, out
    assert "--progressive applies to --mode single only" in out
    assert "First result" not in out


def test_cli_progressive_build_error_is_raised(band_mtx, capsys,
                                               monkeypatch):
    """A failure of the worker thread's build is raised after the first
    result, not swallowed."""
    def broken(*a, **k):
        raise PlanError("broken build")
    monkeypatch.setattr(tops, "make_plan", broken)
    with pytest.raises(PlanError, match="broken build"):
        _cli([band_mtx, "3.0", "4.0", "1", "f64", "--mode", "single",
              "--progressive"], capsys)
    assert "First result" in capsys.readouterr().out


# ---- the bench's bf16-transport line ----

def test_bench_bf16_transport_line(capsys):
    """The JAX bench's informational line: the routed plan re-aimed to
    bf16, gated at 2e-3, timed beside f32 when it passes the gate and not
    timed when it fails it (the n=50000 webbase's worst row is just over
    2e-3); a plan without a route says so."""
    clock = bench._Clock(torch.device("cpu"))
    for A, plan, said in (
            (_choice_matrix("webbase100k"), None,
             "spmv webbase bf16 transport (opt-in, 2e-3 bar):"),
            (_web(), _transport_plans("f32")[1],
             "spmv webbase bf16 transport FAILED its bar"),
            (_web(), tops.make_plan(_port(_web()), force="coo",
                                    device="cpu"),
             "best[CooPlan] has no route; not timed")):
        if plan is None:
            plan = tops.make_plan(_port(A), op="spmv", device="cpu")
            assert isinstance(plan, tr.RoutedPlan)
        x, y = _xy(A)
        xt, yt = torch.from_numpy(_f32(x)), torch.from_numpy(_f32(y))
        want = spmv_cpu(A, x, bench.ALPHA, bench.BETA, y)
        bench.bf16_transport_line(clock, A, plan, xt, yt, want, 1.0, None)
        err = capsys.readouterr().err
        assert said in err, err
        assert ("f32 1.00000 ms, device not measured" in err) == (
            "opt-in" in said)
