"""Port parity: sblas_tpu_torch.ops.rspmv against sblas_tpu.ops.rspmv.

Both packages build their routed plan from the same matrix; the arrays
must agree byte for byte.  Kernel K2 (`_gathered_contrib`) is one
multiply per slot in both, so it matches exactly.  The full SpMV sums in
another order (the JAX package's sorted segment_sum vs the port's
index_add_), so f64 results agree to 1e-12, not bitwise; both also pass
the reference's 1e-3 check against the numpy oracle."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sblas_tpu.containers import DenseVector as JDenseVector
from sblas_tpu.io.generate import adversarial_skew, webbase_like
from sblas_tpu.ops import rspmv as jr
from sblas_tpu.ops.cpu_reference import spmv_cpu
from sblas_tpu_torch.config import DEFAULT
from sblas_tpu_torch.containers import CsrMatrix
from sblas_tpu_torch.ops import rspmv as tr
from sblas_tpu_torch.ops import route as troute
from sblas_tpu_torch.utils.errors import KernelError, PlanError
from sblas_tpu_torch.utils.verify import check_equal

# (matrix, config) cases: the slice's CPU-size webbase proxy (peel,
# relabel, appendix merge all active), peel off, stack cap off, relabel
# off, and a row-skewed matrix with no hub columns
CASES = {
    "webbase100k": (lambda: webbase_like(n=100_000, avg_deg=4.0), {}),
    "peel_off": (lambda: webbase_like(n=30_000, avg_deg=4.0),
                 {"routed_peel_threshold": 0}),
    "stack_cap_off": (lambda: webbase_like(n=100_000, avg_deg=4.0),
                      {"routed_stack_cap": 0}),
    "relabel_off": (lambda: webbase_like(n=30_000, avg_deg=4.0),
                    {"routed_relabel": False}),
    "row_skew": (lambda: adversarial_skew(), {}),
}
DTYPES = {"f32": (jnp.float32, torch.float32, np.float32),
          "f64": (jnp.float64, torch.float64, np.float64)}


@functools.lru_cache(maxsize=None)
def _matrix(case):
    return CASES[case][0]()


@functools.lru_cache(maxsize=None)
def _plans(case, dt):
    A = _matrix(case)
    cfg = dataclasses.replace(DEFAULT, **CASES[case][1])
    jdt, tdt, _ = DTYPES[dt]
    jp = jr.RoutedPlan.from_csr(A, dtype=jdt, config=cfg)
    At = CsrMatrix(A.row_ptr, A.col_idx, A.values, A.shape)
    tp = tr.RoutedPlan.from_csr(At, dtype=tdt, config=cfg, device="cpu")
    return jp, tp


def _jax_fields(jp):
    return {f: (tuple(np.asarray(t) for t in getattr(jp, f))
                if f in ("tables", "unrank_tables", "xroute_tables")
                else np.asarray(getattr(jp, f)))
            for f in tr.DATA_FIELDS}


def _assert_same_plan(jp, tp):
    for f, a in _jax_fields(jp).items():
        b = getattr(tp, f)
        if isinstance(a, tuple):
            assert len(a) == len(b), f
            for u, v in zip(a, b):
                assert u.dtype == v.numpy().dtype, f
                assert np.array_equal(u, v.numpy()), f
        else:
            assert a.dtype == b.numpy().dtype, (f, a.dtype, b.dtype)
            assert a.shape == tuple(b.shape), f
            assert np.array_equal(a, b.numpy()), f
    for f in tr.META_FIELDS:
        assert getattr(tp, f) == getattr(jp, f), f


@pytest.mark.parametrize("case,dt", [(c, "f64") for c in CASES]
                         + [("webbase100k", "f32")])
def test_plan_arrays_match_jax(case, dt):
    jp, tp = _plans(case, dt)
    _assert_same_plan(jp, tp)


def test_cases_cover_the_branches():
    """Between them the cases take every optional stage of the path."""
    plans = {c: _plans(c, "f64")[1] for c in CASES}
    main = plans["webbase100k"]
    assert main.n_prows and main.merged and main.xroute_n
    assert any(op[0] == "mix" for op in main.xroute_schedule)
    assert plans["peel_off"].n_prows == 0
    assert not plans["stack_cap_off"].merged
    assert plans["relabel_off"].xroute_n == 0
    assert plans["relabel_off"].xroute_tables == ()


@pytest.mark.parametrize("case", list(CASES))
def test_from_numpy_of_jax_plan(case):
    jp, tp = _plans(case, "f64")
    meta = {f: getattr(jp, f) for f in tr.META_FIELDS}
    conv = tr.RoutedPlan.from_numpy(_jax_fields(jp), meta, "cpu")
    _assert_same_plan(jp, conv)
    assert conv.device.type == "cpu" and conv.dtype == torch.float64
    assert conv.n_route_gathers == tp.n_route_gathers


@pytest.mark.parametrize("case", list(CASES))
def test_gathered_contrib_exact(case):
    jp, tp = _plans(case, "f64")
    x = JDenseVector.random(jp.shape[1]).values
    want = np.asarray(jr._gathered_contrib(jp, jnp.asarray(x)))
    got = tr._gathered_contrib(tp, torch.from_numpy(x)).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("alpha,beta", [(3.0, 4.0), (-2.5, 0.0)])
def test_spmv_routed_f64_matches_jax(case, alpha, beta):
    jp, tp = _plans(case, "f64")
    A = _matrix(case)
    x = JDenseVector.random(A.width)
    y = JDenseVector.constant(A.height, 1.0)
    want_j = np.asarray(jr.spmv_routed(jp, jnp.asarray(x.values), alpha,
                                       beta, jnp.asarray(y.values)))
    before = (troute.lane_shuffle.launches, tr.slab_gather.launches)
    got = tr.spmv_routed(tp, torch.from_numpy(x.values), alpha, beta,
                         torch.from_numpy(y.values)).numpy()
    assert (troute.lane_shuffle.launches, tr.slab_gather.launches) == before
    np.testing.assert_allclose(got, want_j, rtol=1e-12, atol=1e-12)
    oracle = spmv_cpu(A, x, alpha, beta, y)
    assert check_equal(got, oracle).ok
    assert check_equal(want_j, oracle).ok


def test_spmv_routed_f32_relative():
    jp, tp = _plans("webbase100k", "f32")
    A = _matrix("webbase100k")
    x = JDenseVector.random(A.width, dtype=np.float32)
    y = JDenseVector.constant(A.height, 1.0, dtype=np.float32)
    got = tr.spmv_routed(tp, torch.from_numpy(x.values), 3.0, 4.0,
                         torch.from_numpy(y.values))
    assert got.dtype == torch.float32
    want_j = np.asarray(jr.spmv_routed(jp, jnp.asarray(x.values), 3.0, 4.0,
                                       jnp.asarray(y.values)))
    oracle = spmv_cpu(A, x, 3.0, 4.0, y)
    assert check_equal(got.numpy(), oracle, relative=True).ok
    assert check_equal(want_j, oracle, relative=True).ok


def test_merge_targets_repeat():
    """Appendix pad slots all merge into rank 0, so merge_ids repeats
    targets; the merge must add every duplicate (index_add_), which the
    oracle checks above confirm end to end."""
    _, tp = _plans("row_skew", "f64")
    ids = tp.merge_ids.numpy()
    assert tp.merged and len(np.unique(ids)) < len(ids)


@pytest.mark.parametrize("case", list(CASES))
def test_brow_offsets_are_the_segments_of_brow_ids(case):
    """The segment sum's stored offsets (built from the stack layout)
    equal the runs of `brow_ids`, as a plan loaded from the JAX package
    derives them."""
    jp, tp = _plans(case, "f64")
    ids = tp.brow_ids.numpy()
    off = tp.brow_offsets.numpy()
    assert off.dtype == np.int64 and off.shape == (tp.n_blocks + 1,)
    assert off[0] == 0 and off[-1] == tp.n_srows
    assert np.array_equal(np.repeat(np.arange(tp.n_blocks), np.diff(off)),
                          ids)
    meta = {f: getattr(jp, f) for f in tr.META_FIELDS}
    conv = tr.RoutedPlan.from_numpy(_jax_fields(jp), meta, "cpu")
    assert torch.equal(conv.brow_offsets, tp.brow_offsets)


def test_plan_to_moves_every_tensor():
    _, tp = _plans("webbase100k", "f64")
    moved = tp.to("meta")
    assert moved.device.type == "meta"
    for f in tr.DATA_FIELDS + tr.RoutedPlan.PORT_FIELDS:
        v = getattr(moved, f)
        for t in (v if isinstance(v, tuple) else (v,)):
            assert t.device.type == "meta", f
    assert moved.schedule == tp.schedule and moved.shape == tp.shape


def test_bf16_transport_is_not_ported():
    A = _matrix("row_skew")
    At = CsrMatrix(A.row_ptr, A.col_idx, A.values, A.shape)
    cfg = dataclasses.replace(DEFAULT, routed_transport="bf16")
    with pytest.raises(PlanError, match="bf16"):
        tr.RoutedPlan.from_csr(At, dtype=torch.float32, config=cfg,
                               device="cpu")
    jp, _ = _plans("row_skew", "f64")
    meta = {f: getattr(jp, f) for f in tr.META_FIELDS}
    meta["transport"] = "bf16"
    with pytest.raises(PlanError, match="bf16"):
        tr.RoutedPlan.from_numpy(_jax_fields(jp), meta, "cpu")


def test_slab_gather_plain_and_refusal():
    rng = np.random.RandomState(5)
    x_slabs = torch.from_numpy(rng.standard_normal((3, 128, 128)))
    gslab = torch.tensor([2, 0, 2, 1], dtype=torch.int32)
    gidx = torch.from_numpy(rng.randint(0, 128, (4, 128, 128))
                            .astype(np.int32))
    gvals = torch.from_numpy(rng.standard_normal((4, 128, 128)))
    got = tr.slab_gather(gslab, x_slabs, gidx, gvals).numpy()
    xs, gi, gv = x_slabs.numpy(), gidx.numpy(), gvals.numpy()
    want = gv * np.take_along_axis(xs[gslab.numpy()], gi, axis=2)
    assert np.array_equal(got, want)
    with pytest.raises(KernelError):
        tr.slab_gather(gslab.to("meta"), x_slabs.to("meta"),
                       gidx.to("meta"), gvals.to("meta"))


def test_is_profitable_matches_jax():
    for case in ("webbase100k", "row_skew"):
        A = _matrix(case)
        At = CsrMatrix(A.row_ptr, A.col_idx, A.values, A.shape)
        assert (tr.RoutedPlan.is_profitable(At)
                == jr.RoutedPlan.is_profitable(A))
