"""Port parity: sblas_tpu_torch.ops.rspmv against sblas_tpu.ops.rspmv.

Both packages build their routed plan from the same matrix; the arrays
must agree byte for byte.  Kernel K2 (`_gathered_contrib`) is one
multiply per slot in both, so it matches exactly.  The full SpMV sums in
another order (the JAX package's sorted segment_sum vs the port's
index_add_), so f64 results agree to 1e-12, not bitwise; both also pass
the reference's 1e-3 check against the numpy oracle."""

import dataclasses
import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sblas_tpu.containers import DenseVector as JDenseVector
from sblas_tpu.io.generate import adversarial_skew, webbase_like
from sblas_tpu.ops import rspmv as jr
from sblas_tpu.ops.cpu_reference import spmv_cpu
from sblas_tpu_torch import _kernels
from sblas_tpu_torch.config import DEFAULT
from sblas_tpu_torch.containers import CsrMatrix
from sblas_tpu_torch.ops import rspmv as tr
from sblas_tpu_torch.ops import route as troute
from sblas_tpu_torch.tools import k1k2_variants
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


def test_bf16_transport_plan_from_jax_fields():
    """A JAX-built bf16-transport plan (f32 values, int16 main-route
    tables) loads through `from_numpy` as it is and equals the port's own
    build; its transport refuses f64 values and unknown names."""
    A = _matrix("row_skew")
    At = CsrMatrix(A.row_ptr, A.col_idx, A.values, A.shape)
    cfg = dataclasses.replace(DEFAULT, routed_transport="bf16")
    jp = jr.RoutedPlan.from_csr(A, dtype=jnp.float32, config=cfg)
    meta = {f: getattr(jp, f) for f in tr.META_FIELDS}
    conv = tr.RoutedPlan.from_numpy(_jax_fields(jp), meta, "cpu")
    own = tr.RoutedPlan.from_csr(At, dtype=torch.float32, config=cfg,
                                 device="cpu")
    _assert_same_plan(jp, own)
    assert conv.transport == own.transport == "bf16"
    assert all(t.dtype == torch.int16 for t in conv.tables)
    x = torch.from_numpy(JDenseVector.random(A.width).values.astype(
        np.float32))
    assert torch.equal(tr.spmv_routed(conv, x, 2.0, 0.0, x[: A.height]),
                       tr.spmv_routed(own, x, 2.0, 0.0, x[: A.height]))
    jp64, _ = _plans("row_skew", "f64")
    meta64 = {f: getattr(jp64, f) for f in tr.META_FIELDS}
    for transport in ("bf16", "f16"):
        with pytest.raises(PlanError):
            tr.RoutedPlan.from_numpy(_jax_fields(jp64),
                                     dict(meta64, transport=transport),
                                     "cpu")


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


# ---- K1 and K2 on the port's own paths take their row bodies ----
#
# K1's and K2's one body, the row body, reads and writes its vector
# operands (K1's x, idx and out; K2's gidx, gvals and out) as vectors, and
# on the card their wrappers copy one that does not start on 16 bytes to
# fresh storage first.  Each path below records every operand its K1 and
# K2 calls get (here the plain versions run them), and must give only
# operands on 16 bytes, so that no port path pays the copy.

@functools.lru_cache(maxsize=None)
def _web20k():
    from sblas_tpu_torch.io.generate import webbase_like as twebbase_like
    return twebbase_like(n=20000, avg_deg=4.0)


@pytest.fixture
def kernel_bases(monkeypatch):
    """(kernel, operand, byte offset mod 16) of every K1 and K2 call the
    test makes, through every module that calls them."""
    from sblas_tpu_torch.experiments import stage_fuse_probe as sfp
    seen = []
    k1, k2 = troute.lane_shuffle, tr.slab_gather

    def record(kernel, **operands):
        seen.extend((kernel, name, t.data_ptr() % 16)
                    for name, t in operands.items())

    def lane_shuffle(x2d, idx):
        out = k1(x2d, idx)
        record("K1", x2d=x2d, idx=idx, out=out)
        return out

    def slab_gather(gslab, x_slabs, gidx, gvals, out_dtype=None):
        out = k2(gslab, x_slabs, gidx, gvals, out_dtype)
        record("K2", gidx=gidx, gvals=gvals, out=out)   # x: by element
        return out

    for mod in (troute, sfp):
        monkeypatch.setattr(mod, "lane_shuffle", lane_shuffle)
    for mod in (tr, sfp):
        monkeypatch.setattr(mod, "slab_gather", slab_gather)
    return seen


def _paths_run(path):
    """Run one of the port's paths through K1 and K2 on the CPU."""
    from sblas_tpu_torch.experiments.stage_fuse_probe import (
        pass1_tiles_stock, spmv_routed_fused1)
    from sblas_tpu_torch.ops import make_plan, spmv
    from sblas_tpu_torch.parallel import Mesh, partition_xfoot
    from sblas_tpu_torch.parallel.modes import row_block
    from sblas_tpu_torch.parallel.xfoot import (xfoot_extract,
                                                xfoot_worst_local)
    A = _web20k()
    dtype = {"f64": torch.float64, "bf16": torch.bfloat16}.get(
        path, torch.float32)
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.standard_normal(A.shape[1])).to(dtype)
    y = torch.from_numpy(rng.standard_normal(A.shape[0])).to(dtype)
    if path == "xfoot4":
        local, (tg, srs, prs, sks) = xfoot_worst_local(A, 4)
        plan = tr.RoutedPlan.from_csr(local, dtype=dtype, min_gtiles=tg,
                                      min_srows=srs, min_prows=prs,
                                      min_sranks=sks, device="cpu")
        xl = x[1: 1 + local.shape[1]]      # a view one element in
        tr.spmv_routed(plan, xl, 3.0, 4.0, y[: local.shape[0]])
        for rank in range(4):
            sh = partition_xfoot(A, 4, dtype=dtype, kind="coo",
                                 extract="route", device="cpu", rank=rank)
            mesh = Mesh(None, rank, 4, torch.device("cpu"))
            xfoot_extract(sh, sh.local(rank),
                          row_block(x, mesh, sh.r_x * 4))
        return
    plan = make_plan(A, dtype=dtype, force="routed", device="cpu")
    if path == "bf16_transport":
        plan = plan.with_transport("bf16")
    if path == "stage_fuse":
        spmv_routed_fused1(plan, x, 3.0, 4.0, y)
        pass1_tiles_stock(plan, x)
        return
    spmv(plan, x, 3.0, 4.0, y)


@pytest.mark.parametrize("path", ["f32", "f64", "bf16", "bf16_transport",
                                  "xfoot4", "stage_fuse"])
def test_port_paths_give_k1_k2_row_aligned_bases(kernel_bases, path):
    _paths_run(path)
    kernels = {k for k, *_ in kernel_bases}
    assert kernels == {"K1", "K2"}
    off = [rec for rec in kernel_bases if rec[2]]
    assert not off, f"operands off 16 bytes: {off[:5]}"


@pytest.mark.parametrize("variant", sorted(k1k2_variants.VARIANTS))
def test_k1k2_variant_patches_match_the_sources(variant):
    """Every copy the K1/K2 variants tool builds is made from the current
    sources: each of its patches matches exactly once and changes the
    text (the tool's base copies, `k1` and `k2`, are the sources)."""
    kernel, name, patches = k1k2_variants.VARIANTS[variant]
    with open(os.path.join(_kernels.CSRC_DIR, name)) as fh:
        src = fh.read()
    copy = k1k2_variants.patched_sources()[variant]
    assert (copy == src) == (not patches)
    assert f"sblas_{kernel}_f32" in copy
