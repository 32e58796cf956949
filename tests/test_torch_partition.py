"""Port parity of the distribution layer's host code: the partitioners,
the routed shard sizing, and the per-shard plans.

Every array the port builds must equal the JAX package's byte for byte:
`partition_nnz_balanced`, `partition_row_blocks`, `partition_halo_dia`,
`partition_row_plans` for every shard kind (shard s of the port against
row s of the JAX package's stacked plan), `routed_shard_sizes`,
`shared_routed_sizes` and `RoutedPlan.from_csr` with the `min_*` sizes."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sblas_tpu.config import SBlasConfig as JConfig
from sblas_tpu.containers import CsrMatrix as JCsrMatrix
from sblas_tpu.io import generate as jgen
from sblas_tpu.ops import rspmv as jr
from sblas_tpu import partition as jpart
from sblas_tpu.parallel import planned as jplanned
from sblas_tpu_torch import partition as tpart
from sblas_tpu_torch.config import SBlasConfig as TConfig
from sblas_tpu_torch.containers import CsrMatrix
from sblas_tpu_torch.ops import rspmv as tr
from sblas_tpu_torch.parallel import planned as tplanned
from sblas_tpu_torch.utils.errors import PartitionError

N = 4
DT = {"f64": (jnp.float64, torch.float64), "f32": (jnp.float32, torch.float32)}
ROUTED = dict(routed_min_nnz=1000, routed_min_width=512)

MATRICES = {
    "banded": lambda: jgen.fem_banded_like(n=1100, half_band=6),
    "ragged": lambda: jgen.uniform_random(900, 700, nnz_per_row=5, seed=11),
    "skew": lambda: jgen.adversarial_skew(m=1024, n=1024, heavy_rows=2,
                                          heavy_nnz=512),
    "web": lambda: jgen.webbase_like(n=9000, avg_deg=3.0, seed=17,
                                     local_scale=120.0),
    "routed": lambda: jgen.uniform_random(1500, 1024, nnz_per_row=4, seed=3),
    "tiny": lambda: jgen.pattern_symmetric(),
}


@functools.lru_cache(maxsize=None)
def _matrix(name):
    return MATRICES[name]()


def _port(A):
    return CsrMatrix(A.row_ptr, A.col_idx, A.values, A.shape)


def _same(a, t, what):
    a = np.asarray(a)
    b = t.numpy()
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.array_equal(a, b), what


def _assert_shard(jplan, s, tplan):
    """Port plan `tplan` equals shard s of the JAX package's stacked plan
    (every field the JAX plan has; `WcooPlan.k3_units` and `k3_rows` are
    port-only)."""
    assert type(jplan).__name__ == type(tplan).__name__
    for f in dataclasses.fields(jplan):
        a, b = getattr(jplan, f.name), getattr(tplan, f.name)
        if isinstance(a, jax.Array):
            _same(np.asarray(a)[s], b, f.name)
        elif isinstance(a, tuple) and a and isinstance(a[0], jax.Array):
            assert len(a) == len(b), f.name
            for u, v in zip(a, b):
                _same(np.asarray(u)[s], v, f.name)
        else:
            assert a == b, (f.name, a, b)


@pytest.mark.parametrize("name", ["banded", "ragged", "skew", "tiny"])
@pytest.mark.parametrize("n", [1, 3, 4])
@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_partition_nnz_balanced_matches_jax(name, n, dt):
    A = _matrix(name)
    j = jpart.partition_nnz_balanced(A, n, dtype=DT[dt][0])
    t = tpart.partition_nnz_balanced(_port(A), n, dtype=DT[dt][1],
                                     device="cpu")
    for f in ("rows", "cols", "vals"):
        _same(getattr(j, f), getattr(t, f), f)
    for f in ("shape", "nnz", "n_shards", "starting_rows", "stopping_rows",
              "seg_nnz"):
        assert getattr(j, f) == getattr(t, f), f
    assert jpart.partition_report(j) == tpart.partition_report(t)


def test_more_shards_than_nnz():
    A = _matrix("tiny")
    j = jpart.partition_nnz_balanced(A, A.nnz + 3, dtype=jnp.float64)
    t = tpart.partition_nnz_balanced(_port(A), A.nnz + 3,
                                     dtype=torch.float64, device="cpu")
    _same(j.rows, t.rows, "rows")
    assert j.stopping_rows == t.stopping_rows


@pytest.mark.parametrize("name", ["banded", "ragged", "tiny"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_partition_row_blocks_matches_jax(name, n):
    A = _matrix(name)
    if A.shape[0] != A.shape[1]:
        with pytest.raises(PartitionError):
            tpart.partition_row_blocks(_port(A), n, device="cpu")
        return
    j = jpart.partition_row_blocks(A, n, dtype=jnp.float64)
    t = tpart.partition_row_blocks(_port(A), n, dtype=torch.float64,
                                   device="cpu")
    for f in ("cols", "vals", "local_rows"):
        _same(getattr(j, f), getattr(t, f), f)
    for f in ("shape", "nnz", "n_shards", "rows_per_shard", "halo_left",
              "halo_right"):
        assert getattr(j, f) == getattr(t, f), f


def test_partitions_reject_bad_counts():
    A = _port(_matrix("tiny"))
    for fn in (tpart.partition_nnz_balanced, tpart.partition_row_blocks):
        with pytest.raises(PartitionError):
            fn(A, 0, device="cpu")


@functools.lru_cache(maxsize=None)
def _row_plans(name, kind, dt="f64", op=None, routed_cfg=False):
    A = _matrix(name)
    jcfg = JConfig(**ROUTED) if routed_cfg else JConfig()
    tcfg = TConfig(**ROUTED) if routed_cfg else TConfig()
    j = jplanned.partition_row_plans(A, N, dtype=DT[dt][0], kind=kind,
                                     op=op, config=jcfg)
    t = tplanned.partition_row_plans(_port(A), N, dtype=DT[dt][1],
                                     kind=kind, op=op, config=tcfg,
                                     device="cpu")
    return j, t


ROW_PLAN_CASES = [("banded", "bsr"), ("banded", "ell"), ("banded", "dia"),
                  ("ragged", "ell"), ("web", "wcoo"), ("web", "coo"),
                  ("skew", "coo"), ("banded", None), ("ragged", None)]


@pytest.mark.parametrize("name,kind", ROW_PLAN_CASES)
def test_partition_row_plans_match_jax(name, kind):
    j, t = _row_plans(name, kind)
    assert t.kind == j.kind and t.band_rows == j.band_rows
    assert (t.shape, t.nnz, t.n_shards) == (j.shape, j.nnz, j.n_shards)
    assert t.row_offsets == tuple(np.asarray(j.row_offsets)[:, 0].tolist())
    for s in range(N):
        _assert_shard(j.plan, s, t.plans[s])


def test_partition_row_plans_f32():
    j, t = _row_plans("web", "wcoo", "f32")
    for s in range(N):
        _assert_shard(j.plan, s, t.plans[s])
        assert t.plans[s].dtype == torch.float32


def test_wcoo_degrades_to_coo_like_jax():
    """A matrix whose shards tile-split badly falls back to COO shards in
    both packages (probe_band_dims)."""
    A = jgen.scattered_sparse(n=20_000, nnz=600)
    j = jplanned.partition_row_plans(A, N, dtype=jnp.float64, kind="wcoo")
    t = tplanned.partition_row_plans(_port(A), N, dtype=torch.float64,
                                     kind="wcoo", device="cpu")
    assert t.kind == j.kind == "coo"
    for s in range(N):
        _assert_shard(j.plan, s, t.plans[s])


@pytest.mark.parametrize("dt", ["f64", "f32"])
def test_routed_row_plans_match_jax(dt):
    j, t = _row_plans("routed", "routed", dt, routed_cfg=True)
    assert t.kind == "routed"
    for s in range(N):
        _assert_shard(j.plan, s, t.plans[s])
    assert len({p.schedule for p in t.plans}) == 1


def test_routed_chosen_for_spmv_only():
    A = jgen.adversarial_skew(m=1500, n=1024, heavy_rows=2, heavy_nnz=512,
                              seed=3)
    for op in ("spmv", None):
        jk = jplanned.pick_shard_kind(A, op, JConfig(**ROUTED))
        tk = tplanned.pick_shard_kind(_port(A), op, TConfig(**ROUTED))
        assert tk == jk
    assert tplanned.pick_shard_kind(_port(A), "spmv",
                                    TConfig(**ROUTED)) == "routed"


@pytest.mark.parametrize("name", ["routed", "web", "skew"])
def test_routed_shard_sizes_match_jax(name):
    A = _matrix(name)
    bounds = jplanned._row_boundaries(A, N)
    band = int(np.max(bounds[1:] - bounds[:-1]))
    subs = [jplanned._local_csr(A, int(bounds[s]), int(bounds[s + 1]),
                                band) for s in range(N)]
    jsz = [jr.routed_shard_sizes(sub) for sub in subs]
    tsz = [tr.routed_shard_sizes(_port(sub)) for sub in subs]
    assert jsz == tsz
    assert (jplanned.shared_routed_sizes(jsz)
            == tplanned.shared_routed_sizes(tsz))


def test_shared_routed_sizes_corrects_the_stack_depth():
    """The 513-vs-512 case: a shard with the deepest natural stack but a
    small appendix gains pad blocks when its appendix grows to the shared
    slot count."""
    sizes = [(3, 512, 0, 0), (2, 400, 1, 300)]
    assert tplanned.shared_routed_sizes(sizes) == (3, 515, 1, 300)
    assert (tplanned.shared_routed_sizes(sizes)
            == jplanned.shared_routed_sizes(sizes))


@pytest.mark.parametrize("mins", [(0, 0, 0, 0), (40, 900, 7, 300)])
def test_routed_from_csr_min_sizes_match_jax(mins):
    A = _matrix("skew")
    kw = dict(zip(("min_gtiles", "min_srows", "min_prows", "min_sranks"),
                  mins))
    jp = jr.RoutedPlan.from_csr(A, dtype=jnp.float64, **kw)
    tp = tr.RoutedPlan.from_csr(_port(A), dtype=torch.float64,
                                device="cpu", **kw)
    for f in tr.DATA_FIELDS:
        a, b = getattr(jp, f), getattr(tp, f)
        if isinstance(a, tuple):
            assert len(a) == len(b)
            for u, v in zip(a, b):
                _same(u, v, f)
        else:
            _same(a, b, f)
    for f in tr.META_FIELDS:
        assert getattr(jp, f) == getattr(tp, f), f
    if mins[0]:
        assert tp.n_gtiles == 40 and tp.n_prows >= 7


def test_empty_routed_shard_builds_identity_relabel():
    """A shard with no entries still carries an x route when min_gtiles
    is set (every shard shares one schedule), as in the JAX package."""
    m, n = 256, 40_000
    A = CsrMatrix(np.zeros(m + 1, np.int64), np.zeros(0, np.int64),
                  np.zeros(0), (m, n))
    jA = JCsrMatrix(A.row_ptr, A.col_idx, A.values, A.shape)
    jp = jr.RoutedPlan.from_csr(jA, dtype=jnp.float64, min_gtiles=2)
    tp = tr.RoutedPlan.from_csr(A, dtype=torch.float64, min_gtiles=2,
                                device="cpu")
    assert tp.xroute_n == jp.xroute_n > 0
    assert tp.xroute_schedule == jp.xroute_schedule
    _same(jp.gslab, tp.gslab, "gslab")


@pytest.mark.parametrize("n", [1, 4])
def test_partition_halo_dia_matches_jax(n):
    A = _matrix("banded")
    j = jplanned.partition_halo_dia(A, n, dtype=jnp.float64)
    t = tplanned.partition_halo_dia(_port(A), n, dtype=torch.float64,
                                    device="cpu")
    assert (t.shape, t.nnz, t.n_shards, t.rows_per_shard) == (
        j.shape, j.nnz, j.n_shards, j.rows_per_shard)
    for s in range(n):
        _assert_shard(j.plan, s, t.plans[s])


def test_halo_dia_rejects_wide_footprint():
    A = _port(_matrix("web"))
    with pytest.raises(PartitionError, match="halo"):
        tplanned.partition_halo_dia(A, 4, device="cpu")


def test_rank_places_only_its_shard():
    A = _port(_matrix("banded"))
    t = tplanned.partition_row_plans(A, N, dtype=torch.float64, kind="ell",
                                     device="meta", rank=2)
    assert [p is None for p in t.plans] == [True, True, False, True]
    assert t.local(2).device.type == "meta"
    with pytest.raises(PartitionError, match="shard 1"):
        t.local(1)
    h = tplanned.partition_halo_dia(A, N, device="meta", rank=0)
    assert h.local(0).device.type == "meta" and h.plans[3] is None


def test_unknown_shard_kind():
    with pytest.raises(PartitionError):
        tplanned.partition_row_plans(_port(_matrix("banded")), 2,
                                     kind="csr", device="cpu")
