"""Port parity of the footprint-compressed x exchange
(`sblas_tpu_torch/parallel/xfoot.py`) against `sblas_tpu/parallel/xfoot.py`.

* the cases of tests/test_xfoot.py at world 1 (a gloo group of one made
  in-process), against the JAX package on make_mesh(1) to 1e-12 in f64
  and against the numpy oracle;
* at n = 4 and 8: the exchange geometry (`_xfoot_analyze`), the
  extraction tables of both engines, `hot_put`/`hot_cnt` and every
  shard's plan arrays equal the JAX package's stacked `XFootShards`, and
  `xfoot_worst_local` equals its;
* each rank's `spmv_xfoot_nocomm` (a `Mesh` with no group) against the
  JAX package's nocomm twin on make_mesh(4);
* the extraction engine as a function of the port's constants;
* `spmv_test --mode xfoot` at one rank.

The exchange at four ranks runs in test_torch_parallel.py's spawned dry
run (cases xfoot, xfoot_route, xfoot_routed)."""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from sblas_tpu import parallel as jpar
from sblas_tpu import scaling as jscaling
from sblas_tpu.config import SBlasConfig as JConfig
from sblas_tpu.containers import DenseVector
from sblas_tpu.io import generate as jgen
from sblas_tpu.io.mmio import write_mtx
from sblas_tpu.ops.cpu_reference import spmv_cpu
from sblas_tpu.parallel import xfoot as jx
from sblas_tpu.utils.errors import PartitionError as JPartitionError
from sblas_tpu_torch import parallel as tpar
from sblas_tpu_torch import scaling as tscaling
from sblas_tpu_torch.cli import spmv_test
from sblas_tpu_torch.config import SBlasConfig as TConfig
from sblas_tpu_torch.containers import CsrMatrix
from sblas_tpu_torch.ops import route as troute
from sblas_tpu_torch.ops import rspmv as tr
from sblas_tpu_torch.parallel import xfoot as tx
from sblas_tpu_torch.parallel.mesh import Mesh
from sblas_tpu_torch.utils.errors import PartitionError, ShapeError
from sblas_tpu_torch.utils.verify import check_equal

F64 = jnp.float64
ROUTED = dict(routed_min_nnz=256, routed_min_width=256)
QMIN4 = dict(xfoot_hot_qmin=4)

MATRICES = {
    "banded": lambda: jgen.fem_banded_like(n=1024, half_band=5),
    "web": lambda: jgen.webbase_like(n=20_000, avg_deg=3.0, seed=3,
                                     local_scale=200.0),
    "web5": lambda: jgen.webbase_like(n=20_000, avg_deg=3.0, seed=5,
                                      local_scale=200.0),
    "uniform": lambda: jgen.uniform_random(1024, 1024, nnz_per_row=4,
                                           seed=9),
    "adversarial": lambda: jgen.adversarial_skew(m=2048, n=2048),
    "rect": lambda: jgen.uniform_random(1500, 700, nnz_per_row=3, seed=4),
    "routed": lambda: jgen.uniform_random(2048, 2048, nnz_per_row=3,
                                          seed=7),
    "band512": lambda: jgen.fem_banded_like(n=512, half_band=3),
    "ab": lambda: jgen.uniform_random(512, 512, nnz_per_row=3, seed=11),
    "single": lambda: jgen.uniform_random(300, 300, nnz_per_row=3, seed=2),
}


@functools.lru_cache(maxsize=None)
def _matrix(name):
    return MATRICES[name]()


def _port(A):
    return CsrMatrix(A.row_ptr, A.col_idx, A.values, A.shape)


def _both(name, n, cfg=None, **kw):
    """(A, JAX XFootShards, port XFootShards with every shard on the CPU)."""
    A = _matrix(name)
    cfg = cfg or {}
    js = jpar.partition_xfoot(A, n, dtype=F64, config=JConfig(**cfg), **kw)
    ts = tpar.partition_xfoot(_port(A), n, dtype=torch.float64,
                              config=TConfig(**cfg), device="cpu", **kw)
    return A, js, ts


def _same(a, t, what):
    a = np.asarray(a)
    b = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    assert np.array_equal(a, b), what


def _assert_shard(jplan, s, tplan):
    """Port plan `tplan` equals shard s of the JAX package's stacked plan
    (every field the JAX plan has)."""
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


def _geometry(st):
    """XFootStats without the engine price (the two packages price with
    different constants)."""
    return tuple(st._replace(extract_mode="", extract_ns=0.0))


# ---- world 1: the cases of tests/test_xfoot.py in a group of one ----

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


WORLD1 = {
    "banded": ("banded", {}, {}),
    "webbase_wcoo": ("web", {}, dict(kind="wcoo")),
    "engine_flat": ("web5", {}, dict(kind="coo", extract="flat")),
    "engine_route": ("web5", {}, dict(kind="coo", extract="route")),
    "uniform": ("uniform", {}, {}),
    "adversarial": ("adversarial", {}, {}),
    "rectangular": ("rect", {}, {}),
    "routed_kind": ("routed", ROUTED, dict(kind="routed")),
    "coo": ("band512", {}, dict(kind="coo")),
    "ell": ("band512", {}, dict(kind="ell")),
    "dia": ("band512", {}, dict(kind="dia")),
    "single_shard": ("single", {}, {}),
    "forced_hot_qmin": ("web", QMIN4, {}),
}


@pytest.mark.parametrize("case", sorted(WORLD1))
def test_world1_matches_jax(world1, case):
    name, cfg, kw = WORLD1[case]
    A, js, ts = _both(name, 1, cfg, **kw)
    x = DenseVector.random(A.width).values
    y = np.ones(A.height)
    want = np.asarray(jpar.spmv_xfoot(js, jnp.asarray(x), 3.0, 4.0,
                                      jnp.asarray(y), jpar.make_mesh(1)))
    got = tpar.spmv_xfoot(ts, torch.from_numpy(x), 3.0, 4.0,
                          torch.from_numpy(y), world1).numpy()
    assert got.shape == want.shape == (A.height,)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    oracle = spmv_cpu(A, DenseVector(x), 3.0, 4.0, DenseVector(y))
    assert check_equal(got, oracle).ok
    assert ts.kind == js.kind and ts.stats.hot_qmin == js.stats.hot_qmin
    assert _geometry(ts.stats) == _geometry(js.stats)


def test_world1_alpha_beta(world1):
    A, js, ts = _both("ab", 1)
    x = DenseVector.random(A.width).values
    y = np.random.RandomState(1).random_sample(A.height)
    want = np.asarray(jpar.spmv_xfoot(js, jnp.asarray(x), 1.0, 0.0,
                                      jnp.asarray(y), jpar.make_mesh(1)))
    got = tpar.spmv_xfoot(ts, torch.from_numpy(x), 1.0, 0.0,
                          torch.from_numpy(y), world1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    assert check_equal(got, spmv_cpu(A, DenseVector(x), 1.0, 0.0,
                                     DenseVector(y))).ok


def test_world1_nocomm_twin_is_the_product(world1):
    """At world 1 nothing is remote: the nocomm twin is alpha=1, beta=0."""
    A, _, ts = _both("banded", 1)
    x = torch.from_numpy(DenseVector.random(A.width).values)
    full = tpar.spmv_xfoot(ts, x, 1.0, 0.0,
                           torch.zeros(A.height, dtype=torch.float64),
                           world1)
    nc = tpar.spmv_xfoot_nocomm(ts, x, world1)
    assert nc.shape == full.shape and torch.equal(nc, full)


def test_world1_routed_launch_counts(world1, monkeypatch):
    """A routed xfoot shard goes through K2' once and never through K2."""
    A, _, ts = _both("routed", 1, ROUTED, kind="routed")
    calls = []
    for name in ("tile_gather", "slab_gather"):
        orig = getattr(tr, name)
        monkeypatch.setattr(tr, name, lambda *a, _f=orig, _n=name:
                            calls.append(_n) or _f(*a))
    x = torch.from_numpy(DenseVector.random(A.width).values)
    tpar.spmv_xfoot(ts, x, 1.0, 0.0, torch.zeros(A.height,
                                                 dtype=torch.float64),
                    world1)
    assert calls == ["tile_gather"]


def test_world1_checks(world1):
    A, _, ts = _both("banded", 1)
    x = torch.ones(A.width, dtype=torch.float64)
    with pytest.raises(ShapeError):
        tpar.spmv_xfoot(ts, x[:-1], 1.0, 0.0, x, world1)
    _, _, t2 = _both("banded", 2)
    with pytest.raises(PartitionError, match="built for 2"):
        tpar.spmv_xfoot(t2, x, 1.0, 0.0, x, world1)


def test_cli_xfoot_one_rank(tmp_path, capsys):
    A = jgen.webbase_like(n=20_000, avg_deg=4.0)
    coo = A.to_coo()
    path = str(tmp_path / "web.mtx")
    write_mtx(path, A.height, A.width, coo.row_idx, coo.col_idx, coo.values)
    rc = spmv_test.main([path, "3", "4", "1", "f64", "--mode", "xfoot",
                         "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and "Validation = True" in out, out
    assert "mode xfoot" in out and "xfoot shards: kind=" in out


# ---- n = 4 and 8: geometry, tables and shard plans byte for byte ----

@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("name", ["banded", "web", "uniform", "adversarial",
                                  "rect"])
def test_analysis_matches_jax(name, n):
    A = _matrix(name)
    jl = jx._xfoot_analyze(A, n)
    tl = tx._xfoot_analyze(_port(A), n)
    for k in ("band_rows", "r_x", "H_tot", "Hmax", "P", "route_space",
              "dup"):
        assert jl[k] == tl[k], k
    for k in ("hot_own", "hot_off", "hot_cols"):
        _same(jl[k], tl[k], k)
    assert sorted(jl["packets"]) == sorted(tl["packets"])
    for key, grp in jl["packets"].items():
        _same(grp, tl["packets"][key], key)
    assert _geometry(tl["stats"]) == _geometry(jl["stats"])
    assert _geometry(tpar.xfoot_stats(_port(A), n)) == \
        _geometry(jpar.xfoot_stats(A, n))
    src, used = tx.send_tables(tl, n)
    assert src.shape == used.shape == (n, tl["Hmax"] + n * tl["P"])


@pytest.mark.parametrize("engine", ["flat", "route"])
@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("name,kind,cfg", [
    ("web", "coo", {}), ("banded", "dia", {}), ("uniform", "ell", {}),
    ("rect", "coo", {}), ("routed", "routed", ROUTED)])
def test_partition_matches_jax(name, kind, cfg, n, engine):
    _, js, ts = _both(name, n, cfg, kind=kind, extract=engine)
    for f in ("shape", "nnz", "n_shards", "band_rows", "r_x", "kind",
              "hot_total", "hot_own_max", "packet_pad", "extract_mode",
              "xroute_schedule", "xroute_n"):
        assert getattr(ts, f) == getattr(js, f), f
    assert _geometry(ts.stats) == _geometry(js.stats)
    assert ts.stats.extract_mode == engine
    _same(np.asarray(js.hot_put)[:, 0], np.asarray(ts.hot_put, np.int32),
          "hot_put")
    _same(np.asarray(js.hot_cnt)[:, 0], np.asarray(ts.hot_cnt, np.int32),
          "hot_cnt")
    send = np.asarray(js.send_idx)
    for s in range(n):
        part = ts.plans[s]
        _same(send[s], part.send_idx, "send_idx")
        assert len(part.xroute_tables) == len(js.xroute_tables)
        for u, v in zip(js.xroute_tables, part.xroute_tables):
            _same(np.asarray(u)[s], v, "xroute_tables")
        _assert_shard(js.plan, s, part.plan)
    if engine == "route":
        assert ts.xroute_n > 0 and len(ts.plans[0].xroute_tables) > 0
    else:
        assert ts.plans[0].send_idx.shape[0] == ts.out_slots > 0


@pytest.mark.parametrize("name", ["web", "banded"])
def test_worst_local_matches_jax(name):
    A = _matrix(name)
    jloc, jsizes = jx.xfoot_worst_local(A, 4)
    tloc, tsizes = tx.xfoot_worst_local(_port(A), 4)
    assert tsizes == jsizes and tloc.shape == jloc.shape
    for f in ("row_ptr", "col_idx", "values"):
        _same(getattr(jloc, f), getattr(tloc, f), f)


# ---- each rank's compute: the nocomm twin with no process group ----

@pytest.mark.parametrize("name,kind,cfg,engine", [
    ("banded", None, {}, "flat"), ("banded", None, {}, "route"),
    ("web", "coo", {}, "flat"), ("web", "wcoo", {}, "route"),
    ("uniform", None, {}, "route"), ("adversarial", None, {}, "flat"),
    ("rect", None, {}, "route"), ("routed", "routed", ROUTED, "route")])
def test_nocomm_per_rank_matches_jax(name, kind, cfg, engine):
    A, js, ts = _both(name, 4, cfg, kind=kind, extract=engine)
    x = DenseVector.random(A.width).values
    want = np.asarray(jpar.spmv_xfoot_nocomm(js, jnp.asarray(x),
                                             jpar.make_mesh(4)))
    L = ts.band_rows
    got = [tpar.spmv_xfoot_nocomm(ts, torch.from_numpy(x),
                                  Mesh(None, s, 4, "cpu")).numpy()
           for s in range(4)]
    np.testing.assert_allclose(np.concatenate(got), want, rtol=1e-12,
                               atol=1e-12)
    assert all(len(g) == len(want[s * L:(s + 1) * L])
               for s, g in enumerate(got))


def test_route_extraction_runs_k1(monkeypatch):
    """The route engine's extraction goes through K1's wrapper once per
    `gather` layer of its schedule; the flat one never does."""
    A, _, ts = _both("web5", 4, kind="coo", extract="route")
    calls = []
    orig = troute.lane_shuffle
    monkeypatch.setattr(troute, "lane_shuffle",
                        lambda *a: calls.append(1) or orig(*a))
    x = torch.from_numpy(DenseVector.random(A.width).values)
    got = tx.xfoot_extract(ts, ts.plans[1], x[ts.r_x: 2 * ts.r_x])
    n_k1 = len(calls)
    assert n_k1 == sum(op[0] == "gather" for op in ts.xroute_schedule) > 0
    _, _, tf = _both("web5", 4, kind="coo", extract="flat")
    want = tx.xfoot_extract(tf, tf.plans[1], x[ts.r_x: 2 * ts.r_x])
    assert len(calls) == n_k1
    _, used = tx.send_tables(tx._xfoot_analyze(_port(A), 4), 4)
    assert torch.equal(got[torch.from_numpy(used[1])],
                       want[torch.from_numpy(used[1])])


def test_forced_hot_qmin(monkeypatch):
    """A forced hot_qmin > 2 demotes low-q hot columns into duplicated
    packets: the flat engine expresses them (and matches the JAX package
    per rank), the route engine refuses in both packages."""
    A, js, ts = _both("web", 8, QMIN4)
    _, jb, tb = _both("web", 8)
    assert ts.stats.hot_qmin == 4 and tb.stats.hot_qmin == 2
    assert ts.extract_mode == "flat"
    assert ts.hot_total == js.hot_total < tb.hot_total == jb.hot_total
    assert ts.packet_pad >= tb.packet_pad
    x = DenseVector.random(A.width).values
    want = np.asarray(jpar.spmv_xfoot_nocomm(js, jnp.asarray(x),
                                             jpar.make_mesh(8)))
    got = np.concatenate([tpar.spmv_xfoot_nocomm(
        ts, torch.from_numpy(x), Mesh(None, s, 8, "cpu")).numpy()
        for s in range(8)])
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    with pytest.raises(PartitionError, match="duplicated packets"):
        tpar.partition_xfoot(_port(A), 8, dtype=torch.float64,
                             config=TConfig(**QMIN4), extract="route",
                             device="cpu")
    with pytest.raises(JPartitionError):
        jpar.partition_xfoot(A, 8, dtype=F64, config=JConfig(**QMIN4),
                             extract="route")


def test_default_hot_qmin_keeps_route_bijective():
    _, js, ts = _both("web5", 8, extract="route")
    assert ts.extract_mode == js.extract_mode == "route"
    assert ts.stats.hot_qmin == 2


def test_rank_places_only_its_shard():
    ts = tpar.partition_xfoot(_port(_matrix("banded")), 4,
                              dtype=torch.float64, device="meta", rank=2)
    assert [p is None for p in ts.plans] == [True, True, False, True]
    assert ts.local(2).plan.vals.device.type == "meta"
    with pytest.raises(PartitionError, match="not on this rank"):
        ts.local(0)


# ---- the extraction engine follows the port's constants ----

@pytest.mark.parametrize("gather_ns,route_ns,mode", [
    (1.0, 1e-6, "route"), (1e-6, 1.0, "flat")])
def test_engine_choice_follows_the_ports_constants(monkeypatch, gather_ns,
                                                   route_ns, mode):
    for mod in (tscaling, jscaling):
        monkeypatch.setattr(mod, "GATHER_NS", gather_ns)
        monkeypatch.setattr(mod, "ROUTE_NS", route_ns)
    A = _matrix("web")
    st = tpar.xfoot_stats(_port(A), 4)
    assert st.extract_mode == mode
    lay = tx._xfoot_analyze(_port(A), 4)
    out_slots = lay["Hmax"] + 4 * lay["P"]
    assert st.extract_ns == (gather_ns * out_slots if mode == "flat"
                             else route_ns * lay["route_space"])
    # with the same constants the two packages choose and price alike
    assert tuple(st) == tuple(jpar.xfoot_stats(A, 4))
    ts = tpar.partition_xfoot(_port(A), 4, dtype=torch.float64, kind="coo",
                              device="cpu")
    assert ts.extract_mode == mode


def test_constants_are_the_ports_own(monkeypatch):
    assert tscaling.GATHER_NS == tscaling._H100_GATHER_NS or \
        "SBLAS_GATHER_NS" in os.environ
    assert "H100" in tscaling.param_provenance() or \
        "SBLAS_" in tscaling.param_provenance()
    monkeypatch.setenv("SBLAS_ROUTE_NS", "0.5")
    assert tscaling._const("SBLAS_ROUTE_NS", 1.0) == (0.5,
                                                      "env SBLAS_ROUTE_NS")
    monkeypatch.delenv("SBLAS_ROUTE_NS")
    assert tscaling._const("SBLAS_ROUTE_NS", 1.0)[0] == 1.0


def test_stats_single_shard_has_no_exchange():
    st = tpar.xfoot_stats(_port(_matrix("web")), 1)
    assert st.comm_bytes(8) == 0 and st.hot_total == 0 and \
        st.packet_pad == 0 and st.extract_mode == "none"
    st4 = tpar.xfoot_stats(_port(_matrix("web")), 4)
    assert st4.comm_bytes(8) == jpar.xfoot_stats(_matrix("web"),
                                                 4).comm_bytes(8) > 0
