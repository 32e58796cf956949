"""Port parity of the plan cache (`sblas_tpu_torch/io/plancache.py`): the
cases of tests/test_plancache.py for the ported classes, RoutedPlan and
WcooPlan files written by `sblas_tpu`'s `save_plan` loaded in the port
(the WcooPlan's port-only K3 tables derived on load, as for a file saved
before they existed), the
rebuild of a drifted file by `cached_plan`, per-rank loading of shard
containers, and `spmv_test --plan-cache`."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sblas_tpu.io import generate as jgen
from sblas_tpu.io.mmio import write_mtx
from sblas_tpu.io.plancache import save_plan as j_save_plan
from sblas_tpu.containers import DenseMatrix as JDenseMatrix
from sblas_tpu.ops import rspmv as jr
from sblas_tpu.ops import wcoo as jw
from sblas_tpu_torch import parallel as tpar
from sblas_tpu_torch.cli import spmv_test
from sblas_tpu_torch.config import SBlasConfig as TConfig
from sblas_tpu_torch.containers import CsrMatrix, DenseVector
from sblas_tpu_torch.io.plancache import (cached_plan, load_plan, place,
                                          save_plan)
from sblas_tpu_torch.ops import make_plan, spmv
from sblas_tpu_torch.ops import spmm
from sblas_tpu_torch.ops.rspmv import RoutedPlan
from sblas_tpu_torch.ops.wcoo import WcooPlan
from sblas_tpu_torch.parallel.mesh import Mesh
from sblas_tpu_torch.utils.errors import FormatError

F64 = torch.float64


def _port(A):
    return CsrMatrix(A.row_ptr, A.col_idx, A.values, A.shape)


def _tensors(obj, prefix=""):
    """{dotted name: tensor} of every tensor reachable from a plan."""
    out = {}
    for name, v in vars(obj).items():
        key = prefix + name
        if isinstance(v, torch.Tensor):
            out[key] = v
        elif isinstance(v, tuple):
            for i, e in enumerate(v):
                if isinstance(e, torch.Tensor):
                    out[f"{key}[{i}]"] = e
                elif e is not None and hasattr(e, "__dataclass_fields__"):
                    out.update(_tensors(e, f"{key}[{i}]."))
        elif hasattr(v, "__dataclass_fields__"):
            out.update(_tensors(v, key + "."))
    return out


def _assert_same_plan(a, b):
    assert type(a) is type(b)
    ta, tb = _tensors(a), _tensors(b)
    assert sorted(ta) == sorted(tb)
    for k in ta:
        assert ta[k].dtype == tb[k].dtype, k
        assert torch.equal(ta[k], tb[k]), k
    for f in a.__dataclass_fields__:
        v = getattr(a, f)
        if hasattr(v, "__dataclass_fields__"):
            _assert_same_plan(v, getattr(b, f))
        elif not isinstance(v, (torch.Tensor, tuple)) or f in (
                "shape", "schedule", "unrank_schedule", "xroute_schedule",
                "offsets", "block"):
            assert v == getattr(b, f), f


def _xy(A):
    x = torch.from_numpy(DenseVector.random(A.width).values)
    y = torch.ones(A.height, dtype=F64)
    return x, y


@pytest.mark.parametrize("kind", ["dia", "bsr", "ell", "wcoo", "coo"])
def test_roundtrip_structured(tmp_path, kind):
    A = _port(jgen.fem_banded_like(n=600, half_band=5))
    plan = make_plan(A, dtype=F64, force=kind, device="cpu")
    p = str(tmp_path / f"{kind}.npz")
    save_plan(p, plan)
    plan2 = load_plan(p, "cpu")
    _assert_same_plan(plan, plan2)
    x, y = _xy(A)
    assert torch.equal(spmv(plan, x, 3.0, 4.0, y),
                       spmv(plan2, x, 3.0, 4.0, y))


def test_roundtrip_routed(tmp_path):
    A = _port(jgen.uniform_random(2000, 70000, 3, seed=4))
    plan = RoutedPlan.from_csr(A, dtype=F64, device="cpu")
    p = str(tmp_path / "routed.npz")
    save_plan(p, plan)
    plan2 = load_plan(p, "cpu")
    assert plan2.schedule == plan.schedule
    assert plan2.unrank_schedule == plan.unrank_schedule
    _assert_same_plan(plan, plan2)
    x, y = _xy(A)
    assert torch.equal(spmv(plan, x, 2.0, 3.0, y),
                       spmv(plan2, x, 2.0, 3.0, y))


def test_jax_written_routed_plan_loads(tmp_path):
    """A RoutedPlan file saved by `sblas_tpu.io.plancache.save_plan`
    loads in the port, equal to the port's own plan, and computes the
    same product as the JAX package."""
    A = jgen.webbase_like(n=30_000, avg_deg=4.0)
    jp = jr.RoutedPlan.from_csr(A, dtype=jnp.float64)
    p = str(tmp_path / "jax_routed.npz")
    j_save_plan(p, jp)
    tp = load_plan(p, "cpu")
    _assert_same_plan(RoutedPlan.from_csr(_port(A), dtype=F64,
                                          device="cpu"), tp)
    x = DenseVector.random(A.width).values
    y = np.ones(A.height)
    want = np.asarray(jr.spmv_routed(jp, jnp.asarray(x), 3.0, 4.0,
                                     jnp.asarray(y)))
    got = spmv(tp, torch.from_numpy(x), 3.0, 4.0, torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def test_jax_written_wcoo_plan_loads(tmp_path):
    """A WcooPlan file saved by `sblas_tpu.io.plancache.save_plan` lacks
    the port-only K3 tables: they are derived on load, equal to the port's
    own plan's, and the loaded plan computes the JAX package's SpMM."""
    A = jgen.webbase_like(n=6_000, avg_deg=4.0)
    jp = jw.WcooPlan.from_csr(A, dtype=jnp.float64)
    p = str(tmp_path / "jax_wcoo.npz")
    j_save_plan(p, jp)
    tp = load_plan(p, "cpu")
    _assert_same_plan(WcooPlan.from_csr(_port(A), dtype=F64, device="cpu"),
                      tp)
    B = JDenseMatrix.random(A.width, 24).values
    C = np.ones((A.height, 24))
    want = np.asarray(jw.spmm_wcoo(jp, jnp.asarray(B), 3.0, 4.0,
                                   jnp.asarray(C)))
    got = spmm(tp, torch.from_numpy(B), 3.0, 4.0, torch.from_numpy(C))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


def test_wcoo_file_without_k3_tables_loads(tmp_path):
    """A port-written WcooPlan file from before the K3 tables existed
    (here: one with them taken out) loads with them derived, through the
    loader's `put`."""
    A = _port(jgen.webbase_like(n=3_000, avg_deg=3.0))
    plan = make_plan(A, dtype=F64, force="wcoo", device="cpu")
    p = str(tmp_path / "old_wcoo.npz")
    save_plan(p, plan)

    def drop(blobs, meta):
        for name in WcooPlan.PORT_FIELDS:
            del blobs[f"a:{name}"]
            del meta["__dtypes__"][f"a:{name}"]
    _rewrite(p, drop)
    _assert_same_plan(plan, load_plan(p, "cpu"))
    assert load_plan(p, "meta").k3_units.device.type == "meta"


def _rewrite(p, edit):
    """Rewrite the .npz at p after `edit(blobs, meta)`."""
    with np.load(p) as z:
        blobs = {k: z[k] for k in z.files}
    meta = json.loads(bytes(blobs["__meta__"]).decode())
    edit(blobs, meta)
    blobs["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                      dtype=np.uint8)
    np.savez_compressed(p, **blobs)


def test_dtype_guard(tmp_path):
    """A load whose dtype differs from the recorded one fails loudly."""
    A = _port(jgen.fem_banded_like(n=300, half_band=4))
    p = str(tmp_path / "guard.npz")
    save_plan(p, make_plan(A, dtype=F64, force="ell", device="cpu"))

    def claim_f16(blobs, meta):
        key = next(k for k, v in meta["__dtypes__"].items()
                   if v == "float64")
        meta["__dtypes__"][key] = "float16"
    _rewrite(p, claim_f16)
    with pytest.raises(FormatError):
        load_plan(p, "cpu")


def test_dtype_recorded(tmp_path):
    A = _port(jgen.fem_banded_like(n=300, half_band=4))
    plan = make_plan(A, dtype=F64, force="coo", device="cpu")
    p = str(tmp_path / "rec.npz")
    save_plan(p, plan)
    with np.load(p) as z:
        rec = json.loads(bytes(z["__meta__"]).decode())["__dtypes__"]
    assert rec["a:vals"] == "float64" and rec["a:rows"] == "int32"
    assert load_plan(p, "cpu").vals.dtype == F64
    # a put that converts is refused
    with pytest.raises(FormatError):
        load_plan(p, put=lambda a: torch.from_numpy(a).float())


def test_load_files_without_the_dtype_record(tmp_path):
    A = _port(jgen.fem_banded_like(n=300, half_band=4))
    p = str(tmp_path / "old.npz")
    save_plan(p, make_plan(A, dtype=F64, force="ell", device="cpu"))
    _rewrite(p, lambda blobs, meta: meta.pop("__dtypes__"))
    assert type(load_plan(p, "cpu")).__name__ == "EllPlan"


def test_load_needs_a_device(tmp_path):
    A = _port(jgen.fem_banded_like(n=300, half_band=4))
    p = str(tmp_path / "d.npz")
    save_plan(p, make_plan(A, dtype=F64, force="coo", device="cpu"))
    with pytest.raises(ValueError, match="device"):
        load_plan(p)
    assert load_plan(p, device="meta").vals.device.type == "meta"


def test_schema_drift_raises_format_error(tmp_path):
    A = _port(jgen.fem_banded_like(n=256, half_band=4))
    p = str(tmp_path / "p.npz")
    save_plan(p, make_plan(A, dtype=F64, force="coo", device="cpu"))
    with np.load(p) as z:
        data = {k: z[k] for k in z.files}
    del data[next(k for k in data if k.startswith(("a:", "n:")))]
    np.savez(p, **data)
    with pytest.raises(FormatError):
        load_plan(p, "cpu")


def test_cached_plan_rebuilds_a_drifted_file(tmp_path):
    A = _port(jgen.fem_banded_like(n=256, half_band=4))
    p = str(tmp_path / "sub" / "c.npz")
    builds = []

    def build():
        builds.append(1)
        return make_plan(A, dtype=F64, force="coo", device="cpu")

    first = cached_plan(p, build, device="cpu")
    again = cached_plan(p, build, device="cpu")
    assert len(builds) == 1
    _assert_same_plan(first, again)
    with np.load(p) as z:
        data = {k: z[k] for k in z.files}
    del data["a:rows"]
    np.savez(p, **data)
    rebuilt = cached_plan(p, build, device="cpu")
    assert len(builds) == 2
    _assert_same_plan(first, rebuilt)
    _assert_same_plan(first, load_plan(p, "cpu"))   # the file was rewritten
    cached_plan(p, build, valid=lambda plan: False, device="cpu")
    assert len(builds) == 3


# ---- shard containers: every shard saved, one placed per rank ----

def _nocomm_per_rank(shards, twin, x):
    return [twin(shards, x, Mesh(None, s, shards.n_shards, "cpu"))
            for s in range(shards.n_shards)]


SHARDS = {
    "row_plans_ell": (lambda: jgen.fem_banded_like(n=640, half_band=4),
                      lambda A: tpar.partition_row_plans(
                          A, 8, dtype=F64, kind="ell", device="cpu"),
                      tpar.spmv_dist_planned_nocomm),
    "row_plans_coo": (lambda: jgen.fem_banded_like(n=640, half_band=4),
                      lambda A: tpar.partition_row_plans(
                          A, 8, dtype=F64, kind="coo", device="cpu"),
                      tpar.spmv_dist_planned_nocomm),
    "routed_shards": (lambda: jgen.uniform_random(512, 512, 3, seed=5),
                      lambda A: tpar.partition_row_plans(
                          A, 8, dtype=F64, kind="routed", device="cpu",
                          config=TConfig(routed_min_nnz=256,
                                         routed_min_width=256)),
                      tpar.spmv_dist_planned_nocomm),
    "halo_dia_shards": (lambda: jgen.fem_banded_like(n=640, half_band=3),
                        lambda A: tpar.partition_halo_dia(
                            A, 8, dtype=F64, device="cpu"),
                        None),
    "xfoot_shards": (lambda: jgen.webbase_like(n=8_000, avg_deg=3.0, seed=6,
                                               local_scale=150.0),
                     lambda A: tpar.partition_xfoot(
                         A, 8, dtype=F64, kind="coo", device="cpu"),
                     tpar.spmv_xfoot_nocomm),
}


@pytest.mark.parametrize("name", sorted(SHARDS))
def test_roundtrip_shards(tmp_path, name):
    make_a, partition, twin = SHARDS[name]
    A = _port(make_a())
    shards = partition(A)
    p = str(tmp_path / f"{name}.npz")
    save_plan(p, shards)
    loaded = load_plan(p, "cpu")
    for f in shards.__dataclass_fields__:
        if f != "plans":
            assert getattr(loaded, f) == getattr(shards, f), f
    for a, b in zip(shards.plans, loaded.plans):
        _assert_same_plan(a, b)
    if twin is not None:
        x = torch.from_numpy(DenseVector.random(A.width).values)
        for a, b in zip(_nocomm_per_rank(shards, twin, x),
                        _nocomm_per_rank(loaded, twin, x)):
            assert torch.equal(a, b)
    # one rank's load keeps only its shard, as partition(rank=3) places
    mine = load_plan(p, "cpu", rank=3)
    assert [q is not None for q in mine.plans] == [s == 3 for s in range(8)]
    _assert_same_plan(shards.plans[3], mine.plans[3])
    placed = place(shards, "cpu", 3)
    assert [q is not None for q in placed.plans] == \
        [q is not None for q in mine.plans]


def test_xfoot_stats_roundtrip(tmp_path):
    A = _port(jgen.webbase_like(n=8_000, avg_deg=3.0, seed=6,
                                local_scale=150.0))
    shards = tpar.partition_xfoot(A, 8, dtype=F64, kind="coo",
                                  extract="route", device="cpu")
    p = str(tmp_path / "x.npz")
    save_plan(p, shards)
    loaded = load_plan(p, "cpu")
    assert type(loaded.stats) is type(shards.stats)
    assert loaded.stats == shards.stats and loaded.hot_total > 0
    assert loaded.xroute_schedule == shards.xroute_schedule
    assert len(loaded.plans[0].xroute_tables) > 0


# ---- spmv_test --plan-cache ----

@pytest.fixture(scope="module")
def mtx(tmp_path_factory):
    d = tmp_path_factory.mktemp("mtx")
    paths = {}
    for name, A in (("web", jgen.webbase_like(n=20_000, avg_deg=4.0)),
                    ("band", jgen.fem_banded_like(n=2000, half_band=5))):
        coo = A.to_coo()
        paths[name] = str(d / f"{name}.mtx")
        write_mtx(paths[name], A.height, A.width, coo.row_idx, coo.col_idx,
                  coo.values)
    return paths


@pytest.mark.parametrize("mode", ["single", "distp", "xfoot", "halop"])
def test_cli_plan_cache_saves_then_loads(tmp_path, capsys, mtx, mode):
    cache = str(tmp_path / f"{mode}.npz")
    path = mtx["band" if mode == "halop" else "web"]
    argv = [path, "3", "4", "1", "f64", "--mode", mode, "--device", "cpu",
            "--plan-cache", cache]
    assert spmv_test.main(argv) == 0
    out = capsys.readouterr().out
    assert f"plan cache: saved {cache}" in out and "Validation = True" in out
    assert spmv_test.main(argv) == 0
    out = capsys.readouterr().out
    assert f"plan cache: loaded {cache}" in out and "Validation = True" in out


def test_cli_stale_plan_cache_raises(tmp_path, capsys, mtx):
    cache = str(tmp_path / "x.npz")
    base = ["3", "4", "1", "f64", "--mode", "xfoot", "--device", "cpu",
            "--plan-cache", cache]
    assert spmv_test.main([mtx["web"], *base]) == 0
    capsys.readouterr()
    with pytest.raises(FormatError, match="was built for shape"):
        spmv_test.main([mtx["band"], *base])
