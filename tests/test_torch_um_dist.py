"""Port parity of the multi-device UM ops: host-resident sparse A under
the v1 / v2 strategies (reference spmm_um.h:163-284, spmv_um.h:35-139),
case for case with tests/test_um_dist.py, and the two UM CLIs (the UM
cases of tests/test_cli.py).

The JAX package runs eight shards on its virtual 8-device mesh.  The
port runs one process per rank; here each of the eight ranks' compute
runs in turn on a `Mesh` of its rank, and the all-reduce is a host sum
of the eight partials, so the shards, their bands and every rank's
partial are held against `make_mesh(8)` to 1e-12 (f64) and against the
numpy oracle.  The real collective runs at world 1 in the CLIs and at
worlds 1 and 4 in tests/test_torch_parallel.py (`dryrun.run_cases`)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sblas_tpu.containers import DenseMatrix, DenseVector
from sblas_tpu.io.generate import (adversarial_skew, fem_banded_like,
                                   uniform_random, webbase_like)
from sblas_tpu.io.mmio import write_mtx
from sblas_tpu.memory import host as jhost
from sblas_tpu.memory import (host_resident_shards as j_shards,
                              spmm_um_dist as j_spmm_dist,
                              spmm_um_mode1 as j_mode1,
                              spmv_um_dist as j_spmv_dist)
from sblas_tpu.ops.cpu_reference import spmm_cpu, spmv_cpu
from sblas_tpu.parallel import make_mesh
from sblas_tpu_torch.cli import spmm_test_um, spmv_test_um
from sblas_tpu_torch.containers import CsrMatrix
from sblas_tpu_torch.io.plancache import load_plan, save_plan
from sblas_tpu_torch.memory import dist as tdist
from sblas_tpu_torch.memory import host as thost
from sblas_tpu_torch.parallel.mesh import Mesh
from sblas_tpu_torch.utils.errors import PartitionError
from sblas_tpu_torch.utils.verify import check_equal

N_DEV = 8
F64 = torch.float64
CPU = torch.device("cpu")


def _port(A):
    return CsrMatrix(A.row_ptr, A.col_idx, A.values, A.shape)


def _rank(r: int, size: int = N_DEV) -> Mesh:
    return Mesh(group=None, rank=r, size=size, device=CPU)


@pytest.fixture
def host_sum(monkeypatch):
    """The all-reduce replaced by a record of each rank's partial."""
    partials = []
    monkeypatch.setattr(tdist, "all_reduce",
                        lambda t, mesh: partials.append(t.clone()) or t)
    return partials


def _shards(A, budget, rank=None):
    """The JAX and port shard containers, checked equal: geometry,
    offsets and every (shard, band) plan's arrays byte for byte."""
    js = j_shards(A, N_DEV, dtype=jnp.float64, hbm_budget_bytes=budget)
    ts = tdist.host_resident_shards(_port(A), N_DEV, dtype=F64,
                                    hbm_budget_bytes=budget, device="cpu",
                                    rank=rank)
    assert (ts.kind, ts.n_bands, ts.band_rows, ts.n_shards) == \
        (js.kind, js.n_bands, js.band_rows, js.n_shards)
    assert np.array_equal(ts.offsets, js.offsets)
    for s, shard in enumerate(ts.shards):
        if shard is None:
            assert rank is not None and s != rank
            continue
        for b, band in enumerate(shard.bands):
            jb = js.bands[b]
            for f in thost.tensor_fields(band):
                if f in ("k3_units", "k3_rows"):
                    continue
                want = np.asarray(getattr(jb, f))[0, s]
                got = getattr(band, f).numpy()
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)
            assert band.shape == jb.shape and band.nnz == jb.nnz
    return js, ts


def _v2(op, ts, dense, partials, alpha, beta, tuning):
    """Every rank's partial of `op` (v2) summed on the host, folded with
    alpha and beta as the collective's caller folds them."""
    Y = dense[1]
    for r in range(N_DEV):
        zero = torch.zeros_like(Y)
        part = op(ts, dense[0], 1.0, 0.0, zero, _rank(r), tuning=tuning)
        assert torch.equal(part, partials[-1])
    assert len(partials) == N_DEV
    return (beta * Y + alpha * sum(partials)).numpy()


def _spmv(A, js, ts, partials, tuning, alpha=3.0, beta=4.0):
    x = DenseVector.random(A.width)
    y = DenseVector.constant(A.height, 1.0)
    want = np.asarray(j_spmv_dist(js, jnp.asarray(x.values), alpha, beta,
                                  jnp.asarray(y.values), make_mesh(N_DEV),
                                  tuning=tuning))
    got = _v2(tdist.spmv_um_dist, ts, (torch.from_numpy(x.values),
                                       torch.from_numpy(y.values)),
              partials, alpha, beta, tuning)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    assert check_equal(got, spmv_cpu(A, x, alpha, beta, y)).ok


def _spmm(A, js, ts, partials, k, tuning, alpha=3.0, beta=4.0):
    B = DenseMatrix.random(A.width, k)
    C = DenseMatrix.constant(A.height, k, 1.0)
    want = np.asarray(j_spmm_dist(js, jnp.asarray(B.values), alpha, beta,
                                  jnp.asarray(C.values), make_mesh(N_DEV),
                                  tuning=tuning))
    got = _v2(tdist.spmm_um_dist, ts, (torch.from_numpy(B.values),
                                       torch.from_numpy(C.values)),
              partials, alpha, beta, tuning)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    assert check_equal(got, spmm_cpu(A, B, alpha, beta, C)).ok


@pytest.fixture(scope="module")
def banded():
    return fem_banded_like(n=2100, half_band=30)


@pytest.fixture(scope="module")
def weblike():
    return webbase_like(n=12000, avg_deg=3.0, seed=8, local_scale=150.0)


@pytest.mark.parametrize("tuning", [False, True])
def test_spmv_um_dist_banded(banded, host_sum, tuning):
    js, ts = _shards(banded, 128 << 10)
    assert ts.n_bands > 1
    _spmv(banded, js, ts, host_sum, tuning)
    assert ts.tuned == tuning == js.tuned


@pytest.mark.parametrize("tuning", [False, True])
def test_spmv_um_dist_unstructured(weblike, host_sum, tuning):
    """The reference's UM headline shape: webbase-class SpMV, A host-
    resident and sharded, a budget below the matrix."""
    js, ts = _shards(weblike, 64 << 10)
    assert ts.kind in ("wcoo", "coo")
    _spmv(weblike, js, ts, host_sum, tuning, alpha=2.0, beta=3.0)


@pytest.mark.parametrize("tuning", [False, True])
def test_spmm_um_dist_mode2(banded, host_sum, tuning):
    js, ts = _shards(banded, 256 << 10)
    _spmm(banded, js, ts, host_sum, 8, tuning)


def _mode1(A, budget, k, tuning):
    jp = jhost.host_resident_plan(A, dtype=jnp.float64,
                                  hbm_budget_bytes=budget)
    tp = thost.host_resident_plan(_port(A), dtype=F64,
                                  hbm_budget_bytes=budget, device="cpu")
    B = DenseMatrix.random(A.width, k)
    C = DenseMatrix.constant(A.height, k, 1.0)
    want = np.asarray(j_mode1(jp, jnp.asarray(B.values), 3.0, 4.0,
                              jnp.asarray(C.values), make_mesh(N_DEV),
                              tuning=tuning))
    blocks = [tdist.spmm_um_mode1(tp, torch.from_numpy(B.values), 3.0, 4.0,
                                  torch.from_numpy(C.values), _rank(r),
                                  tuning=tuning) for r in range(N_DEV)]
    got = torch.cat(blocks, dim=1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    assert check_equal(got, spmm_cpu(A, B, 3.0, 4.0, C)).ok
    return tp


@pytest.mark.parametrize("tuning", [False, True])
def test_spmm_um_mode1(banded, tuning):
    tp = _mode1(banded, 256 << 10, 16, tuning)
    assert tp.tuned == tuning


def test_spmm_um_mode1_ragged_columns(weblike):
    """K = 13 over eight ranks: blocks of 2, the last ones cut or empty."""
    _mode1(weblike, 64 << 10, 13, False)


def test_spmm_um_dist_unstructured(weblike, host_sum):
    js, ts = _shards(weblike, 64 << 10)
    _spmm(weblike, js, ts, host_sum, 4, False, alpha=1.0, beta=2.0)


def test_um_dist_skewed_rows(host_sum):
    """Row-granular nnz-balanced shards under pathological skew."""
    A = adversarial_skew(m=1536, n=1536, heavy_rows=3, heavy_nnz=700)
    js, ts = _shards(A, 64 << 10)
    _spmv(A, js, ts, host_sum, False, alpha=2.0, beta=1.0)


def test_um_dist_tuning_lifecycle(banded):
    _, ts = _shards(banded, 128 << 10)
    ts.apply_gpu_tuning()
    assert ts.tuned
    ts.remove_gpu_tuning()
    assert not ts.tuned
    ts.apply_gpu_tuning()
    ts.apply_cpu_tuning()
    assert not ts.tuned


def test_um_dist_bands_on_host(weblike):
    _, ts = _shards(weblike, 64 << 10)
    for shard in ts.shards:
        for band in shard.bands:
            for f in thost.tensor_fields(band):
                assert getattr(band, f).device.type == "cpu"


@pytest.mark.parametrize("rank", [0, 5])
def test_each_rank_builds_its_own_shard(weblike, rank):
    """rank= builds shard `rank` alone, the same bands as a build of all
    (the dimensions are probed over every shard either way)."""
    _, ts = _shards(weblike, 64 << 10, rank=rank)
    assert [s is not None for s in ts.shards] == \
        [s == rank for s in range(N_DEV)]
    with pytest.raises(PartitionError, match="not on this rank"):
        ts.local((rank + 1) % N_DEV)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_um_dist_inflight_depth(banded, host_sum, depth, monkeypatch):
    """The rank's bands through 1, 2 or 3 device slots (the JAX cases
    over SBLAS_STREAM_CHUNK): the same results, at most `depth` bands on
    the device (the shards built for the JAX package's depth of 3)."""
    js, ts = _shards(banded, 128 << 10)
    monkeypatch.setattr(thost, "_INFLIGHT", depth)
    _spmv(banded, js, ts, host_sum, False)
    assert all(s.last_stream.peak_resident == min(depth, ts.n_bands)
               for s in ts.shards)
    host_sum.clear()
    _spmm(banded, js, ts, host_sum, 8, False)
    tp = _mode1(banded, 128 << 10, 16, False)
    assert tp.last_stream.peak_resident == depth


def test_um_dist_tuned_plan_streamed(banded, host_sum):
    """A tuned container driven with tuning=False computes from its device
    copies (nothing streamed)."""
    js, ts = _shards(banded, 128 << 10)
    ts.apply_gpu_tuning()
    _spmv(banded, js, ts, host_sum, False)
    assert ts.tuned and all(s.last_stream is None for s in ts.shards)


def test_um_dist_checks(banded):
    _, ts = _shards(banded, 128 << 10)
    x = torch.zeros(banded.width, dtype=F64)
    with pytest.raises(PartitionError, match="built for 8"):
        tdist.spmv_um_dist(ts, x, 1.0, 0.0, x, _rank(0, 4))


def test_shards_carried_from_jax(weblike, host_sum):
    """`HostResidentShards.from_numpy` of the JAX package's stacked bands
    is the container the port builds."""
    js, ts = _shards(weblike, 64 << 10)
    got = tdist.HostResidentShards.from_numpy(
        [{f: np.asarray(getattr(b, f)) for f in thost.tensor_fields(
            ts.shards[0].bands[0]) if f not in ("k3_units", "k3_rows")}
         for b in js.bands],
        dict(offsets=js.offsets, band_rows=js.band_rows,
             n_shards=js.n_shards, shape=js.shape, nnz=js.nnz,
             kind=js.kind), "cpu")
    for a, b in zip(ts.shards, got.shards):
        for pa, pb in zip(a.bands, b.bands):
            for f in thost.tensor_fields(pa):
                assert torch.equal(getattr(pa, f), getattr(pb, f))
    _spmv(weblike, js, got, host_sum, False)


def test_roundtrip_host_resident_shards(tmp_path, host_sum):
    """Saved and loaded (tests/test_plancache.py's UM shards round trip);
    `rank=` loads one shard."""
    A = uniform_random(512, 512, 3, seed=7)
    js, ts = _shards(A, 64 << 10)
    p = tmp_path / "umsh.npz"
    save_plan(str(p), ts)
    hs2 = load_plan(str(p), "cpu")
    assert (hs2.n_bands, hs2.n_shards) == (ts.n_bands, ts.n_shards)
    assert np.array_equal(hs2.offsets, ts.offsets)
    assert not hs2.tuned
    _spmv(A, js, hs2, host_sum, False)
    one = load_plan(str(p), "cpu", rank=3)
    assert [s is not None for s in one.shards] == \
        [s == 3 for s in range(N_DEV)]


# ---- the UM CLIs (tests/test_cli.py's UM cases), one rank ----

def _write(tmp_path_factory, A, name):
    coo = A.to_coo()
    path = tmp_path_factory.mktemp("cli") / name
    write_mtx(str(path), A.height, A.width, coo.row_idx, coo.col_idx,
              coo.values)
    return str(path)


@pytest.fixture(scope="module")
def mtx_path(tmp_path_factory):
    return _write(tmp_path_factory,
                  fem_banded_like(n=300, half_band=4, dtype=np.float64),
                  "band.mtx")


@pytest.fixture(scope="module")
def web_mtx_path(tmp_path_factory):
    return _write(tmp_path_factory,
                  webbase_like(n=4000, avg_deg=3.0, seed=12,
                               local_scale=100.0), "web.mtx")


def _ok(capsys, rc):
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "Validation = True" in out
    return out


def test_spmm_um_cli(mtx_path, capsys):
    out = _ok(capsys, spmm_test_um.main(
        ["2", mtx_path, "8", "3.0", "4.0", "1", "1", "f64", "--device",
         "cpu"]))
    assert "method single" in out and "tuning=1" in out


def test_spmv_um_cli(mtx_path, capsys):
    out = _ok(capsys, spmv_test_um.main(
        [mtx_path, "3.0", "4.0", "1", "0", "f64", "--device", "cpu"]))
    assert "tuning=0" in out


@pytest.mark.parametrize("method", ["1", "2"])
@pytest.mark.parametrize("tuning", ["0", "1"])
def test_spmm_um_cli_multidevice(mtx_path, method, tuning, capsys):
    """n_devices 4 in a world of one: the method's strategy on one rank."""
    out = _ok(capsys, spmm_test_um.main(
        [method, mtx_path, "8", "3.0", "4.0", "4", tuning, "f64",
         "--device", "cpu"]))
    assert "running on 1" in out and "1 device(s)" in out
    assert f"method {method}" in out


@pytest.mark.parametrize("tuning", ["0", "1"])
def test_spmv_um_cli_multidevice(mtx_path, tuning, capsys):
    _ok(capsys, spmv_test_um.main(
        [mtx_path, "3.0", "4.0", "4", tuning, "f64", "--device", "cpu"]))


@pytest.mark.parametrize("tuning", ["0", "1"])
def test_spmv_um_cli_unstructured_budget(web_mtx_path, tuning, capsys,
                                         monkeypatch):
    """spmv_test_um on the webbase-class proxy with SBLAS_HBM_BUDGET
    below the matrix, both tuning modes: several WCOO bands, nnz/s."""
    monkeypatch.setenv("SBLAS_HBM_BUDGET", str(64 << 10))
    out = _ok(capsys, spmv_test_um.main(
        [web_mtx_path, "2.0", "3.0", "1", tuning, "f64", "--device",
         "cpu"]))
    assert "nnz/s" in out and "[wcoo]" in out
    assert "1 band(s)" not in out


def test_um_cli_usage_errors(mtx_path, monkeypatch):
    for argv in (["3", mtx_path, "8", "1", "1", "1", "--device", "cpu"],
                 ["1", mtx_path, "8", "1", "1", "1", "2", "--device",
                  "cpu"],
                 ["1", mtx_path, "8", "1", "1", "1", "--device", "tpu"]):
        with pytest.raises(SystemExit):
            spmm_test_um.main(argv)
    with pytest.raises(SystemExit):
        spmv_test_um.main([mtx_path, "1", "1"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert spmv_test_um.main([mtx_path, "1", "1", "1"]) != 0
    assert spmm_test_um.main(["1", mtx_path, "8", "1", "1", "1"]) != 0
