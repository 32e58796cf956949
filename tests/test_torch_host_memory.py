"""Port parity of the host-streamed layer (the UM analog): host-resident
band plans, the streaming executor, `spmm_um` / `spmv_um` and the
tuning lifecycle, case for case with tests/test_host_memory.py.

Each case runs the JAX package and the port on the same seeded inputs
(f64): the bands must be byte-identical (the port-only K3 tables aside),
the results equal to 1e-12 and to the numpy oracle.  The JAX package's
`SBLAS_STREAM_CHUNK` cases become cases over the port's in-flight depth
(`_INFLIGHT` 1, 2, 3), with the bands on the device counted.  Also: the
JAX bands carried across (`from_numpy`), the plan-cache round trip, K3's
calls per band and per K-chunk, and the profiling harness's traces."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sblas_tpu.containers import DenseMatrix, DenseVector
from sblas_tpu.io.generate import (adversarial_skew, fem_banded_like,
                                   uniform_random, webbase_like)
from sblas_tpu.memory import host as jhost
from sblas_tpu.ops.cpu_reference import spmm_cpu, spmv_cpu
from sblas_tpu_torch import profiling
from sblas_tpu_torch.containers import CsrMatrix
from sblas_tpu_torch.io.plancache import load_plan, save_plan
from sblas_tpu_torch.memory import host as thost
from sblas_tpu_torch.ops import wcoo as twcoo
from sblas_tpu_torch.utils.errors import ShapeError
from sblas_tpu_torch.utils.verify import check_equal

F64 = torch.float64


def _port(A):
    return CsrMatrix(A.row_ptr, A.col_idx, A.values, A.shape)


def _jax_fields(band) -> dict:
    """A JAX band plan's data fields as numpy."""
    return {f.name: np.asarray(getattr(band, f.name))
            for f in dataclasses.fields(band)
            if isinstance(getattr(band, f.name), jax.Array)}


def assert_bands_identical(jbands, tbands):
    """Same classes, arrays byte for byte (dtype included), same static
    fields."""
    assert len(jbands) == len(tbands)
    for jb, tb in zip(jbands, tbands):
        assert type(jb).__name__ == type(tb).__name__
        for f in dataclasses.fields(jb):
            v = getattr(jb, f.name)
            if isinstance(v, jax.Array):
                got = getattr(tb, f.name).numpy()
                assert got.dtype == np.asarray(v).dtype, f.name
                np.testing.assert_array_equal(got, np.asarray(v))
            else:
                assert tuple(np.atleast_1d(getattr(tb, f.name))) == \
                    tuple(np.atleast_1d(v)), f.name


def _plans(A, budget, kind=None):
    jp = jhost.host_resident_plan(A, dtype=jnp.float64,
                                  hbm_budget_bytes=budget, kind=kind)
    tp = thost.host_resident_plan(_port(A), dtype=F64,
                                  hbm_budget_bytes=budget, kind=kind,
                                  device="cpu")
    assert (tp.kind, tp.n_bands, tp.band_rows) == \
        (jp.kind, jp.n_bands, jp.band_rows)
    assert_bands_identical(jp.bands, tp.bands)
    return jp, tp


def _spmm_both(A, jp, tp, k, tuning, alpha=3.0, beta=4.0):
    B = DenseMatrix.random(A.width, k)
    C = DenseMatrix.constant(A.height, k, 1.0)
    want = np.asarray(jhost.spmm_um(jp, jnp.asarray(B.values), alpha, beta,
                                    jnp.asarray(C.values), tuning=tuning))
    got = thost.spmm_um(tp, torch.from_numpy(B.values), alpha, beta,
                        torch.from_numpy(C.values), tuning=tuning).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    assert check_equal(got, spmm_cpu(A, B, alpha, beta, C)).ok
    return got


def _spmv_both(A, jp, tp, tuning, alpha=3.0, beta=4.0):
    x = DenseVector.random(A.width)
    y = DenseVector.constant(A.height, 1.0)
    want = np.asarray(jhost.spmv_um(jp, jnp.asarray(x.values), alpha, beta,
                                    jnp.asarray(y.values), tuning=tuning))
    got = thost.spmv_um(tp, torch.from_numpy(x.values), alpha, beta,
                        torch.from_numpy(y.values), tuning=tuning).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    assert check_equal(got, spmv_cpu(A, x, alpha, beta, y)).ok
    return got


def _streamed(tp, tuning):
    """An untuned call streamed every band, never more than `_INFLIGHT`
    on the device; a tuned one streamed nothing."""
    if tuning:
        assert tp.tuned and tp.last_stream is None
        return
    st = tp.last_stream
    assert st.bands == tp.n_bands
    assert st.peak_resident == min(thost._INFLIGHT, tp.n_bands)
    assert st.bytes == tp.band_bytes
    assert not tp.tuned


@pytest.fixture(scope="module")
def banded():
    return fem_banded_like(n=2000, half_band=40)


@pytest.fixture(scope="module")
def weblike():
    """Unstructured power-law matrix, the class of the reference's UM
    headline workload (webbase-1M via spmv_test_um, profiling.sh:16)."""
    return webbase_like(n=20000, avg_deg=3.0, seed=5, local_scale=200.0)


def test_band_partitioning(banded):
    jp, tp = _plans(banded, 256 << 10)
    assert tp.n_bands > 1
    assert tp.band_rows * tp.n_bands >= banded.height
    assert not tp.tuned and tp.device == torch.device("cpu")


@pytest.mark.parametrize("tuning", [False, True])
def test_spmm_um_matches_jax(banded, tuning):
    jp, tp = _plans(banded, 256 << 10)
    _spmm_both(banded, jp, tp, 16, tuning)
    assert tp.tuned == tuning == jp.tuned
    _streamed(tp, tuning)


@pytest.mark.parametrize("tuning", [False, True])
def test_spmv_um_matches_jax(banded, tuning):
    jp, tp = _plans(banded, 256 << 10)
    _spmv_both(banded, jp, tp, tuning)
    _streamed(tp, tuning)


def test_tuning_lifecycle(banded):
    """applyGpuTuning / removeGpuTuning / applyCpuTuning (matrix_um.h:
    529-614)."""
    _, tp = _plans(banded, 512 << 10)
    tp.apply_gpu_tuning()
    assert tp.tuned
    tp.remove_gpu_tuning()
    assert not tp.tuned
    tp.apply_gpu_tuning()
    tp.apply_cpu_tuning()
    assert not tp.tuned


def test_ell_fallback_kind():
    A = uniform_random(500, 400, 3, seed=6)
    jp, tp = _plans(A, 1 << 20)
    assert tp.kind == "ell"
    _spmv_both(A, jp, tp, False, alpha=2.0, beta=3.0)


def test_single_band_degenerate(banded):
    jp, tp = _plans(banded, 1 << 30)
    assert tp.n_bands == 1
    _spmv_both(banded, jp, tp, False, alpha=1.0, beta=1.0)
    _streamed(tp, False)


def test_bands_live_on_host(banded):
    """The bands stay in host memory (pinned only for a CUDA device: the
    `cuda` tests check that), tuned or not; tuning adds a device copy of
    each band (on the CPU, the band itself)."""
    _, tp = _plans(banded, 256 << 10)
    tp.apply_gpu_tuning()
    tensors = [getattr(b, k) for b in tp.bands
               for k in thost.tensor_fields(b)]
    assert all(t.device.type == "cpu" for t in tensors)
    assert len(tp._device_bands) == tp.n_bands


@pytest.mark.parametrize("tuning", [False, True])
def test_spmv_um_unstructured(weblike, tuning):
    """A webbase-class CSR with a budget below the matrix, both tuning
    modes."""
    jp, tp = _plans(weblike, weblike.nnz * (8 + 8 + 8) // 4)
    assert tp.kind == "wcoo" and tp.n_bands > 1
    _spmv_both(weblike, jp, tp, tuning)


@pytest.mark.parametrize("tuning", [False, True])
def test_spmm_um_unstructured(weblike, tuning):
    jp, tp = _plans(weblike, 1 << 20)
    # K3's tables differ in length from band to band: the ring hands K3
    # views of each band's true length
    units = {b.k3_units.shape[0] for b in tp.bands}
    assert len(units) > 1
    _spmm_both(weblike, jp, tp, 8, tuning)
    _streamed(tp, tuning)


def test_um_adversarial_skew_streams():
    A = adversarial_skew(m=2048, n=2048, heavy_rows=3, heavy_nnz=1024)
    jp, tp = _plans(A, 256 << 10)
    assert tp.kind in ("wcoo", "coo")
    _spmv_both(A, jp, tp, False, alpha=2.0, beta=1.0)


def test_um_forced_coo_kind(weblike):
    jp, tp = _plans(weblike, 1 << 20, kind="coo")
    assert tp.kind == "coo"
    _spmv_both(weblike, jp, tp, True, alpha=1.0, beta=2.0)


@pytest.mark.parametrize("tuning", [False, True])
def test_many_bands_against_jax_scan(tuning):
    """More bands than JAX's `_UNROLL_MAX_BANDS`: the JAX package's tuned
    call takes its `lax.scan` branch; the port loops as at any count."""
    A = fem_banded_like(n=3600, half_band=5)
    jp, tp = _plans(A, 40 << 10)
    assert tp.n_bands > jhost._UNROLL_MAX_BANDS
    _spmv_both(A, jp, tp, tuning, alpha=2.0, beta=3.0)
    _streamed(tp, tuning)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_inflight_depth(banded, weblike, depth, monkeypatch):
    """Streamed through 1, 2 or 3 device slots (the bands built as the JAX
    package builds them, for its depth of 3): the same bits as the tuned
    loop (every band kind here is deterministic on the CPU), at most
    `depth` bands on the device."""
    plans = [(A, *_plans(A, budget))
             for A, budget in ((banded, 128 << 10), (weblike, 1 << 20))]
    monkeypatch.setattr(thost, "_INFLIGHT", depth)
    for A, jp, tp in plans:
        assert tp.n_bands > depth
        got = _spmm_both(A, jp, tp, 8, False)
        assert tp.last_stream.peak_resident == depth
        assert np.array_equal(got, _spmm_both(A, jp, tp, 8, True))
        tp.remove_gpu_tuning()
        _spmv_both(A, jp, tp, False)
        assert tp.last_stream.peak_resident == depth


def test_k3_calls_per_band_and_chunk(weblike, monkeypatch):
    """A WCOO band SpMM is one K3 call per K-chunk, so a streamed call
    makes n_bands x chunks of them, as the JAX package's band loop."""
    _, tp = _plans(weblike, 1 << 20)
    calls = []
    orig = twcoo.window_reduce
    monkeypatch.setattr(twcoo, "window_reduce",
                        lambda *a, **k: calls.append(a[-1]) or orig(*a, **k))
    k = 40
    B = torch.rand((weblike.width, k), dtype=F64)
    thost.spmm_um(tp, B, 1.0, 0.0, torch.zeros((weblike.height, k),
                                               dtype=F64))
    kc = twcoo.k_chunk_width(tp.bands[0].n_tiles, k)
    assert len(calls) == tp.n_bands * -(-k // kc)


def test_operand_shape_is_checked(banded):
    _, tp = _plans(banded, 1 << 30)
    with pytest.raises(ShapeError):
        thost.spmv_um(tp, torch.zeros(7, dtype=F64), 1.0, 0.0,
                      torch.zeros(banded.height, dtype=F64))


@pytest.mark.parametrize("budget", [256 << 10, 1 << 20])
def test_bands_carried_from_jax(weblike, budget):
    """`HostResidentPlan.from_numpy` of the JAX package's band arrays
    (K3's tables derived) is the plan the port builds."""
    jp, tp = _plans(weblike, budget)
    got = thost.HostResidentPlan.from_numpy(
        [_jax_fields(b) for b in jp.bands],
        dict(band_rows=jp.band_rows, shape=jp.shape, nnz=jp.nnz,
             kind=jp.kind), "cpu")
    assert_bands_identical(jp.bands, got.bands)
    for a, b in zip(tp.bands, got.bands):
        assert torch.equal(a.k3_units, b.k3_units)
        assert torch.equal(a.k3_rows, b.k3_rows)
    _spmm_both(weblike, jp, got, 8, False)


def test_roundtrip_host_resident_plan(tmp_path):
    """Saved and loaded (tests/test_plancache.py's UM round trip): untuned
    on load, its bands on the host, the same results."""
    A = fem_banded_like(n=512, half_band=4, dtype=np.float64)
    jp, tp = _plans(A, 64 << 10)
    p = tmp_path / "um.npz"
    save_plan(str(p), tp)
    plan2 = load_plan(str(p), "cpu")
    assert (plan2.n_bands, plan2.kind) == (tp.n_bands, tp.kind)
    assert not plan2.tuned and plan2.device == torch.device("cpu")
    assert_bands_identical(jp.bands, plan2.bands)
    _spmv_both(A, jp, plan2, False)


def test_profiling_traces_small(tmp_path):
    """`python -m sblas_tpu_torch.profiling --small`: four traces, each
    with the run's range and its bands' copy and compute ranges."""
    assert profiling.main([str(tmp_path), "--small", "--device",
                           "cpu"]) == 0
    for run in ("spmm_um_tuning0", "spmm_um_tuning1", "spmv_um_tuning0",
                "spmv_um_tuning1"):
        names = {e.get("name") for e in json.loads(
            (tmp_path / f"{run}.json").read_text())["traceEvents"]}
        assert f"sblas.profile run={run}" in names
        assert "sblas.um.compute band=0" in names
        assert ("sblas.um.copy band=0" in names) == run.endswith("0")


def test_profiling_refuses_a_missing_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profiling.main([str(tmp_path), "--small"]) != 0
    assert profiling.main([str(tmp_path), "--device", "tpu"]) == 2
