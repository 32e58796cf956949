"""Port parity for the SpMM slice's plain-torch layers: COO, ELL and DIA
SpMV/SpMM, the dispatchers, `make_plan_fast`, the elementwise ops and the
`spmm_test` CLI on the CPU, each against the JAX package on the same
inputs.

Plan arrays must agree byte for byte.  The port sums with `index_add_`
and `addcmul_` where the JAX package uses a sorted `segment_sum` and a
fused XLA loop, so f64 results agree to 1e-12 relative, not bitwise;
f32 results meet the numpy oracle at the reference's 1e-3."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sblas_tpu.ops as jops
from sblas_tpu.containers import DenseMatrix as JDenseMatrix
from sblas_tpu.containers import DenseVector as JDenseVector
from sblas_tpu.io import generate as jgen
from sblas_tpu.ops.spmm import _auto_chunks as j_auto_chunks
from sblas_tpu.ops.spmm import spmm_coo as j_spmm_coo
from sblas_tpu.ops.spmm import spmm_ell as j_spmm_ell
from sblas_tpu.ops.cpu_reference import spmm_cpu, spmv_cpu
import sblas_tpu_torch.ops as tops
from sblas_tpu_torch.cli import spmm_test
from sblas_tpu_torch.containers import CsrMatrix
from sblas_tpu_torch.io.mmio import write_mtx
from sblas_tpu_torch.ops.spmm import _auto_chunks, spmm_coo, spmm_ell
from sblas_tpu_torch.utils.errors import PlanError
from sblas_tpu_torch.utils.timing import spmm_flops, spmv_flops
from sblas_tpu_torch.utils.verify import check_equal

MATRICES = {
    "web": lambda: jgen.webbase_like(n=3000, avg_deg=3.0),
    "band": lambda: jgen.fem_banded_like(n=700, half_band=9),
    "shell": lambda: jgen.fem_shell_like(nx=16, ny=8, n_target=768),
    "uniform": lambda: jgen.uniform_random(300, 250, 4, seed=5),
}
KINDS = ("coo", "ell", "dia")
ALPHA, BETA = 3.0, 4.0


@functools.lru_cache(maxsize=None)
def _matrix(name):
    return MATRICES[name]()


def _port(A):
    return CsrMatrix(A.row_ptr, A.col_idx, A.values, A.shape)


@functools.lru_cache(maxsize=None)
def _plans(name, kind, dt="f64"):
    A = _matrix(name)
    jdt, tdt = ((jnp.float64, torch.float64) if dt == "f64"
                else (jnp.float32, torch.float32))
    return (jops.make_plan(A, dtype=jdt, force=kind),
            tops.make_plan(_port(A), dtype=tdt, force=kind, device="cpu"))


def _tensor_fields(jp):
    return {f.name: np.asarray(getattr(jp, f.name))
            for f in dataclasses.fields(jp)
            if hasattr(getattr(jp, f.name), "dtype")}


def _operands(A, k):
    B = JDenseMatrix.random(A.width, k)
    C = JDenseMatrix.constant(A.height, k, 1.0)
    return B, C


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("name", list(MATRICES))
def test_plan_arrays_match_jax_and_round_trip(name, kind):
    jp, tp = _plans(name, kind)
    fields = _tensor_fields(jp)
    for f, want in fields.items():
        got = getattr(tp, f).numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want), f
    meta = {f.name: getattr(jp, f.name) for f in dataclasses.fields(jp)
            if f.name not in fields}
    back = type(tp).from_numpy(fields, meta, "cpu")
    assert back.shape == tp.shape and back.nnz == tp.nnz
    for f in fields:
        assert torch.equal(getattr(back, f), getattr(tp, f))
    moved = tp.to("meta")
    assert moved.device.type == "meta" and moved.dtype == tp.dtype


# (web, dia) is left out: thousands of diagonals, which the JAX package
# unrolls into one XLA program that takes half a minute to compile
@pytest.mark.parametrize("name,kind", [
    (name, kind) for name in ("web", "band", "shell") for kind in KINDS
    if (name, kind) != ("web", "dia")])
def test_spmv_spmm_match_jax_f64(name, kind):
    A = _matrix(name)
    jp, tp = _plans(name, kind)
    x = JDenseVector.random(A.width)
    y = JDenseVector.constant(A.height, 1.0)
    B, C = _operands(A, 11)
    jv = np.asarray(jops.spmv(jp, jnp.asarray(x.values), ALPHA, BETA,
                              jnp.asarray(y.values)))
    tv = tops.spmv(tp, torch.from_numpy(x.values), ALPHA, BETA,
                   torch.from_numpy(y.values)).numpy()
    np.testing.assert_allclose(tv, jv, rtol=1e-12, atol=1e-12)
    assert check_equal(tv, spmv_cpu(A, x, ALPHA, BETA, y)).ok
    jm = np.asarray(jops.spmm(jp, jnp.asarray(B.values), ALPHA, BETA,
                              jnp.asarray(C.values)))
    tm = tops.spmm(tp, torch.from_numpy(B.values), ALPHA, BETA,
                   torch.from_numpy(C.values)).numpy()
    np.testing.assert_allclose(tm, jm, rtol=1e-12, atol=1e-12)
    assert check_equal(tm, spmm_cpu(A, B, ALPHA, BETA, C)).ok


@pytest.mark.parametrize("kind", KINDS)
def test_spmm_f32_meets_oracle(kind):
    A = _matrix("band").astype(np.float32)
    _, tp = _plans("band", kind, "f32")
    B = JDenseMatrix.random(A.width, 24, dtype=np.float32)
    C = JDenseMatrix.constant(A.height, 24, 1.0, dtype=np.float32)
    got = tops.spmm(tp, torch.from_numpy(B.values), ALPHA, BETA,
                    torch.from_numpy(C.values))
    assert got.dtype == torch.float32
    assert check_equal(got.numpy(), spmm_cpu(A, B, ALPHA, BETA, C),
                       relative=True).ok


def test_spmm_coo_column_chunks_match_jax():
    A = _matrix("web")
    jp, tp = _plans("web", "coo")
    B, C = _operands(A, 10)
    want = np.asarray(j_spmm_coo(jp, jnp.asarray(B.values), ALPHA,
                                         BETA, jnp.asarray(C.values),
                                         n_chunks=3))
    got = spmm_coo(tp, torch.from_numpy(B.values), ALPHA, BETA,
                             torch.from_numpy(C.values), n_chunks=3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    for k in (1, 64, 4096, 70_000):
        assert (_auto_chunks(tp, k)
                == j_auto_chunks(jp, k))


def test_spmm_ell_ragged_k_chunk_matches_jax():
    A = _matrix("uniform")
    jp, tp = _plans("uniform", "ell")
    B, C = _operands(A, 10)
    want = np.asarray(j_spmm_ell(jp, jnp.asarray(B.values), ALPHA,
                                         BETA, jnp.asarray(C.values),
                                         k_chunk=4))
    got = spmm_ell(tp, torch.from_numpy(B.values), ALPHA, BETA,
                             torch.from_numpy(C.values), k_chunk=4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", list(MATRICES))
def test_make_plan_fast_matches_jax(name):
    A = _matrix(name)
    jp = jops.make_plan_fast(A, dtype=jnp.float64)
    tp = tops.make_plan_fast(_port(A), dtype=torch.float64, device="cpu")
    assert type(jp).__name__ == type(tp).__name__
    assert tp.dtype == torch.float64


@pytest.mark.parametrize("kind", KINDS)
def test_dispatchers_drop_beta_without_y_or_c(kind):
    A = _matrix("band")
    _, tp = _plans("band", kind)
    x = JDenseVector.random(A.width)
    B = JDenseMatrix.random(A.width, 5)
    got_v = tops.spmv(tp, torch.from_numpy(x.values), 2.0).numpy()
    got_m = tops.spmm(tp, torch.from_numpy(B.values), 2.0).numpy()
    assert check_equal(got_v, spmv_cpu(A, x, 2.0, 0.0, JDenseVector.constant(
        A.height, 0.0))).ok
    assert check_equal(got_m, spmm_cpu(A, B, 2.0, 0.0, JDenseMatrix.constant(
        A.height, 5, 0.0))).ok


def test_spmm_rejects_routed_and_unknown_plans():
    A = jgen.webbase_like(n=20_000, avg_deg=4.0)
    from sblas_tpu_torch.config import SBlasConfig
    routed = tops.make_plan(_port(A), op="spmv", force="routed",
                            config=SBlasConfig(routed_min_nnz=1000,
                                               routed_min_width=1000),
                            device="cpu")
    with pytest.raises(TypeError, match="SpMV-only"):
        tops.spmm(routed, torch.zeros(A.width, 4))
    for fn in (tops.spmv, tops.spmm):
        with pytest.raises(TypeError, match="unsupported plan type"):
            fn(object(), torch.zeros(4, 4), 1.0, 0.0, torch.zeros(4, 4))


def test_plans_refuse_other_value_types():
    with pytest.raises(PlanError):
        tops.make_plan(_port(_matrix("band")), dtype=torch.float16,
                       force="dia", device="cpu")


def test_elementwise_match_jax():
    rng = np.random.RandomState(2)
    x, y = rng.rand(50), rng.rand(50)
    np.testing.assert_allclose(
        tops.axpby(torch.from_numpy(x), torch.from_numpy(y), 3.0,
                   4.0).numpy(),
        np.asarray(jops.axpby(jnp.asarray(x), jnp.asarray(y), 3.0, 4.0)),
        rtol=1e-15)
    got = tops.plus_scalar(torch.from_numpy(y).float(), 2.5)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jops.plus_scalar(jnp.asarray(y, jnp.float32), 2.5)), rtol=1e-7)


def test_flop_counts():
    assert spmv_flops(10) == 20 and spmm_flops(10, 64) == 1280


# ---- the spmm_test CLI on the CPU ----

def _write(tmp_path, A, name):
    coo = A.to_coo()
    path = str(tmp_path / name)
    write_mtx(path, A.height, A.width, coo.row_idx, coo.col_idx, coo.values)
    return path


@pytest.mark.parametrize("name,dtype,kind", [
    ("band", "f32", "BsrPlan"),
    ("band", "f64", "BsrPlan"),
    ("web", "f32", "WcooPlan"),
])
def test_spmm_cli_method1_cpu(tmp_path, capsys, name, dtype, kind):
    path = _write(tmp_path, _matrix(name), f"{name}.mtx")
    rc = spmm_test.main(["1", path, "16", "3", "4", "1", dtype,
                         "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and "Validation = True" in out
    assert f"plan {kind}" in out and "cpu host clock" in out
    assert "GFLOPS" in out


@pytest.mark.parametrize("argv", [["3"], ["1", "--device", "tpu"],
                                  ["1", "f16"]])
def test_spmm_cli_usage_errors(tmp_path, argv):
    path = _write(tmp_path, _matrix("band"), "b.mtx")
    full = [argv[0], path, "4", "1", "0", "1", *argv[1:]]
    with pytest.raises(SystemExit) as exc:
        spmm_test.main(full)
    assert exc.value.code == 2


def test_spmm_cli_cuda_without_gpu_exits_nonzero(tmp_path, monkeypatch):
    path = _write(tmp_path, _matrix("band"), "b.mtx")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert spmm_test.main(["1", path, "4", "1", "0", "1"]) != 0
