"""The routed-SpMV slice of the port as a whole, against the JAX package:
plan choice, the tier-0 COO SpMV, the host modules carried over (config,
generators, Matrix-Market I/O, containers), the single-device CLI, and
the rule that the port never imports jax."""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sblas_tpu.ops as jops
from sblas_tpu.config import SBlasConfig as JConfig
from sblas_tpu.containers import DenseVector as JDenseVector
from sblas_tpu.io import generate as jgen
from sblas_tpu.io.mmio import read_csr_arrays as j_read_csr_arrays
from sblas_tpu.ops.cpu_reference import spmv_cpu
from sblas_tpu.ops.spmv import spmv_coo as j_spmv_coo
import sblas_tpu_torch.ops as tops
from sblas_tpu_torch.cli import spmv_test
from sblas_tpu_torch.config import SBlasConfig as TConfig
from sblas_tpu_torch.containers import CsrMatrix, DenseVector
from sblas_tpu_torch.io import generate as tgen
from sblas_tpu_torch.io.mmio import read_csr_arrays, write_mtx
from sblas_tpu_torch.utils.errors import KernelError
from sblas_tpu_torch.utils.timing import (device_time_ms, gflops, nnz_per_s,
                                          wall_time_ms)
from sblas_tpu_torch.utils.verify import check_equal

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_KIND = {"RoutedPlan": "routed", "CooPlan": "coo", "DiaPlan": "dia",
         "BsrPlan": "bsr", "EllPlan": "ell", "WcooPlan": "wcoo"}

# matrices small enough for the JAX package to build every kind it picks
MATRICES = {
    "webbase100k": lambda: jgen.webbase_like(n=100_000, avg_deg=4.0),
    "band": lambda: jgen.fem_banded_like(n=2000, half_band=5),
    "blocks": lambda: jgen.block_dominant(n_brows=8, blocks_per_row=2),
    "uniform": lambda: jgen.uniform_random(3000, 3000, 8, seed=4),
    "scattered": lambda: jgen.scattered_sparse(n=50_000, nnz=2000),
    "tiny": lambda: jgen.pattern_symmetric(),
}


def _port(A):
    return CsrMatrix(A.row_ptr, A.col_idx, A.values, A.shape)


@pytest.mark.parametrize("name", list(MATRICES))
@pytest.mark.parametrize("op", ["spmv", None, "spmm"])
def test_make_plan_chooses_like_jax(name, op):
    """Every kind is built now: the port's plan is the JAX package's
    kind, on the CPU, in the requested dtype."""
    A = MATRICES[name]()
    kind = _KIND[type(jops.make_plan(A, dtype=jnp.float64, op=op)).__name__]
    plan = tops.make_plan(_port(A), dtype=torch.float64, op=op,
                          device="cpu")
    assert _KIND[type(plan).__name__] == kind
    assert plan.dtype == torch.float64 and plan.device.type == "cpu"


def test_slice_matrix_plans_routed():
    plan = tops.make_plan(_port(MATRICES["webbase100k"]()), op="spmv",
                          device="cpu")
    assert isinstance(plan, tops.RoutedPlan)
    assert plan.dtype == torch.float32 and plan.device.type == "cpu"


def test_make_plan_routed_with_lowered_thresholds():
    A = jgen.webbase_like(n=20_000, avg_deg=4.0)
    cfg = dict(routed_min_nnz=1000, routed_min_width=1000)
    jp = jops.make_plan(A, op="spmv", config=JConfig(**cfg),
                        dtype=jnp.float64)
    tp = tops.make_plan(_port(A), op="spmv", config=TConfig(**cfg),
                        dtype=torch.float64, device="cpu")
    assert type(jp).__name__ == type(tp).__name__ == "RoutedPlan"


def test_force_and_unknown_kind():
    A = _port(MATRICES["tiny"]())
    assert isinstance(tops.make_plan(A, force="coo", device="cpu"),
                      tops.CooPlan)
    with pytest.raises(ValueError):
        tops.make_plan(A, force="csr", device="cpu")


@pytest.mark.parametrize("alpha,beta", [(3.0, 4.0), (1.0, 0.0)])
def test_spmv_coo_matches_jax(alpha, beta):
    A = jgen.webbase_like(n=30_000, avg_deg=4.0)
    jp = jops.CooPlan.from_csr(A, dtype=jnp.float64)
    tp = tops.make_plan(_port(A), dtype=torch.float64, force="coo",
                        device="cpu")
    for f in ("rows", "cols", "vals"):
        assert np.array_equal(np.asarray(getattr(jp, f)),
                              getattr(tp, f).numpy())
    x = JDenseVector.random(A.width)
    y = JDenseVector.constant(A.height, 1.0)
    want = np.asarray(j_spmv_coo(jp, jnp.asarray(x.values), alpha, beta,
                                 jnp.asarray(y.values)))
    got = tops.spmv(tp, torch.from_numpy(x.values), alpha, beta,
                    torch.from_numpy(y.values)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    assert check_equal(got, spmv_cpu(A, x, alpha, beta, y)).ok


def test_spmv_without_y_drops_beta():
    A = jgen.webbase_like(n=30_000, avg_deg=4.0)
    tp = tops.make_plan(_port(A), dtype=torch.float64, force="coo",
                        device="cpu")
    x = JDenseVector.random(A.width)
    got = tops.spmv(tp, torch.from_numpy(x.values), 2.0).numpy()
    want = spmv_cpu(A, x, 2.0, 0.0, JDenseVector.constant(A.height, 0.0))
    assert check_equal(got, want).ok


def test_coo_plan_to_moves_every_tensor():
    tp = tops.make_plan(_port(MATRICES["tiny"]()), force="coo",
                        device="cpu")
    moved = tp.to("meta")
    assert moved.device.type == "meta" and moved.shape == tp.shape
    assert {t.device.type for t in (moved.rows, moved.cols)} == {"meta"}


@pytest.mark.parametrize("gen,kwargs", [
    ("webbase_like", dict(n=20_000)),
    ("uniform_random", dict(m=500, n=700, nnz_per_row=5)),
    ("pattern_symmetric", {}),
    ("adversarial_skew", {}),
    ("scattered_sparse", dict(n=10_000, nnz=500)),
])
def test_generators_match_jax(gen, kwargs):
    a, b = getattr(jgen, gen)(**kwargs), getattr(tgen, gen)(**kwargs)
    assert a.shape == b.shape
    for f in ("row_ptr", "col_idx", "values"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


def test_mtx_roundtrip_matches_jax(tmp_path):
    A = tgen.webbase_like(n=5000)
    coo = A.to_coo()
    path = str(tmp_path / "w.mtx")
    write_mtx(path, A.height, A.width, coo.row_idx, coo.col_idx, coo.values)
    _, rp, ci, v = read_csr_arrays(path)
    _, jrp, jci, jv = j_read_csr_arrays(path)
    assert np.array_equal(rp, jrp) and np.array_equal(ci, jci)
    assert np.array_equal(v, jv) and np.array_equal(v, A.values)
    B = CsrMatrix.from_mtx(path, dtype=np.float32)
    assert B.shape == A.shape and B.values.dtype == np.float32


def test_config_and_dense_vector_match_jax(monkeypatch):
    monkeypatch.setenv("SBLAS_ROUTED_PEEL", "64")
    monkeypatch.setenv("SBLAS_ROUTED_RELABEL", "0")
    assert (dataclasses.asdict(TConfig.from_env())
            == dataclasses.asdict(JConfig.from_env()))
    assert dataclasses.asdict(TConfig()) == dataclasses.asdict(JConfig())
    assert np.array_equal(DenseVector.random(1000, dtype=np.float32).values,
                          JDenseVector.random(1000, dtype=np.float32).values)


def _write(tmp_path, A, name):
    coo = A.to_coo()
    path = str(tmp_path / name)
    write_mtx(path, A.height, A.width, coo.row_idx, coo.col_idx, coo.values)
    return path


@pytest.mark.parametrize("name,dtype,kind", [
    ("scattered", "f32", "CooPlan"),
    ("scattered", "f64", "CooPlan"),
    ("webbase100k", "f32", "RoutedPlan"),
])
def test_cli_single_cpu(tmp_path, capsys, name, dtype, kind):
    path = _write(tmp_path, MATRICES[name](), f"{name}.mtx")
    rc = spmv_test.main([path, "3", "4", "1", dtype, "--mode", "single",
                         "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Validation = True" in out
    assert f"plan {kind}" in out
    assert "cpu host clock" in out


@pytest.mark.parametrize("flag,said", [
    ("--transport bf16", "plan RoutedPlan"),
    ("--progressive", "First result (CooPlan)")])
def test_cli_bf16_and_progressive_flags(tmp_path, capsys, flag, said):
    """`--transport bf16` routes bf16 contributions and checks at its
    2e-3 bar; `--progressive` answers first from `make_plan_fast`."""
    path = _write(tmp_path, MATRICES["webbase100k"](), "w.mtx")
    assert spmv_test.main([path, "3", "4", "1", "f32", "--mode", "single",
                           "--device", "cpu", *flag.split()]) == 0
    out = capsys.readouterr().out
    assert said in out and out.count("Validation = True") >= 2


def test_cli_transport_f32_is_accepted(tmp_path, capsys):
    """`--transport f32` is every port plan's transport: accepted, as the
    JAX CLI accepts it, and it changes nothing."""
    path = _write(tmp_path, MATRICES["webbase100k"](), "w.mtx")
    argv = [path, "3", "4", "1", "f32", "--mode", "single", "--device",
            "cpu"]
    assert spmv_test.main([*argv, "--transport", "f32"]) == 0
    out = capsys.readouterr().out
    assert "Validation = True" in out and "plan RoutedPlan" in out
    with pytest.raises(SystemExit):
        spmv_test.main([*argv, "--transport", "f16"])


def test_cli_cuda_without_gpu_exits_nonzero(tmp_path, monkeypatch):
    path = _write(tmp_path, MATRICES["tiny"](), "t.mtx")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert spmv_test.main([path, "3", "4", "1", "--mode", "single"]) != 0


def test_device_time_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for clock in (device_time_ms, wall_time_ms):
        with pytest.raises(KernelError):
            clock(lambda: None)
    assert nnz_per_s(3_000_000, 1.5) == pytest.approx(2e9)
    assert gflops(2 * 3_000_000, 1.5) == pytest.approx(4.0)


def test_port_imports_no_jax():
    code = ("import sys\n"
            "import sblas_tpu_torch, sblas_tpu_torch.ops\n"
            "import sblas_tpu_torch.cli.spmv_test\n"
            "import sblas_tpu_torch.cli.spmm_test\n"
            "import sblas_tpu_torch.tools.k3_skew\n"
            "import sblas_tpu_torch.partition, sblas_tpu_torch.parallel\n"
            "import sblas_tpu_torch.parallel.dryrun\n"
            "import sblas_tpu_torch.memory, sblas_tpu_torch.memory.host\n"
            "import sblas_tpu_torch.memory.dense, sblas_tpu_torch.memory.dist\n"
            "import sblas_tpu_torch.cli.spmv_test_um\n"
            "import sblas_tpu_torch.cli.spmm_test_um\n"
            "import sblas_tpu_torch.profiling\n"
            "import sblas_tpu_torch.parallel.xfoot, sblas_tpu_torch.scaling\n"
            "import sblas_tpu_torch.io.plancache\n"
            "import sblas_tpu_torch.bench, sblas_tpu_torch.solvers\n"
            "import sblas_tpu_torch.cli.unit_test\n"
            "import sblas_tpu_torch.tools.link_bw\n"
            "import sblas_tpu_torch.examples.cg\n"
            "import sblas_tpu_torch.examples.pagerank\n"
            "import sblas_tpu_torch.examples.pagerank_dist\n"
            "import sblas_tpu_torch.experiments.stage_fuse_probe\n"
            "import sblas_tpu_torch.experiments.wcoo_gather_probe\n"
            "import sblas_tpu_torch.experiments.plan_matrix\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', "
            "'sblas_tpu', 'ml_dtypes') "
            "or m.startswith(('jax.', 'jaxlib', 'sblas_tpu.', "
            "'ml_dtypes.')))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO,
                   env=env, timeout=120)
