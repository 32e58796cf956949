"""The port's Jacobi-preconditioned CG on the shell's SPD system, the
benchmark's `s3dkq4m2.cg` deployment at a size the CPU holds: the plan
is DIA, `solvers.cg` with `jacobi_inv_diag` follows the plain float64
reference (`tests/reference_pcg.py`), float32 converges, and the solve
span and the DIA SpMV counter say what ran."""

import os
import subprocess
import sys

import pytest
import torch

import reference_pcg as ref
from sblas_tpu_torch import CsrMatrix, ops, solvers
from sblas_tpu_torch.io.generate import fem_shell_like
from sblas_tpu_torch.ops import DiaPlan
from sblas_tpu_torch.utils import trace

TOL = 1e-6


def _shell(seed: int, nx=24, ny=10, n_target=1439) -> CsrMatrix:
    """The shell's pattern at the benchmark's CPU size, SPD values."""
    P = fem_shell_like(nx=nx, ny=ny, dof=6, n_target=n_target)
    return CsrMatrix(P.row_ptr, P.col_idx,
                     ref.laplacian_values(P.row_ptr, P.col_idx, seed),
                     P.shape)


def _rhs(n: int, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.rand(n, generator=g, dtype=torch.float64) * 2 - 1


def _solve(A: CsrMatrix, b, dtype, **kw):
    plan = ops.make_plan(A, dtype, op="spmv", device="cpu")
    M = solvers.jacobi_inv_diag(A, dtype, device="cpu")
    return solvers.cg(plan, b.to(dtype), tol=TOL, maxiter=2000, M=M, **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_shell_spmv_plan_is_dia(dtype):
    A = _shell(3)
    assert ops.choose_kind(A, op="spmv") == "dia"
    assert isinstance(ops.make_plan(A, dtype, op="spmv", device="cpu"),
                      DiaPlan)


@pytest.mark.parametrize("seed", [7, 2**31 + 9])
def test_cg_f64_matches_the_reference(seed):
    """Same iterations; x within 1e-10 relative: rounding between the
    DIA plan's and the CSR product's orders of the same float64 sums."""
    A = _shell(seed)
    b = _rhs(A.shape[0], seed)
    res = _solve(A, b, torch.float64)
    x, its, rel = ref.pcg(ref.csr_tensor(A.row_ptr, A.col_idx, A.values),
                          b, ref.inv_diag(A.row_ptr, A.col_idx, A.values),
                          TOL, 2000)
    assert res.converged and rel <= TOL
    assert res.iterations == its > 16
    assert float((res.x - x).norm() / x.norm()) <= 1e-10


@pytest.mark.parametrize("seed", [7, 8])
def test_cg_f32_converges_to_what_float32_can_hold(seed):
    """float32 converges on its own residual.  Its true residual, in
    float64, is within 10x of the float64 solution's rounded to float32:
    at this size the near-constant mode (eigenvalue about 1e-4 of the
    diagonal) dominates x, and that rounding alone leaves 6e-6 to 1.2e-5
    of ||b||, above 10 tol."""
    A = _shell(seed)
    b = _rhs(A.shape[0], seed)
    res = _solve(A, b, torch.float32)
    assert res.converged and res.residual <= TOL
    K = ref.csr_tensor(A.row_ptr, A.col_idx, A.values)
    star = torch.linalg.solve(K.to_dense(), b)

    def true_rel(x):
        return float((b - K @ x.to(torch.float64)).norm() / b.norm())
    floor = true_rel(star.to(torch.float32))
    assert true_rel(res.x) <= 10 * max(TOL, floor)


def test_reference_matches_a_dense_solve():
    A = _shell(5, nx=8, ny=5, n_target=200)
    b = _rhs(200, 5)
    K = ref.csr_tensor(A.row_ptr, A.col_idx, A.values)
    x, its, rel = ref.pcg(K, b, ref.inv_diag(A.row_ptr, A.col_idx, A.values),
                          1e-12, 2000)
    star = torch.linalg.solve(K.to_dense(), b)
    assert rel <= 1e-12 and its > 10
    assert float((x - star).norm() / star.norm()) <= 1e-8


def test_laplacian_values_are_spd_with_the_shift():
    A = _shell(11, nx=8, ny=5, n_target=200)
    K = ref.csr_tensor(A.row_ptr, A.col_idx, A.values).to_dense()
    assert torch.equal(K, K.T)
    off = K - torch.diag(torch.diag(K))
    assert bool((off <= 0).all())
    assert torch.allclose(torch.diag(K), -(1 + 1e-4) * off.sum(1),
                          rtol=1e-15, atol=0)
    w = -off[off != 0]
    assert 0.5 <= float(w.min()) and float(w.max()) < 1.5
    assert float(torch.linalg.eigvalsh(K)[0]) > 0


@pytest.mark.parametrize("precond", ["jacobi", "callable", None])
def test_solve_span_says_precond_and_executed(precond):
    A = _shell(3)
    b = _rhs(A.shape[0], 3)
    plan = ops.make_plan(A, torch.float64, op="spmv", device="cpu")
    m = solvers.jacobi_inv_diag(A, torch.float64, device="cpu")
    M = {"jacobi": m, "callable": lambda v: v * m, None: None}[precond]
    with trace.recording() as rec:
        res = solvers.cg(plan, b, tol=TOL, maxiter=2000, M=M, chunk=8)
    solve = [s for s in rec.spans if s[0] == "sblas.solve"]
    assert len(solve) == 1
    attrs = solve[0][4]
    assert attrs["solver"] == "cg" and attrs["graph"] is False
    assert attrs["precond"] == precond
    assert attrs["iterations"] == res.iterations
    assert attrs["executed"] == -(-res.iterations // 8) * 8
    assert attrs["executed"] - 8 < res.iterations <= attrs["executed"]


def test_dia_spmv_loop_calls_count_every_loop_product():
    """Eager chunks on the CPU: the initial residual's SpMV, then one a
    step, masked steps included."""
    A = _shell(3)
    b = _rhs(A.shape[0], 3)
    with trace.recording() as rec:
        res = _solve(A, b, torch.float32)
    executed = [s for s in rec.spans if s[0] == "sblas.solve"][0][4][
        "executed"]
    assert rec.counters["dia_spmv_loop_calls"] == 1 + executed
    plan = ops.make_plan(A, torch.float32, op="spmv", device="cpu")
    with trace.recording() as rec:
        ops.spmv(plan, res.x, 1.0, 0.0, torch.zeros_like(res.x))
        ops.spmm(plan, res.x[:, None], 1.0, 0.0,
                 torch.zeros_like(res.x)[:, None])
    assert rec.counters == {"dia_spmv_loop_calls": 1}


def test_reference_imports_neither_jax_nor_either_package():
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import sys; sys.path.insert(0, {!r}); import reference_pcg; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', "
            "'jaxlib', 'flax', 'sblas_tpu', 'sblas_tpu_torch')]; "
            "assert not bad, bad").format(here)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd="/")
    assert out.returncode == 0, out.stderr
