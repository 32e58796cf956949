"""The CG cell (`s3dkq4m2.cg`) at a size the CPU holds: its result line,
the control and broken solvers caught by its check, its SPD values, and
the work of one iteration at the configuration's own size."""

import numpy as np
import pytest
import torch

import faults
import small
from harness import core, pcg, reference
from harness.control import ControlProgram
from harness.program import Program
from test_harness_run import _line_ok

CELL = "s3dkq4m2.cg"


class SmallCg(small.SmallBench):
    """The cell at CPU size, without the card's settling warm-up."""

    def traffic(self, name):
        return dict(super().traffic(name), warm_seconds=0)


def run(seed=7, trace=False, program=None):
    torch.manual_seed(0)
    return core.run_cell(SmallCg(), CELL, seed, 0.3, trace,
                         torch.device("cpu"), program=program)


@pytest.mark.parametrize("trace", [False, True])
def test_small_run_gives_the_result_line(trace):
    res = run(trace=trace)
    _line_ok(res, CELL, trace)
    assert set(res["checks"]) == {"rel_residual", "rel_err_to_x64"}
    if trace:
        assert {"plan_build_s", "iters_per_solve"} <= set(res["metrics"])
        assert res["metrics"]["iters_per_solve"]["value"] % 16 == 0
    else:
        assert set(res["metrics"]) == {"solve_ms", "setup_s"}


@pytest.mark.parametrize("seed", [3, 2**31 + 9])
def test_control_is_not_correct(seed):
    res = run(seed=seed, program=ControlProgram())
    assert res["correct"] is False
    over = [k for k, c in res["checks"].items() if c["value"] > c["limit"]]
    assert over, res["checks"]


class _ReturnsX0(Program):
    """A solver that reports convergence and returns x0 = 0."""

    @staticmethod
    def cg(plan, b, inv_diag, tol, maxiter):
        return torch.zeros_like(b), 1, True


def test_altered_product_is_caught(monkeypatch):
    faults.plant("altered", monkeypatch.setattr)
    res = run(seed=5)
    assert res["correct"] is False, res["checks"]


def test_solver_returning_x0_is_caught():
    res = run(seed=5, program=_ReturnsX0())
    assert res["correct"] is False
    assert res["checks"]["rel_residual"]["value"] == pytest.approx(1.0)
    assert res["checks"]["rel_err_to_x64"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("seed", [1, 2**31 + 5])
def test_spd_values_are_symmetric_positive_definite(seed):
    cfg = SmallCg().config("s3dkq4m2_spd_f32")
    (row_ptr, col_idx), (n, _) = reference.pattern(cfg["matrix"])
    vals = pcg.spd_values(row_ptr, col_idx, seed, np.float64)
    K = np.zeros((n, n))
    K[np.repeat(np.arange(n), np.diff(row_ptr)), col_idx] = vals
    assert np.array_equal(K, K.T)
    np.linalg.cholesky(K)
    w = -vals[col_idx != np.repeat(np.arange(n), np.diff(row_ptr))]
    assert 0.5 <= w.min() and w.max() < 1.5


def test_pcg_iteration_counts_the_full_configuration():
    cfg = core.Bench().config("s3dkq4m2_spd_f32")
    w = pcg.pcg_iteration(cfg["rows"], cfg["nnz"], 4)
    assert w.bytes == 41_620_876
    assert w.flops == 2 * 4_840_813 + 13 * 90_449


@pytest.mark.cuda
def test_control_on_the_card(cuda_device):
    """The control at the cell's own size: benchmark/control.py."""
    import subprocess
    import sys

    out = subprocess.run(
        [sys.executable, "benchmark/control.py", "--workload", CELL,
         "--seeds", "11,12,13", "--control", "--seconds", "2"],
        cwd=core.ROOT, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 3 and all('"correct": false' in ln for ln in lines)


def test_pcg_imports_neither_jax_nor_the_program():
    import subprocess
    import sys

    code = ("import sys; sys.path[:0] = [{!r}]; from harness import pcg; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'sblas_tpu', 'sblas_tpu_torch')]; "
            "assert not bad, bad").format(small.BENCH)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd="/")
    assert out.returncode == 0, out.stderr
