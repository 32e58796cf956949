"""The control, the reference put in the program's place at TF32, fails
each cell's check, at a size the CPU holds.  (At the cells' own sizes
`benchmark/control.py` reads it on the card.)"""

import functools

import pytest

import small
from harness.control import ControlProgram


@pytest.mark.parametrize("cell", ["s3dkq4m2.spmm_k64", "webbase1m.spmm_k64",
                                  "webbase1m.pagerank"])
@pytest.mark.parametrize("seed", [3, 2**31 + 9])
def test_control_is_not_correct(cell, seed):
    res = small.run(cell, seed=seed, program=ControlProgram())
    assert res["correct"] is False
    over = [k for k, c in res["checks"].items() if c["value"] > c["limit"]]
    assert over, res["checks"]


def test_control_of_mode2_is_not_correct():
    res = small.run_ranks("webbase1m_4gpu.spmm_mode2_k64",
                          program=functools.partial(ControlProgram))
    assert res["correct"] is False


@pytest.mark.cuda
def test_control_on_the_card(cuda_device):
    """The control at the cells' own sizes: benchmark/control.py."""
    import subprocess
    import sys

    from harness import core
    out = subprocess.run(
        [sys.executable, "benchmark/control.py", "--workload",
         "s3dkq4m2.spmm_k64", "--seeds", "11,12,13", "--control",
         "--seconds", "2"], cwd=core.ROOT, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    assert len(lines) == 3 and all('"correct": false' in ln for ln in lines)
