"""A run with the timed path broken underneath it comes out not
correct: once for each fault the cell can have (`faults.py`)."""

import functools

import pytest

import faults
import small

CASES = [("s3dkq4m2.spmm_k64", f) for f in ("unchanged", "half", "altered")]
CASES += [("webbase1m.spmm_k64", f) for f in ("unchanged", "half",
                                               "altered")]
CASES += [("webbase1m.pagerank", f) for f in ("unchanged", "altered")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_caught(cell, fault, monkeypatch):
    faults.plant(fault, monkeypatch.setattr)
    res = small.run(cell, seed=5)
    assert res["correct"] is False, (fault, res["checks"])


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered",
                                   "no_exchange"])
def test_mode2_fault_is_caught(fault):
    res = small.run_ranks("webbase1m_4gpu.spmm_mode2_k64", seed=5,
                          program=functools.partial(faults.broken_program,
                                                    fault))
    assert res["correct"] is False, (fault, res["checks"])
