"""The port's `make_plan` choices per structure class, mirroring
tests/test_plan_choices.py: the same ten classes of the plan-matrix
experiment at its full size (the port's copy of `matrix_classes`), the
same expected kinds for SpMV and SpMM, and the full shell's SpMM choice
of DIA.  The port's chooser runs the JAX package's ladder; the choices
are pinned through `choose_kind`, the kind `make_plan` builds, so no
plan is built here."""

import functools

import numpy as np
import pytest
import torch

from sblas_tpu_torch.experiments.plan_matrix import matrix_classes
from sblas_tpu_torch.ops import choose_kind

# the JAX package's table (tests/test_plan_choices.py), measured there on
# a TPU v5e
EXPECTED = {
    # class: (spmv kind, spmm kind)
    "shell_fem": ("dia", "bsr"),
    "web_power": ("routed", "wcoo"),
    "dense_band": ("bsr", "bsr"),
    "block_dom": ("bsr", "bsr"),
    "road_local": ("routed", "bsr"),
    "uniform": ("routed", "ell"),
    "rect_wide": ("routed", "ell"),
    "near_empty": ("coo", "coo"),
    "skew_rows": ("routed", "wcoo"),
    "small_sym": ("dia", "bsr"),
}


@functools.lru_cache(maxsize=None)
def _matrix(name):
    return matrix_classes()[name]()


def test_classes_are_the_experiments():
    assert sorted(matrix_classes()) == sorted(EXPECTED)


@pytest.mark.parametrize("op", ["spmv", "spmm"])
@pytest.mark.parametrize("cname", sorted(EXPECTED))
def test_auto_choice(cname, op):
    want = EXPECTED[cname][0 if op == "spmv" else 1]
    assert choose_kind(_matrix(cname), torch.float32, op=op) == want


def test_full_shell_spmm_prefers_dia():
    """The BELL-vs-DIA SpMM crossover depends on size (same structure,
    blowup 24): the bench headline's full shell takes DIA."""
    from sblas_tpu_torch.io.generate import fem_shell_like
    A = fem_shell_like(dtype=np.float32)
    assert choose_kind(A, torch.float32, op="spmm") == "dia"
