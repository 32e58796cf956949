"""Port parity of host-resident dense operands: B and C in host memory,
the 2-D cell-grid SpMM and SpMV (reference DenseMatrix_um /
DenseVector_um, matrix_um.h:735-814), case for case with
tests/test_host_dense.py.

Each case runs the JAX package and the port on the same seeded inputs
(f64): the grid's cells byte-identical (the port-only K3 tables aside),
the results equal to 1e-12 and to the numpy oracle, read from the
returned `HostDense` straight after the call."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sblas_tpu.containers import DenseMatrix, DenseVector
from sblas_tpu.io.generate import (adversarial_skew, fem_banded_like,
                                   webbase_like)
from sblas_tpu.memory import dense as jdense
from sblas_tpu.ops.cpu_reference import spmm_cpu, spmv_cpu
from sblas_tpu_torch.containers import CsrMatrix
from sblas_tpu_torch.memory import dense as tdense
from sblas_tpu_torch.memory import host as thost
from sblas_tpu_torch.utils.errors import ShapeError
from sblas_tpu_torch.utils.verify import check_equal

F64 = torch.float64


def _port(A):
    return CsrMatrix(A.row_ptr, A.col_idx, A.values, A.shape)


def _grids(A, budget, k):
    jg = jdense.host_resident_grid(A, dtype=jnp.float64,
                                   hbm_budget_bytes=budget, k=k)
    tg = tdense.host_resident_grid(_port(A), dtype=F64,
                                   hbm_budget_bytes=budget, k=k,
                                   device="cpu")
    geometry = ("kind", "band_rows", "chunk_cols", "n_bands", "n_chunks")
    assert [getattr(tg, a) for a in geometry] == \
        [getattr(jg, a) for a in geometry]
    assert sorted(tg.cells) == sorted(jg.cells)
    for key in jg.cells:
        jc, tc = jg.cells[key], tg.cells[key]
        for f in dataclasses.fields(jc):
            v = getattr(jc, f.name)
            if isinstance(v, jax.Array):
                got = getattr(tc, f.name).numpy()
                assert got.dtype == np.asarray(v).dtype
                np.testing.assert_array_equal(got, np.asarray(v))
            else:
                assert tuple(np.atleast_1d(getattr(tc, f.name))) == \
                    tuple(np.atleast_1d(v))
    return jg, tg


def _run(A, k, budget, tuning, alpha=3.0, beta=4.0, grids=None):
    B = DenseMatrix.random(A.width, k)
    C = DenseMatrix.constant(A.height, k, 1.0)
    jg, tg = grids or _grids(A, budget, k)
    want = jdense.spmm_um_hostdense(
        jg, jdense.HostDense.from_array(B.values), alpha, beta,
        jdense.HostDense.from_array(C.values), tuning=tuning).to_numpy()
    Ch = tdense.HostDense.from_array(C.values, device="cpu")
    got = tdense.spmm_um_hostdense(
        tg, tdense.HostDense.from_array(B.values, device="cpu"), alpha,
        beta, Ch, tuning=tuning)
    assert got.shape == (A.height, k) and got.device.type == "cpu"
    np.testing.assert_allclose(got.to_numpy(), want, rtol=1e-12,
                               atol=1e-12)
    assert check_equal(got.to_numpy(), spmm_cpu(A, B, alpha, beta, C)).ok
    assert np.array_equal(Ch.to_numpy(), C.values)   # C is not written
    assert tg.tuned == tuning
    return tg, got.to_numpy()


@pytest.mark.parametrize("tuning", [False, True])
def test_banded_budget_below_result(tuning):
    """The budget is smaller than the m x K result."""
    A = fem_banded_like(n=2000, half_band=20)
    k = 16
    grid, _ = _run(A, k, A.height * k * 8 // 4, tuning)
    assert grid.n_bands > 1
    # banded structure leaves most of the grid empty
    assert len(grid.cells) < grid.n_bands * grid.n_chunks or \
        grid.n_chunks == 1


@pytest.mark.parametrize("tuning", [False, True])
def test_unstructured_budget_below_operands(tuning):
    A = webbase_like(n=6000, avg_deg=3.0, seed=4, local_scale=100.0)
    k = 8
    grid, _ = _run(A, k, (A.height * k * 8) // 4, tuning)
    assert grid.kind in ("wcoo", "coo")


def test_skewed_rows():
    A = adversarial_skew(m=1024, n=1024, heavy_rows=2, heavy_nnz=512)
    _run(A, 4, 96 << 10, False, alpha=2.0, beta=0.5)


def test_column_chunking_engages():
    A = fem_banded_like(n=3000, half_band=10)
    _, grid = _grids(A, 64 << 10, 8)
    assert grid.n_chunks > 1 and grid.n_bands > 1


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_inflight_depth(depth, monkeypatch):
    """Cells, B chunks and C bands through 1, 2 or 3 device slots: the
    same bits as the tuned grid (the grid built for the JAX package's
    depth of 3)."""
    A = fem_banded_like(n=3000, half_band=10)
    grids = _grids(A, 64 << 10, 8)
    _, want = _run(A, 8, 64 << 10, True, grids=grids)
    grids[1].remove_gpu_tuning()
    monkeypatch.setattr(thost, "_INFLIGHT", depth)
    grid, got = _run(A, 8, 64 << 10, False, grids=grids)
    assert grid.n_chunks > 1 and grid.n_bands > depth
    assert np.array_equal(got, want)


def test_hostdense_lifecycle():
    h = tdense.HostDense.from_array(np.arange(12.0).reshape(3, 4),
                                    device="cpu")
    assert not h.tuned
    h.apply_gpu_tuning()
    assert h.tuned
    np.testing.assert_array_equal(h.chunk(1, 3).numpy(),
                                  np.arange(12.0).reshape(3, 4)[1:3])
    h.apply_cpu_tuning()
    assert not h.tuned
    np.testing.assert_array_equal(h.chunk(0, 2).numpy(),
                                  np.arange(12.0).reshape(3, 4)[:2])
    assert h.values.device.type == "cpu"


def test_grid_cells_on_host():
    A = fem_banded_like(n=1500, half_band=8)
    _, grid = _grids(A, 64 << 10, 8)
    grid.apply_gpu_tuning()
    for cell in grid.cells.values():
        for name in thost.tensor_fields(cell):
            assert getattr(cell, name).device.type == "cpu"


@pytest.mark.parametrize("tuning", [False, True])
def test_spmv_hostdense(tuning):
    """x and y host-resident (DenseVector_um, matrix_um.h:918-1075)."""
    A = fem_banded_like(n=1800, half_band=12)
    jg, tg = _grids(A, 64 << 10, 1)
    x = DenseVector.random(A.width)
    y = DenseVector.constant(A.height, 1.0)
    want = jdense.spmv_um_hostdense(
        jg, jdense.HostDense.from_array(x.values), 3.0, 4.0,
        jdense.HostDense.from_array(y.values), tuning=tuning).to_numpy()
    got = tdense.spmv_um_hostdense(
        tg, tdense.HostDense.from_array(x.values, device="cpu"), 3.0, 4.0,
        tdense.HostDense.from_array(y.values, device="cpu"), tuning=tuning)
    assert got.to_numpy().shape == (A.height,)
    np.testing.assert_allclose(got.to_numpy(), want, rtol=1e-12,
                               atol=1e-12)
    assert check_equal(got.to_numpy(), spmv_cpu(A, x, 3.0, 4.0, y)).ok


def test_shapes_are_checked():
    A = fem_banded_like(n=600, half_band=4)
    _, grid = _grids(A, 64 << 10, 2)

    def dense(*shape):
        return tdense.HostDense.from_array(np.ones(shape), device="cpu")

    with pytest.raises(ShapeError):
        tdense.spmm_um_hostdense(grid, dense(599, 2), 1.0, 0.0,
                                 dense(600, 2))
    with pytest.raises(ShapeError):
        tdense.spmm_um_hostdense(grid, dense(600, 2), 1.0, 0.0,
                                 dense(600, 3))
    with pytest.raises(ShapeError):
        tdense.spmv_um_hostdense(grid, dense(600), 1.0, 0.0, dense(601))
