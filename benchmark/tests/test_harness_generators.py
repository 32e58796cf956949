"""The harness's frozen copies of the program's proxies give the
program's patterns, and its TF32 rounding is TF32's."""

import numpy as np
import pytest
import torch

from harness import reference


@pytest.mark.parametrize("n,scale", [(3000, 60.0), (20_000, 400.0)])
def test_webbase_pattern_is_the_programs(n, scale):
    from sblas_tpu_torch.io.generate import webbase_like
    want = webbase_like(n=n, local_scale=scale, seed=211)
    (row_ptr, col_idx), shape = reference.webbase_like(n=n, local_scale=scale,
                                                       seed=211)
    assert shape == want.shape
    np.testing.assert_array_equal(row_ptr, want.row_ptr)
    np.testing.assert_array_equal(col_idx, want.col_idx)


@pytest.mark.parametrize("nx,ny,n_target", [(20, 8, 950), (31, 12, 2232)])
def test_shell_pattern_is_the_programs(nx, ny, n_target):
    from sblas_tpu_torch.io.generate import fem_shell_like
    want = fem_shell_like(nx=nx, ny=ny, n_target=n_target, seed=211)
    (row_ptr, col_idx), shape = reference.fem_shell_like(
        nx=nx, ny=ny, n_target=n_target, seed=211)
    assert shape == want.shape
    np.testing.assert_array_equal(row_ptr, want.row_ptr)
    np.testing.assert_array_equal(col_idx, want.col_idx)


def test_transition_is_the_programs():
    from sblas_tpu_torch.examples.pagerank import transition
    from sblas_tpu_torch.io.generate import webbase_like
    G = webbase_like(n=5000, local_scale=100.0, seed=211)
    want, want_d = transition(G, np.float32)
    PT, dang = reference.transition(G.row_ptr, G.col_idx, 5000)
    np.testing.assert_array_equal(PT.row_ptr, want.row_ptr)
    np.testing.assert_array_equal(PT.col_idx, want.col_idx)
    np.testing.assert_array_equal(PT.values, want.values)
    np.testing.assert_array_equal(dang, want_d)


def test_pattern_dispatch_and_seeded_values():
    spec = {"generator": "fem_shell_like",
            "params": {"nx": 10, "ny": 5, "dof": 6, "n_target": 299,
                       "seed": 211}}
    (row_ptr, col_idx), shape = reference.pattern(spec)
    assert shape == (299, 299) and row_ptr[-1] == len(col_idx)
    a = reference.draw_values(100, 2**31 + 5)
    assert a.dtype == np.float32 and ((a >= 0) & (a < 1)).all()
    np.testing.assert_array_equal(a, reference.draw_values(100, 2**31 + 5))
    assert not np.array_equal(a, reference.draw_values(100, 2**31 + 6))


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0, 1 + 2**-11, 1 + 3 * 2**-11, 1 + 2**-10 + 2**-20,
                      -(1 + 2**-11 + 2**-21), 0.0], dtype=torch.float32)
    got = reference.tf32(x)
    want = torch.tensor([1.0, 1.0, 1 + 2**-9, 1 + 2**-10,
                         -(1 + 2**-10), 0.0])
    assert torch.equal(got, want)
    r = torch.rand(10_000)
    rel = ((reference.tf32(r) - r).abs() / r).max()
    assert 2**-13 < rel <= 2**-11


def test_reference_products_in_float64():
    rng = np.random.default_rng(0)
    dense = (rng.random((40, 30)) < 0.2) * rng.random((40, 30))
    r, c = np.nonzero(dense)
    row_ptr = np.concatenate([[0], np.cumsum(np.bincount(r, minlength=40))])
    A = reference.Csr(row_ptr, c, dense[r, c].astype(np.float32), (40, 30))
    dA = reference.DeviceCsr(A, "cpu")
    B = torch.rand(30, 5, dtype=torch.float32) * 2 - 1
    C = torch.rand(40, 5, dtype=torch.float32)
    ref, scale = reference.spmm(dA, B, C, 2.0, 3.0)
    d = torch.as_tensor(dense[r, c].astype(np.float32).astype(np.float64))
    dense64 = torch.zeros(40, 30, dtype=torch.float64)
    dense64[r, c] = d
    want = 3.0 * C.double() + 2.0 * dense64 @ B.double()
    assert torch.allclose(ref, want, rtol=1e-14, atol=1e-14)
    assert torch.allclose(scale, 3.0 * C.double().abs()
                          + 2.0 * dense64.abs() @ B.double().abs())
