"""Plain Jacobi-preconditioned conjugate gradients in float64, and the SPD
values the benchmark's `s3dkq4m2_spd_f32` configuration puts on the
shell's pattern: the reference `tests/test_torch_cg_shell.py` holds the
port's `solvers.cg` to.  Plain numpy and torch only: no JAX, no
`sblas_tpu`, no `sblas_tpu_torch`.

The recurrence, from x0 = 0 (so r0 = b):

    z = M r, p = z, rz = r.z
    Ap = A p, alpha = rz / p.Ap, x += alpha p, r -= alpha Ap,
    z = M r, rz' = r.z, p = z + (rz'/rz) p

with M the inverse diagonal, stopped when r.r <= tol^2 b.b or at
`maxiter`.
"""

from __future__ import annotations

import numpy as np
import torch


def laplacian_values(row_ptr, col_idx, seed: int,
                     shift: float = 1e-4) -> np.ndarray:
    """float64 values of a weighted Laplacian on a symmetric pattern that
    holds every diagonal entry: w_ij uniform in [0.5, 1.5) from
    `default_rng([seed, 2])`, one for each stored entry with i < j in CSR
    order; a_ij = a_ji = -w_ij, a_ii = (1 + shift) * sum_{j != i} w_ij."""
    n = len(row_ptr) - 1
    rows = np.repeat(np.arange(n), np.diff(row_ptr))
    rng = np.random.default_rng([seed, 2])
    weight = {}
    for (i, j), w in zip(
            ((i, j) for i, j in zip(rows, col_idx) if i < j),
            rng.random(int((col_idx > rows).sum())) + 0.5):
        weight[i, j] = w
    vals = np.zeros(len(col_idx))
    for e, (i, j) in enumerate(zip(rows, col_idx)):
        if i != j:
            vals[e] = -weight[min(i, j), max(i, j)]
    for i in range(n):
        lo, hi = row_ptr[i], row_ptr[i + 1]
        d = lo + int(np.flatnonzero(col_idx[lo:hi] == i)[0])
        vals[d] = (1.0 + shift) * -(vals[lo:hi].sum())
    return vals


def csr_tensor(row_ptr, col_idx, values) -> torch.Tensor:
    """A as a float64 torch sparse CSR tensor."""
    n = len(row_ptr) - 1
    return torch.sparse_csr_tensor(
        torch.as_tensor(row_ptr, dtype=torch.int64),
        torch.as_tensor(col_idx, dtype=torch.int64),
        torch.as_tensor(values, dtype=torch.float64), (n, n),
        check_invariants=True)


def inv_diag(row_ptr, col_idx, values) -> torch.Tensor:
    """1 / a_ii in float64 (1 where a row has no diagonal entry)."""
    n = len(row_ptr) - 1
    d = np.ones(n)
    for i in range(n):
        lo, hi = row_ptr[i], row_ptr[i + 1]
        hit = np.flatnonzero(col_idx[lo:hi] == i)
        if len(hit):
            d[i] = values[lo + hit[0]]
    return torch.as_tensor(1.0 / d)


def pcg(A: torch.Tensor, b: torch.Tensor, m: torch.Tensor, tol: float,
        maxiter: int):
    """(x, iterations, ||r|| / ||b||) of the module docstring's
    recurrence in float64; `A` a sparse or dense float64 matrix, `m` the
    inverse diagonal."""
    b = b.to(torch.float64)
    x = torch.zeros_like(b)
    r = b.clone()
    z = r * m
    p = z.clone()
    rz = torch.dot(r, z)
    b2 = torch.dot(b, b)
    it = 0
    while it < maxiter and torch.dot(r, r) > tol * tol * b2:
        Ap = A @ p
        alpha = rz / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = r * m
        rz_n = torch.dot(r, z)
        p = z + (rz_n / rz) * p
        rz, it = rz_n, it + 1
    return x, it, float(torch.sqrt(torch.dot(r, r) / b2))
