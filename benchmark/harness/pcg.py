"""Jacobi-preconditioned conjugate gradients: the values of the SPD
configuration, the float64 reference solve, the control's solve, the
adapter the CG entry calls, and one iteration's least work.

Nothing here imports the program at module level: the adapter imports
`sblas_tpu_torch.solvers` inside the call, as `program.Program` imports
the package.

The recurrence, in every solve here as in the program's `solvers.cg`,
from x0 = 0:

    r = b - A x0, z = M r, p = z, rz = r.z
    Ap = A p, alpha = rz / p.Ap, x += alpha p, r -= alpha Ap,
    z = M r, rz' = r.z, p = z + (rz'/rz) p

with M the inverse diagonal, stopped when r.r <= tol^2 b.b or at maxiter;
`converged` is ||r|| / ||b|| <= tol (1 + 1e-7).
"""

from __future__ import annotations

import numpy as np
import torch

from . import reference, work
from .control import ControlProgram

# relative diagonal shift of the configuration's weighted Laplacian
SHIFT = 1e-4


def spd_values(row_ptr, col_idx, seed: int, dtype=np.float32,
               shift: float = SHIFT) -> np.ndarray:
    """Values of an SPD weighted Laplacian on a symmetric pattern that
    holds every diagonal entry: for each stored entry with i < j a weight
    w_ij uniform in [0.5, 1.5) from `default_rng([seed, 2])`, in the
    order of the upper triangle's CSR entries; a_ij = a_ji = -w_ij and
    a_ii = (1 + shift) * sum over j != i of w_ij.  Built in float64, then
    cast to `dtype`."""
    n = len(row_ptr) - 1
    rows = np.repeat(np.arange(n, dtype=np.int64), np.diff(row_ptr))
    upper, lower, diag = col_idx > rows, col_idx < rows, col_idx == rows
    if int(diag.sum()) != n:
        raise ValueError("the pattern lacks diagonal entries")
    vals = np.zeros(len(col_idx), dtype=np.float64)
    rng = np.random.default_rng([seed, 2])
    vals[upper] = -(rng.random(int(upper.sum())) + 0.5)
    # a lower entry (i, j) takes the weight of (j, i): upper keys ascend
    ukey = rows[upper] * n + col_idx[upper]
    lkey = col_idx[lower] * n + rows[lower]
    at = np.minimum(np.searchsorted(ukey, lkey), len(ukey) - 1)
    if len(lkey) != len(ukey) or not np.array_equal(ukey[at], lkey):
        raise ValueError("the pattern is not symmetric")
    vals[lower] = vals[upper][at]
    off = ~diag
    wsum = np.bincount(rows[off], weights=-vals[off], minlength=n)
    vals[diag] = (1.0 + shift) * wsum[rows[diag]]
    return vals.astype(dtype)


def reference_inv_diag(A: reference.Csr, dtype, device) -> torch.Tensor:
    """1 / a_ii from the benchmark's own CSR, in float64, then cast."""
    rows = np.repeat(np.arange(A.shape[0], dtype=np.int64),
                     np.diff(A.row_ptr))
    hit = A.col_idx == rows
    d = np.ones(A.shape[0])
    d[rows[hit]] = A.values[hit].astype(np.float64)
    return torch.as_tensor(1.0 / d, device=device).to(dtype)


def _pcg(matvec, b, inv_diag, tol: float, maxiter: int):
    """The module docstring's recurrence in b's precision, `matvec`
    returning A p in it; (x, iterations, converged)."""
    x = torch.zeros_like(b)
    r = b.clone()
    z = r * inv_diag
    p = z.clone()
    rz = torch.dot(r, z)
    b2 = torch.dot(b, b)
    tol2 = tol * tol * b2
    it = 0
    while it < maxiter and bool(torch.dot(r, r) > tol2):
        Ap = matvec(p)
        alpha = rz / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = r * inv_diag
        rz_n = torch.dot(r, z)
        p = z + (rz_n / rz) * p
        rz, it = rz_n, it + 1
    rel = float(torch.sqrt(torch.dot(r, r) / b2))
    return x, it, rel <= tol * 1.0000001


def reference_pcg(A: reference.DeviceCsr, b, inv_diag, tol: float = 1e-12,
                  maxiter: int = 20_000):
    """Plain Jacobi-PCG in float64 on A's device (`DeviceCsr.matmul`, no
    plan, graph or kernel of the program): (x, iterations, converged)."""
    return _pcg(A.matmul, b.to(torch.float64), inv_diag.to(torch.float64),
                tol, maxiter)


def control_pcg(plan: reference.DeviceCsr, b, inv_diag, tol: float,
                maxiter: int):
    """The control: A's values (the plan `ControlProgram.make_plan`
    gives) and each product's input vector rounded to TF32, the products
    summed in float64, the updates in float32, stopped as the program's
    solver stops."""
    def matvec(p):
        return plan.matmul(reference.tf32(p)).to(torch.float32)
    return _pcg(matvec, b.to(torch.float32), inv_diag.to(torch.float32),
                tol, maxiter)


def cg(program, plan, b, inv_diag, tol: float, maxiter: int):
    """(x, iterations, converged) of one Jacobi-PCG solve from x0 = 0 by
    `program`: its own `cg` method where it has one; the control's
    `control_pcg`; else `sblas_tpu_torch.solvers.cg` with M the inverse
    diagonal, the default chunk and its CUDA graph where it takes one."""
    if hasattr(program, "cg"):
        return program.cg(plan, b, inv_diag, tol, maxiter)
    if isinstance(program, ControlProgram):
        return control_pcg(plan, b, inv_diag, tol, maxiter)
    from sblas_tpu_torch import solvers
    res = solvers.cg(plan, b, tol=tol, maxiter=maxiter, M=inv_diag)
    return res.x, res.iterations, res.converged


def inv_diag(program, A: reference.Csr, dtype, device) -> torch.Tensor:
    """The Jacobi preconditioner: the program's `solvers.jacobi_inv_diag`
    of its own `CsrMatrix`, or the reference's for the control."""
    if isinstance(program, ControlProgram):
        return reference_inv_diag(A, dtype, device)
    from sblas_tpu_torch import solvers
    return solvers.jacobi_inv_diag(program.csr(A), dtype, device=device)


def pcg_iteration(n: int, nnz: int, value_bytes: int = 4) -> work.Work:
    """One CG + Jacobi iteration's least work on an (n, n) A of nnz
    entries: A once in CSR (values, 32-bit column indices and row
    pointers, as `work.spmm` counts it, whatever plan holds it); p, x, r
    and the inverse diagonal read once, x, r and p written once (A p and
    z need not leave the chip): 7n values; 2 nnz + 13n operations (the
    product; the dots p.Ap, r.z and r.r; the updates of x, r and p; the
    scaling z = M r).  At the shell (n 90,449, nnz 4,840,813, float32)
    that is 41,620,876 bytes, which fit in the H100's 50 MB L2: a share
    near 100 % would mean the iteration ran from L2."""
    csr = nnz * (value_bytes + work.INDEX_BYTES) + (n + 1) * work.INDEX_BYTES
    return work.Work(2.0 * nnz + 13.0 * n,
                     float(csr + 7 * n * value_bytes))
