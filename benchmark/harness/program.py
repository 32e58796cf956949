"""The system under test: the public entries of `sblas_tpu_torch` that a
cell's window drives, behind one small interface.

The entries call only this interface, so the control (`control.py`:
the reference in the program's place) and the broken programs of the
tests drive the same window through the same code.  The benchmark hands
the program a `CsrMatrix` built from its own arrays; everything the
program derives from it (plans, shards, captured graphs) stays here.
"""

from __future__ import annotations

import torch


class Program:
    """`sblas_tpu_torch` as the cells drive it."""

    def __init__(self):
        from sblas_tpu_torch import CsrMatrix, ops, solvers
        from sblas_tpu_torch.parallel import make_mesh
        from sblas_tpu_torch.parallel import planned
        self._csr = CsrMatrix
        self._ops, self._solvers = ops, solvers
        self._planned, self._make_mesh = planned, make_mesh

    def csr(self, A):
        return self._csr(A.row_ptr, A.col_idx, A.values, A.shape)

    def make_plan(self, A, dtype, op, device):
        """`ops.make_plan(A, dtype, op=op)`, unforced."""
        return self._ops.make_plan(self.csr(A), dtype=dtype, op=op,
                                   device=device)

    def partition_row_plans(self, A, n_shards, dtype, op, device, rank):
        """Per-shard fast plans (`parallel.planned.partition_row_plans`),
        the shard kind unforced; only shard `rank` on `device`."""
        return self._planned.partition_row_plans(
            self.csr(A), n_shards, dtype=dtype, op=op, device=device,
            rank=rank)

    @staticmethod
    def kind(plan) -> str:
        return getattr(plan, "kind", None) or type(plan).__name__

    def spmm(self, plan, B, alpha, beta, C):
        return self._ops.spmm(plan, B, alpha, beta, C)

    def pagerank(self, plan, n, dangling, r0, damping, tol, maxiter):
        """(ranks, iterations, converged) of `solvers.pagerank`, with
        its CUDA graph where it takes one (`graph=None`)."""
        res = self._solvers.pagerank(plan, n, dangling=dangling, r0=r0,
                                     damping=damping, tol=tol,
                                     maxiter=maxiter)
        return res.x, res.iterations, res.converged

    def mesh(self, world: int, device):
        return self._make_mesh(world, device=device)

    def spmm_mode2(self, shards, B, alpha, beta, C, mesh):
        """Mode 2 with per-shard plans, the partial all-reduced."""
        return self._planned.spmm_mode2_planned(shards, B, alpha, beta, C,
                                                mesh, reduce="psum")

    @staticmethod
    def chunk() -> int:
        """Iterations a solver chunk runs (and a CUDA graph replays)."""
        import inspect

        from sblas_tpu_torch import solvers
        return inspect.signature(solvers.pagerank).parameters[
            "chunk"].default

    def release(self):
        """Drop what the program cached across calls (captured graphs)."""
        self._solvers.clear_programs()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
