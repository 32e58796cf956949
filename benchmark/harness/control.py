"""The control: the reference put in the program's place, computed from
TF32 inputs.

The configurations state float32 with TF32 off; the step below that a
later change could be tempted to take is TF32, which reads float32
operands at a 10-bit mantissa.  `ControlProgram` has the program's
interface (`program.Program`) and answers every call with the plain
reference, its matrix values and its dense operands rounded to TF32
(`reference.tf32`) and the products summed in float64, so it is more
accurate than a TF32 kernel would be: a check that fails it fails TF32.
It distributes nothing: its mode 2 returns the whole product.
"""

from __future__ import annotations

import torch

from . import reference


class ControlProgram:
    """Program's interface over the TF32 reference."""

    def make_plan(self, A, dtype, op, device):
        vals = torch.as_tensor(A.values, device=device).to(torch.float32)
        return reference.DeviceCsr(A, device, reference.tf32(vals))

    def partition_row_plans(self, A, n_shards, dtype, op, device, rank):
        return self.make_plan(A, dtype, op, device)

    @staticmethod
    def kind(plan) -> str:
        return "control_tf32"

    @staticmethod
    def spmm(plan, B, alpha, beta, C):
        prod = plan.matmul(reference.tf32(B.to(torch.float32)))
        return (beta * C.to(torch.float64) + alpha * prod).to(C.dtype)

    def spmm_mode2(self, shards, B, alpha, beta, C, mesh):
        return self.spmm(shards, B, alpha, beta, C)

    @staticmethod
    def mesh(world, device):
        return None

    @staticmethod
    def pagerank(plan, n, dangling, r0, damping, tol, maxiter):
        """The power iteration with r read at TF32 by the product, the
        update in float32, stopped as the program's solver stops."""
        r, d = r0.to(torch.float32), dangling.to(torch.float32)
        it, delta = 0, float("inf")
        while it < maxiter and delta > tol:
            spread = plan.matmul(reference.tf32(r)).to(torch.float32)
            r_n = damping * (spread + torch.dot(d, r) / n) + (1 - damping) / n
            delta = float((r_n - r).abs().sum())
            r, it = r_n, it + 1
        return r, it, delta <= tol

    @staticmethod
    def chunk() -> int:
        return 1

    @staticmethod
    def release():
        pass
