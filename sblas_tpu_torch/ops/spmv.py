"""Tier-0 SpMV over a `CooPlan` or `EllPlan`:  y' = beta*y + alpha*A@x.

Port of `sblas_tpu/ops/spmv.py`.  COO: gather x at the column ids,
multiply, and sum per row; the JAX package's sorted `segment_sum` becomes
`index_add_`, which on CUDA adds with atomics in no fixed order.  ELL:
gather x into the (m_pad, L) slots and sum each row, no scatter.  COO is
the baseline the other layouts are measured against.

A bf16 plan's products are bf16, as the JAX package's are, but its
scatter sums run in f32 and round once (`plans.sum_dtype`).
"""

from __future__ import annotations

import torch

from .plans import CooPlan, EllPlan, sum_dtype


def segment_spmv(rows, cols, vals, x, m: int) -> torch.Tensor:
    """Sorted COO triplets x vector -> (m,) partial result."""
    contrib = vals * torch.index_select(x, 0, cols)
    acc = sum_dtype(contrib.dtype)
    return torch.zeros(m, dtype=acc, device=contrib.device).index_add_(
        0, rows, contrib.to(acc)).to(contrib.dtype)


def spmv_coo(plan: CooPlan, x: torch.Tensor, alpha, beta,
             y: torch.Tensor) -> torch.Tensor:
    ax = segment_spmv(plan.rows, plan.cols, plan.vals, x, plan.shape[0])
    return beta * y + alpha * ax


def spmv_ell(plan: EllPlan, x: torch.Tensor, alpha, beta,
             y: torch.Tensor) -> torch.Tensor:
    gathered = x[plan.cols]                          # (m_pad, L)
    ax = (plan.vals * gathered).sum(dim=1)[: plan.shape[0]]
    return beta * y + alpha * ax
