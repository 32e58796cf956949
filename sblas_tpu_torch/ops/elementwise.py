"""Elementwise utility ops (port of `sblas_tpu/ops/elementwise.py`).

* `axpby` <- the reference's `denseVector_plusEqual_denseVector`
  (kernel.h:27-38, `Y = beta*Y + alpha*X`);
* `plus_scalar` <- `denseVector_plusEqual_scalar` (kernel.h:18-25, whose
  thread-indexing bug is not carried over).
"""

from __future__ import annotations

import torch


def axpby(x: torch.Tensor, y: torch.Tensor, alpha, beta) -> torch.Tensor:
    """Return beta*y + alpha*x."""
    return beta * y + alpha * x


def plus_scalar(y: torch.Tensor, value) -> torch.Tensor:
    """Return y + value, in y's dtype."""
    return y + torch.tensor(value, dtype=y.dtype, device=y.device)
