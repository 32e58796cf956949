"""Diagonal (DIA) plan: shift-and-FMA SpMV/SpMM for banded matrices.

Port of `sblas_tpu/ops/dia.py`.  One dense value column per occupied
diagonal, and

    y = sum_j  vals[:, j] * x[offset_j : offset_j + m]

Every term is a static-offset slice of (zero-padded) x or B, so there is
no gather and no scatter.  The JAX package leaves the loop to XLA, which
fuses it into one pass; eager torch runs one in-place `addcmul_` per
diagonal (91 on the shell proxy), which is correct but not fused — a
fused DIA kernel is later work.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import DEFAULT, SBlasConfig
from ..containers import CsrMatrix
from .plans import Plan, np_value_dtype


def dia_stats(A: CsrMatrix) -> dict:
    """Occupied-diagonal count and storage blowup."""
    coo = A.to_coo()
    m = max(A.height, 1)
    offs = np.unique(coo.col_idx - coo.row_idx) if A.nnz else np.zeros(
        1, np.int64)
    return {
        "n_diags": len(offs),
        "offsets": offs,
        "blowup": len(offs) * m / max(A.nnz, 1),
    }


def dia_arrays(A: CsrMatrix, offsets=None, n_rows: int = None) -> tuple:
    """DIA value matrix as host numpy: (vals (n_rows, len(offsets)),
    offsets tuple).  `offsets` defaults to A's occupied diagonals."""
    coo = A.to_coo()
    if offsets is None:
        offsets = dia_stats(A)["offsets"]
    offsets = np.asarray(offsets, dtype=np.int64)
    n_rows = n_rows if n_rows is not None else max(A.height, 1)
    vals = np.zeros((n_rows, len(offsets)), dtype=A.values.dtype)
    if A.nnz:
        j = np.searchsorted(offsets, coo.col_idx - coo.row_idx)
        vals[coo.row_idx, j] = coo.values
    return vals, tuple(int(o) for o in offsets)


@dataclasses.dataclass(frozen=True)
class DiaPlan(Plan):
    """Diagonal storage: vals[i, j] = A[i, i + offsets[j]] (0 if absent).
    `offsets` is a static Python tuple."""

    vals: torch.Tensor  # (m, n_diags)
    offsets: Tuple[int, ...]
    shape: Tuple[int, int]
    nnz: int

    @property
    def blowup(self) -> float:
        return self.vals.numel() / max(self.nnz, 1)

    @classmethod
    def from_csr(cls, A: CsrMatrix, dtype=torch.float32,
                 config: SBlasConfig = DEFAULT, *, device) -> "DiaPlan":
        vals, offs = dia_arrays(A)
        return cls.from_numpy(dict(vals=vals.astype(np_value_dtype(dtype))),
                              dict(offsets=offs, shape=A.shape, nnz=A.nnz),
                              device)

    @classmethod
    def is_profitable(cls, A: CsrMatrix,
                      config: SBlasConfig = DEFAULT) -> bool:
        """Few enough occupied diagonals and a small enough blowup."""
        if A.nnz == 0:
            return False
        st = dia_stats(A)
        return (st["n_diags"] <= config.dia_max_diags
                and st["blowup"] <= config.dia_blowup_limit)


def _x_padded(plan: DiaPlan, x: torch.Tensor):
    """x (or B, along its rows) extended so every diagonal's length-m
    slice is in range: slice j starts at offsets[j] + lead into
    [lead zeros | x | tail zeros]."""
    m, n = plan.shape
    lead = max(-min(plan.offsets), 0)
    tail = max(max(plan.offsets) + m - n, 0)
    pad = (lead, tail) if x.dim() == 1 else (0, 0, lead, tail)
    return F.pad(x, pad), lead


def spmv_dia(plan: DiaPlan, x: torch.Tensor, alpha, beta,
             y: torch.Tensor) -> torch.Tensor:
    m = plan.shape[0]
    x_pad, lead = _x_padded(plan, x)
    acc = torch.zeros(m, dtype=plan.dtype, device=x.device)
    for j, off in enumerate(plan.offsets):
        acc.addcmul_(plan.vals[:, j], x_pad[off + lead: off + lead + m])
    return beta * y + alpha * acc


def spmm_dia(plan: DiaPlan, B: torch.Tensor, alpha, beta,
             C: torch.Tensor) -> torch.Tensor:
    """C' = beta*C + alpha*A@B; B is re-read once per diagonal."""
    m = plan.shape[0]
    B_pad, lead = _x_padded(plan, B)
    acc = torch.zeros((m, B.shape[1]), dtype=plan.dtype, device=B.device)
    for j, off in enumerate(plan.offsets):
        acc.addcmul_(plan.vals[:, j:j + 1], B_pad[off + lead: off + lead + m])
    return beta * C + alpha * acc
