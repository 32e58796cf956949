"""Diagonal (DIA) plan: shift-and-FMA SpMV/SpMM for banded matrices.

Port of `sblas_tpu/ops/dia.py`.  One dense value column per occupied
diagonal, and

    y = sum_j  vals[:, j] * x[offset_j : offset_j + m]

Every term is a static-offset slice of (zero-padded) x or B, so there is
no gather and no scatter.  The JAX package leaves the loop to XLA, which
fuses it into one pass.  Eager torch runs it as one in-place `addcmul_`
per diagonal (91 on the shell proxy): `spmv_dia_plain` and
`spmm_dia_plain`, the plain versions.  On the card an f32 or f64 SpMM is
one launch of kernel K5 (`dia_spmm`, csrc/dia_kernels.cu), which reads B
once per run of consecutive offsets (`dia_runs`) and writes
`beta*C + alpha*A@B` in its epilogue; an f32 or f64 SpMV is one launch of
kernel K6 (`dia_spmv`, the same file), which stages a tile of rows'
values and one window of x a run in shared memory and writes
`beta*y + alpha*A@x`.  CPU plans and bf16 plans keep the loop.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import _kernels
from ..config import DEFAULT, SBlasConfig
from ..containers import CsrMatrix
from ..utils import trace
from ..utils.errors import KernelError, ShapeError, require
from .plans import Plan, fold, host_value_dtype

# the widest run of consecutive offsets K5 takes in one B window; a
# longer one is split (`kRunCap` in csrc/dia_kernels.cu: at 28 three of
# the kernel's blocks fit an SM's shared memory).  K6 stages one window
# of x a run of the same table.
RUN_CAP = 28


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
        return cls.from_numpy(
            dict(vals=vals.astype(host_value_dtype(dtype))),
            dict(offsets=offs, shape=A.shape, nnz=A.nnz), device,
            dtype=dtype)

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


def spmv_dia_plain(plan: DiaPlan, x: torch.Tensor, alpha, beta,
                   y: torch.Tensor) -> torch.Tensor:
    """y' = beta*y + alpha*A@x, one `addcmul_` per diagonal, counted as
    `dia_spmv_loop_calls` on every device (under a CUDA graph: its
    capture, not each replay)."""
    trace.count("dia_spmv_loop_calls")
    m = plan.shape[0]
    x_pad, lead = _x_padded(plan, x)
    acc = torch.zeros(m, dtype=plan.dtype, device=x.device)
    for j, off in enumerate(plan.offsets):
        acc.addcmul_(plan.vals[:, j], x_pad[off + lead: off + lead + m])
    return beta * y + alpha * acc


def spmm_dia_plain(plan: DiaPlan, B: torch.Tensor, alpha, beta,
                   C: torch.Tensor) -> torch.Tensor:
    """C' = beta*C + alpha*A@B, one `addcmul_` per diagonal; B is re-read
    once per diagonal."""
    m = plan.shape[0]
    B_pad, lead = _x_padded(plan, B)
    acc = torch.zeros((m, B.shape[1]), dtype=plan.dtype, device=B.device)
    for j, off in enumerate(plan.offsets):
        acc.addcmul_(plan.vals[:, j:j + 1], B_pad[off + lead: off + lead + m])
    return beta * C + alpha * acc


@functools.lru_cache(maxsize=256)
def dia_runs(offsets: Tuple[int, ...]) -> tuple:
    """The plan's diagonals cut into runs of consecutive offsets, in their
    order: (lo, j0, width) each, diagonals j0 .. j0 + width - 1 at offsets
    lo .. lo + width - 1, width at most `RUN_CAP`."""
    runs = []
    for j, off in enumerate(offsets):
        if runs:
            lo, j0, w = runs[-1]
            if off == lo + w and w < RUN_CAP:
                runs[-1] = (lo, j0, w + 1)
                continue
        runs.append((off, j, 1))
    return tuple(runs)


@functools.lru_cache(maxsize=None)
def _run_table(offsets: Tuple[int, ...], device: torch.device) -> tuple:
    """(K5's and K6's run table on `device`, an (n_runs, 3) int32 tensor
    of `dia_runs(offsets)`, and the widest run): made once per offsets
    and device, so a call copies nothing to the device.  Never evicted: a
    captured CUDA graph (a solver's chunk) keeps reading it."""
    runs = dia_runs(offsets)
    table = torch.tensor(runs, dtype=torch.int32).reshape(len(runs), 3)
    return table.to(device), max((w for _, _, w in runs), default=0)


def dia_spmm(plan: DiaPlan, B: torch.Tensor, C: torch.Tensor, alpha,
             beta) -> torch.Tensor:
    """Kernel K5: beta*C + alpha*A@B in one launch, into a new (m, K)
    tensor.  B (n, K) and C (m, K) in the plan's dtype on its device, with
    unit column stride (any row stride); raises otherwise."""
    dev, dt = plan.vals.device, plan.dtype
    variant = _kernels.value_suffix(dt)
    (m, n), k = plan.shape, B.shape[1]
    nd = len(plan.offsets)
    _kernels.check_operand(plan.vals, "vals", dt, (m, nd), dev)
    for t, name, rows in ((B, "B", n), (C, "C", m)):
        # as check_operand: the messages are formatted only on a failure
        if (t.device == dev and t.dtype == dt and t.shape == (rows, k)
                and (t.stride(1) == 1 or k <= 1)):
            continue
        require(t.device == dev and t.dtype == dt, KernelError,
                f"{name} is {t.dtype} on {t.device}, expected {dt} on {dev}")
        require(tuple(t.shape) == (rows, k), ShapeError,
                f"{name} has shape {tuple(t.shape)}, expected {(rows, k)}")
        require(t.stride(1) == 1 or k <= 1, KernelError,
                f"{name} has column stride {t.stride(1)}, expected 1")
    table, wmax = _run_table(plan.offsets, dev)
    out = torch.empty((m, k), dtype=dt, device=dev)
    _kernels.launch(_kernels.launcher("dia_spmm", variant), dev, plan.vals,
                    table, B, C, out, table.shape[0], nd, wmax, m, n, k,
                    B.stride(0), C.stride(0), float(alpha), float(beta))
    dia_spmm.launches += 1
    return out


dia_spmm.launches = 0   # K5 launches since the last reset


def dia_spmv(plan: DiaPlan, x: torch.Tensor, y, alpha,
             beta) -> torch.Tensor:
    """Kernel K6: beta*y + alpha*A@x in one launch, into a new (m,)
    tensor; y=None gives alpha*A@x without reading y.  x (n,) and y (m,)
    in the plan's dtype on its device, with unit stride; raises
    otherwise."""
    dev, dt = plan.vals.device, plan.dtype
    variant = _kernels.value_suffix(dt)
    m, n = plan.shape
    nd = len(plan.offsets)
    _kernels.check_operand(plan.vals, "vals", dt, (m, nd), dev)
    for t, name, rows in ((x, "x", n), (y, "y", m)):
        # as check_operand: the messages are formatted only on a failure
        if t is None or (t.device == dev and t.dtype == dt
                         and t.shape == (rows,)
                         and (t.stride(0) == 1 or rows <= 1)):
            continue
        require(t.device == dev and t.dtype == dt, KernelError,
                f"{name} is {t.dtype} on {t.device}, expected {dt} on {dev}")
        require(tuple(t.shape) == (rows,), ShapeError,
                f"{name} has shape {tuple(t.shape)}, expected {(rows,)}")
        require(t.stride(0) == 1 or rows <= 1, KernelError,
                f"{name} has stride {t.stride(0)}, expected 1")
    table, _ = _run_table(plan.offsets, dev)
    out = torch.empty(m, dtype=dt, device=dev)
    _kernels.launch(_kernels.launcher("dia_spmv", variant), dev, plan.vals,
                    table, x, y, out, table.shape[0], nd, m, n,
                    float(alpha), float(beta))
    dia_spmv.launches += 1
    return out


dia_spmv.launches = 0   # K6 launches since the last reset


def spmv_dia(plan: DiaPlan, x: torch.Tensor, alpha, beta,
             y: torch.Tensor) -> torch.Tensor:
    """y' = beta*y + alpha*A@x.  CPU plans, and bf16 plans elsewhere (their
    bf16 running sum is the JAX package's), take the plain loop
    (`spmv_dia_plain`).  Elsewhere f32 and f64 plans launch K6 once,
    counted as `dia_spmv_kernel_calls`, with x taken in the plan's dtype.
    Where y is of another dtype, K6 forms A@x alone and the epilogue runs
    in the result's dtype (`plans.fold`), so y is never rounded to the
    plan's."""
    if plan.vals.device.type == "cpu" or plan.dtype == torch.bfloat16:
        return spmv_dia_plain(plan, x, alpha, beta, y)
    trace.count("dia_spmv_kernel_calls")
    dt = plan.dtype
    x = x.to(dt).contiguous()
    if y.dtype == dt:
        return dia_spmv(plan, x, y.contiguous(), alpha, beta)
    return fold(alpha, dia_spmv(plan, x, None, 1.0, 0.0), beta, y, dt)


def _unit_columns(t: torch.Tensor) -> torch.Tensor:
    return t if t.shape[1] <= 1 or t.stride(1) == 1 else t.contiguous()


def spmm_dia(plan: DiaPlan, B: torch.Tensor, alpha, beta,
             C: torch.Tensor) -> torch.Tensor:
    """C' = beta*C + alpha*A@B.  CPU plans take the plain loop
    (`spmm_dia_plain`).  Elsewhere f32 and f64 plans launch K5 once,
    with B and C taken in the plan's dtype (as K4's path takes them), and
    bf16 plans take the loop, counted as `dia_loop_calls` (its bf16
    running sum is the JAX package's)."""
    if plan.vals.device.type == "cpu":
        return spmm_dia_plain(plan, B, alpha, beta, C)
    if plan.dtype == torch.bfloat16:
        trace.count("dia_loop_calls")
        return spmm_dia_plain(plan, B, alpha, beta, C)
    dt = plan.dtype
    return dia_spmm(plan, _unit_columns(B.to(dt)), _unit_columns(C.to(dt)),
                    alpha, beta)
