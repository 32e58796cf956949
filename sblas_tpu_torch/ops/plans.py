"""Device-side sparse-operand plans: padded COO and ELLPACK.

Port of `sblas_tpu/ops/plans.py`.  A plan lays a CSR matrix out once as
fixed-shape tensors on an explicit device, so every op is a plain
function of tensors.  `CooPlan` is the universal fallback and the
benchmark's tier-0 baseline; `EllPlan` pads every row to L slots, so its
ops are gather + multiply + row sum with no scatter.  The DIA, BELL and
windowed-COO plans (`dia.py`, `bsr.py`, `wcoo.py`) share the `Plan` base
below; the routed plan (`rspmv.py`) has its own.

Every plan's host arrays are built by the JAX package's numpy code,
carried over, so they are byte-identical to its plan's; `from_numpy`
takes either.  Indices are int32 on the device.  Single-device plans
take float32, float64 or bfloat16 values; numpy has no bfloat16, so a
bf16 plan's host arrays are float32 (`host_value_dtype`) and its values
are narrowed once as they are placed, and its ops compute at bf16, as
the JAX package's XLA code does.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..config import DEFAULT, SBlasConfig
from ..containers import CsrMatrix
from ..utils.errors import PlanError, require

NP_VALUE = {torch.float32: np.float32, torch.float64: np.float64}
# value dtype -> the host layout's: bf16 plans are laid out in f32
HOST_VALUE = {torch.float32: np.float32, torch.float64: np.float64,
              torch.bfloat16: np.float32}


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def np_value_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy value type of a plan of torch `dtype` (float32/64; the
    distributed and host-streamed plans take no bfloat16)."""
    require(dtype in NP_VALUE, PlanError,
            f"plans take torch.float32 or torch.float64, got {dtype}")
    return np.dtype(NP_VALUE[dtype])


def sum_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type a plan's scatter sums and K3's row sums run in: f32 for
    bf16 (a bf16 running sum stops growing on a long row: at 256 its ulp
    is 2, and a term below 1 then adds nothing), else the value type."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def host_value_dtype(dtype: torch.dtype) -> np.dtype:
    """The numpy type a single-device plan of torch `dtype` is laid out in
    on the host: float32 for bfloat16 (narrowed by `from_numpy`)."""
    require(dtype in HOST_VALUE, PlanError,
            f"plans take torch.float32, torch.float64 or torch.bfloat16, "
            f"got {dtype}")
    return np.dtype(HOST_VALUE[dtype])


class Plan:
    """Base of the frozen plan dataclasses: every `torch.Tensor` field lies
    on one device, `vals` holds the values, and every other field is
    static metadata."""

    @property
    def device(self) -> torch.device:
        return self.vals.device

    @property
    def dtype(self) -> torch.dtype:
        return self.vals.dtype

    def to(self, device):
        """The same plan with every tensor on `device`."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})

    @classmethod
    def from_numpy(cls, fields: dict, meta: dict, device, dtype=None):
        """Plan from host arrays: `fields` maps each tensor field to a numpy
        array (the JAX package's plan fields, `np.asarray` of each, are
        taken as they are), `meta` each static field to its value.
        `dtype` (e.g. torch.bfloat16) narrows every floating field once,
        as it is placed."""
        def tensor(a):
            a = np.ascontiguousarray(a)
            if not a.flags.writeable:   # e.g. np.asarray of a jax.Array
                a = a.copy()
            t = torch.from_numpy(a).to(device)
            if dtype is not None and t.is_floating_point():
                t = t.to(dtype)
            return t

        data = {k: tensor(v) for k, v in fields.items()}
        require(data["vals"].dtype in HOST_VALUE, PlanError,
                f"plans hold float32, float64 or bfloat16 values, got "
                f"{data['vals'].dtype}")
        meta = dict(meta, shape=tuple(int(d) for d in meta["shape"]))
        return cls(**data, **meta)


@dataclasses.dataclass(frozen=True)
class CooPlan(Plan):
    """Padded, row-sorted COO triplets on one device.

    Padding entries carry val=0 and point at the last row/col 0, so the
    arrays stay row-sorted and contribute nothing."""

    rows: torch.Tensor  # (nnz_pad,) int32, sorted ascending
    cols: torch.Tensor  # (nnz_pad,) int32
    vals: torch.Tensor  # (nnz_pad,) dtype
    shape: Tuple[int, int]
    nnz: int

    @classmethod
    def from_csr(cls, A: CsrMatrix, dtype=torch.float32,
                 config: SBlasConfig = DEFAULT, *, device) -> "CooPlan":
        np_val = host_value_dtype(dtype)
        coo = A.to_coo()
        nnz_pad = max(_round_up(max(A.nnz, 1), config.nnz_tile),
                      config.nnz_tile)
        pad = nnz_pad - A.nnz
        rows = np.concatenate(
            [coo.row_idx, np.full(pad, A.height - 1, dtype=np.int64)])
        cols = np.concatenate([coo.col_idx, np.zeros(pad, dtype=np.int64)])
        vals = np.concatenate(
            [coo.values, np.zeros(pad, dtype=coo.values.dtype)])
        return cls.from_numpy(
            dict(rows=rows.astype(np.int32), cols=cols.astype(np.int32),
                 vals=vals.astype(np_val)),
            dict(shape=A.shape, nnz=A.nnz), device, dtype=dtype)


def ell_arrays(A: CsrMatrix):
    """ELLPACK layout as host numpy arrays: (cols, vals), each (m_pad, L)."""
    m, _ = A.shape
    row_nnz = A.row_nnz
    L = max(int(row_nnz.max()) if m else 1, 1)
    m_pad = _round_up(max(m, 1), 8)
    cols = np.zeros((m_pad, L), dtype=np.int64)
    vals = np.zeros((m_pad, L), dtype=A.values.dtype)
    # slot index of each nnz within its row: position - row start
    slot = np.arange(A.nnz, dtype=np.int64) - np.repeat(
        A.row_ptr[:-1], row_nnz)
    row_of = np.repeat(np.arange(m, dtype=np.int64), row_nnz)
    cols[row_of, slot] = A.col_idx
    vals[row_of, slot] = A.values
    return cols, vals


@dataclasses.dataclass(frozen=True)
class EllPlan(Plan):
    """ELLPACK layout: every row padded to L slots (col 0, val 0); rows
    padded to a multiple of 8, as in the JAX package."""

    cols: torch.Tensor  # (m_pad, L) int32
    vals: torch.Tensor  # (m_pad, L) dtype
    shape: Tuple[int, int]
    nnz: int

    @property
    def slots(self) -> int:
        return self.cols.shape[1]

    @classmethod
    def from_csr(cls, A: CsrMatrix, dtype=torch.float32,
                 config: SBlasConfig = DEFAULT, *, device) -> "EllPlan":
        np_val = host_value_dtype(dtype)
        cols, vals = ell_arrays(A)
        return cls.from_numpy(
            dict(cols=cols.astype(np.int32), vals=vals.astype(np_val)),
            dict(shape=A.shape, nnz=A.nnz), device, dtype=dtype)

    @classmethod
    def is_profitable(cls, A: CsrMatrix,
                      config: SBlasConfig = DEFAULT) -> bool:
        """ELL stores m * max_row_nnz padded slots; profitable only when
        that stays within ell_blowup_limit of the true nnz (the exact
        padded-slot form)."""
        if A.nnz == 0 or A.height == 0:
            return False
        padded = float(A.row_nnz.max()) * A.height
        return padded <= config.ell_blowup_limit * A.nnz
