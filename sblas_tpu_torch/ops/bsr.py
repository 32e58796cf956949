"""Block-sparse (BELL: block-ELLPACK) plan and its batched-matmul ops.

Port of `sblas_tpu/ops/bsr.py`.  The matrix is re-blocked into dense
(R x C) tiles, every block-row padded to L block slots (padding slots
point at block-column 0 with zero values), and SpMM runs as batched dense
products:

    C_blockrow += sum_s  A_block[brow, s] @ B_blocktile[bcol[brow, s]]

The per-slot products are a plain large matrix product that the JAX
package leaves to XLA; here they are `torch.baddbmm`.  f32 must be true
f32, as the JAX package's `Precision.HIGHEST` is, so on CUDA the f32 path
raises `KernelError` while torch is set to use TF32 for float32 products.
`spmm_bsr` runs the hand-written kernel K4 (`bsr_pallas.py`) where
`takes_k4` says, on every path that multiplies a BELL plan: a single
device, a shard, a band, a mode-1 block.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import DEFAULT, SBlasConfig
from ..containers import CsrMatrix
from .bsr_pallas import spmm_bsr_pallas
from .plans import Plan, _round_up, host_value_dtype, require_true_f32

# B width from which a BELL SpMM takes kernel K4 (`takes_k4`)
_K4_MIN_K = 256


@dataclasses.dataclass(frozen=True)
class BsrPlan(Plan):
    """Block-ELL layout.

    vals: (n_brows, L, R, C) dense blocks (zero-filled)
    bcol: (n_brows, L) int32 block-column ids (padding slots point at
          block-column 0 with zero values)
    """

    vals: torch.Tensor
    bcol: torch.Tensor
    shape: Tuple[int, int]
    nnz: int
    block: Tuple[int, int]  # (R, C)

    @property
    def slots(self) -> int:
        return self.bcol.shape[1]

    @property
    def blowup(self) -> float:
        """Stored elements / true nnz (1.0 = perfectly dense blocks)."""
        return float(self.vals.numel()) / max(self.nnz, 1)

    @classmethod
    def from_csr(cls, A: CsrMatrix, dtype=torch.float32,
                 block: Tuple[int, int] = (128, 128),
                 config: SBlasConfig = DEFAULT, *, device) -> "BsrPlan":
        vals, bcol = bell_arrays(A, block)
        return cls.from_numpy(
            dict(vals=vals.astype(host_value_dtype(dtype)),
                 bcol=bcol.astype(np.int32)),
            dict(shape=A.shape, nnz=A.nnz, block=tuple(block)), device,
            dtype=dtype)


def bell_arrays(A: CsrMatrix, block: Tuple[int, int] = (128, 128)):
    """Block-ELL layout as host numpy arrays: (vals (n_brows,L,R,C),
    bcol (n_brows,L))."""
    R, C = block
    stats = bell_stats(A, block)
    n_brows, n_bcols, L = (stats["n_brows"], stats["n_bcols"],
                           stats["slots"])
    coo = A.to_coo()
    brow = coo.row_idx // R
    bcol = coo.col_idx // C
    # rank blocks within each block-row (blocks sorted by (brow, bcol))
    key = brow * n_bcols + bcol
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    uniq, inverse = np.unique(key_s, return_inverse=True)
    u_brow = uniq // n_bcols
    # slot of each unique block within its block-row
    first_of_brow = np.searchsorted(u_brow, np.arange(n_brows))
    slot_of_uniq = np.arange(len(uniq)) - first_of_brow[u_brow]
    slot = np.empty(len(key), dtype=np.int64)
    slot[order] = slot_of_uniq[inverse]

    vals = np.zeros((n_brows, L, R, C), dtype=A.values.dtype)
    bcol_arr = np.zeros((n_brows, L), dtype=np.int64)
    vals[brow, slot, coo.row_idx % R, coo.col_idx % C] = coo.values
    bcol_arr[u_brow, slot_of_uniq] = uniq % n_bcols
    return vals, bcol_arr


def bell_stats(A: CsrMatrix, block: Tuple[int, int] = (128, 128)) -> dict:
    """Block counts and fill blowup without materialising the plan."""
    R, C = block
    m, n = A.shape
    n_brows = max(_round_up(m, R) // R, 1)
    n_bcols = max(_round_up(n, C) // C, 1)
    coo = A.to_coo()
    key = (coo.row_idx // R) * n_bcols + (coo.col_idx // C)
    uniq = np.unique(key)
    counts = np.bincount(uniq // n_bcols, minlength=n_brows)
    L = max(int(counts.max()) if len(counts) else 1, 1)
    n_blocks_padded = n_brows * L
    return {
        "n_brows": n_brows,
        "n_bcols": n_bcols,
        "slots": L,
        "n_blocks": len(uniq),
        "blowup": n_blocks_padded * R * C / max(A.nnz, 1),
        "mean_blocks_per_brow": len(uniq) / n_brows,
    }


def _b_blocks(plan: BsrPlan, B: torch.Tensor) -> torch.Tensor:
    """Zero-pad B's rows to the block grid and view as (n_bcols, C, K)."""
    C = plan.block[1]
    n_pad = _round_up(plan.shape[1], C)
    B_p = F.pad(B, (0, 0, 0, n_pad - B.shape[0]))
    return B_p.reshape(n_pad // C, C, B.shape[1])


def bsr_matmul(plan: BsrPlan, B: torch.Tensor) -> torch.Tensor:
    """A @ B via a per-slot block gather + batched matmul."""
    require_true_f32(plan.vals)
    n_brows, L, R, _ = plan.vals.shape
    blocks = _b_blocks(plan, B)
    acc = torch.zeros((n_brows, R, B.shape[1]), dtype=plan.dtype,
                      device=B.device)
    for s in range(L):
        gathered = torch.index_select(blocks, 0, plan.bcol[:, s])
        acc.baddbmm_(plan.vals[:, s], gathered)
    return acc.reshape(n_brows * R, B.shape[1])[: plan.shape[0]]


def takes_k4(plan: BsrPlan, k: int, on_cuda: bool) -> bool:
    """Whether `spmm_bsr` over `plan` with a K-wide B runs kernel K4: B on
    CUDA, K >= 256 and the plan's blocks K4's 128 x 128.  The JAX package
    gates its Pallas kernel on K >= 256 and a TPU backend, so the CPU and
    other block shapes take the batched matmuls, as its CPU backend
    does."""
    return (on_cuda and k >= _K4_MIN_K
            and tuple(plan.block) == (128, 128))


def spmm_bsr_plain(plan: BsrPlan, B: torch.Tensor, alpha, beta,
                   C: torch.Tensor) -> torch.Tensor:
    """C' = beta*C + alpha*A@B by the batched matmuls (`bsr_matmul`)."""
    return beta * C + alpha * bsr_matmul(plan, B)


def spmm_bsr(plan: BsrPlan, B: torch.Tensor, alpha, beta,
             C: torch.Tensor) -> torch.Tensor:
    """C' = beta*C + alpha*A@B: kernel K4 where `takes_k4`, else the
    batched matmuls (`spmm_bsr_plain`)."""
    if takes_k4(plan, B.shape[1], B.is_cuda):
        return spmm_bsr_pallas(plan, B, alpha, beta, C)
    return spmm_bsr_plain(plan, B, alpha, beta, C)


def bsr_matvec(plan: BsrPlan, x: torch.Tensor) -> torch.Tensor:
    """A @ x: per-slot gather of (C,) x-tiles + batched block matvec."""
    return bsr_matmul(plan, x[:, None])[:, 0]


def spmv_bsr(plan: BsrPlan, x: torch.Tensor, alpha, beta,
             y: torch.Tensor) -> torch.Tensor:
    return beta * y + alpha * bsr_matvec(plan, x)
