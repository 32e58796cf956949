"""Distributed SpMM/SpMV strategies: mode 1, mode 2 and the halo SpMV.

Port of `sblas_tpu/parallel/modes.py`, the reference's two multi-GPU
strategies and one of the JAX package's:

* **mode 1, partition dense B** (`sblas_spmm_csr_v1`, spmm.h:83-161): A
  replicated, B and C split by columns, no communication.
* **mode 2, partition sparse A** (`sblas_spmm_csr_v2`, spmm.h:163-284, and
  `sblas_spmv_csr_v1`, spmv.h:35-139): A nnz-segmented with rows
  straddling shards; each rank sums its segment into a full-height
  partial, and one collective adds them: `reduce="psum"` all-reduces (the
  reference's replicated result), `reduce="psum_scatter"`
  reduce-scatters, leaving each rank a block of rows and moving 1/n of
  the bytes.
* **halo SpMV** (no reference analog): row blocks of a square A with x
  blocked the same way; each rank receives only its two neighbours' x
  blocks over the ring instead of all of x.

Every function runs on every rank of `mesh` and takes the global operands
(as the JAX wrappers do); where the JAX package shards an operand, the
rank reads only its block.  It returns the rank's part on the rank's
device: the whole result where the JAX output is replicated, the rank's
block of columns (mode 1) or rows (psum_scatter, halo) where it is
sharded, with the padding cut as the JAX wrappers cut it.
`sync_to_host(out, mesh, dim)` assembles the whole.  The `*_nocomm` twins
return the rank's partial without the collective (timing only).

bf16 values: a mode-2 partial holds rows that straddle shards, so it stays
in f32 (`plans.sum_dtype`), the collective sums f32, and the epilogue
rounds each element once (`plans.fold`); the JAX package sums bf16
partials and rounds a straddling row twice.  The result has the dtype the
JAX package returns (bf16 for bf16 operands).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops import spmm
from ..ops.plans import fold
from ..ops.spmm import segment_spmm
from ..ops.spmv import segment_spmv
from ..partition import CooSegments, RowBlocks
from ..utils.errors import PartitionError, ShapeError, require
from .mesh import Mesh, all_reduce, reduce_scatter, ring_exchange


def _pad_rows(x: torch.Tensor, m_pad: int) -> torch.Tensor:
    pad = m_pad - x.shape[0]
    if pad == 0:
        return x
    return F.pad(x, (0, 0) * (x.dim() - 1) + (0, pad))


def row_block(x: torch.Tensor, mesh: Mesh, m_pad: int) -> torch.Tensor:
    """The rank's block of `x` zero-padded to `m_pad` rows."""
    blk = m_pad // mesh.size
    return _pad_rows(x, m_pad)[mesh.rank * blk: (mesh.rank + 1) * blk]


def own_rows(out: torch.Tensor, mesh: Mesh, m: int) -> torch.Tensor:
    """`out`, the rank's row block, cut to the rows below `m` (the JAX
    wrappers' `[:m]` on the assembled result)."""
    blk = out.shape[0]
    return out[: max(min(blk, m - mesh.rank * blk), 0)]


def _check_reduce(reduce: str) -> None:
    require(reduce in ("psum", "psum_scatter"), PartitionError,
            f"bad reduce {reduce!r}")


def _check_shards(n_shards: int, mesh: Mesh, what: str = "segments"):
    require(n_shards == mesh.size, PartitionError,
            f"{what} built for {n_shards} shards, mesh has {mesh.size}")


def spmm_mode1(plan, B, alpha, beta, C, mesh: Mesh) -> torch.Tensor:
    """C' = beta*C + alpha*A@B with B/C split by columns, A replicated:
    the rank's column block.

    Functional equivalent of sblas_spmm_csr_v1 (spmm.h:83-161): each rank
    multiplies the whole A by its K/n columns; no collective.  K is
    zero-padded to a multiple of the rank count (the reference gives the
    last GPU a ragged slice instead, matrix.h:563-567)."""
    n = mesh.size
    require(B.shape[0] == plan.shape[1], ShapeError,
            f"A width {plan.shape[1]} != B height {B.shape[0]}")
    k = B.shape[1]
    kb = -(-k // n)
    k_pad = kb * n
    cols = slice(mesh.rank * kb, (mesh.rank + 1) * kb)
    B_blk = F.pad(B, (0, k_pad - k))[:, cols].contiguous()
    C_blk = F.pad(C, (0, k_pad - k))[:, cols]
    out = spmm(plan, B_blk, alpha, beta, C_blk)
    return out[:, : max(min(kb, k - mesh.rank * kb), 0)]


def _mode2_finish(partial, alpha, beta, Y, m, mesh, reduce, dtype):
    """Sum the full-height partials over the mesh and fold alpha/beta
    (`dtype`: the segments' value type)."""
    if reduce == "psum":
        return fold(alpha, all_reduce(partial, mesh), beta, Y, dtype)
    m_pad = -(-m // mesh.size) * mesh.size
    mine = reduce_scatter(_pad_rows(partial, m_pad), mesh)
    return own_rows(fold(alpha, mine, beta, row_block(Y, mesh, m_pad),
                         dtype), mesh, m)


def spmm_mode2(segs: CooSegments, B, alpha, beta, C, mesh: Mesh,
               reduce: str = "psum") -> torch.Tensor:
    """C' = beta*C + alpha*A@B with A nnz-segmented (rows may straddle
    shards), B replicated.

    `reduce="psum"` reproduces the reference's all-reduce of the full C
    (spmm.h:182-183, 260-262) and returns the whole C'; `"psum_scatter"`
    returns the rank's row block, moving 1/n of the bytes."""
    _check_reduce(reduce)
    _check_shards(segs.n_shards, mesh)
    require(B.shape[0] == segs.shape[1], ShapeError,
            f"A width {segs.shape[1]} != B height {B.shape[0]}")
    m = segs.shape[0]
    partial = spmm_mode2_nocomm(segs, B, mesh)
    return _mode2_finish(partial, alpha, beta, C, m, mesh, reduce,
                         segs.vals.dtype)


def spmv_dist(segs: CooSegments, x, alpha, beta, y, mesh: Mesh,
              reduce: str = "psum") -> torch.Tensor:
    """y' = beta*y + alpha*A@x with A nnz-segmented, x replicated.

    Functional equivalent of sblas_spmv_csr_v1 (spmv.h:35-139): per-rank
    partial y (spmv.h:85-91), one sum collective (spmv.h:115-118), fused
    fold (spmv.h:138)."""
    _check_reduce(reduce)
    _check_shards(segs.n_shards, mesh)
    require(x.shape[0] == segs.shape[1], ShapeError,
            f"A width {segs.shape[1]} != x length {x.shape[0]}")
    m = segs.shape[0]
    partial = spmv_dist_nocomm(segs, x, mesh)
    return _mode2_finish(partial, alpha, beta, y, m, mesh, reduce,
                         segs.vals.dtype)


def spmm_mode2_nocomm(segs: CooSegments, B, mesh: Mesh) -> torch.Tensor:
    """Diagnostic: the rank's full-height mode-2 partial (in the summing
    type) WITHOUT the sum collective, for the comm/compute split the CLIs
    report (the reference prints per-GPU NCCL time, spmm.h:258-271)."""
    r = mesh.rank
    return segment_spmm(segs.rows[r], segs.cols[r], segs.vals[r], B,
                        segs.shape[0], keep_sum=True)


def spmv_dist_nocomm(segs: CooSegments, x, mesh: Mesh) -> torch.Tensor:
    """Diagnostic twin of `spmv_dist` without the collective."""
    r = mesh.rank
    return segment_spmv(segs.rows[r], segs.cols[r], segs.vals[r], x,
                        segs.shape[0], keep_sum=True)


def spmv_halo(blocks: RowBlocks, x, alpha, beta, y, mesh: Mesh
              ) -> torch.Tensor:
    """y' = beta*y + alpha*A@x with A row-block-partitioned and x blocked
    the same way: the rank's row block.  Each rank receives only its
    neighbours' x blocks over the ring, never the whole vector.

    The column reach of every block must stay within one block left and
    right (checked from the partition's halo metadata), the case of
    banded/FEM matrices; wider reach -> spmv_dist."""
    _check_shards(blocks.n_shards, mesh, "blocks")
    r = blocks.rows_per_shard
    require(blocks.halo_left <= r and blocks.halo_right <= r, PartitionError,
            f"column footprint (halo {blocks.halo_left}/{blocks.halo_right})"
            f" exceeds one block ({r}); use spmv_dist instead")
    m = blocks.shape[0]
    m_pad = r * mesh.size
    x_blk = row_block(x, mesh, m_pad)
    from_left, from_right = ring_exchange(x_blk, mesh)
    x_ext = torch.cat([from_left, x_blk, from_right])       # (3r,)
    s = mesh.rank
    # global col -> offset into x_ext: col - (block_start - r); the clamp
    # is a no-op for valid partitions (halo <= r checked above)
    local_cols = torch.clamp(blocks.cols[s] - (s * r - r), 0, 3 * r - 1)
    partial = segment_spmv(blocks.local_rows[s], local_cols, blocks.vals[s],
                           x_ext, r, keep_sum=True)
    return own_rows(fold(alpha, partial, beta, row_block(y, mesh, m_pad),
                         blocks.vals.dtype), mesh, m)
