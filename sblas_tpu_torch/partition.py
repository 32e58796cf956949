"""nnz-balanced and row-block partitioners for the distributed modes.

Port of `sblas_tpu/partition.py`; the numpy code is carried over, so the
arrays are byte-identical to the JAX package's.

* `partition_nnz_balanced` splits A's nnz range into `ceil(nnz/n)`-sized
  contiguous chunks, as the reference's `sync2gpu(n_gpu, segment)` does
  (matrix.h:356-395), and lets rows straddle shard boundaries: the sum
  collective adds the partial rows (the reference's overlap-add).  Shards
  are padded COO segments of one length, stacked `(n_shards, seg_nnz)`,
  with global row ids; padding carries val=0 and the shard's last real
  row, so each shard stays row-sorted.
* `partition_row_blocks` gives each shard a contiguous block of whole rows
  (and the matching x/y block) for the halo-exchange SpMV, with the
  column reach beyond the block recorded so the exchange is sized ahead.

The stacked tensors lie on an explicit `device`; every rank holds all
shards (COO is cheap) and reads row `rank`.  Values are float32, float64
or bfloat16 (laid out in float32 on the host and narrowed once, as the
single-device plans are).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from .config import DEFAULT, SBlasConfig
from .containers import CsrMatrix
from .ops.plans import host_value_dtype
from .utils.errors import PartitionError, require


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _tensor(a: np.ndarray, device, dtype=None) -> torch.Tensor:
    """`a` on `device`, narrowed to `dtype` on the host first when given."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return (t if dtype is None else t.to(dtype)).to(device)


@dataclasses.dataclass(frozen=True)
class CooSegments:
    """Stacked nnz-balanced COO shards of one CSR matrix.  `rows` hold
    global row indices, so the sum collective needs no offset
    bookkeeping."""

    rows: torch.Tensor  # (n_shards, seg_nnz) int32, row-sorted per shard
    cols: torch.Tensor  # (n_shards, seg_nnz) int32
    vals: torch.Tensor  # (n_shards, seg_nnz) dtype
    shape: Tuple[int, int]
    nnz: int
    n_shards: int
    starting_rows: Tuple[int, ...]   # first (possibly partial) row per shard
    stopping_rows: Tuple[int, ...]   # last row touched per shard (inclusive)

    @property
    def seg_nnz(self) -> int:
        return self.rows.shape[1]


def partition_nnz_balanced(A: CsrMatrix, n_shards: int, dtype=torch.float32,
                           config: SBlasConfig = DEFAULT, *,
                           device) -> CooSegments:
    """Split A's nnz into `n_shards` equal contiguous chunks.

    Chunking matches matrix.h:360 (`avg_nnz = ceil(nnz / n_gpu)`); the final
    shard takes the remainder.  Every shard is padded to the same
    tile-aligned length."""
    require(n_shards >= 1, PartitionError, f"n_shards must be >=1, got {n_shards}")
    m, _ = A.shape
    coo = A.to_coo()  # row-sorted by construction
    avg = -(-max(A.nnz, 1) // n_shards)  # ceil, like the reference
    seg_nnz = _round_up(avg, config.nnz_tile)

    rows = np.zeros((n_shards, seg_nnz), dtype=np.int64)
    cols = np.zeros((n_shards, seg_nnz), dtype=np.int64)
    vals = np.zeros((n_shards, seg_nnz), dtype=A.values.dtype)
    starting, stopping = [], []
    for s in range(n_shards):
        lo = min(s * avg, A.nnz)
        hi = min(lo + avg, A.nnz)
        k = hi - lo
        if k > 0:
            rows[s, :k] = coo.row_idx[lo:hi]
            cols[s, :k] = coo.col_idx[lo:hi]
            vals[s, :k] = coo.values[lo:hi]
            last_row = int(coo.row_idx[hi - 1])
            first_row = int(coo.row_idx[lo])
        else:  # empty shard (more shards than nnz)
            last_row = first_row = m - 1 if m else 0
        rows[s, k:] = last_row  # keeps per-shard rows sorted
        starting.append(first_row)
        stopping.append(last_row)

    return CooSegments(
        rows=_tensor(rows.astype(np.int32), device),
        cols=_tensor(cols.astype(np.int32), device),
        vals=_tensor(vals.astype(host_value_dtype(dtype)), device, dtype),
        shape=A.shape, nnz=A.nnz, n_shards=n_shards,
        starting_rows=tuple(starting), stopping_rows=tuple(stopping))


def partition_report(segs: CooSegments) -> str:
    """Human-readable shard stats (analog of the reference's per-shard
    printf, matrix.h:388-390)."""
    lines = []
    avg = -(-max(segs.nnz, 1) // segs.n_shards)
    for s in range(segs.n_shards):
        lo = min(s * avg, segs.nnz)
        hi = min(lo + avg, segs.nnz)
        lines.append(f"shard {s}: rows [{segs.starting_rows[s]}, "
                     f"{segs.stopping_rows[s]}], nnz {hi - lo} "
                     f"(padded {segs.seg_nnz})")
    return "\n".join(lines)


@dataclasses.dataclass(frozen=True)
class RowBlocks:
    """Contiguous row-block shards with halo metadata.

    Shard s owns rows [s*rows_per_shard, (s+1)*rows_per_shard) of the
    row-padded matrix.  `cols` are global column ids; `halo_left/right`
    give, over all shards, the max reach of columns beyond the owned block
    (in rows), so the x-block exchange is sized ahead."""

    cols: torch.Tensor        # (n_shards, seg_nnz) int32, global columns
    vals: torch.Tensor        # (n_shards, seg_nnz) dtype
    local_rows: torch.Tensor  # (n_shards, seg_nnz) int32, row - shard_base
    shape: Tuple[int, int]
    nnz: int
    n_shards: int
    rows_per_shard: int
    halo_left: int
    halo_right: int


def partition_row_blocks(A: CsrMatrix, n_shards: int, dtype=torch.float32,
                         config: SBlasConfig = DEFAULT, *,
                         device) -> RowBlocks:
    require(n_shards >= 1, PartitionError, f"bad n_shards {n_shards}")
    require(A.shape[0] == A.shape[1], PartitionError,
            "halo SpMV requires a square matrix (x and y share the blocking)")
    m = A.shape[0]
    rows_per_shard = _round_up(-(-m // n_shards), 8)

    seg_nnz_raw = 1
    per_shard = []
    for s in range(n_shards):
        r0 = min(s * rows_per_shard, m)
        r1 = min((s + 1) * rows_per_shard, m)
        lo, hi = int(A.row_ptr[r0]), int(A.row_ptr[r1])
        per_shard.append((r0, r1, lo, hi))
        seg_nnz_raw = max(seg_nnz_raw, hi - lo)
    seg_nnz = _round_up(seg_nnz_raw, config.nnz_tile)

    cols = np.zeros((n_shards, seg_nnz), dtype=np.int64)
    vals = np.zeros((n_shards, seg_nnz), dtype=A.values.dtype)
    lrow = np.zeros((n_shards, seg_nnz), dtype=np.int64)
    halo_l = halo_r = 0
    row_of = np.repeat(np.arange(m, dtype=np.int64), A.row_nnz)
    for s, (r0, r1, lo, hi) in enumerate(per_shard):
        k = hi - lo
        if k:
            cols[s, :k] = A.col_idx[lo:hi]
            vals[s, :k] = A.values[lo:hi]
            lrow[s, :k] = row_of[lo:hi] - r0
            halo_l = max(halo_l, int(max(r0 - A.col_idx[lo:hi].min(), 0)))
            halo_r = max(halo_r, int(max(A.col_idx[lo:hi].max() + 1
                                         - (r0 + rows_per_shard), 0)))
        lrow[s, k:] = (r1 - r0 - 1) if r1 > r0 else 0
        cols[s, k:] = min(r0, m - 1) if m else 0

    return RowBlocks(
        cols=_tensor(cols.astype(np.int32), device),
        vals=_tensor(vals.astype(host_value_dtype(dtype)), device, dtype),
        local_rows=_tensor(lrow.astype(np.int32), device),
        shape=A.shape, nnz=A.nnz, n_shards=n_shards,
        rows_per_shard=rows_per_shard,
        halo_left=halo_l, halo_right=halo_r)
