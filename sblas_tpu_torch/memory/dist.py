"""Multi-device UM ops: host-resident sparse A under the v1 / v2
strategies, over `torch.distributed`.

Port of `sblas_tpu/memory/dist.py`.  The reference's UM ops are its
multi-GPU drivers, `sblas_spmm_csr_v2` / `sblas_spmv_csr_v1` over managed
memory with NCCL (spmm_um.h:163-284, spmv_um.h:35-139): A lives in
host-pageable memory, each GPU computes its nnz segment, and an
all-reduce combines the partial C.  Here:

* A is split into row-granular nnz-balanced shards, and every shard into
  row bands sized to the per-device budget (`host_resident_shards`).  All
  (shard, band) cells share one set of dimensions, probed over every
  cell; each rank builds and pins only its own shard's bands (the others
  are None, as in `parallel.planned.RowPlanShards`).
* `spmv_um_dist` / `spmm_um_dist` (v2) stream the rank's bands through
  `host.each_band`, add each band's product into a full-height partial at
  the band's global first row, and all-reduce the partial once per call
  (the JAX package sums once per dispatch of `SBLAS_STREAM_CHUNK` bands,
  so the two differ only in summation order).  `tuning=True` keeps the
  rank's bands on its device.
* `spmm_um_mode1` (v1, spmm.h:83-161) streams the whole A, a
  `HostResidentPlan`, on every rank against the rank's block of B's
  columns, with no collective, and returns that block of C's columns, as
  `parallel.modes.spmm_mode1` does.

Every function runs on every rank of `mesh` and takes the global dense
operands; `parallel.sync_to_host` assembles mode 1's column blocks.

bf16 values: the shards' rows straddle no shard, but the v2 partial is
kept in f32 (`plans.sum_dtype`) all the same, as mode 2's is, and the
epilogue rounds once (`plans.fold`); the JAX package sums bf16 partials.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import DEFAULT, SBlasConfig
from ..containers import CsrMatrix
from ..ops import spmm, spmv
from ..ops.plans import fold, sum_dtype, value_itemsize
from ..parallel.mesh import Mesh, all_reduce
from ..parallel.planned import _local, _row_boundaries
from ..utils.errors import PartitionError, ShapeError, require
from .host import (_INFLIGHT, HostResidentPlan, _choose_band_kind,
                   build_band_plan, each_band, probe_band_dims, spmm_um)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class HostResidentShards:
    """Per-shard host-resident bands: `shards[s]` holds shard s's bands as
    a `HostResidentPlan` over its local rows (n_bands * band_rows of them,
    the tail empty), or None where this rank does not hold it;
    `offsets[b, s]` is the global first row of shard s's band b (clamped
    to the last row for empty bands past the matrix)."""

    shards: Tuple[Optional[HostResidentPlan], ...]
    offsets: np.ndarray  # (n_bands, n_shards) int32
    band_rows: int
    n_shards: int
    shape: Tuple[int, int]
    nnz: int
    kind: str

    @property
    def n_bands(self) -> int:
        return self.offsets.shape[0]

    def _held(self):
        return [s for s in self.shards if s is not None]

    @property
    def tuned(self) -> bool:
        return all(s.tuned for s in self._held())

    def local(self, rank: int) -> HostResidentPlan:
        return _local(self.shards, rank)

    # --- residency control (reference matrix_um.h:529-614) ---
    def apply_gpu_tuning(self) -> None:
        """Copy the bands of every shard this process holds to its
        device and keep them there."""
        for s in self._held():
            s.apply_gpu_tuning()

    def remove_gpu_tuning(self) -> None:
        for s in self._held():
            s.remove_gpu_tuning()

    def apply_cpu_tuning(self) -> None:
        self.remove_gpu_tuning()

    @classmethod
    def from_numpy(cls, bands: Sequence[dict], meta: dict, device,
                   rank: Optional[int] = None) -> "HostResidentShards":
        """The shards from host arrays laid out as the JAX package stacks
        them: `bands[b]` maps each tensor field to an array with leading
        (1, n_shards) axes; `meta` holds `offsets`, `band_rows`,
        `n_shards`, `shape`, `nnz` and `kind`.  `rank` keeps only that
        shard (every shard when None)."""
        n_shards, band_rows = int(meta["n_shards"]), int(meta["band_rows"])
        shape = tuple(int(d) for d in meta["shape"])
        offsets = np.asarray(meta["offsets"], np.int32)
        local = dict(kind=meta["kind"], band_rows=band_rows, nnz=meta["nnz"],
                     shape=(offsets.shape[0] * band_rows, shape[1]))
        shards = tuple(
            HostResidentPlan.from_numpy(
                [{k: np.asarray(v)[0, s] for k, v in f.items()}
                 for f in bands], local, device)
            if rank is None or s == rank else None
            for s in range(n_shards))
        return cls(shards, offsets, band_rows, n_shards, shape,
                   int(meta["nnz"]), meta["kind"])


def host_resident_shards(A: CsrMatrix, n_shards: int, dtype=torch.float32,
                         hbm_budget_bytes: int = 256 << 20,
                         config: SBlasConfig = DEFAULT,
                         kind: str = None, *, device,
                         rank: Optional[int] = None) -> HostResidentShards:
    """nnz-balanced row-granular shards, each cut into bands sized to the
    per-device budget, host-resident for `device`.  Every (shard, band)
    cell shares one set of dimensions; only shard `rank` is built (every
    shard when None)."""
    require(n_shards >= 1, PartitionError, f"bad n_shards {n_shards}")
    m, n = A.shape
    bounds = _row_boundaries(A, n_shards)
    shard_rows = _round_up(int(np.max(bounds[1:] - bounds[:-1])) or 1, 128)
    kind = kind or _choose_band_kind(A, config)

    itemsize = value_itemsize(dtype)
    nnz_per_row = A.nnz / max(m, 1)
    budget = hbm_budget_bytes / _INFLIGHT
    if kind == "bsr":
        from ..ops.bsr import bell_stats
        R, _ = config.bsr_block
        st = bell_stats(A, config.bsr_block)
        bytes_per_brow = st["slots"] * R * 128 * (itemsize + 4 / (R * 128))
        band_rows = max(int(budget // max(bytes_per_brow, 1)), 1) * R
    elif kind == "ell":
        L = max(int(A.row_nnz.max()), 1)
        band_rows = max(int(budget // max(L * (itemsize + 4), 1)), 8)
        band_rows = (band_rows // 8) * 8
    else:
        slot_bytes = (itemsize + 12) if kind == "wcoo" else (itemsize + 8)
        bytes_per_row = max(nnz_per_row, 0.1) * slot_bytes * 1.4
        band_rows = max(int(budget // max(bytes_per_row, 1)), 128)
        band_rows = (band_rows // 128) * 128
    band_rows = min(_round_up(band_rows, 128), shard_rows)
    n_bands = -(-shard_rows // band_rows)

    # local CSRs for every (shard, band) cell, all (band_rows, n)
    subs = []     # [shard][band]
    offsets = np.zeros((n_bands, n_shards), dtype=np.int32)
    for s in range(n_shards):
        row = []
        for b in range(n_bands):
            g0 = int(bounds[s]) + b * band_rows
            g1 = min(g0 + band_rows, int(bounds[s + 1]))
            g0c = min(g0, g1)
            lo, hi = int(A.row_ptr[g0c]), int(A.row_ptr[g1])
            rp = np.concatenate([A.row_ptr[g0c:g1 + 1] - lo,
                                 np.full(band_rows - (g1 - g0c), hi - lo,
                                         dtype=A.row_ptr.dtype)])
            row.append(CsrMatrix(rp, A.col_idx[lo:hi], A.values[lo:hi],
                                 (band_rows, n)))
            offsets[b, s] = min(g0, max(m - 1, 0))
        subs.append(row)

    kind, dim = probe_band_dims([sub for row in subs for sub in row], kind,
                                A.nnz, config)
    shards = tuple(
        HostResidentPlan(
            [build_band_plan(sub, kind, dim, band_rows, n, A.nnz, dtype,
                             config, device="cpu") for sub in subs[s]],
            band_rows, (n_bands * band_rows, n), A.nnz, kind).placed(device)
        if rank is None or s == rank else None
        for s in range(n_shards))
    return HostResidentShards(shards=shards, offsets=offsets,
                              band_rows=band_rows, n_shards=n_shards,
                              shape=A.shape, nnz=A.nnz, kind=kind)


def _check(hs: HostResidentShards, mesh: Mesh, rows: int) -> None:
    require(hs.n_shards == mesh.size, PartitionError,
            f"shards built for {hs.n_shards}, mesh has {mesh.size}")
    require(rows == hs.shape[1], ShapeError,
            f"A width {hs.shape[1]} != operand height {rows}")


def _summed(hs: HostResidentShards, mesh: Mesh, tuning: bool, partial,
            product) -> torch.Tensor:
    """Add the rank's band products into `partial` (full height plus one
    band) at their global rows, then sum rows [0, m) over the mesh."""
    shard = hs.local(mesh.rank)
    if tuning:
        shard.apply_gpu_tuning()
    offs, br = hs.offsets[:, mesh.rank], hs.band_rows

    def compute(b: int, band) -> None:
        o = int(offs[b])
        partial[o:o + br] += product(band)

    each_band(shard, compute)
    return all_reduce(partial[:hs.shape[0]], mesh)


def spmv_um_dist(hs: HostResidentShards, x, alpha, beta, y, mesh: Mesh,
                 tuning: bool = False) -> torch.Tensor:
    """y' = beta*y + alpha*A@x, A host-resident and nnz-sharded over
    `mesh` (reference sblas_spmv_csr_v1 over managed memory,
    spmv_um.h:35-139).  Every rank returns the whole y'."""
    _check(hs, mesh, x.shape[0])
    partial = torch.zeros(hs.shape[0] + hs.band_rows,
                          dtype=sum_dtype(x.dtype), device=x.device)
    ax = _summed(hs, mesh, tuning, partial,
                 lambda band: spmv(band, x))
    return fold(alpha, ax, beta, y, hs.local(mesh.rank).dtype)


def spmm_um_dist(hs: HostResidentShards, B, alpha, beta, C, mesh: Mesh,
                 tuning: bool = False) -> torch.Tensor:
    """C' = beta*C + alpha*A@B, A host-resident and nnz-sharded over
    `mesh` (reference sblas_spmm_csr_v2 over managed memory,
    spmm_um.h:163-284).  Every rank returns the whole C'."""
    _check(hs, mesh, B.shape[0])
    partial = torch.zeros((hs.shape[0] + hs.band_rows, B.shape[1]),
                          dtype=sum_dtype(B.dtype), device=B.device)
    ab = _summed(hs, mesh, tuning, partial,
                 lambda band: spmm(band, B))
    return fold(alpha, ab, beta, C, hs.local(mesh.rank).dtype)


def spmm_um_mode1(hp: HostResidentPlan, B, alpha, beta, C, mesh: Mesh,
                  tuning: bool = False) -> torch.Tensor:
    """C' = beta*C + alpha*A@B with A host-resident and streamed whole on
    every rank, B and C split by columns (the v1 strategy, spmm.h:83-161,
    no collective): the rank's column block of C'.  K is zero-padded to a
    multiple of the rank count."""
    require(B.shape[0] == hp.shape[1], ShapeError,
            f"A width {hp.shape[1]} != B height {B.shape[0]}")
    k = B.shape[1]
    kb = -(-k // mesh.size)
    cols = slice(mesh.rank * kb, (mesh.rank + 1) * kb)
    B_blk = F.pad(B, (0, kb * mesh.size - k))[:, cols].contiguous()
    C_blk = F.pad(C, (0, kb * mesh.size - k))[:, cols]
    out = spmm_um(hp, B_blk, alpha, beta, C_blk, tuning=tuning)
    return out[:, : max(min(kb, k - mesh.rank * kb), 0)]
