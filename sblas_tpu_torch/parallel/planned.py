"""Distributed modes over per-shard fast plans.

Port of `sblas_tpu/parallel/planned.py`.  The baseline modes (`modes.py`)
run the tier-0 COO segment sum per rank.  Here each shard gets the fast
single-device layouts (BELL, ELL, DIA, routed, windowed COO), built with
one common set of static dimensions, as the JAX package builds them to
stack them for one `shard_map` program:

* `partition_row_plans`: nnz-balanced row-granular split (whole rows move
  to shards), then one plan per shard padded to shared dims.  Shard s's
  arrays equal the JAX package's stacked `plan.<field>[s]`; each rank
  moves only its own shard to its device (`rank=`).
* `spmm_mode2_planned` / `spmv_dist_planned`: mode 2 with per-shard
  plans and `psum` / `psum_scatter` of the partial.  The routed SpMV of a
  shard runs kernel K2' (`spmv_routed(..., pregather=True)`), as the JAX
  package runs its pre-gathered kernel inside `shard_map`.
* `spmv_halo_planned` / `spmm_halo_planned`: the halo exchange with a
  per-shard DIA plan over the [left | own | right] window.

Operands and results follow `modes.py`: global operands in, the rank's
part out.  Shards take float32, float64 or bfloat16 values; a bf16 shard
runs the bf16 variants of the kernels (K2' and K1 for routed shards, K3
for windowed-COO ones).  Each row lies in one shard, so a bf16 partial
holds one shard's product beside zeros and its bf16 collective is exact,
as the JAX package's bf16 psum is; the epilogue then rounds once
(`plans.fold`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import DEFAULT, SBlasConfig
from ..containers import CsrMatrix
from ..ops import spmm, spmv
from ..ops.bsr import BsrPlan, bell_arrays, bell_stats
from ..ops.dia import DiaPlan, dia_arrays
from ..ops.plans import EllPlan, ell_arrays, fold, host_value_dtype
from ..ops.rspmv import spmv_routed
from ..partition import partition_row_blocks
from ..utils import trace
from ..utils.errors import PartitionError, ShapeError, require
from .mesh import Mesh, all_reduce, reduce_scatter, ring_exchange
from .modes import own_rows, row_block


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _placed(plans, device, rank: Optional[int]):
    """The shard plans on `device`, or only shard `rank` (None elsewhere)."""
    with trace.span("sblas.plan.place", device=device):
        return tuple(p.to(device) if rank is None or s == rank else None
                     for s, p in enumerate(plans))


def _local(plans, rank: int):
    plan = plans[rank]
    require(plan is not None, PartitionError,
            f"shard {rank} is not on this rank: build the shards with "
            f"rank={rank} (or rank=None for all)")
    return plan


@dataclasses.dataclass(frozen=True)
class RowPlanShards:
    """Per-shard plans with identical static dims: `plans[s]` is shard s's
    plan of local shape (band_rows, n), or None where this rank does not
    hold it; `row_offsets[s]` is shard s's first global row."""

    plans: Tuple
    row_offsets: Tuple[int, ...]
    shape: Tuple[int, int]
    nnz: int
    n_shards: int
    band_rows: int
    kind: str

    def local(self, rank: int):
        return _local(self.plans, rank)


def _row_boundaries(A: CsrMatrix, n_shards: int) -> np.ndarray:
    """Row-granular nnz-balanced boundaries (n_shards+1,)."""
    targets = (np.arange(1, n_shards) * (A.nnz / n_shards)).astype(np.int64)
    cuts = np.searchsorted(A.row_ptr[1:-1], targets, side="left") + 1 \
        if A.height > 1 else np.zeros(n_shards - 1, np.int64)
    cuts = np.clip(cuts, 0, A.height)
    return np.concatenate([[0], np.sort(cuts), [A.height]]).astype(np.int64)


def _local_csr(A: CsrMatrix, r0: int, r1: int, band_rows: int,
               col_shift: int = 0, width: int = None) -> CsrMatrix:
    """Rows [r0, r1) of A as a (band_rows, width) matrix, columns shifted."""
    lo, hi = int(A.row_ptr[r0]), int(A.row_ptr[r1])
    rp = np.concatenate([A.row_ptr[r0:r1 + 1] - lo,
                         np.full(band_rows - (r1 - r0), hi - lo,
                                 dtype=A.row_ptr.dtype)])
    return CsrMatrix(rp, A.col_idx[lo:hi] + col_shift, A.values[lo:hi],
                     (band_rows, width if width is not None else A.shape[1]))


def _union_offsets(subs):
    """Sorted union of occupied diagonals over shard submatrices (shards
    share one offset list)."""
    from ..ops.dia import dia_stats
    offs = {int(o) for sub in subs for o in dia_stats(sub)["offsets"]}
    return sorted(offs or {0})


def pick_shard_kind(A: CsrMatrix, op: str = None,
                    config: SBlasConfig = DEFAULT) -> str:
    """Plan-kind heuristic of the shard partitioners: BELL when the global
    structure is block-friendly, ELL when row occupancy is balanced,
    routed for large unstructured matrices when `op="spmv"` (RoutedPlan is
    SpMV-only), windowed-COO otherwise."""
    from ..ops.rspmv import RoutedPlan
    if (bell_stats(A, config.bsr_block)["blowup"]
            <= config.bsr_blowup_limit):
        return "bsr"
    if EllPlan.is_profitable(A, config):
        return "ell"
    if op == "spmv" and RoutedPlan.is_profitable(A, config):
        return "routed"
    return "wcoo"


def shared_routed_sizes(sizes):
    """Element-wise maxima of per-shard `routed_shard_sizes` probes,
    with the stack depth CORRECTED for the shared overflow appendix:
    padding a shard's appendix up to the shared slot count adds
    depth-1 pad blocks, so a shard whose natural stack was the deepest
    but whose appendix was small can exceed the naive max-S probe
    (observed: 513 vs 512 rows -> stacked-plan shape divergence)."""
    tg = max(z[0] for z in sizes)
    pr = max(z[2] for z in sizes)
    sk = max(z[3] for z in sizes)
    sk_blocks = _round_up(sk, 128) // 128 if sk else 0
    sr = max(z[1] + (sk_blocks - (_round_up(z[3], 128) // 128
                                  if z[3] else 0))
             for z in sizes)
    return tg, sr, pr, sk


def build_stacked_plans(locals_, kind: str, band_rows: int, width: int,
                        nnz: int, dtype, config: SBlasConfig):
    """Per-shard fast plans over identically-shaped (band_rows, width)
    local CSR matrices, padded to one common set of static dims, on the
    CPU.  Returns (plans, kind): the JAX package stacks the plans for one
    `shard_map` program; here they stay one per shard.  `kind` may
    degrade (wcoo -> coo) when tile-splitting blows up."""
    np_val = host_value_dtype(dtype)
    if kind == "routed":
        # shared static sizes make every static field — and hence the
        # route-layer schedules — equal across shards
        from ..ops.rspmv import RoutedPlan, routed_shard_sizes
        sizes = [routed_shard_sizes(sub, config) for sub in locals_]
        tg, sr, pr, sk = shared_routed_sizes(sizes)
        plans = [dataclasses.replace(
            RoutedPlan.from_csr(sub, dtype=dtype, config=config,
                                min_gtiles=tg, min_srows=sr, min_prows=pr,
                                min_sranks=sk, device="cpu"),
            nnz=nnz)
            for sub in locals_]
        require(len({p.schedule for p in plans}) == 1
                and len({p.unrank_schedule for p in plans}) == 1
                and len({p.xroute_schedule for p in plans}) == 1,
                PartitionError, "routed shard schedules diverged despite "
                "shared static sizes (planner bug)")
        return plans, kind
    if kind == "bsr":
        raw = [bell_arrays(sub, config.bsr_block) for sub in locals_]
        L = max(v.shape[1] for v, _ in raw)
        plans = []
        for vals, bcol in raw:
            vals = np.pad(vals, ((0, 0), (0, L - vals.shape[1]),
                                 (0, 0), (0, 0)))
            bcol = np.pad(bcol, ((0, 0), (0, L - bcol.shape[1])))
            plans.append(BsrPlan.from_numpy(
                dict(vals=vals.astype(np_val), bcol=bcol.astype(np.int32)),
                dict(shape=(band_rows, width), nnz=nnz,
                     block=tuple(config.bsr_block)), "cpu", dtype=dtype))
    elif kind == "ell":
        raw = [ell_arrays(sub) for sub in locals_]
        L = max(c.shape[1] for c, _ in raw)
        plans = []
        for cols, vals in raw:
            cols = np.pad(cols, ((0, 0), (0, L - cols.shape[1])))
            vals = np.pad(vals, ((0, 0), (0, L - vals.shape[1])))
            plans.append(EllPlan.from_numpy(
                dict(cols=cols.astype(np.int32), vals=vals.astype(np_val)),
                dict(shape=(band_rows, width), nnz=nnz), "cpu", dtype=dtype))
    elif kind == "dia":
        offs = _union_offsets(locals_)
        plans = []
        for sub in locals_:
            vals, offs_t = dia_arrays(sub, offsets=offs, n_rows=band_rows)
            plans.append(DiaPlan.from_numpy(
                dict(vals=vals.astype(np_val)),
                dict(offsets=offs_t, shape=(band_rows, width), nnz=nnz),
                "cpu", dtype=dtype))
    elif kind in ("wcoo", "coo"):
        # per-shard windowed-COO (the unstructured workhorse) or plain COO
        # segments, built by the band-plan machinery (shared static dims;
        # wcoo falls back to coo when tile-splitting blows up)
        from ..memory.host import build_band_plan, probe_band_dims
        kind, dim = probe_band_dims(locals_, kind, nnz, config)
        plans = [build_band_plan(sub, kind, dim, band_rows, width, nnz,
                                 dtype, config, device="cpu")
                 for sub in locals_]
    else:
        raise PartitionError(f"unknown plan kind {kind!r}")
    return plans, kind


def partition_row_plans(A: CsrMatrix, n_shards: int, dtype=torch.float32,
                        kind: str = None, op: str = None,
                        config: SBlasConfig = DEFAULT, *, device,
                        rank: Optional[int] = None) -> RowPlanShards:
    """nnz-balanced row-granular shards, each laid out as a fast plan.

    `kind` in {"bsr", "ell", "dia", "routed", "wcoo", "coo", None}; None
    picks by `pick_shard_kind`.  Every shard is built on the host (the
    common dims need them all); `rank` places only that shard on
    `device`, None places every shard there."""
    require(n_shards >= 1, PartitionError, f"bad n_shards {n_shards}")
    with trace.span("sblas.plan", op=op, dtype=dtype,
                    shards=n_shards) as sp:
        bounds = _row_boundaries(A, n_shards)
        band_rows = _round_up(int(np.max(bounds[1:] - bounds[:-1])) or 1,
                              128)
        if kind is None:
            with trace.span("sblas.plan.choose"):
                kind = pick_shard_kind(A, op, config)
        locals_ = [_local_csr(A, int(bounds[s]), int(bounds[s + 1]),
                              band_rows)
                   for s in range(n_shards)]
        plans, kind = build_stacked_plans(locals_, kind, band_rows,
                                          A.shape[1], A.nnz, dtype, config)
        sp.set(kind=kind)
        return RowPlanShards(
            plans=_placed(plans, device, rank),
            row_offsets=tuple(int(b) for b in bounds[:-1]),
            shape=A.shape, nnz=A.nnz, n_shards=n_shards,
            band_rows=band_rows, kind=kind)


def _local_spmm(kind, plan, B):
    """The shard's (band_rows, K) product A_s @ B: `ops.spmm` as this
    module imported it (a later replacement of `ops.spmm` does not reach
    here), which picks the function by the plan's type."""
    return spmm(plan, B)


def _local_spmv(kind, plan, x):
    """The shard's product A_s @ x: a routed shard through kernel K2'
    (`pregather`, the JAX package's per-shard kernel), every other kind
    through `ops.spmv`."""
    if kind == "routed":
        return spmv_routed(plan, x, 1.0, 0.0,
                           torch.zeros(plan.shape[0], dtype=plan.dtype,
                                       device=x.device), pregather=True)
    return spmv(plan, x)


def full_height(local, offset: int, m_full: int) -> torch.Tensor:
    """The shard's local rows placed at `offset` of an m_full-row zero
    partial (the JAX package's dynamic_update_slice)."""
    partial = local.new_zeros((m_full, *local.shape[1:]))
    partial[offset: offset + local.shape[0]] = local
    return partial


def _planned_finish(shards, local, alpha, beta, Y, mesh, reduce):
    m = shards.shape[0]
    m_full = _round_up(m + shards.band_rows, mesh.size * 128)
    with trace.span("sblas.mode2.partial"):
        partial = full_height(local, shards.row_offsets[mesh.rank], m_full)
    if reduce == "psum":
        summed = all_reduce(partial, mesh)[:m]
        with trace.span("sblas.mode2.fold"):
            return fold(alpha, summed, beta, Y, local.dtype)
    mine = reduce_scatter(partial, mesh)
    with trace.span("sblas.mode2.fold"):
        return own_rows(fold(alpha, mine, beta, row_block(Y, mesh, m_full),
                             local.dtype), mesh, m)


def _check_planned(shards, mesh, reduce, width, what):
    require(reduce in ("psum", "psum_scatter"), PartitionError,
            f"bad reduce {reduce!r}")
    require(shards.n_shards == mesh.size, PartitionError,
            f"shards built for {shards.n_shards}, mesh has {mesh.size}")
    require(width == shards.shape[1], ShapeError,
            f"A width {shards.shape[1]} != {what} {width}")


def spmm_mode2_planned(shards: RowPlanShards, B, alpha, beta, C, mesh: Mesh,
                       reduce: str = "psum") -> torch.Tensor:
    """Mode 2 (partition sparse A) with per-shard fast plans; the same
    collective contract as `modes.spmm_mode2`."""
    require(shards.kind != "routed", PartitionError,
            "routed shards are SpMV-only (RoutedPlan has no K-wide analog);"
            " build SpMM shards with partition_row_plans(kind=...) in "
            "{'bsr','ell','dia','coo'}")
    _check_planned(shards, mesh, reduce, B.shape[0], "B height")
    with trace.span("sblas.mode2", op="spmm", reduce=reduce):
        with trace.span("sblas.mode2.local"):
            local = spmm_mode2_planned_nocomm(shards, B, mesh)
        return _planned_finish(shards, local, alpha, beta, C, mesh, reduce)


def spmv_dist_planned(shards: RowPlanShards, x, alpha, beta, y, mesh: Mesh,
                      reduce: str = "psum") -> torch.Tensor:
    """Distributed SpMV (partition sparse A) with per-shard fast plans."""
    _check_planned(shards, mesh, reduce, x.shape[0], "x length")
    with trace.span("sblas.mode2", op="spmv", reduce=reduce):
        with trace.span("sblas.mode2.local"):
            local = spmv_dist_planned_nocomm(shards, x, mesh)
        return _planned_finish(shards, local, alpha, beta, y, mesh, reduce)


def spmm_mode2_planned_nocomm(shards: RowPlanShards, B, mesh: Mesh
                              ) -> torch.Tensor:
    """Diagnostic: the rank's (band_rows, k) local product without the
    collective (the comm/compute split of the CLIs)."""
    return _local_spmm(shards.kind, shards.local(mesh.rank), B)


def spmv_dist_planned_nocomm(shards: RowPlanShards, x, mesh: Mesh
                             ) -> torch.Tensor:
    """Diagnostic twin of `spmv_dist_planned` without the collective."""
    return _local_spmv(shards.kind, shards.local(mesh.rank), x)


# ---------------------------------------------------------------------------
# Halo exchange with per-shard DIA plans
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HaloDiaShards:
    """Per-shard DIA plans over the [left | own | right] window, local
    shape (rows_per_shard, 3*rows_per_shard); None where not held."""

    plans: Tuple
    shape: Tuple[int, int]
    nnz: int
    n_shards: int
    rows_per_shard: int

    def local(self, rank: int):
        return _local(self.plans, rank)


def partition_halo_dia(A: CsrMatrix, n_shards: int, dtype=torch.float32,
                       config: SBlasConfig = DEFAULT, *, device,
                       rank: Optional[int] = None) -> HaloDiaShards:
    """Row blocks whose local matrices are DIA plans in window coordinates
    (column shift r - s*r): the banded halo path runs shift-and-FMA.
    `rank` as in `partition_row_plans`."""
    blocks = partition_row_blocks(A, n_shards, dtype=dtype, config=config,
                                  device="cpu")
    r = blocks.rows_per_shard
    require(blocks.halo_left <= r and blocks.halo_right <= r, PartitionError,
            f"halo ({blocks.halo_left}/{blocks.halo_right}) exceeds one "
            f"block ({r})")
    m = A.shape[0]
    # per-shard local CSR in window coords: col_ext = col - (s*r - r)
    subs = []
    for s in range(n_shards):
        r0, r1 = min(s * r, m), min((s + 1) * r, m)
        subs.append(_local_csr(A, r0, r1, r, col_shift=r - s * r,
                               width=3 * r))
    offs = _union_offsets(subs)
    np_val = host_value_dtype(dtype)
    plans = []
    for sub in subs:
        vals, offs_t = dia_arrays(sub, offsets=offs, n_rows=r)
        plans.append(DiaPlan.from_numpy(
            dict(vals=vals.astype(np_val)),
            dict(offsets=offs_t, shape=(r, 3 * r), nnz=A.nnz), "cpu",
            dtype=dtype))
    return HaloDiaShards(plans=_placed(plans, device, rank), shape=A.shape,
                         nnz=A.nnz, n_shards=n_shards, rows_per_shard=r)


def _halo_window(shards: HaloDiaShards, X, mesh: Mesh):
    """(plan, the rank's X row block, the [left | own | right] window)."""
    require(shards.n_shards == mesh.size, PartitionError,
            f"shards built for {shards.n_shards}, mesh has {mesh.size}")
    m_pad = shards.rows_per_shard * mesh.size
    blk = row_block(X, mesh, m_pad)
    from_left, from_right = ring_exchange(blk, mesh)
    return shards.local(mesh.rank), torch.cat([from_left, blk, from_right])


def spmv_halo_planned(shards: HaloDiaShards, x, alpha, beta, y, mesh: Mesh
                      ) -> torch.Tensor:
    """Halo-exchange SpMV with per-shard DIA plans (banded multi-device):
    the rank's row block."""
    plan, x_ext = _halo_window(shards, x, mesh)
    m_pad = shards.rows_per_shard * mesh.size
    out = fold(alpha, spmv(plan, x_ext), beta, row_block(y, mesh, m_pad),
               plan.dtype)
    return own_rows(out, mesh, shards.shape[0])


def spmm_halo_planned(shards: HaloDiaShards, B, alpha, beta, C, mesh: Mesh
                      ) -> torch.Tensor:
    """Halo-exchange SpMM: B and C blocked by rows like A; each rank pulls
    only its neighbours' B row blocks over the ring (constant comm in n,
    against mode 2's full-C all-reduce).  Needs a square A.  Returns the
    rank's row block of C'."""
    require(shards.shape[0] == shards.shape[1], PartitionError,
            "halo SpMM needs square A (B rows follow A's row partition)")
    plan, B_ext = _halo_window(shards, B, mesh)
    m_pad = shards.rows_per_shard * mesh.size
    out = fold(alpha, spmm(plan, B_ext), beta, row_block(C, mesh, m_pad),
               plan.dtype)
    return own_rows(out, mesh, shards.shape[0])
