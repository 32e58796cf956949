"""Two-tier distributed mode 2 over (slice, chip) groups.

Port of `sblas_tpu/parallel/hier.py`.  A deployment with two interconnect
tiers (on GPUs: NVLink within a host, the network across hosts) reduces
in two steps so the slow tier carries 1/c of the result:

    partial C (full height, per rank)
      -> reduce-scatter within the chip group   (fast tier)
      -> all-reduce across the slice group      (slow tier)

The result is row-blocked over the chips and the same in every slice.
Rank i sits at (slice i // c, chip i % c), as in the JAX package, so the
shards come from the same `partition_row_plans(A, s*c)` as the flat
planned modes, and shard i runs on rank i.  Every row has one owner, so
both tiers sum bf16 partials exactly, as the flat planned modes do.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..ops.plans import fold
from ..utils.errors import PartitionError, ShapeError, require
from .mesh import Mesh, all_reduce, reduce_scatter
from .modes import own_rows, row_block
from .planned import (RowPlanShards, _local_spmm, _local_spmv, _round_up,
                      full_height)


@dataclasses.dataclass(frozen=True)
class Mesh2:
    """A rank's two groups: `chips`, the c ranks of its slice (rank = chip
    index), and `slices`, the s ranks with its chip index (rank = slice
    index); `rank` is the global rank, which is also its shard."""

    slices: Mesh
    chips: Mesh
    rank: int


def make_mesh2(n_slices: int, chips_per_slice: int, *, device) -> Mesh2:
    """(n_slices, chips_per_slice) groups over the world, which must hold
    n_slices * chips_per_slice ranks.  Every rank creates every group, in
    the same order, as `dist.new_group` requires.  The groups live until
    the process group is destroyed (on NCCL each holds a communicator and
    its device memory), so build a Mesh2 once per process and reuse it."""
    require(dist.is_initialized(), PartitionError,
            "no process group: call init_distributed first")
    s, c = n_slices, chips_per_slice
    world = dist.get_world_size()
    require(s * c == world, PartitionError,
            f"requested {s * c} devices ({s}x{c}), the process group has "
            f"{world} ranks")
    chip_groups = [dist.new_group([i * c + j for j in range(c)])
                   for i in range(s)]
    slice_groups = [dist.new_group([i * c + j for i in range(s)])
                    for j in range(c)]
    rank = dist.get_rank()
    device = torch.device(device)
    return Mesh2(
        slices=Mesh(slice_groups[rank % c], rank // c, s, device),
        chips=Mesh(chip_groups[rank // c], rank % c, c, device),
        rank=rank)


def _hier_finish(shards: RowPlanShards, local, alpha, beta, Y,
                 mesh2: Mesh2):
    s, c = mesh2.slices.size, mesh2.chips.size
    m = shards.shape[0]
    m_full = _round_up(m + shards.band_rows, s * c * 128)
    partial = full_height(local, shards.row_offsets[mesh2.rank], m_full)
    # tier 1: reduce-scatter the slice's partial over its chips
    mine = reduce_scatter(partial, mesh2.chips)            # (m_full/c, ...)
    # tier 2: sum the chip's row band across slices
    mine = all_reduce(mine, mesh2.slices)
    out = fold(alpha, mine, beta, row_block(Y, mesh2.chips, m_full),
               local.dtype)
    return own_rows(out, mesh2.chips, m)


def _check(shards: RowPlanShards, mesh2: Mesh2, width: int, what: str):
    s, c = mesh2.slices.size, mesh2.chips.size
    require(shards.n_shards == s * c, PartitionError,
            f"shards built for {shards.n_shards} devices, mesh is {s}x{c}")
    require(width == shards.shape[1], ShapeError,
            f"A width {shards.shape[1]} != {what} {width}")


def spmm_mode2_hier(shards: RowPlanShards, B, alpha, beta, C,
                    mesh2: Mesh2) -> torch.Tensor:
    """Two-tier mode 2 (partition sparse A): reduce-scatter within the
    slice, all-reduce across slices.  Returns the rank's row block of C'
    (block `mesh2.chips.rank`; `sync_to_host(out, mesh2.chips, 0)`
    assembles it)."""
    _check(shards, mesh2, B.shape[0], "B height")
    local = _local_spmm(shards.kind, shards.local(mesh2.rank), B)
    return _hier_finish(shards, local, alpha, beta, C, mesh2)


def spmv_dist_hier(shards: RowPlanShards, x, alpha, beta, y,
                   mesh2: Mesh2) -> torch.Tensor:
    """Two-tier distributed SpMV (partition sparse A); see
    spmm_mode2_hier."""
    _check(shards, mesh2, x.shape[0], "x length")
    local = _local_spmv(shards.kind, shards.local(mesh2.rank), x)
    return _hier_finish(shards, local, alpha, beta, y, mesh2)
