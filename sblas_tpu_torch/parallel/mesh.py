"""Process groups, the `Mesh` record, collectives and operand placement.

Port of `sblas_tpu/parallel/mesh.py`.  The JAX package runs one
controller: a `shard_map` over a `jax.sharding.Mesh`, with operands
stacked along a shard axis.  The port runs one process per rank, as
`torchrun` launches them, over `torch.distributed` (NCCL for CUDA
tensors, gloo for CPU tensors).  Every public function of the
distribution layer runs on every rank; a `Mesh` names the rank's group,
its rank and size in that group, and its device.  JAX's collectives map
as

    lax.psum                    -> dist.all_reduce        (`all_reduce`)
    lax.psum_scatter(tiled)     -> dist.reduce_scatter_tensor
                                                          (`reduce_scatter`)
    the lax.ppermute ring       -> dist.batch_isend_irecv (`ring_exchange`)
    lax.all_to_all(split_axis=0, concat_axis=0)
                                -> dist.all_to_all_single (`all_to_all`)

A `Mesh` with `group=None` runs no collective: it serves the per-rank
compute (the `*_nocomm` twins) for any rank of any size, with or without
a process group.  `vma_check_ok` (a `shard_map` typing switch) has no
counterpart.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..containers import SharePolicy
from ..utils import trace
from ..utils.errors import PartitionError, require


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a group: `rank` of `size` in `group` (None: no
    collective may run), computing on `device`."""

    group: Optional[object]
    rank: int
    size: int
    device: torch.device


def init_distributed(**kwargs) -> None:
    """Process-group bootstrap (`dist.init_process_group(**kwargs)`).

    Idempotent when a group is already up; every other failure (an
    unreachable address, a bad rank, a missing environment) re-raises.  A
    swallowed bootstrap error would turn a multi-rank launch into a
    silent single-rank run whose results look valid."""
    if dist.is_initialized():
        return
    dist.init_process_group(**kwargs)


def make_mesh(n_devices: Optional[int] = None, *, device) -> Mesh:
    """The world group as a `Mesh` on `device`.  `n_devices` (default: the
    world size) must equal the world size: each rank is one device."""
    require(dist.is_initialized(), PartitionError,
            "no process group: call init_distributed first")
    world = dist.get_world_size()
    n = n_devices or world
    require(n == world, PartitionError,
            f"requested {n} devices, the process group has {world} ranks")
    return Mesh(group=dist.group.WORLD, rank=dist.get_rank(), size=world,
                device=torch.device(device))


def _group_of(mesh: Mesh):
    require(mesh.group is not None, PartitionError,
            f"mesh of rank {mesh.rank}/{mesh.size} has no process group: "
            f"collectives need make_mesh")
    return mesh.group


def _count_bytes(t: torch.Tensor) -> int:
    """Add the bytes of `t`, a collective's input, to counter
    `collective_bytes`; returns them."""
    n = t.numel() * t.element_size()
    trace.count("collective_bytes", n)
    return n


def all_reduce(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum of `t` over the mesh, in place (lax.psum)."""
    group = _group_of(mesh)
    with trace.span("sblas.dist.all_reduce", bytes=_count_bytes(t)):
        dist.all_reduce(t, group=group)
    return t


def reduce_scatter(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Block `mesh.rank` of the sum of `t` over the mesh, blocks taken
    along dim 0 (lax.psum_scatter(..., scatter_dimension=0, tiled=True));
    dim 0 must divide by the mesh size."""
    group = _group_of(mesh)
    require(t.shape[0] % mesh.size == 0, PartitionError,
            f"reduce_scatter of {t.shape[0]} rows over {mesh.size} ranks")
    out = t.new_empty((t.shape[0] // mesh.size, *t.shape[1:]))
    # reduce_scatter_tensor exists in every torch the port runs on; newer
    # ones name reduce_scatter_single instead and warn (FutureWarning)
    with warnings.catch_warnings(), \
            trace.span("sblas.dist.reduce_scatter",
                       bytes=_count_bytes(t)):
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, t.contiguous(), group=group)
    return out


def ring_exchange(blk: torch.Tensor, mesh: Mesh):
    """(from_left, from_right): the blocks of ranks rank-1 and rank+1 (mod
    size), as the JAX package's two ring `ppermute`s deliver them.

    At size 1 both are the rank's own block (a self-send fails on gloo);
    at size 2 both neighbours are one rank, and the two messages pair in
    the order they are posted (and by tag where the backend has tags)."""
    n = mesh.size
    if n == 1:
        return blk, blk
    group = _group_of(mesh)
    blk = blk.contiguous()
    left = dist.get_global_rank(group, (mesh.rank - 1) % n)
    right = dist.get_global_rank(group, (mesh.rank + 1) % n)
    from_left, from_right = torch.empty_like(blk), torch.empty_like(blk)
    ops = [dist.P2POp(dist.isend, blk, peer=right, group=group, tag=0),
           dist.P2POp(dist.isend, blk, peer=left, group=group, tag=1),
           dist.P2POp(dist.irecv, from_left, peer=left, group=group, tag=0),
           dist.P2POp(dist.irecv, from_right, peer=right, group=group,
                      tag=1)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return from_left, from_right


def all_to_all(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Block j of `t` along dim 0 goes to rank j; block i of the result
    came from rank i (lax.all_to_all(split_axis=0, concat_axis=0)).  dim 0
    must divide by the mesh size; the identity at size 1."""
    group = _group_of(mesh)
    if mesh.size == 1:
        return t
    require(t.shape[0] % mesh.size == 0, PartitionError,
            f"all_to_all of {t.shape[0]} rows over {mesh.size} ranks")
    t = t.contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    return out


def _as_tensor(arr, device) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):
        return arr.to(device)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def replicate(arr, mesh: Mesh) -> torch.Tensor:
    """The whole array on the rank's device (GpuSharePolicy::replicate,
    matrix.h:341-356)."""
    return _as_tensor(arr, mesh.device)


def shard_along(arr, mesh: Mesh, dim: int) -> torch.Tensor:
    """The rank's block of `arr` split evenly along `dim`
    (GpuSharePolicy::segment for dense operands, matrix.h:554-568)."""
    t = _as_tensor(arr, mesh.device)
    require(t.shape[dim] % mesh.size == 0, PartitionError,
            f"dim {dim} size {t.shape[dim]} not divisible by {mesh.size} "
            f"shards; pad first (pad_to_shards)")
    blk = t.shape[dim] // mesh.size
    return t.narrow(dim, mesh.rank * blk, blk)


def place_dense(arr, mesh: Mesh, policy: SharePolicy,
                segment_dim: int = 0) -> torch.Tensor:
    """Policy-driven placement of a dense operand (the `sync2gpu` analog):
    SEGMENT takes the rank's block of `segment_dim`; REPLICATE and NONE
    the whole array."""
    if policy is SharePolicy.SEGMENT:
        return shard_along(arr, mesh, segment_dim)
    return replicate(arr, mesh)


def pad_to_shards(arr: np.ndarray, n_shards: int, dim: int,
                  multiple_of: int = 1) -> np.ndarray:
    """Zero-pad `dim` so it divides evenly into `n_shards` blocks (each a
    multiple of `multiple_of`).  The reference instead allows ragged last
    shards (matrix.h:563-567)."""
    size = arr.shape[dim]
    block = -(-(-(-size // n_shards)) // multiple_of) * multiple_of
    target = block * n_shards
    pad = [(0, 0)] * arr.ndim
    pad[dim] = (0, target - size)
    return np.pad(arr, pad) if target != size else arr


def sync_to_host(part: torch.Tensor, mesh: Optional[Mesh] = None,
                 dim: Optional[int] = None) -> np.ndarray:
    """The whole result as host numpy (the `sync2cpu` analog,
    matrix.h:595-612), on every rank.

    `dim=None`: `part` is already whole (a replicated result).  Otherwise
    `part` is the rank's block along `dim` and the blocks, in rank order
    and of any lengths (the last ones are cut at the matrix edge), are
    all-gathered over `mesh`.  numpy has no bfloat16: a bf16 result comes
    back as float32, exactly."""
    if dim is None or mesh.size == 1:
        return _host_numpy(part.detach())
    group = _group_of(mesh)
    moved = part.detach().movedim(dim, 0).contiguous()
    n_local = torch.tensor([moved.shape[0]], dtype=torch.int64,
                           device=moved.device)
    sizes = [torch.empty_like(n_local) for _ in range(mesh.size)]
    dist.all_gather(sizes, n_local, group=group)
    sizes = [int(s) for s in sizes]
    longest = max(sizes)
    padded = moved.new_zeros((longest, *moved.shape[1:]))
    padded[: moved.shape[0]] = moved
    blocks = [torch.empty_like(padded) for _ in range(mesh.size)]
    dist.all_gather(blocks, padded, group=group)
    whole = torch.cat([b[:s] for b, s in zip(blocks, sizes)])
    return _host_numpy(whole.movedim(0, dim))


def _host_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
