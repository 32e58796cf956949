"""Distribution layer: process groups, placement, distributed op modes.

Port of `sblas_tpu/parallel/`: the reference's multi-GPU machinery
(OpenMP thread-per-GPU + NCCL collectives inside the ops,
spmm.h:101-189), rebuilt by the JAX package as `shard_map` programs and
here as one process per rank over `torch.distributed`, including the
footprint-compressed x exchange (`xfoot`)."""

from .mesh import (Mesh, all_to_all, init_distributed,  # noqa: F401
                   make_mesh, pad_to_shards, place_dense, replicate,
                   shard_along, sync_to_host)
from .modes import (spmm_mode1, spmm_mode2, spmm_mode2_nocomm,  # noqa: F401
                    spmv_dist, spmv_dist_nocomm, spmv_halo)
from .planned import (HaloDiaShards, RowPlanShards, partition_halo_dia,  # noqa: F401
                      partition_row_plans, spmm_halo_planned,
                      spmm_mode2_planned, spmm_mode2_planned_nocomm,
                      spmv_dist_planned, spmv_dist_planned_nocomm,
                      spmv_halo_planned)
from .hier import (Mesh2, make_mesh2, spmm_mode2_hier,  # noqa: F401
                   spmv_dist_hier)
from .xfoot import (XFootPlan, XFootShards, XFootStats,  # noqa: F401
                    partition_xfoot, spmv_xfoot, spmv_xfoot_block,
                    spmv_xfoot_nocomm, xfoot_stats, xfoot_worst_local)
