"""Memory-residency layer: host-resident operands streamed to the device
(the UM analog; see `host.py`)."""

from .dense import (HostDense, HostResidentGrid, host_resident_grid,  # noqa: F401
                    spmm_um_hostdense, spmv_um_hostdense)
from .dist import (HostResidentShards, host_resident_shards,  # noqa: F401
                   spmm_um_dist, spmm_um_mode1, spmv_um_dist)
from .host import (HostResidentPlan, host_resident_plan, spmm_um,  # noqa: F401
                   spmv_um)
