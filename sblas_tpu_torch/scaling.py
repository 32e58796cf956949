"""Scaling-efficiency model and harness.

Port of `sblas_tpu/scaling.py`.  The harness measures the single-device
time of a workload and projects its multi-device efficiency from an
analytic collective-cost model of ring algorithms, per distribution mode;
under a process group of more than one rank, `measured_multichip`
measures instead.  The model (bytes are per device, exposed):

* mode 1 (partition dense B): no collective, eff = 1;
* mode 2 + psum (all-reduce of the full result, the reference's
  semantics, spmm.h:260-262): 2 * S * (n-1)/n bytes, S = result bytes;
* mode 2 + psum_scatter (reduce-scatter): S * (n-1)/n bytes;
* halo (ring x exchange): 2 * halo_rows * itemsize bytes, constant in n;
* xfoot: the footprint's bytes (`XFootStats.comm_bytes`) plus the
  modeled extraction time.

    t_n = t_1 / n + bytes(n) / ici_bw
    eff(n) = t_1 / (n * t_n)

The parameter names follow the JAX package's so that both are called
alike; on NVIDIA cards they name these tiers:

* `ici_bw`: the link within one box, NVLink.  `ICI_BW_DEFAULT` is the
  NCCL all-reduce bus bandwidth measured on four H100s joined by NVLink
  (`tools/link_bw.py`).
* `dcn_bw`: the network between boxes.  It cannot be measured on one box;
  `DCN_BW_DEFAULT` is a model parameter, not a measurement.

`SBLAS_ICI_BW` / `SBLAS_DCN_BW` override them.  The device-side
data-movement constants of the xfoot planner are the H100's own as well:
`GATHER_NS`, the cost of one element of a flat gather, and `ROUTE_NS`, of
one element of padded route space of a routed permutation
(`ops/route.py`), measured by `chip_smoke.py`'s `[xfoot-extract]` phase
(rank 0's extraction of webbase-1M at 4 and 16 shards, each engine
forced; the mean of the two sizes' ns per element); `SBLAS_GATHER_NS` /
`SBLAS_ROUTE_NS` override them.  The JAX package's constants and its
`scaling_calib.json` were measured on a TPU and are never read here.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Tuple

# NCCL all-reduce bus bandwidth, bytes/s: the median over 16-256 MB f32
# buffers (242-338 GB/s) on four NVIDIA H100 80GB HBM3 at a 700.00 W
# power limit, joined by NVLink (tools/link_bw.py under torchrun, see
# PERF.md).
_H100_NVLINK_BUSBW = 3.063354e11
# Between boxes: one 400 Gb/s NDR InfiniBand port per GPU (a DGX H100's
# ConnectX-7 layout), 50 GB/s, derated 10 % for protocol overhead as the
# JAX package derates its links.  A model default, not measured.
_NDR_PORT_BW = 4.5e10
# Measured on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit
# (chip_smoke.py [xfoot-extract], see PERF.md): ns per element of
# `out_slots` for the flat gather, of route space for the routed one.
_H100_GATHER_NS = 0.05355
_H100_ROUTE_NS = 0.20419


_EXTRACT_SRC = "H100 default (chip_smoke.py [xfoot-extract])"


def _const(env: str, default: float, source: str = _EXTRACT_SRC):
    """(value, provenance): the environment variable over the default."""
    if env in os.environ:
        return float(os.environ[env]), f"env {env}"
    return default, source


ICI_BW_DEFAULT, ICI_BW_SRC = _const(
    "SBLAS_ICI_BW", _H100_NVLINK_BUSBW,
    "measured, 4x H100 NVLink, NCCL all-reduce busbw, tools/link_bw.py")
DCN_BW_DEFAULT, DCN_BW_SRC = _const(
    "SBLAS_DCN_BW", _NDR_PORT_BW,
    "model default, not measured: one 400 Gb/s NDR port per GPU, derated")
GATHER_NS, GATHER_NS_SRC = _const("SBLAS_GATHER_NS", _H100_GATHER_NS)
ROUTE_NS, ROUTE_NS_SRC = _const("SBLAS_ROUTE_NS", _H100_ROUTE_NS)


def param_provenance() -> str:
    """One line telling measured constants from model defaults."""
    return (f"ici_bw={ICI_BW_DEFAULT / 1e9:.0f} GB/s ({ICI_BW_SRC}), "
            f"dcn_bw={DCN_BW_DEFAULT / 1e9:.0f} GB/s ({DCN_BW_SRC}), "
            f"gather_ns={GATHER_NS:.4f} ({GATHER_NS_SRC}), "
            f"route_ns={ROUTE_NS:.4f} ({ROUTE_NS_SRC})")


def collective_bytes(mode: str, result_bytes: int, n: int,
                     halo_bytes: int = 0, xfoot_bytes: float = 0) -> float:
    """Exposed per-device collective bytes for one op invocation."""
    if n <= 1:
        return 0.0
    if mode == "mode1":
        return 0.0
    if mode == "mode2_psum":
        return 2.0 * result_bytes * (n - 1) / n
    if mode == "mode2_psum_scatter":
        return 1.0 * result_bytes * (n - 1) / n
    if mode == "halo":
        return 2.0 * halo_bytes
    if mode == "xfoot":
        # hot all-reduce + packet all_to_all, from the plan-time footprint
        # (parallel/xfoot.py::XFootStats.comm_bytes)
        return xfoot_bytes
    raise ValueError(f"unknown mode {mode!r}")


@dataclasses.dataclass(frozen=True)
class ModeProjection:
    mode: str
    n: int
    t1_ms: float
    t_n_ms: float
    comm_ms: float
    efficiency: float  # vs linear: t1 / (n * t_n)


def project(mode: str, t1_ms: float, result_bytes: int, n: int,
            halo_bytes: int = 0, ici_bw: float = ICI_BW_DEFAULT,
            xfoot_stats=None, itemsize: int = 4,
            shard_ms: float = None) -> ModeProjection:
    """One mode's n-device time and efficiency from a measured t1.

    `xfoot_stats` (parallel/xfoot.py::XFootStats) prices the xfoot mode:
    the footprint's collective bytes plus the extraction engine's modeled
    time.  `shard_ms` replaces the t1/n assumption by a measured
    per-shard compute time."""
    xf_bytes = (xfoot_stats.comm_bytes(itemsize)
                if xfoot_stats is not None else 0)
    comm_ms = collective_bytes(mode, result_bytes, n, halo_bytes,
                               xf_bytes) / ici_bw * 1e3
    if mode == "xfoot" and xfoot_stats is not None:
        comm_ms += xfoot_stats.extract_ns * 1e-6
    t_n = (shard_ms if shard_ms is not None else t1_ms / n) + comm_ms
    return ModeProjection(mode=mode, n=n, t1_ms=t1_ms, t_n_ms=t_n,
                          comm_ms=comm_ms,
                          efficiency=t1_ms / (n * t_n) if t_n else 1.0)


def best_mode(projections) -> ModeProjection:
    return max(projections, key=lambda p: p.efficiency)


def project_hier(t1_ms: float, result_bytes: int, n_slices: int,
                 chips_per_slice: int, ici_bw: float = ICI_BW_DEFAULT,
                 dcn_bw: float = DCN_BW_DEFAULT,
                 shard_ms: float = None) -> ModeProjection:
    """Two-tier mode-2 projection (parallel/hier.py): a reduce-scatter
    within the box moves S*(c-1)/c bytes per device over `ici_bw`; the
    all-reduce across boxes then carries only the 1/c row band,
    2*(S/c)*(s-1)/s bytes per device, over `dcn_bw`."""
    s, c = n_slices, chips_per_slice
    n = s * c
    ici_ms = (result_bytes * (c - 1) / c / ici_bw * 1e3) if c > 1 else 0.0
    dcn_ms = (2.0 * (result_bytes / max(c, 1)) * (s - 1) / s
              / dcn_bw * 1e3) if s > 1 else 0.0
    comm_ms = ici_ms + dcn_ms
    t_n = (shard_ms if shard_ms is not None else t1_ms / n) + comm_ms
    return ModeProjection(mode=f"hier_{s}x{c}", n=n, t1_ms=t1_ms,
                          t_n_ms=t_n, comm_ms=comm_ms,
                          efficiency=t1_ms / (n * t_n) if t_n else 1.0)


def project_flat_over_dcn(t1_ms: float, result_bytes: int, n_slices: int,
                          chips_per_slice: int,
                          dcn_bw: float = DCN_BW_DEFAULT) -> ModeProjection:
    """One flat reduce-scatter over all s*c devices when the ring crosses
    boxes: the whole collective runs at the network's rate."""
    n = n_slices * chips_per_slice
    comm_ms = result_bytes * (n - 1) / n / dcn_bw * 1e3 if n > 1 else 0.0
    t_n = t1_ms / n + comm_ms
    return ModeProjection(mode=f"flat_{n_slices}x{chips_per_slice}", n=n,
                          t1_ms=t1_ms, t_n_ms=t_n, comm_ms=comm_ms,
                          efficiency=t1_ms / (n * t_n) if t_n else 1.0)


def project_table(op: str, t1_ms: float, m: int, k: int, itemsize: int,
                  halo_rows: int = 0, chips: Tuple[int, ...] = (4, 16),
                  ici_bw: float = ICI_BW_DEFAULT, xfoot: dict = None,
                  xfoot_shard_ms: dict = None) -> dict:
    """{n: [ModeProjection, ...]} over every mode that applies to `op`.

    `xfoot` maps a device count to its XFootStats (prices the xfoot
    mode); `xfoot_shard_ms` maps a device count to a measured per-shard
    compute time, which then replaces t1/n for every mode-2-family
    projection at that count (they all run the same per-shard plans)."""
    result_bytes = m * max(k, 1) * itemsize
    halo_bytes = halo_rows * max(k, 1) * itemsize
    # mode 1 (partition dense B) exists for SpMM only: SpMV has no B
    # columns to split
    modes = (["mode1"] if op == "spmm" else []) \
        + ["mode2_psum", "mode2_psum_scatter"]
    if halo_rows:
        modes.append("halo")
    table = {}
    for n in chips:
        sh = (xfoot_shard_ms or {}).get(n)
        projs = [project(mo, t1_ms, result_bytes, n, halo_bytes, ici_bw,
                         shard_ms=(sh if mo.startswith("mode2") else None))
                 for mo in modes]
        if xfoot and n in xfoot:
            projs.append(project(
                "xfoot", t1_ms, result_bytes, n, halo_bytes, ici_bw,
                xfoot_stats=xfoot[n], itemsize=itemsize, shard_ms=sh))
        table[n] = projs
    return table


def report_lines(op: str, t1_ms: float, m: int, k: int, itemsize: int,
                 halo_rows: int = 0, chips: Tuple[int, ...] = (4, 16),
                 ici_bw: float = ICI_BW_DEFAULT, xfoot: dict = None,
                 xfoot_shard_ms: dict = None, table: dict = None):
    """Per-mode scaling lines for one workload (`project_table`'s
    projections; pass its `table` to project once for both these lines
    and the scorecard)."""
    result_bytes = m * max(k, 1) * itemsize
    if table is None:
        table = project_table(op, t1_ms, m, k, itemsize, halo_rows, chips,
                              ici_bw, xfoot, xfoot_shard_ms)
    lines = [f"# scaling[{op}] t1={t1_ms:.3f} ms, result "
             f"{result_bytes / 1e6:.1f} MB, ici_bw={ici_bw / 1e9:.0f} GB/s "
             f"(model)"]
    for n, projs in table.items():
        cells = ", ".join(
            f"{p.mode} {p.efficiency * 100:.0f}%"
            + (f" (comm {p.comm_ms:.3f} ms)" if p.comm_ms else "")
            for p in projs)
        ok = "meets" if best_mode(projs).efficiency >= 0.8 else "MISSES"
        lines.append(f"# scaling[{op}] n={n}: {cells} -> best "
                     f"{best_mode(projs).mode} "
                     f"{best_mode(projs).efficiency * 100:.0f}% "
                     f"({ok} 80% target)")
    return lines


def scorecard_lines(rows, target: float = 0.8):
    """The BASELINE scorecard block: one row per workload with its best
    mode, strong efficiency per device count, weak efficiency and a
    meets/MISSES verdict.

    `rows` is a list of (workload, table, weak, note): `table` a
    `project_table` result, `weak` None or (n_weak, eff_weak) from a
    measured weak-scaling run, `note` ("" for none) printed under the
    row."""
    chips = sorted({n for _, table, _, _ in rows for n in table})
    pct = "{:.0f}%".format
    header = (["# workload".ljust(26), "best".ljust(20)]
              + [f"strong n={n}".ljust(12) for n in chips]
              + ["weak".ljust(12), "verdict"])
    lines = [f"# ===== BASELINE scorecard (target >={target * 100:.0f}% "
             f"of linear, 1 card → {max(chips)} cards) =====",
             f"# params: {param_provenance()}",
             "".join(header)]
    for workload, table, weak, note in rows:
        bests = {n: best_mode(projs) for n, projs in table.items()}
        n_max = max(table)
        misses = [f"strong@{n}" for n in sorted(table)
                  if bests[n].efficiency < target]
        if weak is not None and weak[1] < target:
            misses.append("weak")
        verdict = "meets" if not misses else (
            "MISSES " + ",".join(misses)
            + ("; weak meets" if weak is not None and weak[1] >= target
               else ""))
        cells = (["# " + workload.ljust(24), bests[n_max].mode.ljust(20)]
                 + [(pct(bests[n].efficiency * 100) if n in table
                     else "--").ljust(12) for n in chips]
                 + [(f"{pct(weak[1] * 100)} @n={weak[0]}" if weak
                     else "--").ljust(12), verdict])
        lines.append("".join(cells))
        if note:
            lines.append(f"#   ^ {note}")
    lines.append("# =====")
    return lines


def measured_multichip(op: str, A, k: int, dtype, chips, *, device,
                       kind: str = None) -> list:
    """Measured multi-device time per call: [(n, ms)] for each n in
    `chips` up to the world size, on the sub-group of ranks 0..n-1.

    Runs on every rank of the process group (each rank calls
    `dist.new_group` for every n, as torch.distributed requires; ranks
    outside a sub-group wait at the next one).  SpMV runs
    `spmv_dist_planned` over `partition_row_plans(A, n, op="spmv")` (a
    routed shard runs kernel K2'), SpMM `spmm_mode2_planned` over
    `partition_row_plans(A, n, kind=kind)`, each rank holding its shard.
    ms is the median wall time per synchronous call on CUDA, a host time
    on the CPU; the list holds this rank's readings (none on a rank that
    sat out)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from .containers import DenseMatrix, DenseVector
    from .parallel import (Mesh, partition_row_plans, spmm_mode2_planned,
                           spmv_dist_planned)
    from .utils.errors import PartitionError, require
    from .utils.timing import host_time_ms, wall_time_ms
    require(dist.is_initialized(), PartitionError,
            "measured_multichip needs a process group")
    world, me = dist.get_world_size(), dist.get_rank()
    dev = torch.device(device)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    lines = []
    for n in chips:
        if n > world:
            break
        group = dist.new_group(list(range(n)))
        if me >= n:
            continue
        mesh = Mesh(group=group, rank=me, size=n, device=dev)
        shards = partition_row_plans(
            A, n, dtype=dtype, kind=kind,
            op="spmv" if op == "spmv" else None, device=dev, rank=me)
        if op == "spmv":
            x = torch.from_numpy(
                DenseVector.random(A.width, dtype=np_dtype).values).to(dev)
            y = torch.ones(A.height, dtype=dtype, device=dev)

            def run():
                return spmv_dist_planned(shards, x, 1.0, 1.0, y, mesh)
        else:
            B = torch.from_numpy(
                DenseMatrix.random(A.width, k, dtype=np_dtype).values).to(dev)
            C = torch.ones((A.height, k), dtype=dtype, device=dev)

            def run():
                return spmm_mode2_planned(shards, B, 1.0, 1.0, C, mesh)
        ms = (wall_time_ms(run, device=dev) if dev.type == "cuda"
              else host_time_ms(run))
        lines.append((n, ms))
    return lines
