"""Multi-rank dry run of every ported distributed mode.

    python -m torch.distributed.run --nproc_per_node=N \
        -m sblas_tpu_torch.parallel.dryrun N --device cuda
    python -m sblas_tpu_torch.parallel.dryrun [n] --device cpu

The port's counterpart of `__graft_entry__.py::dryrun_multichip`:
`dryrun_multichip(n)` spawns n processes, joins them in one gloo group on
the CPU, and runs one step of every ported mode at tiny shapes against
the numpy oracle (`run_cases`).  The command line takes that spawned
run only for `--device cpu` without a launcher.  With `--device cuda`,
or under a launcher (`torchrun`), the same cases run on the launcher's
ranks, one device each (NCCL on cuda, gloo on cpu; a group of one
without a launcher).  `--device` has no default.

The cases: mode 1 (over a BELL and a windowed-COO plan), mode 2 and the
distributed SpMV with both reductions, the halo SpMV, the planned modes
for every shard kind (routed through kernel K2'), the halo-planned SpMV
and SpMM, the two-tier modes (2 x n/2 groups for an even n >= 4, else
1 x n), and the footprint-compressed x exchange: on the banded A with
the default engine, on a small web graph W (hubs make a hot set) with
the route engine forced, and over routed shards of U with the route
engine (kernels K1 and K2' under the exchange), the planned, two-tier
and xfoot SpMVs over routed shards of U at the bf16 route transport (f32
values, K2' storing bf16, K1 on int16 tables; held at the transport's
1e-2 relative bar), and the host-streamed
(UM) modes, each untuned and tuned: `spmv_um_dist` and `spmm_um_dist`
over W's windowed-COO bands, `spmm_um_mode1` over A's ELL bands.  Then
the `bf16_*` cases: bf16 values through every container (segments, row
blocks, every shard kind, halo DIA, hier, xfoot, UM shards and bands),
on the same operands rounded to bf16, each result bf16 and held against
the oracle at the JAX package's bf16 bound (rtol = atol = 0.15).  It
raises if any rank
fails; with `save_dir`, rank 0 writes every whole result to
`save_dir/cases.npz` (bf16 results as float32, exactly).
"""

from __future__ import annotations

import multiprocessing
import os
import sys
import tempfile
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

ALPHA, BETA = 3.0, 4.0
# the routed cases' thresholds, low enough for the tiny unstructured matrix
ROUTED_CONFIG = dict(routed_min_nnz=256, routed_min_width=256)
# the bf16 route transport's bar against the oracle (relative), the JAX
# package's for its CPU tests (tests/test_rspmv.py::TestBf16Transport)
TRANSPORT_BAR = 1e-2
# the JAX package's bound for bf16 values against the f64 oracle,
# |got - want| <= BF16_TOL * (1 + |want|) (tests/test_ops_single_chip.py)
BF16_TOL = 0.15
PLANNED_KINDS = ("bsr", "ell", "dia", "wcoo", "coo")
# the UM cases' device-memory budgets: several bands of each matrix
UM_BUDGET = dict(A=4 << 10, W=64 << 10)


def hier_split(n: int):
    """(slices, chips per slice) of the two-tier cases on n ranks."""
    return (2, n // 2) if n >= 4 and n % 2 == 0 else (1, n)


def case_operands(n: int) -> dict:
    """The dry run's matrices and dense operands, from seeds (f64): A
    banded and square, U unstructured (128·max(n,4)/4 x 512), W a small
    web graph (512·max(n,4) rows)."""
    from ..containers import DenseMatrix, DenseVector
    from ..io.generate import fem_banded_like, uniform_random, webbase_like
    A = fem_banded_like(n=16 * max(n, 4), half_band=3, dtype=np.float64)
    U = uniform_random(32 * max(n, 4), 512, nnz_per_row=3, seed=5,
                       dtype=np.float64)
    W = webbase_like(n=512 * max(n, 4), avg_deg=3.0, seed=6,
                     local_scale=60.0, dtype=np.float64)
    k = 2 * n
    return dict(A=A, U=U, W=W, xW=DenseVector.random(W.width),
                yW=DenseVector.constant(W.height, 1.0),
                BW=DenseMatrix.random(W.width, k),
                CW=DenseMatrix.constant(W.height, k, 1.0),
                B=DenseMatrix.random(A.width, k),
                C=DenseMatrix.constant(A.height, k, 1.0),
                x=DenseVector.random(A.width),
                y=DenseVector.constant(A.height, 1.0),
                BU=DenseMatrix.random(U.width, k),
                CU=DenseMatrix.constant(U.height, k, 1.0),
                xU=DenseVector.random(U.width),
                yU=DenseVector.constant(U.height, 1.0))


def run_cases(mesh) -> dict:
    """Run every case on this rank of `mesh` (a world group), hold each
    whole result against the numpy oracle, and return {case: result}."""
    from ..config import SBlasConfig
    from ..ops import make_plan
    from ..ops.cpu_reference import spmm_cpu, spmv_cpu
    from ..partition import partition_nnz_balanced, partition_row_blocks
    from ..utils.errors import PartitionError, require
    from ..utils.verify import assert_equal, check_equal
    from . import (make_mesh2, partition_halo_dia, partition_row_plans,
                   partition_xfoot, spmm_halo_planned, spmm_mode1,
                   spmm_mode2, spmm_mode2_hier, spmm_mode2_planned,
                   spmv_dist, spmv_dist_hier, spmv_dist_planned, spmv_halo,
                   spmv_halo_planned, spmv_xfoot, sync_to_host)

    n, dev, rank, f64 = mesh.size, mesh.device, mesh.rank, torch.float64
    a, b = ALPHA, BETA
    op = case_operands(n)
    A, U, W = op["A"], op["U"], op["W"]
    t = {k: torch.from_numpy(v.values).to(dev) for k, v in op.items()
         if k not in ("A", "U", "W")}
    want = dict(mm=spmm_cpu(A, op["B"], a, b, op["C"]),
                mv=spmv_cpu(A, op["x"], a, b, op["y"]),
                mmU=spmm_cpu(U, op["BU"], a, b, op["CU"]),
                mvU=spmv_cpu(U, op["xU"], a, b, op["yU"]),
                mvW=spmv_cpu(W, op["xW"], a, b, op["yW"]),
                mmW=spmm_cpu(W, op["BW"], a, b, op["CW"]))
    results = {}

    def case(name, out, oracle, dim=None, on=mesh, bar=None):
        if name.startswith("bf16_"):
            require(out.dtype == torch.bfloat16, PartitionError,
                    f"{name}: result is {out.dtype}, expected bf16")
        whole = sync_to_host(out, on, dim)
        if name.startswith("bf16_"):
            err = np.abs(whole - want[oracle])
            require(bool(np.all(err <= BF16_TOL * (1 + np.abs(want[oracle])))),
                    PartitionError, f"{name}: max error {err.max()} outside "
                    f"rtol = atol = {BF16_TOL}")
        elif bar is None:
            assert_equal(whole, want[oracle])
        else:
            report = check_equal(whole, want[oracle], error_bar=bar,
                                 relative=True)
            require(report.ok, PartitionError, f"{name}: {report}")
        results[name] = whole

    kw = dict(dtype=f64, device=dev)
    B, C, x, y = t["B"], t["C"], t["x"], t["y"]
    case("mode1", spmm_mode1(make_plan(A, **kw), B, a, b, C, mesh), "mm", 1)
    case("mode1_wcoo", spmm_mode1(make_plan(U, force="wcoo", **kw),
                                  t["BU"], a, b, t["CU"], mesh), "mmU", 1)
    segs = partition_nnz_balanced(A, n, **kw)
    for reduce, dim in (("psum", None), ("psum_scatter", 0)):
        case(f"mode2_{reduce}", spmm_mode2(segs, B, a, b, C, mesh, reduce),
             "mm", dim)
        case(f"dist_{reduce}", spmv_dist(segs, x, a, b, y, mesh, reduce),
             "mv", dim)
    case("halo", spmv_halo(partition_row_blocks(A, n, **kw), x, a, b, y,
                           mesh), "mv", 0)

    # planned modes: every shard kind under both reductions
    for kind in PLANNED_KINDS:
        sh = partition_row_plans(A, n, kind=kind, rank=rank, **kw)
        case(f"planned_{kind}_spmm", spmm_mode2_planned(
            sh, B, a, b, C, mesh, reduce="psum"), "mm")
        case(f"planned_{kind}_spmv", spmv_dist_planned(
            sh, x, a, b, y, mesh, reduce="psum_scatter"), "mv", 0)
    routed = partition_row_plans(U, n, kind="routed", rank=rank,
                                 config=SBlasConfig(**ROUTED_CONFIG), **kw)
    xU, yU = t["xU"], t["yU"]
    for reduce, dim in (("psum", None), ("psum_scatter", 0)):
        case(f"planned_routed_{reduce}", spmv_dist_planned(
            routed, xU, a, b, yU, mesh, reduce), "mvU", dim)
    hs = partition_halo_dia(A, n, rank=rank, **kw)
    case("halo_planned_spmv", spmv_halo_planned(hs, x, a, b, y, mesh),
         "mv", 0)
    case("halo_planned_spmm", spmm_halo_planned(hs, B, a, b, C, mesh),
         "mm", 0)

    # two-tier modes over (slice, chip) groups
    mesh2 = make_mesh2(*hier_split(n), device=dev)
    sh = partition_row_plans(A, n, rank=rank, **kw)
    case("hier_spmm", spmm_mode2_hier(sh, B, a, b, C, mesh2), "mm", 0,
         mesh2.chips)
    case("hier_spmv", spmv_dist_hier(sh, x, a, b, y, mesh2), "mv", 0,
         mesh2.chips)
    case("hier_routed_spmv", spmv_dist_hier(routed, xU, a, b, yU, mesh2),
         "mvU", 0, mesh2.chips)

    # footprint-compressed x exchange: hot all-reduce + packet all_to_all
    xs = partition_xfoot(A, n, rank=rank, **kw)
    case("xfoot", spmv_xfoot(xs, x, a, b, y, mesh), "mv", 0)
    xs = partition_xfoot(W, n, kind="coo", extract="route", rank=rank, **kw)
    case("xfoot_route", spmv_xfoot(xs, t["xW"], a, b, t["yW"], mesh), "mvW",
         0)
    xs = partition_xfoot(U, n, kind="routed", extract="route", rank=rank,
                         config=SBlasConfig(**ROUTED_CONFIG), **kw)
    case("xfoot_routed", spmv_xfoot(xs, xU, a, b, yU, mesh), "mvU", 0)

    # the bf16 route transport over routed shards (f32 values)
    cfg16 = SBlasConfig(routed_transport="bf16", **ROUTED_CONFIG)
    kw32 = dict(dtype=torch.float32, device=dev, rank=rank, config=cfg16)
    xU32, yU32 = xU.float(), yU.float()
    r16 = partition_row_plans(U, n, kind="routed", **kw32)
    case("planned_routed_bf16", spmv_dist_planned(r16, xU32, a, b, yU32,
                                                  mesh), "mvU",
         bar=TRANSPORT_BAR)
    case("hier_routed_bf16", spmv_dist_hier(r16, xU32, a, b, yU32, mesh2),
         "mvU", 0, mesh2.chips, bar=TRANSPORT_BAR)
    xs = partition_xfoot(U, n, kind="routed", extract="route", **kw32)
    case("xfoot_routed_bf16", spmv_xfoot(xs, xU32, a, b, yU32, mesh), "mvU",
         0, bar=TRANSPORT_BAR)

    # host-streamed (UM) modes, untuned then tuned
    from ..memory import (host_resident_plan, host_resident_shards,
                          spmm_um_dist, spmm_um_mode1, spmv_um_dist)
    hs = host_resident_shards(W, n, hbm_budget_bytes=UM_BUDGET["W"],
                              rank=rank, **kw)
    hp = host_resident_plan(A, hbm_budget_bytes=UM_BUDGET["A"], **kw)
    for tuning in (False, True):
        tag = f"t{int(tuning)}"
        case(f"um_spmv_dist_{tag}", spmv_um_dist(
            hs, t["xW"], a, b, t["yW"], mesh, tuning=tuning), "mvW")
        case(f"um_spmm_dist_{tag}", spmm_um_dist(
            hs, t["BW"], a, b, t["CW"], mesh, tuning=tuning), "mmW")
        case(f"um_mode1_{tag}", spmm_um_mode1(hp, B, a, b, C, mesh,
                                              tuning=tuning), "mm", 1)
    bf16_cases(mesh, mesh2, op, t, case)
    return results


def bf16_cases(mesh, mesh2, op, t, case) -> None:
    """The `bf16_*` cases of `run_cases`: every container built with bf16
    values, every dense operand rounded to bf16 (through f32, as the
    containers round their values)."""
    from ..config import SBlasConfig
    from ..memory import (host_resident_plan, host_resident_shards,
                          spmm_um_dist, spmm_um_mode1, spmv_um_dist)
    from ..ops import make_plan
    from ..partition import partition_nnz_balanced, partition_row_blocks
    from . import (partition_halo_dia, partition_row_plans, partition_xfoot,
                   spmm_halo_planned, spmm_mode1, spmm_mode2,
                   spmm_mode2_hier, spmm_mode2_planned, spmv_dist,
                   spmv_dist_hier, spmv_dist_planned, spmv_halo, spmv_xfoot)
    n, a, b = mesh.size, ALPHA, BETA
    A, U, W = op["A"], op["U"], op["W"]
    kw = dict(dtype=torch.bfloat16, device=mesh.device)
    r = dict(kw, rank=mesh.rank)
    routed = SBlasConfig(**ROUTED_CONFIG)
    t = {k: v.float().to(torch.bfloat16) for k, v in t.items()}
    B, C, x, y = t["B"], t["C"], t["x"], t["y"]
    case("bf16_mode1_wcoo", spmm_mode1(make_plan(U, force="wcoo", **kw),
                                       t["BU"], a, b, t["CU"], mesh),
         "mmU", 1)
    segs = partition_nnz_balanced(A, n, **kw)
    case("bf16_mode2_psum", spmm_mode2(segs, B, a, b, C, mesh), "mm")
    case("bf16_dist_psum_scatter", spmv_dist(segs, x, a, b, y, mesh,
                                             "psum_scatter"), "mv", 0)
    case("bf16_halo", spmv_halo(partition_row_blocks(A, n, **kw), x, a, b,
                                y, mesh), "mv", 0)
    for kind in PLANNED_KINDS:
        sh = partition_row_plans(A, n, kind=kind, **r)
        case(f"bf16_planned_{kind}_spmm", spmm_mode2_planned(
            sh, B, a, b, C, mesh), "mm")
    sh = partition_row_plans(U, n, kind="routed", config=routed, **r)
    case("bf16_planned_routed_spmv", spmv_dist_planned(
        sh, t["xU"], a, b, t["yU"], mesh, "psum_scatter"), "mvU", 0)
    case("bf16_hier_routed_spmv", spmv_dist_hier(
        sh, t["xU"], a, b, t["yU"], mesh2), "mvU", 0, mesh2.chips)
    case("bf16_hier_spmm", spmm_mode2_hier(
        partition_row_plans(A, n, **r), B, a, b, C, mesh2), "mm", 0,
        mesh2.chips)
    case("bf16_halo_planned_spmm", spmm_halo_planned(
        partition_halo_dia(A, n, **r), B, a, b, C, mesh), "mm", 0)
    case("bf16_xfoot", spmv_xfoot(partition_xfoot(A, n, **r), x, a, b, y,
                                  mesh), "mv", 0)
    case("bf16_xfoot_routed", spmv_xfoot(partition_xfoot(
        U, n, kind="routed", extract="route", config=routed, **r),
        t["xU"], a, b, t["yU"], mesh), "mvU", 0)
    hs = host_resident_shards(W, n, hbm_budget_bytes=UM_BUDGET["W"], **r)
    case("bf16_um_spmv_dist", spmv_um_dist(hs, t["xW"], a, b, t["yW"],
                                           mesh), "mvW")
    case("bf16_um_spmm_dist", spmm_um_dist(hs, t["BW"], a, b, t["CW"],
                                           mesh), "mmW")
    hp = host_resident_plan(A, hbm_budget_bytes=UM_BUDGET["A"], **kw)
    case("bf16_um_mode1", spmm_um_mode1(hp, B, a, b, C, mesh), "mm", 1)


def _rank_main(rank: int, n: int, store: str, save_dir) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=n,
                            timeout=timedelta(seconds=120))
    try:
        from .mesh import make_mesh
        _dryrun_rank(make_mesh(n, device="cpu"), save_dir)
    finally:
        dist.destroy_process_group()


def _dryrun_rank(mesh, save_dir) -> None:
    results = run_cases(mesh)
    if mesh.rank == 0:
        if save_dir:
            np.savez(os.path.join(save_dir, "cases.npz"), **results)
        print(f"dryrun_multichip({mesh.size}): {len(results)} cases of "
              f"every ported distributed mode verified", flush=True)


def dryrun_multichip(n_devices: int, save_dir: str = None,
                     timeout: float = 300.0) -> None:
    """Run `run_cases` on n spawned ranks of one gloo group on the CPU;
    raise unless every rank exits 0.  A rank that fails stops the
    others."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, n_devices, store, save_dir))
                 for r in range(n_devices)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            while any(p.is_alive() for p in procs):
                failed = any(p.exitcode not in (None, 0) for p in procs)
                if failed or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if any(c != 0 for c in codes):
        raise RuntimeError(f"spawned ranks exited with {codes} (timeout "
                           f"{timeout} s)")


USAGE = "usage: python -m sblas_tpu_torch.parallel.dryrun [n] --device cuda|cpu"


def main(argv) -> int:
    """The device is the caller's choice: `--device` has no default."""
    from ..cli.common import flag_value, setup_devices
    n = int(argv[0]) if argv and not argv[0].startswith("-") else 4
    device = flag_value(argv, "--device", None, usage=USAGE)
    if device not in ("cuda", "cpu"):
        print(USAGE, file=sys.stderr)
        return 2
    if device == "cpu" and "WORLD_SIZE" not in os.environ:
        dryrun_multichip(n)
        return 0
    # under a launcher (or on cuda): the launcher's ranks, one per device
    with setup_devices(n, device) as (mesh, _):
        _dryrun_rank(mesh, None)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
