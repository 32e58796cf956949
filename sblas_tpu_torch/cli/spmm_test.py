"""SpMM CLI — argv contract of the reference's spmm_test binary.

    python -m sblas_tpu_torch.cli.spmm_test <method 1|2|2p|halo> <A.mtx>
                                            <B_width> <alpha> <beta>
                                            <n_devices> [f32|f64]
                                            [--device cuda|cpu]

Port of `sblas_tpu/cli/spmm_test.py` (spmm_test.cu:95-124): load A, B
random (seed 211), C = 1.0, run C' = beta*C + alpha*A@B, verify against
the CPU oracle.  Methods: 1 = partition dense B (`spmm_mode1` over a
`make_plan` plan, mixed use, no communication); 2 = partition sparse A
over nnz-balanced COO segments with a sum collective (`spmm_mode2`); 2p =
mode 2 over per-shard fast plans (`spmm_mode2_planned`); halo = row
blocks with the ring B exchange over per-shard DIA plans
(`spmm_halo_planned`, square A).

Every method runs one process per rank (`cli.common.setup_devices`:
the `torchrun` group when launched by it, else a group of one; NCCL on
cuda, gloo on cpu).  Rank 0 prints the report; the exit code is non-zero
if validation fails on any rank.  Methods 2 and 2p on more than one rank
also report the exposed collective time (full run minus the `*_nocomm`
twin).  `--device` (default cuda) names the device; with cuda and no GPU
the CLI exits non-zero.  On cuda, float32 products are pinned to true f32
(no TF32), and the report gives the median wall time per synchronous call
(GFLOP/s is taken over it) and the device's busy time.
"""

from __future__ import annotations

import sys

from .common import (all_ranks_ok, cuda_missing, ensure_dtype, finish,
                     flag_value, positional, run_ms, setup_devices)

USAGE = ("usage: python -m sblas_tpu_torch.cli.spmm_test "
         "<method 1|2|2p|halo> <A.mtx> <B_width> <alpha> <beta> "
         "<n_devices> [f32|f64] [--device cuda|cpu]")

METHODS = ("1", "2", "2p", "halo")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    method, path, b_width, alpha, beta, n_dev = positional(
        argv, range(6), (str, str, int, float, float, int), USAGE)
    rest = argv[6:]
    dtype_name = rest[0] if rest and not rest[0].startswith("-") else "f32"
    device = flag_value(rest, "--device", "cuda", usage=USAGE)

    if method not in METHODS or device not in ("cuda", "cpu"):
        print(USAGE, file=sys.stderr)
        raise SystemExit(2)
    np_dtype, torch_dtype = ensure_dtype(dtype_name, USAGE)
    if cuda_missing(device):
        return 2

    import torch
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    with setup_devices(n_dev, device) as (mesh, n):
        return _run(method, path, b_width, alpha, beta, np_dtype,
                    torch_dtype, mesh, n)


def _run(method, path, b_width, alpha, beta, np_dtype, torch_dtype, mesh,
         n) -> int:
    import numpy as np
    import torch

    from ..containers import CsrMatrix, DenseMatrix, MajorOrder
    from ..ops import make_plan
    from ..ops.cpu_reference import spmm_cpu
    from ..parallel import (partition_halo_dia, partition_row_plans,
                            spmm_halo_planned, spmm_mode1, spmm_mode2,
                            spmm_mode2_nocomm, spmm_mode2_planned,
                            spmm_mode2_planned_nocomm, sync_to_host)
    from ..partition import partition_nnz_balanced, partition_report
    from ..utils.timing import gflops, spmm_flops, timed
    from ..utils.verify import check_equal

    dev, rank = mesh.device, mesh.rank
    say = print if rank == 0 else (lambda *a, **k: None)
    kw = dict(dtype=torch_dtype, device=dev)
    times: dict = {}

    with timed("Load time", times, device=dev):
        A = CsrMatrix.from_mtx(path, dtype=np_dtype)
        # reference: B random col-major, C fill 1.0 (spmm_test.cu:24-26)
        B = DenseMatrix.random(A.width, b_width, order=MajorOrder.COL_MAJOR,
                               dtype=np_dtype)
        C = DenseMatrix.constant(A.height, b_width, 1.0, dtype=np_dtype)
        if method == "1":
            plan = make_plan(A, **kw)
            layout, dim = f"plan {type(plan).__name__}", 1
        elif method == "2p":
            shards = partition_row_plans(A, n, rank=rank, **kw)
            say(f"per-shard plans: kind={shards.kind}, "
                f"band_rows={shards.band_rows}")
            layout, dim = f"shards {shards.kind}", None
        elif method == "halo":
            hshards = partition_halo_dia(A, n, rank=rank, **kw)
            say(f"halo DIA shards: "
                f"{len(hshards.local(rank).offsets)} diagonals, block "
                f"{hshards.rows_per_shard}")
            layout, dim = "shards dia", 0
        else:
            segs = partition_nnz_balanced(A, n, **kw)
            say(partition_report(segs))
            layout, dim = "segments coo", None
    say(f"Matrix: {A.height} x {A.width}, nnz {A.nnz}, K={b_width}, "
        f"{n} device(s) ({dev.type}), method {method}, {layout}")

    Bd = torch.from_numpy(B.values).to(dev)
    Cd = torch.from_numpy(C.values).to(dev)
    run = {
        "1": lambda: spmm_mode1(plan, Bd, alpha, beta, Cd, mesh),
        "2": lambda: spmm_mode2(segs, Bd, alpha, beta, Cd, mesh),
        "2p": lambda: spmm_mode2_planned(shards, Bd, alpha, beta, Cd, mesh),
        "halo": lambda: spmm_halo_planned(hshards, Bd, alpha, beta, Cd,
                                          mesh),
    }[method]
    got = run()
    ms = run_ms(run, dev, times, n)
    say(f"GFLOPS = {gflops(spmm_flops(A.nnz, b_width), ms):.3f}")

    # comm/compute split (the reference prints per-GPU NCCL all-reduce
    # time, spmm.h:258-271): the same per-rank compute without the
    # collective; the difference is the exposed collective time
    if method in ("2", "2p") and n > 1:
        nocomm = {"2": lambda: spmm_mode2_nocomm(segs, Bd, mesh),
                  "2p": lambda: spmm_mode2_planned_nocomm(shards, Bd,
                                                          mesh)}[method]
        ms_nc = run_ms(nocomm, dev, {}, n)
        times["Comm time (exposed psum)"] = max(ms - ms_nc, 0.0)
        times["Compute time (per-shard)"] = ms_nc

    whole = sync_to_host(got, mesh, dim)
    with timed("CPU run time", times):
        want = spmm_cpu(A, B, alpha, beta, C)
    report = check_equal(whole, want, relative=(np_dtype == np.float32))
    ok = all_ranks_ok(report.ok, mesh)
    if rank != 0:
        return 0 if ok else 1
    print(report)
    return finish(ok, times)


if __name__ == "__main__":
    raise SystemExit(main())
