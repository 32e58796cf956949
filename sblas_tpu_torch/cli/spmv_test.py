"""SpMV CLI — argv contract of the reference's spmv_test binary.

    python -m sblas_tpu_torch.cli.spmv_test <A.mtx> <alpha> <beta>
                                            <n_devices> [f32|f64]
                                            [--mode dist|distp|halo|halop|
                                                    hier|single]
                                            [--slices S]
                                            [--device cuda|cpu]

Port of `sblas_tpu/cli/spmv_test.py` (same positional contract,
spmv_test.cu:44-60): load A, x random (seed 211), y = 1.0, run
y' = beta*y + alpha*A@x, verify against the CPU oracle.  Modes:

* `single`: `make_plan(op="spmv")` on one device, no process group;
* `dist`: mode 2 over nnz-balanced COO segments (`spmv_dist`, psum);
* `distp`: mode 2 over per-shard fast plans (`spmv_dist_planned`);
* `halo` / `halop`: row blocks with the ring x exchange, COO or per-shard
  DIA (`spmv_halo`, `spmv_halo_planned`);
* `hier`: the two-tier mode over S x n/S groups (`--slices`, default 2).

The distributed modes run one process per rank: under `torchrun` each
rank joins the launcher's group (NCCL on cuda, gloo on cpu), without it
the CLI runs a group of one (`cli.common.setup_devices`).  Rank 0 prints
the report; the exit code is non-zero if validation fails on any rank.
For dist and distp on more than one rank it also times the per-rank
compute alone (the `*_nocomm` twin) and reports the difference as the
exposed collective time.  `--mode xfoot` and the flags --plan-cache,
--transport and --progressive raise `NotPortedError`.  `--device`
(default cuda) names the device; with cuda and no GPU the CLI exits
non-zero.  On cuda it reports the median wall time per synchronous call
(nnz/s is taken over it) and the device's busy time from CUDA events; on
cpu a host time labelled as such.
"""

from __future__ import annotations

import sys

from .common import (all_ranks_ok, cuda_missing, ensure_dtype, finish,
                     flag_value, positional, run_ms, setup_devices)

USAGE = ("usage: python -m sblas_tpu_torch.cli.spmv_test "
         "<A.mtx> <alpha> <beta> <n_devices> [f32|f64] "
         "[--mode dist|distp|halo|halop|hier|single] [--slices S] "
         "[--device cuda|cpu]")

MODES = ("dist", "distp", "halo", "halop", "xfoot", "hier", "single")
_UNPORTED_FLAGS = ("--plan-cache", "--transport", "--progressive")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    path, alpha, beta, n_dev = positional(
        argv, range(4), (str, float, float, int), USAGE)
    rest = argv[4:]
    dtype_name = rest[0] if rest and not rest[0].startswith("-") else "f32"
    mode = flag_value(rest, "--mode", "dist", usage=USAGE)
    slices = flag_value(rest, "--slices", 2, int, usage=USAGE)
    device = flag_value(rest, "--device", "cuda", usage=USAGE)

    from ..utils.errors import NotPortedError
    if mode not in MODES:
        print(USAGE, file=sys.stderr)
        raise SystemExit(2)
    if mode == "xfoot":
        raise NotPortedError("--mode xfoot is not ported to "
                             "sblas_tpu_torch yet")
    for flag in _UNPORTED_FLAGS:
        if flag in rest:
            raise NotPortedError(f"{flag} is not ported to sblas_tpu_torch "
                                 f"yet")
    if device not in ("cuda", "cpu"):
        print(USAGE, file=sys.stderr)
        raise SystemExit(2)
    np_dtype, torch_dtype = ensure_dtype(dtype_name, USAGE)
    if cuda_missing(device):
        return 2
    if mode == "single":
        return _single(path, alpha, beta, np_dtype, torch_dtype, device)
    with setup_devices(n_dev, device) as (mesh, n):
        return _distributed(path, alpha, beta, np_dtype, torch_dtype, mode,
                            slices, mesh, n)


def _operands(path, np_dtype):
    from ..containers import CsrMatrix, DenseVector
    A = CsrMatrix.from_mtx(path, dtype=np_dtype)
    # reference: x random, y fill 1.0 (spmv_test.cu:12-14)
    x = DenseVector.random(A.width, dtype=np_dtype)
    y = DenseVector.constant(A.height, 1.0, dtype=np_dtype)
    return A, x, y


def _single(path, alpha, beta, np_dtype, torch_dtype, device) -> int:
    import numpy as np
    import torch

    from ..ops import make_plan, spmv
    from ..ops.cpu_reference import spmv_cpu
    from ..utils.timing import nnz_per_s, timed
    from ..utils.verify import check_equal

    times: dict = {}
    with timed("Load time", times, device=device):
        A, x, y = _operands(path, np_dtype)
        plan = make_plan(A, dtype=torch_dtype, op="spmv", device=device)
    print(f"Matrix: {A.height} x {A.width}, nnz {A.nnz}, 1 device(s) "
          f"({device}), mode single, plan {type(plan).__name__}")

    xd = torch.from_numpy(x.values).to(device)
    yd = torch.from_numpy(y.values).to(device)

    def run():
        return spmv(plan, xd, alpha, beta, yd)

    got = run()
    ms = run_ms(run, device, times)
    print(f"nnz/s = {nnz_per_s(A.nnz, ms):.3e}")

    with timed("CPU run time", times):
        want = spmv_cpu(A, x, alpha, beta, y)

    report = check_equal(got.cpu().numpy(), want,
                         relative=(np_dtype == np.float32))
    print(report)
    return finish(report.ok, times)


def _distributed(path, alpha, beta, np_dtype, torch_dtype, mode, slices,
                 mesh, n) -> int:
    import numpy as np
    import torch

    from ..ops.cpu_reference import spmv_cpu
    from ..parallel import (make_mesh2, partition_halo_dia,
                            partition_row_plans, spmv_dist, spmv_dist_hier,
                            spmv_dist_nocomm, spmv_dist_planned,
                            spmv_dist_planned_nocomm, spmv_halo,
                            spmv_halo_planned, sync_to_host)
    from ..partition import (partition_nnz_balanced, partition_report,
                             partition_row_blocks)
    from ..utils.errors import PartitionError, require
    from ..utils.timing import nnz_per_s, timed
    from ..utils.verify import check_equal

    dev, rank = mesh.device, mesh.rank
    say = print if rank == 0 else (lambda *a, **k: None)
    kw = dict(dtype=torch_dtype, device=dev)
    times: dict = {}
    gather_on, dim = mesh, None   # how sync_to_host assembles the result

    with timed("Load time", times, device=dev):
        A, x, y = _operands(path, np_dtype)
        if mode == "dist":
            segs = partition_nnz_balanced(A, n, **kw)
            say(partition_report(segs))
        elif mode == "distp":
            shards = partition_row_plans(A, n, op="spmv", rank=rank, **kw)
            say(f"per-shard plans: kind={shards.kind}, "
                f"band_rows={shards.band_rows}")
        elif mode == "halo":
            blocks = partition_row_blocks(A, n, **kw)
            say(f"halo widths: {blocks.halo_left}/{blocks.halo_right} "
                f"(block {blocks.rows_per_shard})")
            dim = 0
        elif mode == "halop":
            hshards = partition_halo_dia(A, n, rank=rank, **kw)
            say(f"halo DIA shards: "
                f"{len(hshards.local(rank).offsets)} diagonals, block "
                f"{hshards.rows_per_shard}")
            dim = 0
        else:  # hier
            require(slices >= 1 and n % slices == 0, PartitionError,
                    f"--slices {slices} does not divide {n} devices")
            mesh2 = make_mesh2(slices, n // slices, device=dev)
            shards = partition_row_plans(A, n, op="spmv", rank=rank, **kw)
            say(f"hier {slices}x{n // slices}: per-shard plans "
                f"kind={shards.kind}")
            gather_on, dim = mesh2.chips, 0
    say(f"Matrix: {A.height} x {A.width}, nnz {A.nnz}, {n} device(s) "
        f"({dev.type}), mode {mode}")

    xd = torch.from_numpy(x.values).to(dev)
    yd = torch.from_numpy(y.values).to(dev)
    run = {
        "dist": lambda: spmv_dist(segs, xd, alpha, beta, yd, mesh),
        "distp": lambda: spmv_dist_planned(shards, xd, alpha, beta, yd,
                                           mesh),
        "halo": lambda: spmv_halo(blocks, xd, alpha, beta, yd, mesh),
        "halop": lambda: spmv_halo_planned(hshards, xd, alpha, beta, yd,
                                           mesh),
        "hier": lambda: spmv_dist_hier(shards, xd, alpha, beta, yd, mesh2),
    }[mode]
    got = run()
    ms = run_ms(run, dev, times, n)
    say(f"nnz/s = {nnz_per_s(A.nnz, ms):.3e}")

    # comm/compute split (the reference prints per-GPU NCCL time,
    # spmv.h:112-128): exposed collective time = full run - nocomm run
    if mode in ("dist", "distp") and n > 1:
        nocomm = {"dist": lambda: spmv_dist_nocomm(segs, xd, mesh),
                  "distp": lambda: spmv_dist_planned_nocomm(shards, xd,
                                                            mesh)}[mode]
        ms_nc = run_ms(nocomm, dev, {}, n)
        times["Comm time (exposed psum)"] = max(ms - ms_nc, 0.0)
        times["Compute time (per-shard)"] = ms_nc

    whole = sync_to_host(got, gather_on, dim)
    with timed("CPU run time", times):
        want = spmv_cpu(A, x, alpha, beta, y)
    report = check_equal(whole, want, relative=(np_dtype == np.float32))
    ok = all_ranks_ok(report.ok, mesh)
    if rank != 0:
        return 0 if ok else 1
    print(report)
    return finish(ok, times)


if __name__ == "__main__":
    raise SystemExit(main())
