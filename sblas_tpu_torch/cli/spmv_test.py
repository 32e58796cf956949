"""SpMV CLI — argv contract of the reference's spmv_test binary.

    python -m sblas_tpu_torch.cli.spmv_test <A.mtx> <alpha> <beta>
                                            <n_devices> [f32|f64]
                                            [--mode dist|distp|halo|halop|
                                                    xfoot|hier|single]
                                            [--slices S] [--plan-cache PATH]
                                            [--transport f32|bf16]
                                            [--device cuda|cpu]

Port of `sblas_tpu/cli/spmv_test.py` (same positional contract,
spmv_test.cu:44-60): load A, x random (seed 211), y = 1.0, run
y' = beta*y + alpha*A@x, verify against the CPU oracle.  Modes:

* `single`: `make_plan(op="spmv")` on one device, no process group;
* `dist`: mode 2 over nnz-balanced COO segments (`spmv_dist`, psum);
* `distp`: mode 2 over per-shard fast plans (`spmv_dist_planned`);
* `halo` / `halop`: row blocks with the ring x exchange, COO or per-shard
  DIA (`spmv_halo`, `spmv_halo_planned`);
* `xfoot`: the footprint-compressed x exchange (`spmv_xfoot`: hot
  all-reduce + packet all_to_all, row-sharded result);
* `hier`: the two-tier mode over S x n/S groups (`--slices`, default 2).

`--plan-cache PATH` keeps the built plan or shards (`io/plancache.py`):
the first run builds every shard on the host and saves them (rank 0),
later runs load them, each rank only its own shard.  A file built for
another shape, nnz or shard count raises `FormatError`, as does a routed
plan of another transport than f32.

The distributed modes run one process per rank: under `torchrun` each
rank joins the launcher's group (NCCL on cuda, gloo on cpu), without it
the CLI runs a group of one (`cli.common.setup_devices`).  Rank 0 prints
the report; the exit code is non-zero if validation fails on any rank.
For dist, distp and xfoot on more than one rank it also times the
per-rank compute alone (the `*_nocomm` twin) and reports the difference
as the exposed collective time.  `--transport f32` is every port plan's
route transport and changes nothing; `--transport bf16` and
`--progressive` raise `NotPortedError`.  `--device`
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
         "[--mode dist|distp|halo|halop|xfoot|hier|single] [--slices S] "
         "[--plan-cache PATH] [--transport f32|bf16] [--device cuda|cpu]")

MODES = ("dist", "distp", "halo", "halop", "xfoot", "hier", "single")
TRANSPORTS = ("f32", "bf16")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    path, alpha, beta, n_dev = positional(
        argv, range(4), (str, float, float, int), USAGE)
    rest = argv[4:]
    dtype_name = rest[0] if rest and not rest[0].startswith("-") else "f32"
    mode = flag_value(rest, "--mode", "dist", usage=USAGE)
    slices = flag_value(rest, "--slices", 2, int, usage=USAGE)
    device = flag_value(rest, "--device", "cuda", usage=USAGE)
    cache_path = flag_value(rest, "--plan-cache", None, usage=USAGE)
    transport = flag_value(rest, "--transport", "f32", usage=USAGE)

    from ..utils.errors import NotPortedError
    if mode not in MODES or transport not in TRANSPORTS:
        print(USAGE, file=sys.stderr)
        raise SystemExit(2)
    if transport == "bf16":
        raise NotPortedError("--transport bf16 is not ported to "
                             "sblas_tpu_torch yet")
    if "--progressive" in rest:
        raise NotPortedError("--progressive is not ported to sblas_tpu_torch "
                             "yet")
    if device not in ("cuda", "cpu"):
        print(USAGE, file=sys.stderr)
        raise SystemExit(2)
    np_dtype, torch_dtype = ensure_dtype(dtype_name, USAGE)
    if cuda_missing(device):
        return 2
    if mode == "single":
        return _single(path, alpha, beta, np_dtype, torch_dtype, device,
                       cache_path)
    with setup_devices(n_dev, device) as (mesh, n):
        return _distributed(path, alpha, beta, np_dtype, torch_dtype, mode,
                            slices, mesh, n, cache_path)


def _operands(path, np_dtype):
    from ..containers import CsrMatrix, DenseVector
    A = CsrMatrix.from_mtx(path, dtype=np_dtype)
    # reference: x random, y fill 1.0 (spmv_test.cu:12-14)
    x = DenseVector.random(A.width, dtype=np_dtype)
    y = DenseVector.constant(A.height, 1.0, dtype=np_dtype)
    return A, x, y


def _cached(cache_path, A, n_shards, build, device, rank=None):
    """Build-once, run-many (`--plan-cache`): load the plan or shards at
    `cache_path` when the file exists, else `build(device, rank)`.  With a
    path, a missing file is filled from `build("cpu", None)` (every shard,
    on the host) by rank 0 and each rank places its own shard.  A loaded
    file must be bound to this run (shape, nnz and, when sharded, the
    shard count) and hold f32 route transport; otherwise `FormatError`."""
    import os

    from ..io.plancache import load_plan, place, save_plan
    from ..utils.errors import FormatError
    say = print if not rank else (lambda *a, **k: None)
    if not cache_path:
        return build(device, rank)
    if os.path.exists(cache_path):
        obj = load_plan(cache_path, device, rank=rank)
        n_file = getattr(obj, "n_shards", n_shards)
        if (tuple(obj.shape) != tuple(A.shape) or obj.nnz != A.nnz
                or n_file != n_shards):
            raise FormatError(
                f"plan cache {cache_path} was built for shape "
                f"{tuple(obj.shape)}/nnz {obj.nnz}/{n_file} shards; this "
                f"run is {tuple(A.shape)}/{A.nnz}/{n_shards}: delete the "
                f"file or point --plan-cache elsewhere")
        held = [p for p in getattr(obj, "plans", (obj,)) if p is not None]
        transport = {getattr(getattr(p, "plan", p), "transport", "f32")
                     for p in held}
        if transport - {"f32"}:
            raise FormatError(
                f"plan cache {cache_path} holds routed_transport "
                f"{sorted(transport)}; only f32 is ported")
        say(f"plan cache: loaded {cache_path}")
        return obj
    obj = build("cpu", None)
    if not rank:
        save_plan(cache_path, obj)
        say(f"plan cache: saved {cache_path}")
    return place(obj, device, rank)


def _single(path, alpha, beta, np_dtype, torch_dtype, device,
            cache_path) -> int:
    import numpy as np
    import torch

    from ..ops import make_plan, spmv
    from ..ops.cpu_reference import spmv_cpu
    from ..utils.timing import nnz_per_s, timed
    from ..utils.verify import check_equal

    times: dict = {}
    with timed("Load time", times, device=device):
        A, x, y = _operands(path, np_dtype)
        plan = _cached(cache_path, A, None, lambda d, r: make_plan(
            A, dtype=torch_dtype, op="spmv", device=d), device)
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
                 mesh, n, cache_path) -> int:
    import numpy as np
    import torch

    from ..ops.cpu_reference import spmv_cpu
    from ..parallel import (make_mesh2, partition_halo_dia,
                            partition_row_plans, partition_xfoot, spmv_dist,
                            spmv_dist_hier, spmv_dist_nocomm,
                            spmv_dist_planned, spmv_dist_planned_nocomm,
                            spmv_halo, spmv_halo_planned, spmv_xfoot,
                            spmv_xfoot_nocomm, sync_to_host)
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

    def cached(partition, **pkw):
        """The partition `partition(A, n, ...)` through --plan-cache."""
        return _cached(cache_path, A, n, lambda d, r: partition(
            A, n, dtype=torch_dtype, device=d, rank=r, **pkw), dev, rank)

    with timed("Load time", times, device=dev):
        A, x, y = _operands(path, np_dtype)
        if mode == "dist":
            segs = partition_nnz_balanced(A, n, **kw)
            say(partition_report(segs))
        elif mode == "distp":
            shards = cached(partition_row_plans, op="spmv")
            say(f"per-shard plans: kind={shards.kind}, "
                f"band_rows={shards.band_rows}")
        elif mode == "halo":
            blocks = partition_row_blocks(A, n, **kw)
            say(f"halo widths: {blocks.halo_left}/{blocks.halo_right} "
                f"(block {blocks.rows_per_shard})")
            dim = 0
        elif mode == "halop":
            hshards = cached(partition_halo_dia)
            say(f"halo DIA shards: "
                f"{len(hshards.local(rank).offsets)} diagonals, block "
                f"{hshards.rows_per_shard}")
            dim = 0
        elif mode == "xfoot":
            xshards = cached(partition_xfoot)
            st = xshards.stats
            say(f"xfoot shards: kind={xshards.kind}, hot {st.hot_total}, "
                f"packets {st.packet_pad}/pair, extract {st.extract_mode}")
            dim = 0
        else:  # hier
            require(slices >= 1 and n % slices == 0, PartitionError,
                    f"--slices {slices} does not divide {n} devices")
            mesh2 = make_mesh2(slices, n // slices, device=dev)
            shards = cached(partition_row_plans, op="spmv")
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
        "xfoot": lambda: spmv_xfoot(xshards, xd, alpha, beta, yd, mesh),
        "hier": lambda: spmv_dist_hier(shards, xd, alpha, beta, yd, mesh2),
    }[mode]
    got = run()
    ms = run_ms(run, dev, times, n)
    say(f"nnz/s = {nnz_per_s(A.nnz, ms):.3e}")

    # comm/compute split (the reference prints per-GPU NCCL time,
    # spmv.h:112-128): exposed collective time = full run - nocomm run
    if mode in ("dist", "distp", "xfoot") and n > 1:
        nocomm = {"dist": lambda: spmv_dist_nocomm(segs, xd, mesh),
                  "distp": lambda: spmv_dist_planned_nocomm(shards, xd,
                                                            mesh),
                  "xfoot": lambda: spmv_xfoot_nocomm(xshards, xd,
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
