"""UM SpMM CLI — argv contract of the reference's spmm_test_um binary.

    python -m sblas_tpu_torch.cli.spmm_test_um <method 1|2> <A.mtx>
                                               <B_width> <alpha> <beta>
                                               <n_devices> [tuning 0|1]
                                               [f32|f64] [--device cuda|cpu]

Port of `sblas_tpu/cli/spmm_test_um.py` (spmm_test_um.cu:165-190): the
spmm_test shape plus the trailing tuning flag.  A stays in host memory,
cut into row bands and streamed to the device per call
(`memory.spmm_um`); tuning=1 keeps the bands on the device.  With
n_devices > 1 the method picks the strategy (spmm_um.h:163-284): 1
streams the whole A on every rank against its block of B's columns
(`memory.spmm_um_mode1`, no collective), 2 nnz-shards A and sums the
partial C with one all-reduce (`memory.spmm_um_dist`).  SBLAS_HBM_BUDGET
(bytes, default 256 MiB) bounds the bands' device memory per device.

Ranks, report and exit code as in `cli.spmm_test`; on cuda float32
products are pinned to true f32 (no TF32).
"""

from __future__ import annotations

import sys

from .common import (all_ranks_ok, cuda_missing, ensure_dtype, finish,
                     flag_value, hbm_budget, positional, run_ms,
                     setup_devices, trailing)

USAGE = ("usage: python -m sblas_tpu_torch.cli.spmm_test_um "
         "<method 1|2> <A.mtx> <B_width> <alpha> <beta> <n_devices> "
         "[tuning 0|1] [f32|f64] [--device cuda|cpu]")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    method, path, b_width, alpha, beta, n_dev = positional(
        argv, range(6), (str, str, int, float, float, int), USAGE)
    tuning, dtype_name = trailing(argv, 6, USAGE)
    device = flag_value(argv[6:], "--device", "cuda", usage=USAGE)
    if method not in ("1", "2") or device not in ("cuda", "cpu"):
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
        return _run(method if n_dev > 1 else None, path, b_width, alpha,
                    beta, tuning, np_dtype, torch_dtype, mesh, n)


def _run(method, path, b_width, alpha, beta, tuning, np_dtype, torch_dtype,
         mesh, n) -> int:
    import numpy as np
    import torch

    from ..containers import CsrMatrix, DenseMatrix, MajorOrder
    from ..memory import (host_resident_plan, host_resident_shards,
                          spmm_um, spmm_um_dist, spmm_um_mode1)
    from ..ops.cpu_reference import spmm_cpu
    from ..parallel import sync_to_host
    from ..utils.timing import gflops, spmm_flops, timed
    from ..utils.verify import check_equal

    dev, rank = mesh.device, mesh.rank
    say = print if rank == 0 else (lambda *a, **k: None)
    times: dict = {}
    budget = hbm_budget()

    with timed("Load time", times):
        A = CsrMatrix.from_mtx(path, dtype=np_dtype)
        B = DenseMatrix.random(A.width, b_width, order=MajorOrder.COL_MAJOR,
                               dtype=np_dtype)
        C = DenseMatrix.constant(A.height, b_width, 1.0, dtype=np_dtype)
    # method 1 = partition dense B (A streamed whole on every rank);
    # method 2 = partition sparse A (nnz shards, one all-reduce)
    with timed("Distribution time", times, device=dev):
        if method == "2":
            hp = host_resident_shards(A, n, dtype=torch_dtype,
                                      hbm_budget_bytes=budget, device=dev,
                                      rank=rank)
        else:
            hp = host_resident_plan(A, dtype=torch_dtype,
                                    hbm_budget_bytes=budget, device=dev)
    say(f"Matrix: {A.height} x {A.width}, nnz {A.nnz}, K={b_width}, "
        f"{n} device(s) ({dev.type}), method {method or 'single'}, "
        f"{hp.n_bands} band(s) x {hp.band_rows} rows [{hp.kind}], "
        f"tuning={int(tuning)}")

    Bd = torch.from_numpy(B.values).to(dev)
    Cd = torch.from_numpy(C.values).to(dev)
    op, dim = {None: (spmm_um, None), "1": (spmm_um_mode1, 1),
               "2": (spmm_um_dist, None)}[method]
    extra = () if method is None else (mesh,)

    def run():
        return op(hp, Bd, alpha, beta, Cd, *extra, tuning=tuning)

    got = run()
    ms = run_ms(run, dev, times, n)
    say(f"GFLOPS = {gflops(spmm_flops(A.nnz, b_width), ms):.3f}")

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
