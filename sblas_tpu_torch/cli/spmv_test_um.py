"""UM SpMV CLI — argv contract of the reference's spmv_test_um binary.

    python -m sblas_tpu_torch.cli.spmv_test_um <A.mtx> <alpha> <beta>
                                               <n_devices> [tuning 0|1]
                                               [f32|f64] [--device cuda|cpu]

Port of `sblas_tpu/cli/spmv_test_um.py` (spmv_test_um.cu): the spmv_test
shape plus the trailing tuning flag.  A stays in host memory, cut into
row bands and streamed to the device per call (`memory.spmv_um`);
tuning=1 keeps the bands on the device.  With n_devices > 1 A is
nnz-sharded over the ranks and the partial y summed by one all-reduce
(`memory.spmv_um_dist`, the reference's sblas_spmv_csr_v1 over managed
memory, spmv_um.h:35-139).  SBLAS_HBM_BUDGET (bytes, default 256 MiB)
bounds the bands' device memory per device.

Ranks, report and exit code as in `cli.spmv_test`: one process per rank
(`cli.common.setup_devices`: the `torchrun` group, else a group of one),
rank 0 prints, `--device` defaults to cuda and exits non-zero without a
GPU.
"""

from __future__ import annotations

import sys

from .common import (all_ranks_ok, cuda_missing, ensure_dtype, finish,
                     flag_value, hbm_budget, positional, run_ms,
                     setup_devices, trailing)

USAGE = ("usage: python -m sblas_tpu_torch.cli.spmv_test_um "
         "<A.mtx> <alpha> <beta> <n_devices> [tuning 0|1] [f32|f64] "
         "[--device cuda|cpu]")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    path, alpha, beta, n_dev = positional(
        argv, range(4), (str, float, float, int), USAGE)
    tuning, dtype_name = trailing(argv, 4, USAGE)
    device = flag_value(argv[4:], "--device", "cuda", usage=USAGE)
    if device not in ("cuda", "cpu"):
        print(USAGE, file=sys.stderr)
        raise SystemExit(2)
    np_dtype, torch_dtype = ensure_dtype(dtype_name, USAGE)
    if cuda_missing(device):
        return 2
    with setup_devices(n_dev, device) as (mesh, n):
        return _run(path, alpha, beta, n_dev > 1, tuning, np_dtype,
                    torch_dtype, mesh, n)


def _run(path, alpha, beta, sharded, tuning, np_dtype, torch_dtype, mesh,
         n) -> int:
    import numpy as np
    import torch

    from ..containers import CsrMatrix, DenseVector
    from ..memory import (host_resident_plan, host_resident_shards,
                          spmv_um, spmv_um_dist)
    from ..ops.cpu_reference import spmv_cpu
    from ..parallel import sync_to_host
    from ..utils.timing import nnz_per_s, timed
    from ..utils.verify import check_equal

    dev, rank = mesh.device, mesh.rank
    say = print if rank == 0 else (lambda *a, **k: None)
    times: dict = {}
    budget = hbm_budget()

    with timed("Load time", times):
        A = CsrMatrix.from_mtx(path, dtype=np_dtype)
        x = DenseVector.random(A.width, dtype=np_dtype)
        y = DenseVector.constant(A.height, 1.0, dtype=np_dtype)
    with timed("Distribution time", times, device=dev):
        if sharded:
            hp = host_resident_shards(A, n, dtype=torch_dtype,
                                      hbm_budget_bytes=budget, device=dev,
                                      rank=rank)
        else:
            hp = host_resident_plan(A, dtype=torch_dtype,
                                    hbm_budget_bytes=budget, device=dev)
    say(f"Matrix: {A.height} x {A.width}, nnz {A.nnz}, {n} device(s) "
        f"({dev.type}), {hp.n_bands} band(s) x {hp.band_rows} rows "
        f"[{hp.kind}], tuning={int(tuning)}")

    xd, yd = torch.from_numpy(x.values).to(dev), torch.from_numpy(
        y.values).to(dev)
    if sharded:
        def run():
            return spmv_um_dist(hp, xd, alpha, beta, yd, mesh, tuning=tuning)
    else:
        def run():
            return spmv_um(hp, xd, alpha, beta, yd, tuning=tuning)
    got = run()
    ms = run_ms(run, dev, times, n)
    say(f"nnz/s = {nnz_per_s(A.nnz, ms):.3e}")

    whole = sync_to_host(got)
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
