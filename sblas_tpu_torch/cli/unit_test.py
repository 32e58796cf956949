"""Unit-test CLI: the reference's unit_test binary surface.

    python -m sblas_tpu_torch.cli.unit_test [A.mtx] [--device cuda|cpu]

Port of `sblas_tpu/cli/unit_test.py`.  Runs the sequence of
unit_test.cu:177-187: container construction tests (COO/CSR/CSC/Dense,
:20-64), then SpMM by both strategies and SpMV with the hard-coded
n_dev=4, alpha=3, beta=4, b_width=256 (:66-175), verified against the
CPU oracle.  The distributed ops run in `cli.common.setup_devices`'s
group: one process per rank under `torchrun`, or a group of one, which
then runs on its one device (it says so).  Without an `A.mtx` it writes a
generated fixture of ash85's class (`pattern_symmetric`) to a temporary
directory, as the JAX CLI does when the reference's `ash85.mtx` is
absent.  Unlike the reference (it
returns 0 even on failure, SURVEY.md §7) the exit code follows
validation.
"""

from __future__ import annotations

import os
import sys
import tempfile

from .common import (all_ranks_ok, cuda_missing, flag_value, setup_devices)

USAGE = ("usage: python -m sblas_tpu_torch.cli.unit_test [A.mtx] "
         "[--device cuda|cpu]")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    device = flag_value(argv, "--device", "cuda", usage=USAGE)
    if device not in ("cuda", "cpu"):
        print(USAGE, file=sys.stderr)
        raise SystemExit(2)
    pos = [a for i, a in enumerate(argv)
           if not a.startswith("--") and (i == 0 or argv[i - 1] != "--device")]
    path = pos[0] if pos else None
    if cuda_missing(device):
        return 2
    with tempfile.TemporaryDirectory() as tmp:
        if path is None:
            print("no A.mtx given; generating a synthetic fixture")
            from ..io.generate import pattern_symmetric
            from ..io.mmio import write_mtx
            gen = pattern_symmetric()
            coo = gen.to_coo()
            path = os.path.join(tmp, "sblas_unit_fixture.mtx")
            write_mtx(path, *gen.shape, coo.row_idx, coo.col_idx, coo.values)
        with setup_devices(4, device) as (mesh, n):
            return _run(path, mesh, n)


def _run(path, mesh, n) -> int:
    import numpy as np
    import torch

    from ..containers import (CooMatrix, CscMatrix, CsrMatrix, DenseMatrix,
                              DenseVector)
    from ..ops import make_plan
    from ..ops.cpu_reference import spmm_cpu, spmv_cpu
    from ..parallel import spmm_mode1, spmm_mode2, spmv_dist, sync_to_host
    from ..partition import partition_nnz_balanced
    from ..utils.verify import check_equal

    say = print if mesh.rank == 0 else (lambda *a, **k: None)
    ok = True

    def report(name, passed):
        nonlocal ok
        ok &= bool(passed)
        say(f"{name}: {'PASS' if passed else 'FAIL'}")

    # container tests (unit_test.cu:20-64), with real assertions
    coo = CooMatrix.from_mtx(path)
    report("cooMatrixTest", coo.nnz > 0 and coo.sort_by_row().nnz == coo.nnz)
    csr = CsrMatrix.from_mtx(path)
    report("csrMatrixTest", csr.nnz > 0 and csr.row_ptr[-1] == csr.nnz)
    csc = CscMatrix.from_csr(csr)
    report("cscMatrixTest",
           csc.nnz == csr.nnz
           and np.allclose(csc.to_csr().to_dense(), csr.to_dense()))
    dm = DenseMatrix.random(csr.height, 16)
    report("denseMatrixTest",
           np.allclose(dm.transpose().values, dm.values.T))

    # op tests (unit_test.cu:66-175): alpha=3 beta=4 b_width=256 n=4
    alpha, beta, b_width = 3.0, 4.0, 256
    B = DenseMatrix.random(csr.width, b_width)
    C = DenseMatrix.constant(csr.height, b_width, 1.0)
    x = DenseVector.random(csr.width)
    y = DenseVector.constant(csr.height, 1.0)
    dev = mesh.device
    Bd, Cd = (torch.from_numpy(B.values).to(dev),
              torch.from_numpy(C.values).to(dev))
    xd, yd = (torch.from_numpy(x.values).to(dev),
              torch.from_numpy(y.values).to(dev))
    want_mm = spmm_cpu(csr, B, alpha, beta, C)
    want_mv = spmv_cpu(csr, x, alpha, beta, y)
    dt = Bd.dtype

    plan = make_plan(csr, dtype=dt, device=dev)
    segs = partition_nnz_balanced(csr, n, dtype=dt, device=dev)
    rel = dt == torch.float32
    got = spmm_mode1(plan, Bd, alpha, beta, Cd, mesh)
    report("spmmCsrTest (mode 1)",
           check_equal(sync_to_host(got, mesh, 1), want_mm,
                       relative=rel).ok)
    got = spmm_mode2(segs, Bd, alpha, beta, Cd, mesh)
    report("spmmCsrTest2 (mode 2)",
           check_equal(sync_to_host(got), want_mm, relative=rel).ok)
    got = spmv_dist(segs, xd, alpha, beta, yd, mesh)
    report("spmvCsrTest",
           check_equal(sync_to_host(got), want_mv, relative=rel).ok)

    ok = all_ranks_ok(ok, mesh)
    say(f"Validation = {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
