"""SpMM CLI — argv contract of the reference's spmm_test binary.

    python -m sblas_tpu_torch.cli.spmm_test <method 1|2|2p|halo> <A.mtx>
                                            <B_width> <alpha> <beta>
                                            <n_devices> [f32|f64]
                                            [--device cuda|cpu]

Port of `sblas_tpu/cli/spmm_test.py` (spmm_test.cu:95-124): load A, B
random (seed 211), C = 1.0, plan with `make_plan` (mixed use, `op=None`),
run C' = beta*C + alpha*A@B on one device, verify against the CPU oracle.
Only method 1 on one device is ported; methods 2, 2p and halo, and more
than one device, raise `NotPortedError` until the distribution slice.
`--device` (default cuda) names the device explicitly; with cuda and no
GPU the CLI exits non-zero.  On cuda, float32 products are pinned to true
f32 (no TF32), and the report gives the median wall time per synchronous
call (GFLOP/s is taken over it) and the device's busy time.
"""

from __future__ import annotations

import sys

from .common import (cuda_missing, ensure_dtype, finish, flag_value,
                     positional, run_ms)

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

    from ..utils.errors import NotPortedError
    if method not in METHODS or device not in ("cuda", "cpu"):
        print(USAGE, file=sys.stderr)
        raise SystemExit(2)
    if method != "1" or n_dev != 1:
        raise NotPortedError(f"method {method} on {n_dev} device(s) is not "
                             f"ported to sblas_tpu_torch yet (only method 1 "
                             f"on 1 device)")
    np_dtype, torch_dtype = ensure_dtype(dtype_name, USAGE)
    if cuda_missing(device):
        return 2

    import numpy as np
    import torch

    from ..containers import CsrMatrix, DenseMatrix, MajorOrder
    from ..ops import make_plan, spmm
    from ..ops.cpu_reference import spmm_cpu
    from ..utils.timing import gflops, spmm_flops, timed
    from ..utils.verify import check_equal

    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    times: dict = {}

    with timed("Load time", times, device=device):
        A = CsrMatrix.from_mtx(path, dtype=np_dtype)
        # reference: B random col-major, C fill 1.0 (spmm_test.cu:24-26)
        B = DenseMatrix.random(A.width, b_width, order=MajorOrder.COL_MAJOR,
                               dtype=np_dtype)
        C = DenseMatrix.constant(A.height, b_width, 1.0, dtype=np_dtype)
        plan = make_plan(A, dtype=torch_dtype, device=device)
    print(f"Matrix: {A.height} x {A.width}, nnz {A.nnz}, K={b_width}, "
          f"1 device(s) ({device}), method {method}, "
          f"plan {type(plan).__name__}")

    Bd = torch.from_numpy(B.values).to(device)
    Cd = torch.from_numpy(C.values).to(device)

    def run():
        return spmm(plan, Bd, alpha, beta, Cd)

    got = run()
    ms = run_ms(run, device, times)
    print(f"GFLOPS = {gflops(spmm_flops(A.nnz, b_width), ms):.3f}")

    with timed("CPU run time", times):
        want = spmm_cpu(A, B, alpha, beta, C)

    report = check_equal(got.cpu().numpy(), want,
                         relative=(np_dtype == np.float32))
    print(report)
    return finish(report.ok, times)


if __name__ == "__main__":
    raise SystemExit(main())
