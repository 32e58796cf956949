"""SpMV CLI — argv contract of the reference's spmv_test binary.

    python -m sblas_tpu_torch.cli.spmv_test <A.mtx> <alpha> <beta>
                                            <n_devices> [f32|f64]
                                            [--mode single]
                                            [--device cuda|cpu]

Port of `sblas_tpu/cli/spmv_test.py` (same positional contract,
spmv_test.cu:44-60): load A, x random (seed 211), y = 1.0, plan with
`make_plan(op="spmv")`, run y' = beta*y + alpha*A@x on one device, verify
against the CPU oracle.  Only `--mode single` is ported; the distributed
modes (dist, distp, halo, halop, xfoot, hier) and the flags --slices,
--plan-cache, --transport and --progressive raise `NotPortedError` until
their slices land.  `--device` (default cuda) names the device
explicitly; with cuda and no GPU the CLI exits non-zero.  On cuda it
reports the median wall time per synchronous call (nnz/s is taken over
it) and the device's busy time from CUDA events; on cpu a host time
labelled as such.
"""

from __future__ import annotations

import sys

from .common import (cuda_missing, ensure_dtype, finish, flag_value,
                     positional, run_ms)

USAGE = ("usage: python -m sblas_tpu_torch.cli.spmv_test "
         "<A.mtx> <alpha> <beta> <n_devices> [f32|f64] "
         "[--mode single] [--device cuda|cpu]")

MODES = ("dist", "distp", "halo", "halop", "xfoot", "hier", "single")
_UNPORTED_FLAGS = ("--slices", "--plan-cache", "--transport",
                   "--progressive")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    path, alpha, beta, _n_dev = positional(
        argv, range(4), (str, float, float, int), USAGE)
    rest = argv[4:]
    dtype_name = rest[0] if rest and not rest[0].startswith("-") else "f32"
    mode = flag_value(rest, "--mode", "dist", usage=USAGE)
    device = flag_value(rest, "--device", "cuda", usage=USAGE)

    from ..utils.errors import NotPortedError
    if mode not in MODES:
        print(USAGE, file=sys.stderr)
        raise SystemExit(2)
    if mode != "single":
        raise NotPortedError(f"--mode {mode} is not ported to "
                             f"sblas_tpu_torch yet (only --mode single)")
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

    import numpy as np
    import torch

    from ..containers import CsrMatrix, DenseVector
    from ..ops import make_plan, spmv
    from ..ops.cpu_reference import spmv_cpu
    from ..utils.timing import nnz_per_s, timed
    from ..utils.verify import check_equal

    times: dict = {}

    with timed("Load time", times, device=device):
        A = CsrMatrix.from_mtx(path, dtype=np_dtype)
        # reference: x random, y fill 1.0 (spmv_test.cu:12-14)
        x = DenseVector.random(A.width, dtype=np_dtype)
        y = DenseVector.constant(A.height, 1.0, dtype=np_dtype)
        plan = make_plan(A, dtype=torch_dtype, op="spmv", device=device)
    print(f"Matrix: {A.height} x {A.width}, nnz {A.nnz}, 1 device(s) "
          f"({device}), mode {mode}, plan {type(plan).__name__}")

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


if __name__ == "__main__":
    raise SystemExit(main())
