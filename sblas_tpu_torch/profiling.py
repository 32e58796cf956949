"""Profiling harness: the reference's profiling.sh on torch.profiler.

    python -m sblas_tpu_torch.profiling [outdir] [--small]
                                        [--device cuda|cpu]

Port of the root `profiling.py`.  The reference runs `nsys profile
--trace=cuda,nvtx` with UM page-fault counters over {SpMM, SpMV} x
{tuning off, on} (profiling.sh:3-21).  Here each of the four runs,
`spmm_um_tuning{0,1}` on the s3dkq4m2 shell proxy (32 MiB budget) and
`spmv_um_tuning{0,1}` on the webbase-1M proxy (16 MiB), is one
`torch.profiler` window written as a Chrome trace, `outdir/<run>.json`
(open in ui.perfetto.dev or chrome://tracing).  The window records the
package's spans (`utils/trace.py`) as ranges: `sblas.profile run=<run>`
around the call, `sblas.um.copy band=<i>` for each band's copy and
`sblas.um.compute band=<i>` for its compute (NVTX ranges of the same
names on a CUDA device, so `nsys --trace=cuda,nvtx` shows them too), and
the host-to-device copies of an untuned run are the trace's memcpy rows
where the reference counts page faults.  `--small` cuts both matrices
(a 7,649-row shell, a 50,000-row web graph).  `--device` defaults to
cuda and exits non-zero without a GPU.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

USAGE = ("usage: python -m sblas_tpu_torch.profiling [outdir] [--small] "
         "[--device cuda|cpu]")


def workloads(small: bool, device):
    """{run name: call} over host-resident plans of the two proxies, and
    a one-line description of the plans."""
    from .containers import DenseMatrix, DenseVector
    from .io.generate import fem_shell_like, webbase_like
    from .memory import host_resident_plan, spmm_um, spmv_um

    # the reference profiles spmm_test_um on s3dkq4m2 and spmv_test_um on
    # webbase-1M (profiling.sh:6,16): the same split, over the proxies
    A = (fem_shell_like(nx=51, ny=25, dof=6, n_target=51 * 25 * 6 - 1,
                        dtype=np.float32)
         if small else fem_shell_like(dtype=np.float32))
    W = webbase_like(n=50_000 if small else 1_000_000, dtype=np.float32)
    hp = host_resident_plan(A, dtype=torch.float32,
                            hbm_budget_bytes=32 << 20, device=device)
    hpw = host_resident_plan(W, dtype=torch.float32,
                             hbm_budget_bytes=16 << 20, device=device)

    def on(arr):
        return torch.from_numpy(arr).to(device)

    B = on(DenseMatrix.random(A.width, 64, dtype=np.float32).values)
    C = on(DenseMatrix.constant(A.height, 64, 1.0, dtype=np.float32).values)
    x = on(DenseVector.random(W.width, dtype=np.float32).values)
    y = on(DenseVector.constant(W.height, 1.0, dtype=np.float32).values)
    said = (f"spmm workload: {A.shape} nnz={A.nnz}, {hp.n_bands} bands "
            f"[{hp.kind}]; spmv workload: {W.shape} nnz={W.nnz}, "
            f"{hpw.n_bands} bands [{hpw.kind}]")
    runs = {
        "spmm_um_tuning0": (hp, lambda: spmm_um(hp, B, 1.0, 1.0, C)),
        "spmm_um_tuning1": (hp, lambda: spmm_um(hp, B, 1.0, 1.0, C,
                                                tuning=True)),
        "spmv_um_tuning0": (hpw, lambda: spmv_um(hpw, x, 1.0, 1.0, y)),
        "spmv_um_tuning1": (hpw, lambda: spmv_um(hpw, x, 1.0, 1.0, y,
                                                 tuning=True)),
    }
    return runs, said


def trace(name: str, plan, fn, outdir: str, device) -> str:
    """One warm call, then `fn` once inside a profiler window named
    `name`, written to `outdir/<name>.json`; the plan starts untuned both
    times, so a tuned run's trace holds its copy to the device."""
    from .utils import trace as tr
    device = torch.device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    plan.remove_gpu_tuning()
    fn()
    plan.remove_gpu_tuning()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    path = os.path.join(outdir, f"{name}.json")
    with torch.profiler.profile(activities=activities) as prof, \
            tr.recording(ranges=True):
        with tr.span("sblas.profile", run=name):
            fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(path)
    return path


def main(argv=None) -> int:
    from .cli.common import cuda_missing, flag_value
    args = sys.argv[1:] if argv is None else list(argv)
    device = flag_value(args, "--device", "cuda", usage=USAGE)
    if device not in ("cuda", "cpu"):
        print(USAGE, file=sys.stderr)
        return 2
    if cuda_missing(device):
        return 2
    if "--device" in args:
        i = args.index("--device")
        del args[i:i + 2]
    small = "--small" in args
    args = [a for a in args if a != "--small"]
    outdir = args[0] if args else "traces"
    os.makedirs(outdir, exist_ok=True)
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    runs, said = workloads(small, device)
    print(said, file=sys.stderr)
    for name, (plan, fn) in runs.items():
        path = trace(name, plan, fn, outdir, device)
        print(f"{name}: trace written to {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
