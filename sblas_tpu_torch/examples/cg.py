"""Conjugate gradients on the FEM shell proxy.

    python -m sblas_tpu_torch.examples.cg [--n 20000] [--dist N]
        [--tol 1e-6] [--maxiter 500] [--f64] [--device cuda|cpu]

Port of the JAX package's `examples/cg.py`.  Builds a symmetric positive
definite system from the s3dkq4m2-structure proxy (`build_spd`: the
shell's symmetric pattern, made diagonally dominant), plans it once with
`make_plan(op="spmv")`, and solves A x = b for b = A x_true with the
library's `solvers.cg`, whose chunks of iterations run as one CUDA graph
on a card.  `--dist N` solves over `partition_row_plans` shards with
`spmv_dist_planned`: one process per rank under `torchrun`, or a world of
one without it.  Validation holds the relative residual, computed again
on the host with scipy, to max(tol, 1e-5) * 10.
"""

from __future__ import annotations

import argparse
import sys
import time


def build_spd(n: int, dtype):
    """Shell-proxy pattern, symmetric values, diagonally dominant: d_i =
    1 + sum_j |a_ij| added to the diagonal.

    `n` is rounded to the mesh: nx x ny nodes of 6 unknowns, nx near the
    shell's 201:75 aspect (89,244 rows at `n=90_449`).  Diagonal
    dominance keeps the spectrum narrow, so Jacobi-CG reaches 1e-6 in
    about 10 iterations, inside one 16-iteration solver chunk; the
    benchmark's CG cell solves a weighted Laplacian on the shell's
    pattern instead (`benchmark/harness/pcg.py::spd_values`, about 300
    iterations), as a stiffness matrix's widening spectrum asks."""
    import numpy as np

    from ..containers import CooMatrix
    from ..io import generate

    nx = max(int(round((n / 6) ** 0.5 * (201 / 75) ** 0.5)), 4)
    ny = max(n // (6 * nx), 2)
    A = generate.fem_shell_like(nx=nx, ny=ny, dof=6, n_target=nx * ny * 6,
                                dtype=np.float64)
    coo = A.to_coo()
    rowsum = np.zeros(A.shape[0])
    np.add.at(rowsum, coo.row_idx, np.abs(coo.values))
    diag_rows = np.arange(A.shape[0])
    rows = np.concatenate([coo.row_idx, diag_rows])
    cols = np.concatenate([coo.col_idx, diag_rows])
    vals = np.concatenate([coo.values, 1.0 + rowsum]).astype(dtype)
    return CooMatrix(rows, cols, vals, A.shape).to_csr()


def scipy_csr(A):
    """A as a scipy CSR matrix (the host check's operator)."""
    import scipy.sparse as sp
    return sp.csr_matrix((A.values, A.col_idx, A.row_ptr), shape=A.shape)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m sblas_tpu_torch.examples.cg")
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--dist", type=int, default=0, metavar="N_DEV")
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--maxiter", type=int, default=500)
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    from ..cli.common import cuda_missing, setup_devices
    if cuda_missing(args.device):
        return 2
    if args.dist:
        with setup_devices(args.dist, args.device) as (mesh, _):
            return _solve(args, mesh)
    return _solve(args, None)


def _solve(args, mesh) -> int:
    import numpy as np
    import torch

    from ..ops import make_plan
    from ..parallel import partition_row_plans
    from ..solvers import cg

    rank = mesh.rank if mesh is not None else 0
    say = print if rank == 0 else (lambda *a, **k: None)
    dtype = np.float64 if args.f64 else np.float32
    tdt = torch.float64 if args.f64 else torch.float32
    dev = mesh.device if mesh is not None else torch.device(args.device)

    t0 = time.perf_counter()
    A = build_spd(args.n, dtype)
    say(f"SPD system: {A.shape[0]} unknowns, nnz {A.nnz} "
        f"(build {time.perf_counter() - t0:.1f}s)")
    rng = np.random.RandomState(7)
    x_true = rng.standard_normal(A.shape[0]).astype(dtype)
    S = scipy_csr(A)
    b = S @ x_true

    t0 = time.perf_counter()
    if mesh is not None:
        op = partition_row_plans(A, mesh.size, dtype=tdt, op="spmv",
                                 device=dev, rank=rank)
        say(f"distributed over {mesh.size} device(s), kind={op.kind} "
            f"(build {time.perf_counter() - t0:.1f}s)")
    else:
        op = make_plan(A, dtype=tdt, op="spmv", device=dev)
        say(f"plan: {type(op).__name__} "
            f"(build {time.perf_counter() - t0:.1f}s)")

    bd = torch.from_numpy(b).to(dev)
    t0 = time.perf_counter()
    res = cg(op, bd, tol=args.tol, maxiter=args.maxiter, mesh=mesh)
    x = res.x.cpu().numpy()
    dt = time.perf_counter() - t0
    # the host check: the residual again, in float64 with scipy
    rel_res = float(np.linalg.norm(b - S @ x.astype(np.float64))
                    / np.linalg.norm(b))
    rel_err = float(np.linalg.norm(x - x_true) / np.linalg.norm(x_true))
    say(f"CG: {res.iterations} iters in {dt:.2f}s, solver residual "
        f"{res.residual:.2e}, host residual {rel_res:.2e}, rel error vs "
        f"x_true {rel_err:.2e} (converged {res.converged})")
    ok = rel_res < max(args.tol, 1e-5) * 10
    if mesh is not None:
        from ..cli.common import all_ranks_ok
        ok = all_ranks_ok(ok, mesh)
    say(f"Validation = {bool(ok)}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
