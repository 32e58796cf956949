"""PageRank on the webbase proxy: the routed SpMV engine in a power
iteration over a web graph with hub columns.

    python -m sblas_tpu_torch.examples.pagerank [--n 100000]
        [--damping 0.85] [--tol 1e-8] [--maxiter 200] [--device cuda|cpu]

Port of the JAX package's `examples/pagerank.py`.  Builds the
column-stochastic transition matrix P^T of the webbase-like proxy
(`transition`: out-degree normalised, transposed so that ranks update as
r' = a * P^T r + (1 - a)/n + the dangling mass), plans it once
(`make_plan(op="spmv")`, the routed engine at web scale) and runs the
library's `solvers.pagerank` in f32 until the L1 change passes `tol`.
Validation: the ranks sum to 1 within 1e-3, the iteration converged, and
the ranks are within max(10 * tol, 1e-5) in L1 of a float64 power
iteration on the host (`pagerank_numpy`).
"""

from __future__ import annotations

import argparse
import sys
import time


def transition(G, dtype):
    """(P^T as CSR, the dangling mask): edge i -> j of G contributes
    1/outdeg(i) at (j, i); pages with no out-link are dangling."""
    import numpy as np

    from ..containers import CooMatrix
    n = G.shape[0]
    coo = G.to_coo()
    outdeg = np.maximum(G.row_nnz, 1).astype(np.float64)
    PT = CooMatrix(coo.col_idx, coo.row_idx,
                   (1.0 / outdeg[coo.row_idx]).astype(dtype),
                   (n, n)).to_csr()
    return PT, (G.row_nnz == 0).astype(dtype)


def pagerank_numpy(PT, dangling, damping: float, tol: float,
                   maxiter: int = 1000):
    """The float64 power iteration on the host (scipy CSR), run until the
    L1 change is below tol / 100: the reference the examples check
    against."""
    import numpy as np

    from .cg import scipy_csr
    n = PT.shape[0]
    S = scipy_csr(PT).astype(np.float64)
    dang = np.asarray(dangling, dtype=np.float64)
    r = np.full(n, 1.0 / n)
    for _ in range(maxiter):
        r_new = damping * (S @ r + dang @ r / n) + (1.0 - damping) / n
        delta = np.abs(r_new - r).sum()
        r = r_new
        if delta <= tol / 100:
            break
    return r


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sblas_tpu_torch.examples.pagerank")
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--damping", type=float, default=0.85)
    ap.add_argument("--tol", type=float, default=1e-8)
    ap.add_argument("--maxiter", type=int, default=200)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..cli.common import cuda_missing
    from ..io.generate import webbase_like
    from ..ops import make_plan
    from ..solvers import pagerank
    if cuda_missing(args.device):
        return 2
    dev = torch.device(args.device)

    t0 = time.perf_counter()
    G = webbase_like(n=args.n, avg_deg=3.1,
                     local_scale=min(2000.0, args.n / 50))
    n = G.shape[0]
    PT, dangling = transition(G, np.float32)
    print(f"graph: {n} pages, {G.nnz} links "
          f"(build {time.perf_counter() - t0:.1f}s)")
    t0 = time.perf_counter()
    plan = make_plan(PT, dtype=torch.float32, op="spmv", device=dev)
    print(f"plan: {type(plan).__name__} "
          f"(build {time.perf_counter() - t0:.1f}s)")

    t0 = time.perf_counter()
    res = pagerank(plan, n, dangling=torch.from_numpy(dangling).to(dev),
                   damping=args.damping, tol=args.tol, maxiter=args.maxiter)
    r = res.x.cpu().numpy()
    dt = time.perf_counter() - t0
    top = np.argsort(-r)[:5]
    print(f"PageRank: {res.iterations} iters in {dt:.2f}s "
          f"({res.iterations * G.nnz / dt / 1e6:.1f} Mnnz/s sustained), "
          f"L1 delta {res.residual:.2e}, sum {r.sum():.6f}")
    print("top pages:", ", ".join(f"{i} ({r[i]:.2e})" for i in top))
    want = pagerank_numpy(PT, dangling, args.damping, args.tol)
    err = float(np.abs(r.astype(np.float64) - want).sum())
    print(f"L1 distance to the float64 host power iteration: {err:.2e}")
    ok = (abs(float(r.sum()) - 1.0) < 1e-3 and res.converged
          and err <= max(10 * args.tol, 1e-5))
    print(f"Validation = {bool(ok)}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
