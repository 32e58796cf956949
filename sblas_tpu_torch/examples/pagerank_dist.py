"""Distributed PageRank over the footprint-compressed x exchange.

    torchrun --nproc_per_node=N -m sblas_tpu_torch.examples.pagerank_dist
        [--n 100000] [--devices 8] [--damping 0.85] [--tol 1e-8]
        [--maxiter 200] [--device cuda|cpu]

Port of the JAX package's `examples/pagerank_dist.py`.  The xfoot mode's
contract is a solver loop's steady state: each rank keeps its block of
rows of the rank vector, every iteration exchanges only the column
footprint (hot columns through one small all-reduce, single-demander
columns through one all_to_all), and the updated ranks come back in the
same blocks, with no full-vector collective.  The dangling mass and the
L1 delta are one scalar all-reduce each.  The library's
`solvers.pagerank` runs that loop over `partition_xfoot` shards in
float64.  One process per rank under `torchrun`, or a world of one
without it; `--devices` above the world runs on the world.  Validation:
the ranks sum to 1 within 1e-6, the iteration converged, and the ranks
are within 10 * tol in L1 of the float64 power iteration on the host.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m sblas_tpu_torch.examples.pagerank_dist")
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--damping", type=float, default=0.85)
    ap.add_argument("--tol", type=float, default=1e-8)
    ap.add_argument("--maxiter", type=int, default=200)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    from ..cli.common import cuda_missing, setup_devices
    if cuda_missing(args.device):
        return 2
    with setup_devices(args.devices, args.device) as (mesh, _):
        return _run(args, mesh)


def _run(args, mesh) -> int:
    import numpy as np
    import torch

    from ..cli.common import all_ranks_ok
    from ..io.generate import webbase_like
    from ..parallel import partition_xfoot, sync_to_host
    from ..solvers import pagerank
    from ..utils.timing import timed
    from .pagerank import pagerank_numpy, transition

    say = print if mesh.rank == 0 else (lambda *a, **k: None)
    dev, n_dev = mesh.device, mesh.size
    times: dict = {}
    with timed("build graph", times):
        A = webbase_like(n=args.n, dtype=np.float64)
        PT, dangling = transition(A, np.float64)
    with timed("partition (xfoot)", times, device=dev):
        shards = partition_xfoot(PT, n_dev, dtype=torch.float64, device=dev,
                                 rank=mesh.rank)
        st = shards.stats
        say(f"xfoot: kind={shards.kind}, hot {st.hot_total} cols, "
            f"packets {st.packet_pad}/pair, extract {st.extract_mode}, "
            f"exchange {st.comm_bytes(8) / 1e3:.1f} KB/device/iter "
            f"(full vector would be {PT.shape[0] * 8 / 1e3:.1f} KB)")
    n = PT.shape[0]
    with timed("power iteration", times, device=dev):
        res = pagerank(shards, n, dangling=torch.from_numpy(dangling).to(dev),
                       damping=args.damping, tol=args.tol,
                       maxiter=args.maxiter,
                       r0=torch.full((n,), 1.0 / n, dtype=torch.float64,
                                     device=dev), mesh=mesh)
    r = sync_to_host(res.x, mesh, 0)
    top = np.argsort(-r)[:5]
    say(f"converged in {res.iterations} iterations on {n_dev} devices "
        f"(L1 delta {res.residual:.2e})")
    say("top ranks:", ", ".join(f"#{i}={r[i]:.3e}" for i in top))
    err = float(np.abs(r - pagerank_numpy(PT, dangling, args.damping,
                                          args.tol)).sum())
    say(f"sum(r) = {r.sum():.6f} (should be ~1), L1 distance to the "
        f"float64 host power iteration {err:.2e}")
    ok = all_ranks_ok(abs(r.sum() - 1.0) < 1e-6 and res.converged
                      and err <= 10 * args.tol, mesh)
    for name, ms in times.items():
        say(f"{name} = {ms:.1f} ms")
    say(f"Validation = {ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
