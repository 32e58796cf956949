"""Stage-fusion probe: the routed SpMV with the main route's first pass
fused into the slab gather, on an xfoot worst shard of webbase-1M.

    python -m sblas_tpu_torch.experiments.stage_fuse_probe [n_shards=16]
        [--check-only] [--device cuda|cpu]

Port of `experiments/stage_fuse_probe.py`.  The main route's first op is
always a row-local lane shuffle (`build_route` emits idx1 first), so it
can fold into the gather's store: kernel P1 (`stage_fuse_gather`,
csrc/probe_kernels.cu) writes the products already in pass-1 order,
which removes one full read and write of the tile region.  The input of
the route is [tiles | peel | pad]:

* tile rows: fused in P1;
* peel rows: one small lane shuffle (kernel K1) over the n_prows x 128
  block;
* pad rows: zeros, which any row-local permutation leaves zero, so pass 1
  needs no work there.

The remaining route passes go through `apply_route` (K1), the reduce is
the stock one.  The shard is `xfoot_worst_local(webbase_like(1M), n)`'s,
its plan `RoutedPlan.from_csr(min_*)` through the plan cache under
`.bench_cache/`.  The gate: on the CPU the fused SpMV equals the stock one
bitwise; on CUDA (whose `index_add_` adds with atomics) P1's tiles equal
K2 followed by K1's first layer bitwise, and both SpMVs pass the oracle
and agree at the 1e-3 relative bar.  Then both are timed (device and
wall ms on CUDA, host ms on the CPU), unless `--check-only`.
"""

from __future__ import annotations

import sys

import numpy as np
import torch
import torch.nn.functional as F

from .. import _kernels
from ..ops.route import LANES, apply_route, lane_shuffle
from ..ops.rspmv import (RoutedPlan, peel_contrib, reduce_routed,
                         slab_gather, x_slabs_of)

USAGE = ("usage: python -m sblas_tpu_torch.experiments.stage_fuse_probe "
         "[n_shards=16] [--check-only] [--device cuda|cpu]")


def stage_fuse_gather_plain(gslab, x_slabs, gidx, gvals, i1
                            ) -> torch.Tensor:
    """Plain PyTorch P1: kernel K2's product, then route pass 1 along the
    lanes: out[t, r, j] = contrib[t, r, i1[t, r, j]] with contrib[t, r, c]
    = gvals[t, r, c] * x_slabs[gslab[t], r, gidx[t, r, c]]."""
    tiles = torch.index_select(x_slabs, 0, gslab)
    return torch.gather(gvals * torch.gather(tiles, 2, gidx), 2, i1)


def stage_fuse_gather(gslab, x_slabs, gidx, gvals, i1) -> torch.Tensor:
    """The slab gather fused with route pass 1 (see
    `stage_fuse_gather_plain`) over (T_g, 128, 128) tiles.  CPU tensors
    take the plain version; CUDA tensors launch kernel P1
    (csrc/probe_kernels.cu) or raise.  P1 reads gidx, gvals and i1 as
    16-byte vectors, so each must start on 16 bytes (gslab and x_slabs
    are read one value at a time)."""
    if x_slabs.device.type == "cpu":
        return stage_fuse_gather_plain(gslab, x_slabs, gidx, gvals, i1)
    from ..utils.errors import KernelError, require
    dev = x_slabs.device
    require(dev.type == "cuda", KernelError,
            f"stage_fuse_gather runs on cpu or cuda, not {dev}")
    fn = _kernels.launcher("stage_fuse_gather", _kernels.value_suffix(x_slabs.dtype))
    require(x_slabs.dim() == 3 and tuple(x_slabs.shape[1:]) == (LANES, LANES),
            KernelError, f"x_slabs must be (n_slabs, {LANES}, {LANES}), "
            f"got {tuple(x_slabs.shape)}")
    T_g = gslab.shape[0]
    tile_shape = (T_g, LANES, LANES)
    _kernels.check_operand(gslab, "gslab", torch.int32, (T_g,), dev)
    _kernels.check_operand(x_slabs, "x_slabs", x_slabs.dtype, x_slabs.shape,
                           dev)
    _kernels.check_operand(gidx, "gidx", torch.int32, tile_shape, dev)
    _kernels.check_operand(gvals, "gvals", x_slabs.dtype, tile_shape, dev)
    _kernels.check_operand(i1, "i1", torch.int32, tile_shape, dev)
    for name, t in (("gidx", gidx), ("gvals", gvals), ("i1", i1)):
        require(t.data_ptr() % 16 == 0, KernelError,
                f"{name} must start on 16 bytes for P1's vector loads "
                f"(data_ptr % 16 = {t.data_ptr() % 16})")
    out = torch.empty(tile_shape, dtype=x_slabs.dtype, device=dev)
    _kernels.launch(fn, dev, gslab, x_slabs, gidx, gvals, i1, out, T_g)
    stage_fuse_gather.launches += 1
    return out


stage_fuse_gather.launches = 0   # P1 launches since the last reset


def pass1_operands(plan: RoutedPlan, x: torch.Tensor):
    """(gslab, x_slabs, gidx, gvals, i1): P1's operands for `plan` and
    `x`, i1 being the main route's first table cut to the tile rows."""
    T_g = plan.n_gtiles
    i1 = plan.tables[0][: T_g * LANES].reshape(T_g, LANES, LANES)
    return (plan.gslab, x_slabs_of(plan, x), plan.gidx,
            plan.gvals.to(x.dtype), i1)


def pass1_tiles_stock(plan: RoutedPlan, x: torch.Tensor) -> torch.Tensor:
    """What P1 computes, the stock way: kernel K2, then K1 applying route
    pass 1 to the tile rows."""
    gslab, x_slabs, gidx, gvals, i1 = pass1_operands(plan, x)
    contrib = slab_gather(gslab, x_slabs, gidx, gvals)
    return lane_shuffle(contrib.reshape(-1, LANES),
                        i1.reshape(-1, LANES)).reshape(contrib.shape)


def spmv_routed_fused1(plan: RoutedPlan, x: torch.Tensor, alpha, beta,
                       y: torch.Tensor) -> torch.Tensor:
    """`spmv_routed` with route pass 1 fused into the gather (kernel
    P1)."""
    from ..utils.errors import PlanError, require
    require(plan.schedule[0][0] == "gather", PlanError,
            "pass-1 fusion requires the main route to start with a gather")
    require(plan.transport == "f32", PlanError,
            "P1 has no bf16 transport variant (the JAX probe has none)")
    tiles1 = stage_fuse_gather(*pass1_operands(plan, x))
    parts = [tiles1.reshape(-1)]
    if plan.n_prows:
        r_t = plan.n_gtiles * LANES
        idxp = plan.tables[0][r_t: r_t + plan.n_prows]
        parts.append(lane_shuffle(peel_contrib(plan, x), idxp).reshape(-1))
    contrib1 = torch.cat(parts) if len(parts) > 1 else parts[0]
    # the pad rows are zeros, which pass 1 leaves zero
    contrib1 = F.pad(contrib1, (0, plan.route_n - contrib1.shape[0]))
    routed = apply_route(plan.schedule[1:], contrib1, plan.tables[1:])
    return beta * y + alpha * reduce_routed(plan, routed)


def _times_us(fn, device) -> str:
    from ..utils.timing import device_time_ms, host_time_ms, wall_time_ms
    if device.type == "cuda":
        return (f"{device_time_ms(fn, reps=50, inner=10) * 1e3:.1f} us "
                f"device, {wall_time_ms(fn, reps=50) * 1e3:.1f} us wall")
    return f"{host_time_ms(fn) * 1e3:.1f} us cpu host"


def main(argv=None) -> int:
    from ..cli.common import cuda_missing, flag_value
    from ..containers import DenseVector
    from ..io.generate import webbase_like
    from ..io.plancache import cached_plan
    from ..ops.cpu_reference import spmv_cpu
    from ..ops.rspmv import spmv_routed
    from ..parallel.xfoot import xfoot_worst_local
    from ..utils.verify import check_equal

    argv = sys.argv[1:] if argv is None else argv
    device = flag_value(argv, "--device", "cuda", usage=USAGE)
    if device not in ("cuda", "cpu"):
        print(USAGE, file=sys.stderr)
        return 2
    if cuda_missing(device):
        return 2
    dev = torch.device(device)
    check_only = "--check-only" in argv
    pos = [a for i, a in enumerate(argv)
           if not a.startswith("-") and (i == 0 or argv[i - 1] != "--device")]
    n_shards = int(pos[0]) if pos else 16

    W = webbase_like(n=1_000_000, dtype=np.float32)
    local, (tg, srs, prs, sks) = xfoot_worst_local(W, n_shards)
    plan = cached_plan(
        f".bench_cache/webbase_xfoot_shard{n_shards}_f32_torch_v1.npz",
        lambda: RoutedPlan.from_csr(local, dtype=torch.float32,
                                    min_gtiles=tg, min_srows=srs,
                                    min_prows=prs, min_sranks=sks,
                                    device=dev),
        valid=lambda p: (p.shape == local.shape and p.nnz == local.nnz
                         and p.n_gtiles >= tg and p.n_srows >= srs
                         and p.n_prows >= prs),
        device=dev)
    print(f"# shard: {local.shape} nnz={local.nnz}, route_n="
          f"{plan.route_n}, schedule[0]={plan.schedule[0]}, "
          f"{len(plan.schedule)} main ops", file=sys.stderr)

    xv = DenseVector.random(local.shape[1], dtype=np.float32)
    x = torch.from_numpy(xv.values).to(dev)
    y0 = torch.zeros(local.shape[0], dtype=torch.float32, device=dev)
    want = spmv_routed(plan, x, 1.0, 0.0, y0).cpu().numpy()
    got = spmv_routed_fused1(plan, x, 1.0, 0.0, y0).cpu().numpy()
    if dev.type == "cpu":
        rep = check_equal(got, want, error_bar=0.0)
        ok = rep.ok
        print(f"# fused-vs-stock exactness: {rep}", file=sys.stderr)
    else:
        # index_add_ adds with atomics on CUDA: the reduce's order varies,
        # so the bitwise gate moves to pass 1, the part P1 replaces
        tiles_ok = torch.equal(stage_fuse_gather(*pass1_operands(plan, x)),
                               pass1_tiles_stock(plan, x))
        rep = check_equal(got, want, relative=True)
        oracle = spmv_cpu(local, xv, 1.0, 0.0, DenseVector(
            np.zeros(local.shape[0], np.float32)))
        rep_s = check_equal(want, oracle, relative=True)
        rep_f = check_equal(got, oracle, relative=True)
        ok = tiles_ok and rep.ok and rep_s.ok and rep_f.ok
        print(f"# pass-1 tiles P1 vs K2+K1 bitwise: {tiles_ok}; "
              f"fused-vs-stock: {rep}; oracle: stock {rep_s.ok}, fused "
              f"{rep_f.ok}", file=sys.stderr)
    if not ok:
        print("# ABORT: fused pipeline differs", file=sys.stderr)
        return 1
    if check_only:
        return 0

    t_stock = _times_us(lambda: spmv_routed(plan, x, 1.0, 1.0, y0), dev)
    t_fused = _times_us(lambda: spmv_routed_fused1(plan, x, 1.0, 1.0, y0),
                        dev)
    print(f"# n={n_shards} heaviest shard: stock {t_stock}; fused "
          f"(gather+route-pass-1) {t_fused}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
