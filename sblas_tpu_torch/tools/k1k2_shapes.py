"""Kernels K1 and K2 at the shapes the routed SpMV gives them, on one CUDA
device.

    python -m sblas_tpu_torch.tools.k1k2_shapes

The tables of three routed plans of the webbase-1M proxy
(`tools.p1_shapes.plans()`: the full plan and the xfoot worst shards at 4
and 16): K1 (`lane_shuffle`) on each plan's first main-route layer,
(32768, 128), (8192, 128) and (2048, 128), in its four variants (f32,
f64 and bf16 values on the int32 table, bf16 on the table as int16); K2
(`slab_gather`) on each plan's 188, 53 and 14 tiles in its four variants
(f32, f64, bf16, f32 stored as bf16).  Each line: device ms, bitwise
equality with the plain version, the bound (each operand read once and
the output written once, over 3.35 TB/s) and share, `torch.gather`'s ms
beside K1, and the host microseconds a launch costs the caller (100
launches enqueued back to back).
Then K1 as the routes launch it: the n=4 and n=16 shards' whole main
route (`apply_route`: its K1 layers, on the card each transpose stored
by the K1 launch before it; in an older checkout a copy); the stock SpMV of each shard (`spmv_routed`) and of the full plan
(`spmv`), in device ms and in wall ms per synchronous call (the call and
a synchronize, median of 50 after 5 warm-ups); and a 1-element `zero_`,
the floor of back-to-back launches.

Device ms are medians of 50 event pairs around 10 launches each
(`utils.timing.device_time_ms`); values are random from seed 211.  Only
the package's public calls are used, so the same file runs against an
older checkout of the package, for parent / change / change / parent
turns.  Prints the card's name and power limit last.  Exits 1 without a
card, or if a kernel differs from its plain version.
"""

from __future__ import annotations

import functools
import subprocess
import sys
import time

import numpy as np
import torch

from ..ops import spmv
from ..ops.route import LANES, apply_route, lane_shuffle, lane_shuffle_plain
from ..ops.rspmv import (SLAB, slab_gather, slab_gather_plain, spmv_routed)
from ..utils.timing import device_time_ms, wall_time_ms
from .p1_shapes import SEED, plans

HBM_BYTES_PER_S = 3.35e12
BF16 = torch.bfloat16
# K1: (value dtype, index dtype); K2: (value dtype, stored dtype).  The
# package's own tables (`ops.route.LANE_SHUFFLE_VARIANTS`,
# `ops.rspmv.SLAB_GATHER_VARIANTS`) are not imported: older checkouts,
# which this tool is run against, do not have them.
K1_VARIANTS = {"f32": (torch.float32, torch.int32),
               "f64": (torch.float64, torch.int32),
               "bf16": (BF16, torch.int32), "bf16_i16": (BF16, torch.int16)}
K2_VARIANTS = {"f32": (torch.float32, None), "f64": (torch.float64, None),
               "bf16": (BF16, None), "f32_bf16": (torch.float32, BF16)}


def _ms(fn) -> float:
    return device_time_ms(fn, reps=50, inner=10)


def _wall(fn) -> float:
    return wall_time_ms(fn, warmup=5, reps=50)


def host_us(fn, launches: int = 100, reps: int = 7) -> float:
    """Median host microseconds of one `fn()` call, from `launches` calls
    enqueued back to back after a synchronize (the device may still run
    them when the clock stops): the wrapper's own cost per launch."""
    ts = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(launches):
            fn()
        ts.append((time.perf_counter() - t0) * 1e6 / launches)
    return float(np.median(ts[1:]))


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def k1_operands(plan, dt, it, gen):
    """K1 on the plan's first main-route layer: (x2d, idx)."""
    idx = plan.tables[0].reshape(-1, LANES).to(it)
    x2d = torch.rand(idx.shape, generator=gen, device=idx.device).to(dt)
    return x2d, idx


def k2_operands(plan, dt, gen):
    """K2 on the plan's tiles: (gslab, x_slabs, gidx, gvals)."""
    n_slabs = -(-plan.shape[1] // SLAB)
    x_slabs = torch.rand((n_slabs, LANES, LANES), generator=gen,
                         device=plan.gslab.device).to(dt)
    return plan.gslab, x_slabs, plan.gidx, plan.gvals.to(dt)


def kernel_line(title, kernel, variant, run, plain, moved, lib=None):
    got = run()
    same = torch.equal(got, plain())
    ms = _ms(run)
    bnd = (_nbytes(*moved) + _nbytes(got)) / HBM_BYTES_PER_S * 1e3
    extra = f" gather_ms={_ms(lib):.5f}" if lib is not None else ""
    print(f"{kernel}[{variant}] {title}: shape={tuple(got.shape)} "
          f"ms={ms:.5f} bitwise_equal={same} bound_ms={bnd:.5f} "
          f"share={bnd / ms:.3f}{extra} host_us={host_us(run):.2f}",
          flush=True)
    return same


def main() -> int:
    if not torch.cuda.is_available():
        print("k1k2_shapes needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    ok = True
    built = plans(dev)
    for title, plan in built:
        for variant, (dt, it) in K1_VARIANTS.items():
            x2d, idx = k1_operands(plan, dt, it, gen)
            idx32 = idx.to(torch.int32)
            ok &= kernel_line(
                title, "K1", variant, lambda: lane_shuffle(x2d, idx),
                lambda: lane_shuffle_plain(x2d, idx), (x2d, idx),
                lambda: torch.gather(x2d, 1, idx32))
        for variant, (dt, ot) in K2_VARIANTS.items():
            args = k2_operands(plan, dt, gen)
            ok &= kernel_line(
                title, "K2", variant, lambda: slab_gather(*args, ot),
                lambda: slab_gather_plain(*args, ot), args)
    for title, plan in built:
        x = torch.rand(plan.shape[1], generator=gen, device=dev)
        y = torch.rand(plan.shape[0], generator=gen, device=dev)
        if title.startswith("xfoot"):
            contrib = torch.rand(plan.route_n, generator=gen, device=dev)
            k1 = sum(op[0] == "gather" for op in plan.schedule)
            route_ms = _ms(lambda: apply_route(plan.schedule, contrib,
                                               plan.tables))
            run = functools.partial(spmv_routed, plan, x, 3.0, 4.0, y)
            print(f"route {title}: route_n={plan.route_n} k1_layers={k1} "
                  f"ops={len(plan.schedule)} main_route_ms={route_ms:.5f} "
                  f"stock_spmv_ms={_ms(run):.5f} "
                  f"stock_spmv_wall_ms={_wall(run):.5f}", flush=True)
        else:
            run = functools.partial(spmv, plan, x, 3.0, 4.0, y)
            print(f"spmv {title}: n_gtiles={plan.n_gtiles} "
                  f"spmv_ms={_ms(run):.5f} spmv_wall_ms={_wall(run):.5f}",
                  flush=True)
    z = torch.zeros(1, device=dev)
    print(f"launch floor: zero_1_elem_ms={_ms(lambda: z.zero_()):.5f}",
          flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
