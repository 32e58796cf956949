"""Kernel P1 at the shapes its fused SpMV gives it, on one CUDA device.

    python -m sblas_tpu_torch.tools.p1_shapes

P1 (`experiments.stage_fuse_probe.stage_fuse_gather`, csrc/probe_kernels.cu)
on the tables of three routed plans of the webbase-1M proxy
(`webbase_like()`, f32): the full plan (`make_plan`'s routed plan, 188 gather
tiles) and the xfoot worst shards at 4 and 16 shards
(`xfoot_worst_local` -> `RoutedPlan.from_csr(min_*)`, 53 and 14 tiles),
each on `pass1_operands(plan, x)` for a random x.  Each line: P1's device
ms, bitwise equality with its plain version and the plain version's ms,
its bound (the operands and the output in bytes once over 3.35 TB/s) and
share, and beside it the stock path's kernels on the same plan: K2
(`slab_gather`) and K1 (`lane_shuffle`) on the first route layer's tile
rows.  Then what a launch costs at the n=16 shard: P1 on that plan's
first tile alone, and a 1-element `zero_` (one PyTorch fill kernel), the
floor of back-to-back launches on this stream.

Device ms are medians of 50 event pairs around 10 launches each
(`utils.timing.device_time_ms`); x is random from seed 211.  Only the
package's public calls are used, so the same file runs against an older
checkout of the package, for parent / change / change / parent turns.
Prints the card's name and power limit last.  Exits 1 without a card.
"""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch

from ..experiments.stage_fuse_probe import (pass1_operands,
                                            stage_fuse_gather,
                                            stage_fuse_gather_plain)
from ..io.generate import webbase_like
from ..ops import make_plan
from ..ops.route import LANES, lane_shuffle
from ..ops.rspmv import RoutedPlan, slab_gather
from ..parallel.xfoot import xfoot_worst_local
from ..utils.timing import device_time_ms

SEED = 211
HBM_BYTES_PER_S = 3.35e12


def _ms(fn) -> float:
    return device_time_ms(fn, reps=50, inner=10)


def _bound_ms(*tensors) -> float:
    return sum(t.numel() * t.element_size() for t in tensors) \
        / HBM_BYTES_PER_S * 1e3


def plans(dev) -> list:
    """(title, plan) of the full webbase-1M plan and the two worst
    shards."""
    A = webbase_like(dtype=np.float32)
    out = [("full plan", make_plan(A, dtype=torch.float32, force="routed",
                                   device=dev))]
    for n in (4, 16):
        local, (tg, srs, prs, sks) = xfoot_worst_local(A, n)
        out.append((f"xfoot shard n={n}", RoutedPlan.from_csr(
            local, dtype=torch.float32, min_gtiles=tg, min_srows=srs,
            min_prows=prs, min_sranks=sks, device=dev)))
    return out


def p1_line(title, plan, gen) -> tuple:
    x = torch.rand(plan.shape[1], generator=gen, device=plan.gslab.device)
    args = pass1_operands(plan, x)
    gslab, x_slabs, gidx, gvals, i1 = args
    got = stage_fuse_gather(*args)
    same = torch.equal(got, stage_fuse_gather_plain(*args))
    ms = _ms(lambda: stage_fuse_gather(*args))
    bnd = _bound_ms(*args, got)
    contrib = slab_gather(gslab, x_slabs, gidx, gvals).reshape(-1, LANES)
    k2_ms = _ms(lambda: slab_gather(gslab, x_slabs, gidx, gvals))
    i1_2d = i1.reshape(-1, LANES)
    k1_ms = _ms(lambda: lane_shuffle(contrib, i1_2d))
    print(f"P1 {title}: n_gtiles={plan.n_gtiles} "
          f"n_slabs={x_slabs.shape[0]} ms={ms:.5f} bitwise_equal={same} "
          f"plain_ms={_ms(lambda: stage_fuse_gather_plain(*args)):.5f} "
          f"bound_ms={bnd:.5f} bound_by=bytes share={bnd / ms:.3f} "
          f"K2_ms={k2_ms:.5f} K1_tile_rows_ms={k1_ms:.5f}", flush=True)
    return same, args


def latency_line(args) -> None:
    gslab, x_slabs, gidx, gvals, i1 = args
    one = (gslab[:1], x_slabs, gidx[:1], gvals[:1], i1[:1])
    p1_one = _ms(lambda: stage_fuse_gather(*one))
    z = torch.zeros(1, device=x_slabs.device)
    print(f"launch floor: P1 one tile ms={p1_one:.5f} "
          f"zero_1_elem_ms={_ms(lambda: z.zero_()):.5f}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("p1_shapes needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    ok = True
    for title, plan in plans(dev):
        same, args = p1_line(title, plan, gen)
        ok &= same
    latency_line(args)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
