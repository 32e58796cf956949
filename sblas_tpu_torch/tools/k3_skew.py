"""Row skew against kernel K3 (windowed reduce) on one CUDA device.

    python -m sblas_tpu_torch.tools.k3_skew

Times K3 and a bare `index_select` of the same B rows (the gather alone)
at K = 64 and 32 on three 1M-row f32 matrices: the webbase proxy (rows
of up to 2,990 entries), the same matrix with every row cut to its first
64 entries, and a uniform 3-per-row matrix.  K3 cuts the entries into
units of a fixed slot count whatever the row lengths, so the webbase and
cut matrices should take about the same time; the ratio of the two is
printed per K.  Each case is timed with the tables cut at 128- and
256-slot units (the plan's are `UNIT`; the ratio uses them).  Prints one
line per case and the card's name and power limit.  Exits 1 without a
card.
"""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch

from ..containers import CooMatrix
from ..io.generate import uniform_random, webbase_like
from ..ops.wcoo import K3Schedule, UNIT, WcooPlan, k3_tables, window_reduce
from ..utils.timing import device_time_ms


def _rows_cut(A, cap: int):
    """A with each row cut to its first `cap` entries."""
    keep = (np.arange(A.nnz) - np.repeat(A.row_ptr[:-1], A.row_nnz)) < cap
    c = A.to_coo()
    return CooMatrix(c.row_idx[keep], c.col_idx[keep], c.values[keep],
                     A.shape).to_csr()


def _schedule(p: WcooPlan, unit: int) -> K3Schedule:
    """`p.k3` with its tables cut at `unit`-slot units."""
    t = k3_tables(*(getattr(p, k).cpu().numpy() for k in
                    ("wb", "relrow", "vals", "xblk", "lane")),
                  p.n_row_blocks, unit=unit)
    return K3Schedule(torch.from_numpy(t["k3_units"]).to(p.device),
                      torch.from_numpy(t["k3_rows"]).to(p.device),
                      p.n_row_blocks)


def main() -> int:
    if not torch.cuda.is_available():
        print("k3_skew needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    W = webbase_like(dtype=np.float32)
    cases = {"webbase": W, "webbase_rows_cut_64": _rows_cut(W, 64),
             "uniform_3_per_row": uniform_random(1_000_000, 1_000_000, 3,
                                                 dtype=np.float32)}
    times = {}
    for name, A in cases.items():
        p = WcooPlan.from_csr(A, dtype=torch.float32, device=dev)
        scheds = {u: p.k3 if u == UNIT else _schedule(p, u)
                  for u in (128, 256)}
        cols = p.xblk.long() * 128 + p.lane
        for k in (64, 32):
            B = torch.rand((A.shape[1], k), device=dev)
            ms = {}
            for u, sched in scheds.items():
                args = (sched, p.wb, p.relrow, p.vals, p.xblk, p.lane, B, 0,
                        k)
                ms[f"k3_unit{u}_ms"] = device_time_ms(
                    lambda: window_reduce(*args), reps=10, inner=5)
            gather = device_time_ms(lambda: torch.index_select(B, 0, cols),
                                    reps=10, inner=5)
            times[name, k] = ms[f"k3_unit{UNIT}_ms"]
            print(f"{name}: nnz={A.nnz} max_row={int(A.row_nnz.max())} "
                  f"tiles={p.n_tiles} units={p.k3_units.shape[0]} "
                  f"unit={UNIT} K={k} "
                  + " ".join(f"{lb}={v:.5f}" for lb, v in ms.items())
                  + f" index_select_ms={gather:.5f}", flush=True)
    for k in (64, 32):
        print(f"webbase / webbase_rows_cut_64 at K={k}: "
              f"{times['webbase', k] / times['webbase_rows_cut_64', k]:.3f}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
