"""Row skew against kernel K3 (windowed reduce) on one CUDA device.

    python -m sblas_tpu_torch.tools.k3_skew

Times K3 and a bare `index_select` of the same B rows (the gather alone)
at K = 64 and 32 on three 1M-row matrices: the webbase proxy (rows of up
to 2,990 entries), the same matrix with every row cut to its first 64
entries, and a uniform 3-per-row matrix.  K3 cuts the entries into units
of a fixed slot count whatever the row lengths, so the webbase and cut
matrices should take about the same time; the ratio of the two is
printed per K.  Each case runs an f32 plan and a bf16 plan.  K3 is timed
in the grid form with the tables cut at several unit sizes (f32: 128
and 256 slots; bf16, whose `bf16` variant walks a unit with 8 lanes: 32,
64 and 128; the plan's are `k3_unit`'s, and the ratio uses them), and in the
fused form (`C`, alpha = 3, beta = 4) at the plan's tables; at webbase x
K=64 the fused call's device time is split between K3's two launches
(the unit pass and the carry combine) by a torch.profiler window.
Prints one line per case, dtype and K, naming the variant launched, and
the card's name and power limit.  Exits 1 without a card.
"""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch

from .. import _kernels
from ..containers import CooMatrix
from ..io.generate import uniform_random, webbase_like
from ..ops.wcoo import (K3Schedule, WcooPlan, k3_tables, k3_unit,
                        window_reduce)
from ..utils.timing import device_time_ms


def _rows_cut(A, cap: int):
    """A with each row cut to its first `cap` entries."""
    keep = (np.arange(A.nnz) - np.repeat(A.row_ptr[:-1], A.row_nnz)) < cap
    c = A.to_coo()
    return CooMatrix(c.row_idx[keep], c.col_idx[keep], c.values[keep],
                     A.shape).to_csr()


def _schedule(p: WcooPlan, unit: int) -> K3Schedule:
    """`p.k3` with its tables cut at `unit`-slot units."""
    t = k3_tables(*(getattr(p, k).cpu().float().numpy() if k == "vals"
                    else getattr(p, k).cpu().numpy() for k in
                    ("wb", "relrow", "vals", "xblk", "lane")),
                  p.n_row_blocks, unit=unit)
    return K3Schedule(torch.from_numpy(t["k3_units"]).to(p.device),
                      torch.from_numpy(t["k3_rows"]).to(p.device),
                      p.n_row_blocks)


def _split_ms(fn, reps: int = 20) -> dict:
    """Device ms per call of K3's two launches (the unit pass, the carry
    combine) in `fn`, from a torch.profiler window of `reps` calls."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = (getattr(e, "device_time_total", 0)
              or getattr(e, "cuda_time_total", 0))
        for label, kernel in (("units_ms", "unit_reduce"),
                              ("combine_ms", "carry_combine")):
            if kernel in e.key:
                out[label] = out.get(label, 0.0) + us / reps / 1e3
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("k3_skew needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    W = webbase_like(dtype=np.float32)
    cases = {"webbase": W, "webbase_rows_cut_64": _rows_cut(W, 64),
             "uniform_3_per_row": uniform_random(1_000_000, 1_000_000, 3,
                                                 dtype=np.float32)}
    units = {torch.float32: (128, 256), torch.bfloat16: (32, 64, 128)}
    times = {}
    for name, A in cases.items():
        for dtype, sizes in units.items():
            p = WcooPlan.from_csr(A, dtype=dtype, device=dev)
            unit = k3_unit(dtype)
            scheds = {u: p.k3 if u == unit else _schedule(p, u)
                      for u in sizes}
            cols = p.xblk.long() * 128 + p.lane
            for k in (64, 32):
                B = torch.rand((A.shape[1], k), device=dev).to(dtype)
                C = torch.rand((A.shape[0], k), device=dev).to(dtype)
                out = torch.empty_like(C)
                ms = {}
                for u, sched in scheds.items():
                    args = (sched, p.wb, p.relrow, p.vals, p.xblk, p.lane,
                            B, 0, k)
                    ms[f"k3_unit{u}_ms"] = device_time_ms(
                        lambda: window_reduce(*args), reps=10, inner=5)
                args = (p.k3, p.wb, p.relrow, p.vals, p.xblk, p.lane, B, 0,
                        k)
                _kernels.LAUNCHED.clear()
                ms["k3_fused_ms"] = device_time_ms(
                    lambda: window_reduce(*args, C=C, alpha=3.0, beta=4.0,
                                          out=out), reps=10, inner=5)
                variants = sorted(v[len("sblas_window_reduce_"):]
                                  for v in _kernels.LAUNCHED)
                gather = device_time_ms(
                    lambda: torch.index_select(B, 0, cols), reps=10,
                    inner=5)
                times[name, dtype, k] = ms[f"k3_unit{unit}_ms"]
                print(f"{name}: dtype={str(dtype)[6:]} nnz={A.nnz} "
                      f"max_row={int(A.row_nnz.max())} tiles={p.n_tiles} "
                      f"units={p.k3_units.shape[0]} unit={unit} K={k} "
                      f"variant={','.join(variants)} "
                      + " ".join(f"{lb}={v:.5f}" for lb, v in ms.items())
                      + f" index_select_ms={gather:.5f}", flush=True)
                if name == "webbase" and k == 64:
                    split = _split_ms(lambda: window_reduce(
                        *args, C=C, alpha=3.0, beta=4.0, out=out))
                    print(f"{name}: dtype={str(dtype)[6:]} K={k} fused, "
                          f"device ms by launch: " + " ".join(
                              f"{lb}={v:.5f}" for lb, v in split.items()),
                          flush=True)
            del p, scheds, cols, B, C, out
    for dtype in units:
        for k in (64, 32):
            ratio = (times["webbase", dtype, k]
                     / times["webbase_rows_cut_64", dtype, k])
            print(f"webbase / webbase_rows_cut_64 {str(dtype)[6:]} K={k}: "
                  f"{ratio:.3f}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
