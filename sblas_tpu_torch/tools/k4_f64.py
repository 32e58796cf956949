"""Kernel K4[f64] at the band-73 plan's shapes, on one CUDA device.

    python -m sblas_tpu_torch.tools.k4_f64 [--variants a,b] [--label L]

K4[f64] (`sblas_bell_spmm_f64`, csrc/bsr_kernels.cu) runs the BELL SpMM
`beta*C + alpha*A@B` in f64.  Without `--variants` this tool times it
through the public wrapper `ops.bsr_pallas.bell_spmm` on the full
band-73 plan (`fem_banded_like()`, 707 block rows of 3 slots, f64
values) at K = 256 (the BELL SpMM's K4 width; even K and aligned
operands) and K = 263 (an odd K: 8-byte row stride), each held to its
plain version (1e-12 normwise, two launches bitwise equal), beside the
plain version's time, `torch.addmm` on the same matrix as an f64 CSR
tensor, and the bound: bytes (each operand once) at 3.35 TB/s or the
FLOPs at the f64 tensor cores' 67 TFLOP/s, whichever is larger, the
CUDA cores' 33.5 TFLOP/s bound beside it.  Public calls only, so a copy
of this file runs on an older checkout (a `git archive` of the parent)
for parent / change / change / parent turns on one card.

`--variants` builds copies of the source with the text patches in
`VARIANTS` (the mma.sync shape: sm_80's m8n8k4, m16n8k4, m16n8k8,
m16n8k16; the ring's depth and its chunks; one 8-warp block an SM;
32 x 32 warp tiles) into `_build/` (one `nvcc
-Xptxas -v` per copy, all started together) and times each copy's
`sblas_bell_spmm_f64` at the same shapes in one process, with each
DMMA kernel's registers and spill bytes.  Every copy must meet the same
1e-12 bar.  `--ablations` does the same for `ABLATIONS`, copies that
leave a part of the work out (the epilogue's C and out traffic, the
products, the ring's refills) to show what the rest costs; their
results are wrong by design and not checked.

Prints one line per reading and, last, the card's name and power limit.
Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import _kernels
from ..io.generate import fem_banded_like
from ..ops.bsr import BsrPlan
from ..ops.bsr_pallas import bell_spmm, bell_spmm_plain
from ..utils.timing import device_time_ms

ALPHA, BETA = 3.0, 4.0
SEED = 16
WIDTHS = (256, 263)
HBM_BYTES_PER_S = 3.35e12
FP64_TC_FLOPS = 67e12    # H100 SXM data sheet: f64 tensor cores, dense
FP64_FLOPS = 33.5e12     # the same: f64 on the CUDA cores
TOL = 1e-12


def _kd(n: int):
    return ("constexpr int kDK = 4;", f"constexpr int kDK = {n};")


_DEPTH16 = ("constexpr int kDTK = 32;", "constexpr int kDTK = 16;")
_STAGES3 = ("constexpr int kDStages = 2;", "constexpr int kDStages = 3;")
_STAGES4 = ("constexpr int kDStages = 2;", "constexpr int kDStages = 4;")
_WARPS_N4 = ("constexpr int kDWarpsN = 2;", "constexpr int kDWarpsN = 4;")
_ONE_BLOCK = ("constexpr int kDBlocksPerSM = 2;",
              "constexpr int kDBlocksPerSM = 1;")
_MT2 = ("constexpr int kDMT = 4;", "constexpr int kDMT = 2;")

# name -> [(text in csrc/bsr_kernels.cu, its replacement)], applied in
# order
VARIANTS = {
    "source": [],
    "m8n8k4": [_kd(0)],
    "m16n8k8": [_kd(8)],
    "m16n8k16": [_kd(16)],
    "depth16_stages3": [_DEPTH16, _STAGES3],
    # one block an SM, 128 x 128 on 8 warps: 32-deep chunks in 3 stages
    # (the best such copy); and the first design, m16n8k8 on 16-deep
    # chunks in 4 stages
    "one_block": [_WARPS_N4, _ONE_BLOCK, _STAGES3],
    "one_block_first": [_WARPS_N4, _ONE_BLOCK, _DEPTH16, _STAGES4, _kd(8)],
    # 32 x 32 warp tiles (32 accumulators a thread): two 8-warp blocks an
    # SM on 128 x 64 tiles; one 16-warp block on 128 x 128 tiles
    "warps8_two_blocks": [_MT2],
    "warps8_two_blocks_depth16_stages3": [_MT2, _DEPTH16, _STAGES3],
    "warps16_one_block": [_MT2, _WARPS_N4, _ONE_BLOCK, _STAGES3],
    "warps16_one_block_stages2": [_MT2, _WARPS_N4, _ONE_BLOCK],
}
# name -> patches of a copy that leaves part of the work out
ABLATIONS = {
    # no C read, no out written (a test on the sums keeps the products)
    "no_epilogue": [(
        "            i * kBlock + wm * 16 * kDMT + mt * 16 + g + 8 * h;\n"
        "        if (row >= m) continue;",
        "            i * kBlock + wm * 16 * kDMT + mt * 16 + g + 8 * h;\n"
        "        if (row >= m || acc[mt][0][2 * h] != -1.25e300) continue;")],
    # one f64 FMA a tile in place of the products
    "no_mma": [("            dmma<kDK>(acc[mt][nt], af[mt], bf[nt]);",
                "            acc[mt][nt][0] += af[mt][0] * bf[nt][0];")],
    # the ring filled once, never refilled
    "no_feed": [("      if (gs + kDStages - 1 < steps) "
                 "load(gs + kDStages - 1);\n", "")],
}


def patched_source(patches) -> str:
    with open(os.path.join(_kernels.CSRC_DIR, "bsr_kernels.cu")) as fh:
        src = fh.read()
    for old, new in patches:
        if src.count(old) != 1:
            raise RuntimeError(f"patch text not found once: {old[:60]!r}")
        src = src.replace(old, new)
    return src


def dmma_resources(report: str) -> list:
    """(registers, spill stores, spill loads) of each DMMA kernel
    instantiation in a `-Xptxas -v` report."""
    return [(r["registers"], r["spill_stores"], r["spill_loads"])
            for r in _kernels.kernel_resources(report,
                                               "bell_spmm_dmma_kernel")]


def _ms(fn) -> float:
    return device_time_ms(fn, reps=20, inner=10)


def _rel(got, want) -> float:
    return float((got - want).abs().max()) / max(
        1.0, float(want.abs().max()))


def operands(dev) -> tuple:
    """The band-73 plan at f64 and, for each K in WIDTHS, (B, C), made
    from SEED; and A as an f64 CSR tensor for `torch.addmm`."""
    A = fem_banded_like(dtype=np.float64)
    plan = BsrPlan.from_csr(A, dtype=torch.float64, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    bc = {k: (torch.rand((A.shape[1], k), generator=gen, device=dev,
                         dtype=torch.float64),
              torch.rand((A.shape[0], k), generator=gen, device=dev,
                         dtype=torch.float64)) for k in WIDTHS}
    csr = torch.sparse_csr_tensor(
        torch.from_numpy(A.row_ptr), torch.from_numpy(A.col_idx),
        torch.from_numpy(A.values), size=A.shape, device=dev,
        check_invariants=False)
    return A, plan, bc, csr


def bound(plan, n_blocks: int, B, C) -> dict:
    nbytes = sum(t.numel() * t.element_size()
                 for t in (plan.vals, plan.bcol, B, C, C))
    flops = 2 * n_blocks * 128 * 128 * B.shape[1]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_tc = flops / FP64_TC_FLOPS * 1e3
    return dict(bound_ms=max(t_bytes, t_tc),
                bound_by="bytes" if t_bytes >= t_tc else "operations",
                cuda_core_bound_ms=max(t_bytes, flops / FP64_FLOPS * 1e3),
                mbytes=nbytes / 1e6, gflop=flops / 1e9)


def public_lines(label, A, plan, bc, csr) -> None:
    from ..ops.bsr import bell_stats
    n_blocks = bell_stats(A)["n_blocks"]
    for k, (B, C) in bc.items():
        args = (plan.vals, plan.bcol, B, C, ALPHA, BETA)
        got, again = bell_spmm(*args), bell_spmm(*args)
        want = bell_spmm_plain(*args)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"K4[f64] K={k}: two launches differ")
        rel = _rel(got, want)
        if rel > TOL:
            raise AssertionError(f"K4[f64] K={k}: {rel:.3e} from plain")
        del got, again, want
        ms = _ms(lambda: bell_spmm(*args))
        plain_ms = _ms(lambda: bell_spmm_plain(*args))
        lib_ms = _ms(lambda: torch.addmm(C, csr, B, beta=BETA, alpha=ALPHA))
        bnd = bound(plan, n_blocks, B, C)
        print(f"K4[f64] tree={label} K={k} n_brows={plan.vals.shape[0]} "
              f"slots={plan.slots} n_blocks={n_blocks} rel_err={rel:.3e} "
              f"ms={ms:.5f} plain_ms={plain_ms:.5f} addmm_ms={lib_ms:.5f} "
              f"bound_ms={bnd['bound_ms']:.5f} bound_by={bnd['bound_by']} "
              f"share={bnd['bound_ms'] / ms:.3f} "
              f"cuda_core_bound_ms={bnd['cuda_core_bound_ms']:.5f} "
              f"mbytes={bnd['mbytes']:.1f} gflop={bnd['gflop']:.3f}",
              flush=True)


def variant_lines(tags, A, plan, bc, ablate=()) -> bool:
    """One line a copy: each tag of `tags` (VARIANTS, checked) and of
    `ablate` (ABLATIONS, unchecked)."""
    from ..ops.bsr import bell_stats
    n_blocks = bell_stats(A)["n_blocks"]
    jobs = {tag: patched_source(VARIANTS[tag]) for tag in tags}
    jobs.update({tag: patched_source(ABLATIONS[tag]) for tag in ablate})
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(
            lambda kv: _kernels.build_copy(f"k4f64_{kv[0]}", kv[1]),
            jobs.items())))
    dev = plan.vals.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    want = {k: bell_spmm_plain(plan.vals, plan.bcol, B, C, ALPHA, BETA)
            for k, (B, C) in bc.items()}
    ok = True
    for tag in jobs:
        checked = tag not in ablate
        so, report = built[tag]
        if so is None:
            err = [ln for ln in report.splitlines() if "error" in ln]
            print(f"K4[f64] variant={tag}: build failed: {err[:3]}",
                  flush=True)
            ok = False
            continue
        fn = ctypes.CDLL(so).sblas_bell_spmm_f64
        fn.argtypes = _kernels.LAUNCHERS["bell_spmm"][0] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        res = dmma_resources(report)
        cells = []
        for k, (B, C) in bc.items():
            out = torch.empty_like(C)
            argv = [plan.vals.data_ptr(), plan.bcol.data_ptr(),
                    B.data_ptr(), C.data_ptr(), out.data_ptr(),
                    plan.vals.shape[0], plan.slots, C.shape[0], B.shape[0],
                    k, ALPHA, BETA, stream]

            def run():
                rc = fn(*argv)
                if rc != 0:
                    raise RuntimeError(f"launch failed: cudaError {rc}")

            run()
            torch.cuda.synchronize()
            rel = _rel(out, want[k])
            if checked and rel > TOL:
                print(f"K4[f64] variant={tag} K={k}: {rel:.3e} from plain",
                      flush=True)
                ok = False
                continue
            ms = _ms(run)
            share = bound(plan, n_blocks, B, C)["bound_ms"] / ms
            cells.append(f"K{k}_ms={ms:.5f} K{k}_share={share:.3f} "
                         f"K{k}_rel_err={rel:.3e}")
        spill = any(s or ld for _, s, ld in res)
        kind = "variant" if checked else "ablation (unchecked)"
        print(f"K4[f64] {kind}={tag} dmma_kernels(registers, spill "
              f"stores, spill loads)={res} spill={spill} " + " ".join(cells),
              flush=True)
        ok = ok and not spill
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default="",
                    help="comma-separated source variants to build and "
                         "time (default: none; the public wrapper only)")
    ap.add_argument("--ablations", default="",
                    help="comma-separated ablations to build and time")
    ap.add_argument("--label", default="this",
                    help="the tree's name on the public lines")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k4_f64 needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    A, plan, bc, csr = operands(dev)
    tags = [t for t in args.variants.split(",") if t]
    ablate = [t for t in args.ablations.split(",") if t]
    ok = (variant_lines(tags, A, plan, bc, ablate) if tags or ablate
          else True)
    public_lines(args.label, A, plan, bc, csr)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
