"""Kernel P1's body at other settings and designs, on one CUDA device.

    python -m sblas_tpu_torch.tools.p1_variants [--variants a,b]

P1 (`stage_fuse_kernel`, csrc/probe_kernels.cu) gives one warp a whole
128-lane tile row: the row's gidx, gvals and i1 and the tile's gslab
in one round trip, the slab row's values through L1 in a second, route
pass 1 on the products in shared memory.  This tool builds copies of
the source with the text patches in `VARIANTS` (another block size; the
output stored through the value pack, which the compiler splits into
4-byte stores; the slab row staged in shared memory by 16-byte vectors
before the products, alone and at 8 rows a block; route pass 1 by warp
shuffles instead of shared memory; the body this one replaced, one
thread a slot with three dependent round trips) into `_build/` (one
`nvcc` per copy, all started together), and times each copy's
`sblas_stage_fuse_gather_f32` in one process on the tables of
`tools.p1_shapes.plans()` (the full webbase-1M plan, the xfoot worst
shards at 4 and 16) and on the n=16 shard's first tile alone.
Every copy's result must equal the plain version bitwise.

Prints one line per copy: registers and static shared memory of the f32
kernel (`nvcc -Xptxas -v`) and the device ms at each shape (medians of
50 event pairs around 10 launches); then the card's name and power
limit.  Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from .. import _kernels
from ..experiments.stage_fuse_probe import (pass1_operands,
                                            stage_fuse_gather_plain)
from ..utils.timing import device_time_ms
from .p1_shapes import SEED, plans

_L1_READ = """  // round trip 2: slab row r, read through L1 where each product needs it
  const T* x = x_slabs + (s * kLanes + (g % kLanes)) * kLanes;
"""
# the slab row staged in shared memory by 16-byte vectors first
_STAGED = """  // round trip 2: slab row r into shared memory
  __shared__ __align__(16) T xrow[kRows][kLanes];
  const T* x = x_slabs + (s * kLanes + (g % kLanes)) * kLanes;
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    const int c = n * 32 * kV + lane * kV;
    *reinterpret_cast<Vals*>(&xrow[w][c]) =
        *reinterpret_cast<const Vals*>(x + c);
  }
  __syncwarp();
"""
_PASS1_SMEM = """    *reinterpret_cast<Vals*>(&contrib[w][c]) = p;
  }
  __syncwarp();
  // route pass 1 on the row's products
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    const int c = n * 32 * kV + lane * kV;
    Vals o;
#pragma unroll
    for (int k = 0; k < kV; ++k) o.v[k] = contrib[w][ii[n].v[k] & 127];
    store_vec(out + base + c, o);
  }"""
# route pass 1 by warp shuffles: each output takes the lane's four
# products from the owner lane of its slot and keeps the one it names
_PASS1_SHFL = """    pv[n] = p;
  }
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    const int c = n * 32 * kV + lane * kV;
    Vals o;
#pragma unroll
    for (int k = 0; k < kV; ++k) {
      const int src = ii[n].v[k] & 127;
      const int owner = src % (32 * kV) / kV;
      const int q = src / (32 * kV) * kV + src % kV;
      T r = T(0);
#pragma unroll
      for (int m = 0; m < kN * kV; ++m) {
        const T a = __shfl_sync(0xffffffffu, pv[m / kV].v[m % kV], owner);
        if (m == q) r = a;
      }
      o.v[k] = r;
    }
    store_vec(out + base + c, o);
  }"""
_NEW_BODY_START = "template <typename T>\n__global__ void __launch_bounds__"
_NEW_LAUNCH = """    const auto blocks =
        static_cast<unsigned int>(n_tiles * (kLanes / kRows));
    stage_fuse_kernel<T><<<blocks, kRows * 32, 0,"""
# the body this one replaced: one thread a slot, 4 slots a thread,
# T_g x 16 blocks
_PER_SLOT_KERNEL = """template <typename T>
__global__ void stage_fuse_kernel_per_slot(const int32_t* __restrict__ gslab,
                                      const T* __restrict__ x_slabs,
                                      const int32_t* __restrict__ gidx,
                                      const T* __restrict__ gvals,
                                      const int32_t* __restrict__ i1,
                                      T* __restrict__ out) {
  constexpr int kSlab = 128 * 128, kPerBlock = kSlab / 16;
  const int64_t t = blockIdx.x;
  const T* slab = x_slabs + static_cast<int64_t>(gslab[t]) * kSlab;
  const int64_t base = t * kSlab;
#pragma unroll
  for (int k = 0; k < kPerBlock / kThreads; ++k) {
    const int e = blockIdx.y * kPerBlock + k * kThreads + threadIdx.x;
    const int row = e >> 7;
    const int64_t src = base + ((row << 7) | (i1[base + e] & 127));
    out[base + e] = gvals[src] * slab[(row << 7) | (gidx[src] & 127)];
  }
}

"""
_PER_SLOT_LAUNCH = """    const dim3 blocks(static_cast<unsigned int>(n_tiles), 16);
    stage_fuse_kernel_per_slot<T><<<blocks, kThreads, 0,"""


def _rows(n: int):
    """A patch setting P1's rows a block (`kRows`) to n."""
    return (re.compile(r"constexpr int kRows = \d+;"),
            f"constexpr int kRows = {n};")


# name -> [(text in csrc/probe_kernels.cu, or a compiled pattern; its
# replacement)], applied in order
VARIANTS = {
    "source": [],
    "rows2": [_rows(2)],
    "rows8": [_rows(8)],
    "rows16": [_rows(16)],
    # the output stored through the Pack itself, which the compiler split
    # into four 4-byte stores a lane
    "pack_store": [("    store_vec(out + base + c, o);",
                    "    *reinterpret_cast<Vals*>(out + base + c) = o;")],
    "staged_x": [(_L1_READ, _STAGED),
                 ("p.v[k] = gv[n].v[k] * x[gi[n].v[k] & 127];",
                  "p.v[k] = gv[n].v[k] * xrow[w][gi[n].v[k] & 127];")],
    "shfl_pass1": [(_PASS1_SMEM, _PASS1_SHFL),
                   ("  Vals gv[kN];\n", "  Vals gv[kN], pv[kN];\n")],
    "per_slot_body": [(_NEW_BODY_START, _PER_SLOT_KERNEL + _NEW_BODY_START),
                 (_NEW_LAUNCH, _PER_SLOT_LAUNCH)],
}
VARIANTS["staged_x_rows8"] = VARIANTS["staged_x"] + VARIANTS["rows8"]


def _source(patches) -> str:
    with open(os.path.join(_kernels.CSRC_DIR, "probe_kernels.cu")) as fh:
        src = fh.read()
    for old, new in patches:
        if isinstance(old, str):
            if src.count(old) != 1:
                raise RuntimeError(f"patch text not found once: "
                                   f"{old[:60]!r}")
            src = src.replace(old, new)
        else:
            src, n = old.subn(new, src)
            if n != 1:
                raise RuntimeError(f"{old.pattern} not found once")
    return src


def _usage(report: str) -> tuple:
    """(registers, static shared bytes) of the f32 P1 kernel."""
    for entry in report.split("Compiling entry function")[1:]:
        head = entry.splitlines()[0]
        if "stage_fuse_kernel" in head and "IfE" in head:
            regs = re.search(r"Used (\d+) registers", entry)
            smem = re.search(r"(\d+) bytes smem", entry)
            return int(regs.group(1)), int(smem.group(1)) if smem else 0
    raise RuntimeError("the f32 P1 kernel is not in the ptxas report")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated variants (default: all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("p1_variants needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    tags = [t for t in args.variants.split(",") if t]
    jobs = {tag: _source(VARIANTS[tag]) for tag in tags}
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(
            lambda kv: _kernels.build_copy(f"p1_{kv[0]}", kv[1]),
            jobs.items())))
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    shapes = {}
    for title, plan in plans(dev):
        x = torch.rand(plan.shape[1], generator=gen, device=dev)
        shapes[title] = pass1_operands(plan, x)
    gslab, x_slabs, gidx, gvals, i1 = shapes["xfoot shard n=16"]
    shapes["one tile"] = (gslab[:1], x_slabs, gidx[:1], gvals[:1], i1[:1])
    want = {k: stage_fuse_gather_plain(*a) for k, a in shapes.items()}
    stream = torch.cuda.current_stream(dev).cuda_stream
    ok = True
    for tag in tags:
        so, report = built[tag]
        if so is None:
            err = [ln for ln in report.splitlines() if "error" in ln]
            print(f"P1 {tag}: build failed: {err[:2]}", flush=True)
            ok = False
            continue
        fn = ctypes.CDLL(so).sblas_stage_fuse_gather_f32
        fn.argtypes = _kernels.LAUNCHERS["stage_fuse_gather"][0] + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        times = {}
        for key, a in shapes.items():
            out = torch.empty_like(a[3])
            argv = [t.data_ptr() for t in a] + [out.data_ptr(),
                                                a[0].shape[0], stream]

            def run():
                rc = fn(*argv)
                if rc != 0:
                    raise RuntimeError(f"launch failed: cudaError {rc}")

            out.zero_()
            run()
            torch.cuda.synchronize()
            if not torch.equal(out, want[key]):
                raise RuntimeError(f"{tag} at {key} differs from the plain "
                                   f"version")
            times[key] = device_time_ms(run, reps=50, inner=10)
        regs, smem = _usage(report)
        print(f"P1 {tag}: registers={regs} static_smem_bytes={smem} "
              + " ".join(f"{k.replace(' ', '_')}_ms={v:.5f}"
                         for k, v in times.items()), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
