"""Kernels K1 and K2 at other bodies and launches, on one CUDA device.

    python -m sblas_tpu_torch.tools.k1k2_variants [--variants a,b]
    python -m sblas_tpu_torch.tools.k1k2_variants --wall

K1 (`csrc/route_kernels.cu`) and K2 (`csrc/rspmv_kernels.cu`) give one
warp a whole 128-lane row, load its operands as vectors and launch with
programmatic dependent launch (PDL).  This tool builds copies of the two
sources with the text patches in `VARIANTS` into `_build/` (one `nvcc`
per copy, all started together) and times each copy's launchers, every
value variant, in one process on the tables of `tools.p1_shapes.plans()`
(K1 on the first main-route layer of the full webbase-1M plan and of the
xfoot worst shards at 4 and 16: (32768, 128), (8192, 128), (2048, 128);
K2 on their 188, 53 and 14 tiles).  The patches: other warps a block
(`kWarps`) and, for K2, rows a warp (`kPerWarp`); K1 gathering x
through L1 after its idx (two round trips), K1 exchanging the row by
warp shuffles, K2's slab row loaded as vectors and exchanged in shared
memory or by shuffles; the PDL trigger after the stores instead of
after the loads; the tables (K1's idx, K2's gslab and gidx) loaded
before the wait; the row body launched plainly.  Every copy's result
must equal the plain version bitwise.  `patched_sources()` applies every patch without
a compiler, so a CPU test catches a patch that no longer matches.

Prints one line per copy and value variant: the registers of the copy's
f32 kernel (`nvcc -Xptxas -v`), the device ms at each shape (medians
of 50 event pairs around 10 launches back to back) and the host
microseconds one call of the launcher costs at the last shape (through
ctypes, no wrapper: `k1k2_shapes.host_us`), which sets a launch mode's
host cost beside the plain launch's; then the card's name and power
limit.  `--wall` instead times the routed SpMV's wall per synchronous
call with K1 and K2 launched with PDL and plainly, in turns in one
process (`wall_turns`).  Exits 1 without a card or if a copy fails.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

from .. import _kernels
from ..ops.route import LANE_SHUFFLE_VARIANTS as K1_VARIANTS
from ..ops.route import lane_shuffle_plain
from ..ops.rspmv import SLAB_GATHER_VARIANTS as K2_VARIANTS
from ..ops.rspmv import slab_gather_plain
from ..utils.timing import device_time_ms, wall_time_ms
from .k1k2_shapes import host_us, k1_operands, k2_operands
from .p1_shapes import SEED, plans

# ---- K1 (route_kernels.cu) ----
_K1_SMEM = """    // the row through shared memory, read back where the indices say
#pragma unroll
    for (int n = 0; n < S::kVecs; ++n) {
      *reinterpret_cast<Vals*>(&row[w][S::lane0(n, lane)]) = xv[n];
    }
"""
_K1_SYNC = ("  __syncwarp();\n  pdl_trigger();\n", "  pdl_trigger();\n")
_K1_READ = ("      for (int k = 0; k < S::kSpan; ++k) o.v[k] = "
            "row[w][iv[n].v[k] & 127];\n")
_K1_XLOAD = "      xv[n] = *reinterpret_cast<const Vals*>(x + at);\n"
# the output's source among the warp's values: lane `owner`, value q
_OWNER = """const int owner = src % (kLanes / S::kVecs) / S::kSpan;
        const int q = src / (kLanes / S::kVecs) * S::kSpan + src % S::kSpan;"""
_K1_SHFL_READ = """      for (int k = 0; k < S::kSpan; ++k) {
        const int src = iv[n].v[k] & 127;
        """ + _OWNER + """
        T v = xv[0].v[0];
#pragma unroll
        for (int m = 0; m < S::kVecs * S::kSpan; ++m) {
          const T a = __shfl_sync(0xffffffffu,
                                  xv[m / S::kSpan].v[m % S::kSpan], owner);
          if (m == q) v = a;
        }
        o.v[k] = v;
      }
"""
_K1_WAIT = ("  pdl_wait();\n  // one trip to memory: the row's indices and "
            "values together\n")
_K1_IDX_FIRST = """  if (r < rows) {
#pragma unroll
    for (int n = 0; n < S::kVecs; ++n) {
      iv[n] = *reinterpret_cast<const Idx*>(idx + r * kLanes +
                                            S::lane0(n, lane));
    }
  }
"""
_K1_IDX_LOAD = "      iv[n] = *reinterpret_cast<const Idx*>(idx + at);\n"
_K1_END = "\n}\n\ntemplate <typename T, typename I>\nint launch("
_K1_ROWS_LAUNCH = """    sblas::launch_pdl(lane_shuffle_rows<T, I>,
                      dim3(static_cast<unsigned int>(
                          (rows + kWarps<T> - 1) / kWarps<T>)),
                      dim3(kWarps<T> * 32), stream, x, idx, out, rows);"""

# ---- K2 (rspmv_kernels.cu) ----
_K2_WAIT = """  pdl_wait();
  // round trip 1: the tile's slab and the rows' gidx and gvals
  const int64_t s = gslab[g0 / kLanes];
"""
_K2_GIDX_LOAD = ("      gi[p][n] = *reinterpret_cast<const Pack<int32_t, "
                 "S::kSpan>*>(gidx + at);\n")
_K2_GIDX_FIRST = """  const int64_t s = gslab[g0 / kLanes];
#pragma unroll
  for (int p = 0; p < kPerWarp<T>; ++p) {
#pragma unroll
    for (int n = 0; n < S::kVecs; ++n) {
      gi[p][n] = *reinterpret_cast<const Pack<int32_t, S::kSpan>*>(
          gidx + (g0 + p) * kLanes + S::lane0(n, lane));
    }
  }
  pdl_wait();
"""
_K2_ROUND2 = ("  // round trip 2: slab row r through L1, where each product "
              "needs it\n")
_K2_X = ("    const T* x = x_slabs + (s * kLanes + (g0 + p) % kLanes) * "
         "kLanes;\n")
_K2_STAGED = """  // round trip 2: the slab rows into shared memory
  __shared__ __align__(16) T xrow[kWarps<T>][kPerWarp<T>][kLanes];
#pragma unroll
  for (int p = 0; p < kPerWarp<T>; ++p) {
    const T* xs = x_slabs + (s * kLanes + (g0 + p) % kLanes) * kLanes;
#pragma unroll
    for (int n = 0; n < S::kVecs; ++n) {
      const int c = S::lane0(n, lane);
      *reinterpret_cast<Pack<T, S::kSpan>*>(&xrow[w][p][c]) =
          *reinterpret_cast<const Pack<T, S::kSpan>*>(xs + c);
    }
  }
  __syncwarp();
"""
_K2_PRODUCT = """        o[p][n].v[k] = narrow<O>(widen(gv[p][n].v[k]) *
                                 widen(x[gi[p][n].v[k] & 127]));
"""
_K2_SHFL_PRODUCT = """        const int src = gi[p][n].v[k] & 127;
        """ + _OWNER + """
        T v = xv[0].v[0];
#pragma unroll
        for (int m = 0; m < S::kVecs * S::kSpan; ++m) {
          const T a = __shfl_sync(0xffffffffu,
                                  xv[m / S::kSpan].v[m % S::kSpan], owner);
          if (m == q) v = a;
        }
        o[p][n].v[k] = narrow<O>(widen(gv[p][n].v[k]) * widen(v));
"""
_K2_XV = _K2_X + """    Pack<T, S::kSpan> xv[S::kVecs];
#pragma unroll
    for (int n = 0; n < S::kVecs; ++n) {
      xv[n] = *reinterpret_cast<const Pack<T, S::kSpan>*>(
          x + S::lane0(n, lane));
    }
"""
_K2_TRIGGER = ("  pdl_trigger();\n#pragma unroll\n"
               "  for (int p = 0; p < kPerWarp<T>; ++p) {\n#pragma unroll\n"
               "    for (int n = 0; n < S::kVecs; ++n) {\n"
               "      sblas::store_vec(")
_K2_END = ("\n}\n\ntemplate <typename T, typename O>\n"
           "__global__ void tile_gather_kernel(")
_K2_ROWS_LAUNCH = """    sblas::launch_pdl(slab_gather_rows<T, O>,
                      dim3(static_cast<unsigned int>(
                          n_tiles * (kLanes / (kWarps<T> * kPerWarp<T>)))),
                      dim3(kWarps<T> * 32), stream, gslab, x_slabs, gidx,
                      gvals, out);"""


def _shape(warps: int = None, per_warp: int = None) -> list:
    """Patches setting the row body's warps a block and (K2) rows a warp,
    each unless None."""
    out = []
    if per_warp is not None:
        out.append((re.compile(r"constexpr int kPerWarp = [^;]+;"),
                    f"constexpr int kPerWarp = {per_warp};"))
    if warps is not None:
        out.append((re.compile(r"constexpr int kWarps = [^;]+;"),
                    f"constexpr int kWarps = {warps};"))
    return out


def _plain(launch: str, kernel: str, grid: str, block: str,
           args: str) -> tuple:
    """A patch launching `kernel` with <<<>>> instead of `launch_pdl`."""
    return (launch, f"    {kernel}<<<{grid}, {block}, 0, "
            f"static_cast<cudaStream_t>(stream)>>>({args});")


_K1_NO_PDL = _plain(_K1_ROWS_LAUNCH, "lane_shuffle_rows<T, I>",
                    "static_cast<unsigned int>((rows + kWarps<T> - 1) / "
                    "kWarps<T>)", "kWarps<T> * 32", "x, idx, out, rows")
_K2_NO_PDL = _plain(_K2_ROWS_LAUNCH, "slab_gather_rows<T, O>",
                    "static_cast<unsigned int>(n_tiles * (kLanes / "
                    "(kWarps<T> * kPerWarp<T>)))", "kWarps<T> * 32",
                    "gslab, x_slabs, gidx, gvals, out")

VARIANTS_OF = {"lane_shuffle": K1_VARIANTS,
                        "slab_gather": K2_VARIANTS}
_K1, _K2 = ("lane_shuffle", "route_kernels.cu"), ("slab_gather",
                                                   "rspmv_kernels.cu")
# name -> (kernel, source, [(text or compiled pattern, replacement)])
VARIANTS = {
    "k1": (*_K1, []),
    "k1_w4": (*_K1, _shape(4)),
    "k1_w8": (*_K1, _shape(8)),
    "k1_w16": (*_K1, _shape(16)),
    "k1_w32": (*_K1, _shape(32)),
    "k1_l1_gather": (*_K1, [
        (_K1_XLOAD, ""), (_K1_SMEM, ""), _K1_SYNC,
        (_K1_READ, "      for (int k = 0; k < S::kSpan; ++k)\n"
                   "        o.v[k] = __ldg(x + r * kLanes + "
                   "(iv[n].v[k] & 127));\n")]),
    "k1_shfl": (*_K1, [(_K1_SMEM, ""), _K1_SYNC,
                       (_K1_READ, _K1_SHFL_READ)]),
    "k1_trigger_end": (*_K1, [
        ("  __syncwarp();\n  pdl_trigger();\n", "  __syncwarp();\n"),
        (_K1_END, "\n  pdl_trigger();" + _K1_END)]),
    "k1_tables_first": (*_K1, [(_K1_IDX_LOAD, ""),
                               (_K1_WAIT, _K1_IDX_FIRST + _K1_WAIT)]),
    "k1_no_pdl": (*_K1, [_K1_NO_PDL]),
    "k2": (*_K2, []),
    "k2_p1": (*_K2, _shape(None, 1)),
    "k2_w4": (*_K2, _shape(4, 1)),
    "k2_w8": (*_K2, _shape(8, 1)),
    "k2_w16": (*_K2, _shape(16, 1)),
    "k2_w32": (*_K2, _shape(32, 1)),
    "k2_w4_p2": (*_K2, _shape(4, 2)),
    "k2_w8_p2": (*_K2, _shape(8, 2)),
    "k2_w8_p4": (*_K2, _shape(8, 4)),
    "k2_w16_p2": (*_K2, _shape(16, 2)),
    "k2_staged": (*_K2, [(_K2_ROUND2, _K2_STAGED),
                         (_K2_X, "    const T* x = xrow[w][p];\n")]),
    "k2_shfl": (*_K2, [(_K2_X, _K2_XV), (_K2_PRODUCT, _K2_SHFL_PRODUCT)]),
    "k2_trigger_end": (*_K2, [
        (_K2_TRIGGER, _K2_TRIGGER.replace("  pdl_trigger();\n", "")),
        (_K2_END, "\n  pdl_trigger();" + _K2_END)]),
    "k2_tables_first": (*_K2, [(_K2_GIDX_LOAD, ""),
                               (_K2_WAIT, _K2_GIDX_FIRST)]),
    "k2_no_pdl": (*_K2, [_K2_NO_PDL]),
}


def _source(name: str, patches) -> str:
    with open(os.path.join(_kernels.CSRC_DIR, name)) as fh:
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


def patched_sources() -> dict:
    """name -> the copy's source, for every copy in `VARIANTS`; raises if
    a patch does not match the sources exactly once."""
    return {tag: _source(src, patches)
            for tag, (_, src, patches) in VARIANTS.items()}


def _registers(report: str, kernel: str) -> str:
    """Registers of the copy's f32 kernel."""
    tag = {"lane_shuffle": "IfiE", "slab_gather": "IffE"}[kernel]
    out = []
    for entry in report.split("Compiling entry function")[1:]:
        head = entry.splitlines()[0]
        if tag in head:
            regs = re.search(r"Used (\d+) registers", entry)
            out.append(regs.group(1) if regs else "?")
    return ",".join(out)


def _shapes(dev) -> dict:
    """title -> (K1 operands by variant, K2 operands by variant)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    out = {}
    for title, plan in plans(dev):
        out[title] = (
            {v: k1_operands(plan, dt, it, gen)
             for v, (dt, it) in K1_VARIANTS.items()},
            {v: k2_operands(plan, dt, gen)
             for v, (dt, _) in K2_VARIANTS.items()})
    return out


def _time_copy(fn, kernel, variant, args, out) -> tuple:
    """Run the copy's launcher once against the plain version, then time
    it: (device ms, host microseconds a launch); `args` are the kernel's
    tensor operands, `out` its output."""
    if kernel == "lane_shuffle":
        x2d, idx = args
        argv = [x2d.data_ptr(), idx.data_ptr(), out.data_ptr(), x2d.numel()]
        want = lane_shuffle_plain(x2d, idx)
    else:
        argv = [t.data_ptr() for t in args] + [out.data_ptr(),
                                               args[0].shape[0]]
        want = slab_gather_plain(*args, K2_VARIANTS[variant][1])
    argv.append(torch.cuda.current_stream().cuda_stream)

    def run():
        rc = fn(*argv)
        if rc != 0:
            raise RuntimeError(f"launch failed: cudaError {rc}")

    out.zero_()
    run()
    torch.cuda.synchronize()
    if not torch.equal(out, want):
        raise RuntimeError("differs from the plain version")
    return device_time_ms(run, reps=50, inner=10), host_us(run)


def _launchers(so: str, kernel: str) -> dict:
    """A copy's launchers of `kernel`, by name, typed as the package's."""
    lib = ctypes.CDLL(so)
    out = {}
    for variant in VARIANTS_OF[kernel]:
        name = f"sblas_{kernel}_{variant}"
        fn = getattr(lib, name)
        fn.argtypes = _kernels.LAUNCHERS[kernel][0] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out[name] = fn
    return out


def wall_turns(built: dict, dev, turns: int = 8) -> None:
    """The routed SpMV's wall ms per synchronous call (full plan and both
    shards: `wall_time_ms`, median of 50 after 5 warm-ups) in one
    process, with the package's own K1 and K2 (PDL launch) and with the
    copies `k1_no_pdl` and `k2_no_pdl` (the same bodies launched
    plainly) put in their place on the package's library, turn by turn:
    pdl, plain, plain, pdl, ...  What the launch mode alone does to the
    wall, the wrappers and everything else being the same."""
    from ..ops import spmv
    from ..ops.rspmv import spmv_routed
    lib = _kernels.library()
    modes = {"pdl": {}, "plain": {}}
    for tag, kernel in (("k1_no_pdl", "lane_shuffle"),
                        ("k2_no_pdl", "slab_gather")):
        plain = _launchers(built[tag][0], kernel)
        modes["plain"].update(plain)
        modes["pdl"].update({name: getattr(lib, name) for name in plain})
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    calls = []
    for title, plan in plans(dev):
        x = torch.rand(plan.shape[1], generator=gen, device=dev)
        y = torch.rand(plan.shape[0], generator=gen, device=dev)
        call = spmv if title == "full plan" else spmv_routed
        calls.append((title, functools.partial(call, plan, x, 3.0, 4.0, y)))
    order = ["pdl", "plain", "plain", "pdl"] * (turns // 4)
    for i, mode in enumerate(order):
        for name, fn in modes[mode].items():
            setattr(lib, name, fn)
        walls = " ".join(
            f"{title.replace(' ', '_')}_wall_ms="
            f"{wall_time_ms(run, warmup=5, reps=50):.5f}"
            for title, run in calls)
        print(f"wall turn {i + 1} {mode}: {walls}", flush=True)
    for name, fn in modes["pdl"].items():
        setattr(lib, name, fn)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated copies (default: all)")
    ap.add_argument("--wall", action="store_true",
                    help="only the routed SpMV's wall with K1 and K2 "
                    "launched with PDL and plainly, in turns "
                    "(`wall_turns`)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k1k2_variants needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    if args.wall:
        args.variants = "k1_no_pdl,k2_no_pdl"
    tags = [t for t in args.variants.split(",") if t]
    jobs = {tag: _source(VARIANTS[tag][1], VARIANTS[tag][2])
            for tag in tags}
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(
            lambda kv: _kernels.build_copy(f"k1k2_{kv[0]}", kv[1]),
            jobs.items())))
    if args.wall:
        if any(so is None for so, _ in built.values()):
            print("a copy failed to build", file=sys.stderr)
            return 1
        wall_turns(built, dev)
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60).stdout.strip())
        return 0
    shapes = _shapes(dev)
    ok = True
    for tag in tags:
        kernel = VARIANTS[tag][0]
        so, report = built[tag]
        if so is None:
            err = [ln for ln in report.splitlines() if "error" in ln]
            print(f"{tag}: build failed: {err[:2]}", flush=True)
            ok = False
            continue
        launchers = _launchers(so, kernel)
        for variant in VARIANTS_OF[kernel]:
            fn = launchers[f"sblas_{kernel}_{variant}"]
            times = []
            try:
                for title, (k1_ops, k2_ops) in shapes.items():
                    ops = (k1_ops if kernel == "lane_shuffle"
                           else k2_ops)[variant]
                    if kernel == "lane_shuffle":
                        out = torch.empty_like(ops[0])
                    else:
                        out = torch.empty(
                            ops[2].shape, device=dev,
                            dtype=K2_VARIANTS[variant][1] or ops[1].dtype)
                    ms, us = _time_copy(fn, kernel, variant, ops, out)
                    times.append(f"{title.replace(' ', '_')}_ms={ms:.5f}")
                times.append(f"host_us={us:.2f}")
            except RuntimeError as e:
                print(f"{tag}[{variant}]: {e}", flush=True)
                ok = False
                continue
            print(f"{tag}[{variant}]: registers="
                  f"{_registers(report, kernel)} " + " ".join(times),
                  flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
