"""K3[bf16_ragged]'s ring body at other batches and feeds, on one CUDA device.

    python -m sblas_tpu_torch.tools.k3_ring [--own-only] [--ablations a,b]

The `ring` body of kernel K3's `bf16_ragged` variant
(csrc/wcoo_kernels.cu) brings each entry's covering words of B into a
per-warp shared-memory ring by cp.async, `kRingBatch` entries a group at
a time, one batch ahead of the batch it sums.  This tool builds copies
of the kernel source at other batches (`SETTINGS`), and the ablations in
`ABLATIONS` (each a text patch of the source: a choice the body did not
keep, such as a bulk copy an entry on an mbarrier, or a part of it cut
out to see what it costs), into `_build/` (one `nvcc` per copy, all
started together), and times each copy's
`sblas_window_reduce_bf16_ragged` on the webbase-1M bf16 plan at the
operands the bf16 WCOO SpMM gives it:

- K = 63: one call, k0 = 0, 63 columns, B, C and out of row stride 63
  (and the same call in the grid form, out of row stride 63);
- K = 100: the two calls of the JAX package's chunk width (81 + 19
  columns, row stride 100), one after another into one out.

Each setting's result, and each kept-choice ablation's, must equal the
package's own build bitwise (they sum in the same order).  Prints one
line per copy: registers, spill bytes and static shared memory of the
ring kernel (`nvcc -Xptxas -v`), the blocks an SM those allow, the B
bytes an SM has in flight (warps x 4 groups x batch x 128), and the
device ms (medians of 20 event pairs around 10 launches); then the
card's name and power limit.  Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import _kernels
from ..io.generate import webbase_like
from ..ops import make_plan
from ..ops.wcoo import k_chunk_width, ragged_body, window_reduce
from ..utils.timing import device_time_ms

BF16 = torch.bfloat16
ALPHA, BETA = 3.0, 4.0
SEED = 211
# (batch,); the source's own setting is timed first
SETTINGS = [(1,), (2,)]
NAMES = ("kRingBatch",)
# load8 / store8 of the group_store ablation
_GROUP_HELPERS = """// The first n (1..8) of the eight bf16 at p, which lies on any 2 bytes:
// one 16-byte load where p is on 16 and n is 8, else the 4-byte words
// that hold them (none past the n-th element), shifted as in read8.
// Elements from n on are not the caller's.
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* p, int n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if ((a & 15) == 0 && n == 8) return *reinterpret_cast<const uint4*>(p);
  const uint32_t* q = reinterpret_cast<const uint32_t*>(a & ~uintptr_t(3));
  const int odd = (a >> 1) & 1;
  uint32_t w[5];
#pragma unroll
  for (int k = 0; k < 5; ++k) w[k] = 2 * k - odd < n ? q[k] : 0u;
  const uint32_t sel = odd ? 0x5432 : 0x3210;
  return make_uint4(__byte_perm(w[0], w[1], sel), __byte_perm(w[1], w[2], sel),
                    __byte_perm(w[2], w[3], sel), __byte_perm(w[3], w[4], sel));
}

// Store the first n (1..8) of y's eight bf16 at p (any 2 bytes): one
// 16-byte store where p is on 16 and n is 8, else 4-byte stores on
// 4-byte words and 2-byte stores at the ends.  No evict-first hint: a
// row's first and last 32-byte sectors are shared with its neighbours',
// stored by other warps, and a sector evicted half written costs the L2
// a fill from device memory (tools/k3_ring.py, `cs_store`).
__device__ __forceinline__ void store8(__nv_bfloat16* p, uint4 y, int n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if ((a & 15) == 0 && n == 8) {
    *reinterpret_cast<uint4*>(p) = y;
    return;
  }
  const uint32_t v[4] = {y.x, y.y, y.z, y.w};
  uint16_t* h = reinterpret_cast<uint16_t*>(p);
  if ((a & 3) == 0) {
    uint32_t* q = reinterpret_cast<uint32_t*>(p);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (2 * j + 1 < n) {
        q[j] = v[j];
      } else if (2 * j < n) {
        h[2 * j] = static_cast<uint16_t>(v[j]);
      }
    }
  } else {
    h[0] = static_cast<uint16_t>(v[0]);
    uint32_t* q = reinterpret_cast<uint32_t*>(p + 1);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (2 * j + 2 < n) {
        q[j] = __byte_perm(v[j], v[j + 1], 0x5432);
      } else if (2 * j + 1 < n) {
        h[2 * j + 1] = static_cast<uint16_t>(v[j] >> 16);
      }
    }
    if (n == 8) h[7] = static_cast<uint16_t>(v[3] >> 16);
  }
}

"""
# load2 of the c_from_memory ablation
_LOAD2 = """__device__ __forceinline__ uint32_t load2(const __nv_bfloat16* p, bool ok0,
                                          bool ok1) {
  if (ok1 && reinterpret_cast<uintptr_t>(p) % 4 == 0) {
    return *reinterpret_cast<const uint32_t*>(p);
  }
  const uint16_t* h = reinterpret_cast<const uint16_t*>(p);
  return (ok0 ? h[0] : 0u) | (ok1 ? static_cast<uint32_t>(h[1]) << 16 : 0u);
}

"""
# the ring fed by one cp.async.bulk an entry, completed on the entry's
# stage mbarrier (C's words on the same barrier), in place of cp.async
_BULK_FEED = [
    ("load in flight: one 16-byte cp.async.ca a lane (the ninth word by lane\n"
     "// 0, a second copy), one commit group a batch.  tools/k3_ring.py rebuilds\n"
     "// the source at another batch, and fed by one cp.async.bulk an entry on\n"
     "// an mbarrier (`bulk_feed`: slower), and times them.\n"
     "constexpr int kRingWords = 9;\n"
     "constexpr int kRingBatch = 1;\n",
     "load in flight.  `kRingFeed`: 0, one 16-byte cp.async.ca a lane (the\n"
     "// ninth word by lane 0, a second copy), one commit group a batch; 1, one\n"
     "// cp.async.bulk an entry, completed on the entry's stage mbarrier.\n"
     "// tools/k3_ring.py rebuilds the source at other settings and times them.\n"
     "constexpr int kRingWords = 9;\n"
     "constexpr int kRingBatch = 1;\n"
     "constexpr int kRingFeed = 1;\n"),
    ("// them.\n",
     "// them, and the bulk feed's barriers.\n"),
    ("  int2 held_row[kWarps][kGroups][kRingBatch];    // row, C slot\n",
     "  int2 held_row[kWarps][kGroups][kRingBatch];    // row, C slot\n"
     "  uint64_t bars[kWarps][kRingFeed ? kRingStages : 1][kGroups];\n"),
    ("// The eight bf16 that start e elements into a group's staged words",
     "__device__ __forceinline__ void mbar_init(uint64_t* bar) {\n"
     '  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\\n" ::"r"(\n'
     '                   smem_addr(bar)) : "memory");\n'
     "}\n"
     "// the stage's barrier is to count `bytes` more (after this thread's\n"
     "// generic reads of the stage: the proxy fence orders them first)\n"
     "__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {\n"
     '  asm volatile("fence.proxy.async.shared::cta;\\n" ::: "memory");\n'
     '  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\\n"\n'
     '               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");\n'
     "}\n"
     "// `bytes` from global src to shared dst (both on 16 bytes), counted on bar\n"
     "__device__ __forceinline__ void bulk_copy(void* dst, const void* src,\n"
     "                                          uint32_t bytes, uint64_t* bar) {\n"
     "  asm volatile(\n"
     '      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"\n'
     '      " [%0], [%1], %2, [%3];\\n" ::"r"(smem_addr(dst)), "l"(src),\n'
     '      "r"(bytes), "r"(smem_addr(bar)) : "memory");\n'
     "}\n"
     "// a wait that has not ended after 2^24 polls (seconds) traps: a broken\n"
     "// ring fails its launch instead of hanging the card\n"
     "__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {\n"
     "  uint32_t done = 0;\n"
     "  for (uint32_t polls = 0; !done; ++polls) {\n"
     "    if (polls == (1u << 24)) __trap();\n"
     "    asm volatile(\n"
     '        "{\\n .reg .pred p;\\n"\n'
     '        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\\n"\n'
     '        " selp.u32 %0, 1, 0, p;\\n}\\n"\n'
     '        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");\n'
     "  }\n"
     "}\n"
     "\n"
     "// The eight bf16 that start e elements into a group's staged words"),
    ("  auto& held_row = sm.held_row;\n",
     "  auto& held_row = sm.held_row;\n"
     "  auto& bars = sm.bars;\n"),
    ("  if (wlen == 0) return;                               // warp-uniform\n"
     "  const bool left = info & kLeft, right = info & kRight;\n"
     "  const int row0 = len > 0 ? wb[start / kTile] * 128 : 0;\n"
     "  const __nv_bfloat16* Bs = B + k0 + slab;\n",
     "  if (wlen == 0) return;                               // warp-uniform\n"
     "  if constexpr (kRingFeed == 1) {\n"
     "    if (ln < kRingStages * kGroups) {\n"
     "      mbar_init(&bars[w][ln / kGroups][ln % kGroups]);\n"
     "    }\n"
     '    asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");\n'
     "    __syncwarp();\n"
     "  }\n"
     "  const bool left = info & kLeft, right = info & kRight;\n"
     "  const int row0 = len > 0 ? wb[start / kTile] * 128 : 0;\n"
     "  const __nv_bfloat16* Bs = B + k0 + slab;\n"),
    ("  // the covering words of the slab's columns at p, into dst: a word a\n"
     "  // lane (the ninth by lane 0)",
     "  // the covering words of the slab's columns at p, into dst: a word a\n"
     "  // lane (the ninth by lane 0), or one bulk copy by lane 0 counted on bar"),
    ("  auto fetch = [&](uint4* dst, const __nv_bfloat16* p) {\n"
     "    const uint4* src = reinterpret_cast<const uint4*>(\n"
     "        reinterpret_cast<uintptr_t>(p) & ~uintptr_t(15));\n"
     "    const int nw = words(p);\n"
     "    if (gl < nw) cp_async16(dst + gl, src + gl);\n"
     "    if (gl == 0 && nw > kGroup) cp_async16(dst + kGroup, src + kGroup);\n"
     "  };",
     "  auto fetch = [&](uint4* dst, const __nv_bfloat16* p, uint64_t* bar) {\n"
     "    const uint4* src = reinterpret_cast<const uint4*>(\n"
     "        reinterpret_cast<uintptr_t>(p) & ~uintptr_t(15));\n"
     "    const int nw = words(p);\n"
     "    if constexpr (kRingFeed == 0) {\n"
     "      if (gl < nw) cp_async16(dst + gl, src + gl);\n"
     "      if (gl == 0 && nw > kGroup) cp_async16(dst + kGroup, src + kGroup);\n"
     "    } else if (gl == 0) {\n"
     "      bulk_copy(dst, src, 16 * nw, bar);\n"
     "    }\n"
     "  };"),
    ("      fetch(ring[w][s][g], b);\n"
     "      if (c_new) {\n"
     "        fetch(cring[w][g][c_in], c_row(r));",
     "      uint64_t* bar = &bars[w][kRingFeed ? s : 0][g];\n"
     "      if (kRingFeed == 1 && gl == 0) {\n"
     "        mbar_expect(bar, 16 * (words(b) + (c_new ? words(c_row(r)) : 0)));\n"
     "      }\n"
     "      fetch(ring[w][s][g], b, bar);\n"
     "      if (c_new) {\n"
     "        fetch(cring[w][g][c_in], c_row(r), bar);"),
    ("  cp_async_commit();\n"
     "  for (int e8",
     "  if constexpr (kRingFeed == 0) cp_async_commit();\n"
     "  for (int e8"),
    ("      cp_async_commit();\n"
     "      cp_async_wait<1>();                              // this batch landed\n",
     "      if constexpr (kRingFeed == 0) {\n"
     "        cp_async_commit();\n"
     "        cp_async_wait<1>();                            // this batch landed\n"
     "      } else {\n"
     "#pragma unroll\n"
     "        for (int t = 0; t < kRingBatch; ++t) {\n"
     "          if (eb + t < len) {\n"
     "            mbar_wait(&bars[w][(b + t) % kRingStages][g],\n"
     "                      ((eb + t) / kRingStages) & 1);\n"
     "          }\n"
     "        }\n"
     "      }\n"),
]
# ablations of the source's own setting, each a list of (text, its
# replacement) in the kernel: what each part of the body costs, or a
# choice it did not keep.  Results of the `no_` ones are wrong by design
# and are not checked.
ABLATIONS = {
    "bulk_feed": _BULK_FEED,
    "cg_not_ca": [("cp.async.ca.shared.global [%0], [%1], 16;",
                   "cp.async.cg.shared.global [%0], [%1], 16;")],
    "unrolled": [("#pragma unroll 1\n    for (int b = 0; b < kGroup;",
                  "#pragma unroll\n    for (int b = 0; b < kGroup;")],
    "no_copy": [("if (gl < nw) cp_async16(dst + gl, src + gl);",
                 "if (gl < nw && nw < 0) cp_async16(dst + gl, src + gl);"),
                ("if (gl == 0 && nw > kGroup) cp_async16(",
                 "if (gl == 0 && nw < 0) cp_async16(")],
    "no_row_store": [("        if (has >> (kGroup * hg) & 1) {",
                      "        if (has >> (kGroup * hg) & 1 && hg < 0) {")],
    # C read by the warp at the row's store from device memory (4 or 2
    # bytes a lane), not brought by the ring
    "c_from_memory": [
        ("// `bf16_ragged` where the `masked` body cannot run",
         _LOAD2 + "// `bf16_ragged` where the `masked` body cannot run"),
        ("      const bool c_new = st.C != nullptr && r != issued && r < st.m;",
         "      const bool c_new = false;"),
        ("            cp = read2(cring[w][hg][rc.y],\n"
         "                       static_cast<int>(reinterpret_cast<uintptr_t>(\n"
         "                                            c_row(rc.x)) & 15) / 2 + c2);",
         "            cp = load2(c_row(rc.x) + c2, ok0, ok1);")],
    # each group forms and stores its own row, 8 lanes and 8 columns a
    # lane, in 4- and 2-byte stores, not held for the warp's store
    "group_store": [
        ("// `bf16_ragged` where the `masked` body cannot run",
         _GROUP_HELPERS + "// `bf16_ragged` where the `masked` body cannot run"),
        ("      float4* dst = reinterpret_cast<float4*>(held_sum[w][g][held]) + 2 * gl;\n"
         "      dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);\n"
         "      dst[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);\n"
         "      if (gl == 0) held_row[w][g][held] = make_int2(cur, cs);\n"
         "      ++held;\n",
         "      uint4 c8 = make_uint4(0, 0, 0, 0);\n"
         "      if (st.C != nullptr) {\n"
         "        c8 = read8(cring[w][g][cs], static_cast<int>(\n"
         "            reinterpret_cast<uintptr_t>(c_row(cur)) & 15) / 2 + 8 * gl);\n"
         "      }\n"
         "      if (nl > 0) store8(st.out + static_cast<int64_t>(cur) * st.ldo + col,\n"
         "                         finish8(st, c8, acc), nl);\n")],
}
CHECKED = ("bulk_feed", "cg_not_ca", "unrolled", "c_from_memory",
           "group_store")


def _own() -> tuple:
    with open(os.path.join(_kernels.CSRC_DIR, "wcoo_kernels.cu")) as fh:
        src = fh.read()
    return tuple(int(re.search(rf"constexpr int {n} = (\d+);", src).group(1))
                 for n in NAMES)


def _source(setting: tuple, patches=()) -> str:
    with open(os.path.join(_kernels.CSRC_DIR, "wcoo_kernels.cu")) as fh:
        src = fh.read()
    for name, value in zip(NAMES, setting):
        src, n = re.subn(rf"(constexpr int {name} = )\d+;", rf"\g<1>{value};",
                         src)
        if n != 1:
            raise RuntimeError(f"{name} not found in wcoo_kernels.cu")
    for old, new in patches:
        if src.count(old) != 1:
            raise RuntimeError(f"ablation text not found once: {old!r}")
        src = src.replace(old, new)
    return src


def _usage(report: str) -> tuple:
    """(registers, spill store bytes, static shared bytes) of the ring
    kernel."""
    for entry in report.split("Compiling entry function")[1:]:
        if "unit_reduce_bf16_ring_kernel" in entry.splitlines()[0]:
            regs = re.search(r"Used (\d+) registers", entry)
            spill = re.search(r"(\d+) bytes spill stores", entry)
            smem = re.search(r"(\d+) bytes smem", entry)
            return (int(regs.group(1)), int(spill.group(1)),
                    int(smem.group(1)) if smem else 0)
    raise RuntimeError("unit_reduce_bf16_ring_kernel not in the ptxas report")


def _calls(wp, k: int, gen, dev) -> tuple:
    """The SpMM's K3 calls at K = k: ((B, C, out), [(k0, width), ...])."""
    m, n = wp.shape
    B = torch.rand((n, k), generator=gen, device=dev).to(BF16)
    C = torch.rand((m, k), generator=gen, device=dev).to(BF16)
    kc = k_chunk_width(wp.n_tiles, k)
    return (B, C, torch.empty_like(C)), [(k0, min(kc, k - k0))
                                         for k0 in range(0, k, kc)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ablations", default=",".join(ABLATIONS),
                    help="comma-separated ablations to run (default: all)")
    ap.add_argument("--own-only", action="store_true",
                    help="time only the source's own setting of the ring")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k3_ring needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    own = _own()
    runs = [("b{}".format(*s), s, ()) for s in
            [own] + ([] if args.own_only else
                     [s for s in SETTINGS if s != own])]
    runs += [(name, own, ABLATIONS[name])
             for name in filter(None, args.ablations.split(","))]
    jobs = {tag: _source(s, patches) for tag, s, patches in runs}
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(
            lambda kv: _kernels.build_copy(f"k3_ring_{kv[0]}", kv[1]),
            jobs.items())))
    A = webbase_like(dtype=np.float32)
    wp = make_plan(A, dtype=BF16, force="wcoo", device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    shapes = {k: _calls(wp, k, gen, dev) for k in (63, 100)}
    tabs = (wp.k3, wp.wb, wp.relrow, wp.vals, wp.xblk, wp.lane)
    U, R = wp.k3_units.shape[0], wp.k3_rows.shape[0]
    grid = torch.empty((wp.n_row_blocks * 128, 63), dtype=BF16, device=dev)
    want = {}
    for k, ((B, C, out), chunks) in shapes.items():
        for k0, width in chunks:
            body = ragged_body(B, k0, C[:, k0:], out[:, k0:], k)
            if body != "ring":
                raise RuntimeError(f"K={k} chunk {k0} takes {body}, not ring")
            window_reduce(*tabs, B, k0, width, C=C, alpha=ALPHA, beta=BETA,
                          out=out)
        want[k] = out.clone()
    want["grid"] = window_reduce(*tabs, shapes[63][0][0], 0, 63)
    stream = torch.cuda.current_stream(dev).cuda_stream
    index = [t.data_ptr() for t in (wp.k3_units, wp.k3_rows, wp.wb,
                                    wp.relrow, wp.vals, wp.xblk, wp.lane)]
    for tag, s, patches in runs:
        so, report = built[tag]
        if so is None:                 # e.g. more static shared memory
            err = [ln for ln in report.splitlines() if "error" in ln]
            print(f"K3 ring {tag}: build failed: {err[:1]}", flush=True)
            continue
        fn = ctypes.CDLL(so).sblas_window_reduce_bf16_ragged
        fn.argtypes = (_kernels.LAUNCHERS["window_reduce"][0]
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        times = {}
        calls = {k: (B, out, [(C[:, k0:].data_ptr(), out[:, k0:].data_ptr(),
                               k0, w, k, C.shape[0]) for k0, w in chunks])
                 for k, ((B, C, out), chunks) in shapes.items()}
        B63 = shapes[63][0][0]
        calls["grid"] = (B63, grid, [(None, grid.data_ptr(), 0, 63, 63,
                                      grid.shape[0])])
        for key, (B, out, launches) in calls.items():
            carry = [torch.empty((U, 2, a[3]), device=dev) for a in launches]
            argv = [index + [B.data_ptr(), c_at, o_at, cy.data_ptr(), U, R,
                             B.shape[1], k0, w, ldo, m, ALPHA if c_at else 1.0,
                             BETA if c_at else 0.0, stream]
                    for (c_at, o_at, k0, w, ldo, m), cy in zip(launches,
                                                               carry)]

            def run():
                for a in argv:
                    rc = fn(*a)
                    if rc != 0:
                        raise RuntimeError(f"launch failed: cudaError {rc}")

            out.zero_()
            run()
            torch.cuda.synchronize()
            checked = not patches or tag in CHECKED
            if checked and not torch.equal(out, want[key]):
                raise RuntimeError(f"{tag} at {key} differs from the "
                                   f"package's build")
            times[key] = device_time_ms(run, reps=20, inner=10)
        regs, spill, smem = _usage(report)
        blocks = min(8, 65536 // (-(-regs // 8) * 8 * 256),
                     (228 * 1024) // (smem + 1024))
        in_flight = blocks * _kernels_warps() * 4 * s[0] * 128
        label = (f"ablation {tag} of batch={s[0]}" if patches else
                 f"batch={s[0]}{' (source)' if s == own else ''}")
        print(f"K3 ring {label}: registers={regs} spill_bytes={spill} "
              f"static_smem_bytes={smem} blocks_per_sm={blocks} "
              f"bytes_in_flight_per_sm={in_flight} "
              f"K63_ms={times[63]:.5f} K100_ms={times[100]:.5f} "
              f"K63_grid_ms={times['grid']:.5f}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


def _kernels_warps() -> int:
    """Warps a block of K3's sub-warp bodies (`kWarps`)."""
    with open(os.path.join(_kernels.CSRC_DIR, "wcoo_kernels.cu")) as fh:
        return int(re.search(r"constexpr int kWarps = (\d+);",
                             fh.read()).group(1))


if __name__ == "__main__":
    sys.exit(main())
