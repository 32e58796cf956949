"""K3's two-column loop at other in-flight depths, on one CUDA device.

    python -m sblas_tpu_torch.tools.k3_inflight

The two-column loop of kernel K3 (csrc/wcoo_kernels.cu, the f32 variant)
keeps `kInFlight` B loads in flight per lane and asks the compiler for
`kMinBlocks` resident 256-thread blocks an SM.  This tool builds copies
of the kernel source with those two constants changed (into `_build/`,
one `nvcc` per copy, all started together) and times each copy's
launcher in the grid form at webbase x K=64, on tables cut at 128-slot
units.  (In bf16 only `bf16_ragged` at an odd stride or uneven operand
offsets reaches this loop, so the tool times f32.)

Prints one line per setting: registers and spill bytes of the loop's
kernel (`nvcc -Xptxas -v`), the blocks an SM those registers allow, the
B bytes an SM keeps in flight (warps x 32 lanes x loads x load bytes),
and the device ms; then the card's name and power limit.  Exits 1
without a card.
"""

from __future__ import annotations

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
from ..ops.wcoo import UNIT, WcooPlan
from ..utils.timing import device_time_ms
from .k3_skew import _schedule

# (value type, launcher suffix, kernel's mangled type, bytes a load, the
# source's own setting first)
TYPES = {
    torch.float32: ("float", "f32", "If", 8, [(8, 4), (1, 8), (4, 4)]),
}


def _source(ctype: str, in_flight: int, min_blocks: int) -> str:
    with open(os.path.join(_kernels.CSRC_DIR, "wcoo_kernels.cu")) as fh:
        src = fh.read()
    pat = (r"(struct Pair<" + re.escape(ctype) + r"> \{[^}]*kInFlight = )"
           r"\d+(, kMinBlocks = )\d+")
    out, n = re.subn(pat, rf"\g<1>{in_flight}\g<2>{min_blocks}", src)
    if n != 1:
        raise RuntimeError(f"Pair<{ctype}> not found in wcoo_kernels.cu")
    return out


def _build(tag: str, src: str) -> tuple:
    """(library path, ptxas report) of one copy of the source."""
    so, report = _kernels.build_copy(f"k3_inflight_{tag}", src)
    if so is None:
        raise _kernels.KernelError(f"nvcc refused k3_inflight_{tag}:\n"
                                   f"{report}")
    return so, report


def _usage(report: str, mangled: str) -> tuple:
    """(registers, spill store bytes) of the grid-form two-column kernel
    (kVec, not fused) of the type `mangled`."""
    want = f"unit_reduce_kernel{mangled}Lb1ELb0E"
    entries = report.split("Compiling entry function")
    for entry in entries[1:]:
        if want in entry.splitlines()[0]:
            spill = re.search(r"(\d+) bytes spill stores", entry)
            regs = re.search(r"Used (\d+) registers", entry)
            return int(regs.group(1)), int(spill.group(1))
    raise RuntimeError(f"{want} not in the ptxas report")


def main() -> int:
    if not torch.cuda.is_available():
        print("k3_inflight needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    A = webbase_like(dtype=np.float32)
    jobs = {f"{sfx}_{f}x{b}": _source(ctype, f, b)
            for ctype, sfx, _, _, sets in TYPES.values() for f, b in sets}
    with ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(lambda kv: _build(*kv),
                                        jobs.items())))
    k = 64
    stream = torch.cuda.current_stream(dev).cuda_stream
    for dtype, (ctype, sfx, mangled, load_bytes, sets) in TYPES.items():
        p = WcooPlan.from_csr(A, dtype=dtype, device=dev)
        sched = _schedule(p, UNIT)
        B = torch.rand((A.shape[1], k), device=dev).to(dtype)
        out = torch.empty((p.n_row_blocks * 128, k), dtype=dtype,
                          device=dev)
        carry = torch.empty((sched.units.shape[0], 2, k), device=dev,
                            dtype=dtype)
        args = [t.data_ptr() for t in (sched.units, sched.rows, p.wb,
                                       p.relrow, p.vals, p.xblk, p.lane, B)]
        args += [None, out.data_ptr(), carry.data_ptr(),
                 sched.units.shape[0], sched.rows.shape[0], k, 0, k, k,
                 out.shape[0], 1.0, 0.0, stream]
        for f, b in sets:
            so, report = built[f"{sfx}_{f}x{b}"]
            fn = getattr(ctypes.CDLL(so), f"sblas_window_reduce_{sfx}")
            fn.argtypes = (_kernels.LAUNCHERS["window_reduce"][0]
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int

            def run():
                rc = fn(*args)
                if rc != 0:
                    raise RuntimeError(f"launch failed: cudaError {rc}")

            ms = device_time_ms(run, reps=10, inner=5)
            regs, spill = _usage(report, mangled)
            blocks = min(8, 65536 // (-(-regs // 8) * 8 * 256))
            in_flight = blocks * 8 * 32 * f * load_bytes
            print(f"{str(dtype)[6:]} two-column loop ({sfx}): "
                  f"in_flight={f} min_blocks={b} registers={regs} "
                  f"spill_bytes={spill} blocks_per_sm={blocks} "
                  f"bytes_in_flight_per_sm={in_flight} ms={ms:.5f}",
                  flush=True)
        del p, sched, B, out, carry
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
