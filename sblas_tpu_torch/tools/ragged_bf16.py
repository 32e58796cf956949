"""The two ragged bf16 kernels against their yardsticks, on one CUDA device.

    python -m sblas_tpu_torch.tools.ragged_bf16

K4[bf16_ragged] (csrc/bsr_kernels.cu) at band-73 (`fem_banded_like()`,
its bf16 BELL plan) x K = 263 and 300, beside the composite a caller
could build from the aligned variant instead: B and C padded with zero
columns to K8 = round_up(K, 8), K4's `bf16` at K8, and out's first K
columns copied back (timed as one call), and beside `bf16` alone at K8.
K3[bf16_ragged] (csrc/wcoo_kernels.cu) in the fused form at webbase-1M x
K = 64, k0 = 1 (63 columns), and the webbase-1M bf16 WCOO SpMM at K =
128 through `make_plan(..., force="wcoo")` and `spmm`: two K3 calls, 81
and 47 columns wide (the JAX package's chunk width), both `bf16_ragged`.

Device ms are medians of 20 event pairs around 10 launches each
(`utils.timing.device_time_ms`); operands are random from seed 211.
Prints one line per measurement with the launches by variant, then the
card's name and power limit.  Only the package's public calls are used,
so the same file runs against an older checkout of the package.  Exits 1
without a card.
"""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch
import torch.nn.functional as F

from .. import _kernels
from ..io.generate import fem_banded_like, webbase_like
from ..ops import make_plan, spmm
from ..ops.bsr_pallas import bell_spmm
from ..ops.wcoo import window_reduce
from ..utils.timing import device_time_ms

BF16 = torch.bfloat16
ALPHA, BETA = 3.0, 4.0
SEED = 211


def _ms(fn) -> float:
    return device_time_ms(fn, reps=20, inner=10)


def _variants(fn) -> dict:
    """Launches by variant (launcher name without `sblas_`) of one call."""
    _kernels.LAUNCHED.clear()
    fn()
    torch.cuda.synchronize()
    return {k[len("sblas_"):]: v for k, v in _kernels.LAUNCHED.items()}


def _rand(shape, gen, dev) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=dev).to(BF16)


def k4_lines(dev, gen) -> None:
    A = fem_banded_like(dtype=np.float32)
    bp = make_plan(A, dtype=BF16, force="bsr", device=dev)
    n, m = A.shape[1], A.shape[0]
    for k in (263, 300):
        k8 = -(-k // 8) * 8
        B, C = _rand((n, k), gen, dev), _rand((m, k), gen, dev)
        B8, C8 = F.pad(B, (0, k8 - k)), F.pad(C, (0, k8 - k))

        def ragged():
            return bell_spmm(bp.vals, bp.bcol, B, C, ALPHA, BETA)

        def aligned():
            return bell_spmm(bp.vals, bp.bcol, B8, C8, ALPHA, BETA)

        def padded():
            out = bell_spmm(bp.vals, bp.bcol, F.pad(B, (0, k8 - k)),
                            F.pad(C, (0, k8 - k)), ALPHA, BETA)
            return out[:, :k].contiguous()

        same = torch.equal(ragged(), padded())
        print(f"K4 band-73 K={k}: ragged_ms={_ms(ragged):.5f} "
              f"padded_composite_ms={_ms(padded):.5f} "
              f"bf16_at_K8_ms={_ms(aligned):.5f} ragged_equals_padded={same} "
              f"variants={_variants(ragged)} / {_variants(aligned)}",
              flush=True)


def k3_lines(dev, gen) -> None:
    A = webbase_like(dtype=np.float32)
    wp = make_plan(A, dtype=BF16, force="wcoo", device=dev)
    n, m = A.shape[1], A.shape[0]
    B, C = _rand((n, 64), gen, dev), _rand((m, 64), gen, dev)
    out = C.clone()
    args = (wp.k3, wp.wb, wp.relrow, wp.vals, wp.xblk, wp.lane, B, 1, 63)

    def fused():
        return window_reduce(*args, C=C, alpha=ALPHA, beta=BETA, out=out)

    print(f"K3 webbase fused k0=1 width=63: ms={_ms(fused):.5f} "
          f"variants={_variants(fused)}", flush=True)
    B, C = _rand((n, 128), gen, dev), _rand((m, 128), gen, dev)

    def spmm128():
        return spmm(wp, B, ALPHA, BETA, C)

    print(f"WCOO SpMM bf16 webbase K=128: device_ms={_ms(spmm128):.5f} "
          f"variants={_variants(spmm128)}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("ragged_bf16 needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    k4_lines(dev, gen)
    k3_lines(dev, gen)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
