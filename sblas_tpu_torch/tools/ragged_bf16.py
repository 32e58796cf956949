"""The two ragged bf16 kernels against their yardsticks, on one CUDA device.

    python -m sblas_tpu_torch.tools.ragged_bf16

K4[bf16_ragged] (csrc/bsr_kernels.cu) at band-73 (`fem_banded_like()`,
its bf16 BELL plan) x K = 263 and 300, beside the composite a caller
could build from the aligned variant instead: B and C padded with zero
columns to K8 = round_up(K, 8), K4's `bf16` at K8, and out's first K
columns copied back (timed as one call), and beside `bf16` alone at K8.
K3[bf16_ragged] (csrc/wcoo_kernels.cu) in the fused form at webbase-1M x
K = 64, k0 = 1 (63 columns), and at the bf16 WCOO SpMM at K = 63's own
operands (k0 = 0, row stride 63: one call), and the webbase-1M bf16 WCOO
SpMM through `make_plan(..., force="wcoo")` and `spmm` at K = 100 (two
K3 calls, 81 and 19 columns wide at row stride 100) and K = 128 (81 and
47 columns; the JAX package's chunk width), every call `bf16_ragged`.
Then K3 f32 where its two-column loop loses its 8-byte loads (an odd row
stride or an odd k0): the fused form at webbase-1M x K = 63 (k0 = 0) and
at the K = 128 f32 SpMM's second chunk (k0 = 81, 47 columns), each with
its plain version's time, `torch.addmm`'s on the same operands (f32 CSR)
and its bound (bytes over 3.35 TB/s or FLOPs over 67 TFLOP/s).

Device ms are medians of 20 event pairs around 10 launches each
(`utils.timing.device_time_ms`); operands are random from seed 211.
Prints one line per measurement with the launches by variant (and by
body, where the package counts them), then the card's name and power
limit.  Only the package's public calls are used, so the same file runs
against an older checkout of the package.  Exits 1 without a card.
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
from ..ops.wcoo import window_reduce, window_reduce_plain
from ..utils.timing import device_time_ms

BF16 = torch.bfloat16
ALPHA, BETA = 3.0, 4.0
SEED = 211
HBM_BYTES_PER_S, FP32_FLOPS = 3.35e12, 67e12


def _ms(fn) -> float:
    return device_time_ms(fn, reps=20, inner=10)


def _variants(fn) -> dict:
    """Launches by variant (launcher name without `sblas_`) of one call,
    and by body where the package counts bodies."""
    bodies = getattr(_kernels, "BODIES", None)
    _kernels.LAUNCHED.clear()
    if bodies is not None:
        bodies.clear()
    fn()
    torch.cuda.synchronize()
    got = {k[len("sblas_"):]: v for k, v in _kernels.LAUNCHED.items()}
    return dict(got, **dict(bodies or {}))


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
    B, C = _rand((n, 63), gen, dev), _rand((m, 63), gen, dev)
    out = C.clone()
    args = (wp.k3, wp.wb, wp.relrow, wp.vals, wp.xblk, wp.lane, B, 0, 63)

    def fused63():
        return window_reduce(*args, C=C, alpha=ALPHA, beta=BETA, out=out)

    print(f"K3 webbase fused K=63 k0=0 (the K=63 SpMM's call): "
          f"ms={_ms(fused63):.5f} variants={_variants(fused63)}", flush=True)
    B, C = _rand((n, 100), gen, dev), _rand((m, 100), gen, dev)

    def spmm100():
        return spmm(wp, B, ALPHA, BETA, C)

    print(f"WCOO SpMM bf16 webbase K=100: device_ms={_ms(spmm100):.5f} "
          f"variants={_variants(spmm100)}", flush=True)
    B, C = _rand((n, 128), gen, dev), _rand((m, 128), gen, dev)

    def spmm128():
        return spmm(wp, B, ALPHA, BETA, C)

    print(f"WCOO SpMM bf16 webbase K=128: device_ms={_ms(spmm128):.5f} "
          f"variants={_variants(spmm128)}", flush=True)


def k3_f32_lines(dev, gen) -> None:
    A = webbase_like(dtype=np.float32)
    wp = make_plan(A, dtype=torch.float32, force="wcoo", device=dev)
    n, m = A.shape[1], A.shape[0]
    A_csr = torch.sparse_csr_tensor(
        torch.from_numpy(A.row_ptr), torch.from_numpy(A.col_idx),
        torch.from_numpy(A.values.astype(np.float32)), size=A.shape,
        device=dev, check_invariants=False)
    index = sum(t.numel() * t.element_size() for t in (
        wp.k3_units, wp.k3_rows, wp.wb, wp.relrow, wp.vals, wp.xblk,
        wp.lane))
    tabs = (wp.k3, wp.wb, wp.relrow, wp.vals, wp.xblk, wp.lane)
    for title, k, k0, width in (("K=63 k0=0", 63, 0, 63),
                                ("K=128 chunk k0=81", 128, 81, 47)):
        B = torch.rand((n, k), generator=gen, device=dev)
        C = torch.rand((m, k), generator=gen, device=dev)
        out = C.clone()
        epi = dict(C=C, alpha=ALPHA, beta=BETA, out=out)
        Bw = B[:, k0:k0 + width].contiguous()
        Cw = C[:, k0:k0 + width].contiguous()

        def kernel():
            return window_reduce(*tabs, B, k0, width, **epi)

        def plain():
            return window_reduce_plain(*tabs, B, k0, width, **epi)

        def addmm():
            return torch.addmm(Cw, A_csr, Bw, beta=BETA, alpha=ALPHA)

        t_bytes = (index + (n + 2 * m) * width * 4) / HBM_BYTES_PER_S * 1e3
        t_ops = (2 * A.nnz * width + 3 * m * width) / FP32_FLOPS * 1e3
        ms = _ms(kernel)
        print(f"K3 f32 webbase fused {title} width={width} ldb={k}: "
              f"ms={ms:.5f} plain_ms={_ms(plain):.5f} "
              f"addmm_ms={_ms(addmm):.5f} "
              f"bound_ms={max(t_bytes, t_ops):.5f} "
              f"bound_by={'bytes' if t_bytes >= t_ops else 'operations'} "
              f"share={max(t_bytes, t_ops) / ms:.3f} "
              f"variants={_variants(kernel)}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("ragged_bf16 needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    k4_lines(dev, gen)
    k3_lines(dev, gen)
    k3_f32_lines(dev, gen)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
