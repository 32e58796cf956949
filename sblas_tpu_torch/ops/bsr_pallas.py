"""BELL SpMM through kernel K4 (csrc/bsr_kernels.cu).

Port of `sblas_tpu/ops/bsr_pallas.py`, whose Pallas kernel
`_spmm_kernel` streamed B's (128, K) tiles by scalar-prefetched block
column and kept each output block resident across the slot loop, with
the alpha/beta epilogue folded into the last slot.  K4 does the same in
one launch: one CUDA thread block per (block-row, column tile) loops
over the slots itself and writes beta*C + alpha*acc once.  In f32 it runs
3xTF32 on the tensor cores (each operand split into two TF32 parts, three
products kept), about f32's accuracy whatever torch's TF32 flag says; in
f64 it runs f64 FMAs; in bf16 f32 FMAs on the CUDA cores, with alpha and
beta folded in f32 and each output element rounded to bf16 once (the JAX
kernel accumulated the slots in its bf16 output block).

`make_plan`'s dispatcher takes this path for K >= 256 on CUDA
(`ops.spmm`); below that, `bsr.spmm_bsr`'s batched matmuls serve.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _kernels
from .bsr import BsrPlan, require_true_f32
from .plans import _round_up

BLOCK = 128   # K4's block edge: R = C = 128


def bell_spmm_plain(vals, bcol, B, C, alpha, beta) -> torch.Tensor:
    """Plain PyTorch K4: beta*C + alpha*(A @ B) with A in BELL layout
    (vals (n_brows, L, R, Cb), bcol (n_brows, L)), B (n, K), C (m, K).
    bf16 is summed and scaled in f32 and rounded once."""
    out_dtype = vals.dtype
    if out_dtype == torch.bfloat16:
        vals, B, C = vals.float(), B.float(), C.float()
    require_true_f32(vals)
    n_brows, _, R, Cb = vals.shape
    n, k = B.shape
    blocks = F.pad(B, (0, 0, 0, _round_up(n, Cb) - n)).reshape(-1, Cb, k)
    tiles = blocks[bcol]                              # (n_brows, L, Cb, K)
    acc = torch.einsum("ilrc,ilck->irk", vals, tiles)
    out = beta * C + alpha * acc.reshape(n_brows * R, k)[: C.shape[0]]
    return out.to(out_dtype)


def bell_spmm(vals, bcol, B, C, alpha, beta) -> torch.Tensor:
    """beta*C + alpha*(A @ B) for A in BELL layout with 128 x 128 blocks
    (see `bell_spmm_plain`).  CPU tensors take the plain version; CUDA
    tensors launch kernel K4 or raise."""
    if vals.device.type == "cpu":
        return bell_spmm_plain(vals, bcol, B, C, alpha, beta)
    from ..utils.errors import KernelError, require
    dev = vals.device
    require(dev.type == "cuda", KernelError,
            f"bell_spmm runs on cpu or cuda, not {dev}")
    fn = _kernels.launcher("bell_spmm", _kernels.value_suffix(vals.dtype))
    require(vals.dim() == 4 and tuple(vals.shape[2:]) == (BLOCK, BLOCK),
            KernelError, f"K4 takes ({BLOCK}, {BLOCK}) blocks, got vals "
            f"{tuple(vals.shape)}")
    n_brows, L = vals.shape[:2]
    (n, k), m = B.shape, C.shape[0]
    require((m + BLOCK - 1) // BLOCK == n_brows, KernelError,
            f"C has {m} rows, vals {n_brows} block rows")
    _kernels.check_operand(vals, "vals", vals.dtype, vals.shape, dev)
    _kernels.check_operand(bcol, "bcol", torch.int32, (n_brows, L), dev)
    _kernels.check_operand(B, "B", vals.dtype, (n, k), dev)
    _kernels.check_operand(C, "C", vals.dtype, (m, k), dev)
    out = torch.empty((m, k), dtype=vals.dtype, device=dev)
    _kernels.launch(fn, dev, vals, bcol, B, C, out, n_brows, L, m, n, k,
                    float(alpha), float(beta))
    bell_spmm.launches += 1
    return out


bell_spmm.launches = 0   # K4 launches since the last reset


def spmm_bsr_pallas(plan: BsrPlan, B: torch.Tensor, alpha, beta,
                    C: torch.Tensor) -> torch.Tensor:
    """C' = beta*C + alpha*A@B with A in BELL layout, through K4.  Same
    semantics as `bsr.spmm_bsr`."""
    dt = plan.dtype
    return bell_spmm(plan.vals, plan.bcol, B.to(dt).contiguous(),
                     C.to(dt).contiguous(), alpha, beta)
