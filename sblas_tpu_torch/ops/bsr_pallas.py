"""BELL SpMM through kernel K4 (csrc/bsr_kernels.cu).

Port of `sblas_tpu/ops/bsr_pallas.py`, whose Pallas kernel
`_spmm_kernel` streamed B's (128, K) tiles by scalar-prefetched block
column and kept each output block resident across the slot loop, with
the alpha/beta epilogue folded into the last slot.  K4 does the same in
one launch: one CUDA thread block per (block-row, column tile) loops
over the slots itself and writes beta*C + alpha*acc once.  In f32 it runs
3xTF32 on the tensor cores (each operand split into two TF32 parts, three
products kept), about f32's accuracy whatever torch's TF32 flag says; in
f64 it runs `mma.sync` f64 on the f64 tensor cores (products and sums in
f64; `f64_body` names which of its two feeds a launch takes); in bf16 it
runs on the bf16 tensor cores (exact products summed in f32), with alpha
and beta folded in f32 and each output element rounded to bf16 once (the
JAX kernel accumulated the slots in its bf16 output block).
`bf16_variant` picks between the two bf16 kernels, both `wgmma` in
persistent blocks fed by TMA: B's rows in 64 x 64 boxes where K and the
operands allow it, else (`bf16_ragged`) in 8-row groups that the
consumers shift into place, on the column tiles `ragged_column_tiles`
names.

`bsr.spmm_bsr` takes this path for K >= 256 on CUDA (`bsr.takes_k4`);
below that, `bsr.spmm_bsr_plain`'s batched matmuls serve.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _kernels
from .plans import _round_up, require_true_f32

BLOCK = 128   # K4's block edge: R = C = 128
RAGGED_MAX_TILE = 192   # K4[bf16_ragged]'s widest column tile: n128 + n64
# K4[f64]'s bodies, by the index its launcher's query returns
F64_BODIES = ("dmma", "dmma_unpaired")


def bell_spmm_plain(vals, bcol, B, C, alpha, beta, out=None) -> torch.Tensor:
    """Plain PyTorch K4: beta*C + alpha*(A @ B) with A in BELL layout
    (vals (n_brows, L, R, Cb), bcol (n_brows, L)), B (n, K), C (m, K),
    into `out` when given.  bf16 is summed and scaled in f32 and rounded
    once."""
    out_dtype = vals.dtype
    if out_dtype == torch.bfloat16:
        vals, B, C = vals.float(), B.float(), C.float()
    require_true_f32(vals)
    n_brows, _, R, Cb = vals.shape
    n, k = B.shape
    blocks = F.pad(B, (0, 0, 0, _round_up(n, Cb) - n)).reshape(-1, Cb, k)
    tiles = blocks[bcol]                              # (n_brows, L, Cb, K)
    acc = torch.einsum("ilrc,ilck->irk", vals, tiles)
    res = (beta * C + alpha * acc.reshape(n_brows * R, k)[: C.shape[0]]
           ).to(out_dtype)
    return res if out is None else out.copy_(res)


def ragged_column_tiles(k: int) -> list:
    """The column tiles K4[bf16_ragged] runs for K columns, as (first
    column, width): ceil(K / 192) tiles of one width, a multiple of 8 and
    at most 192, the last cut to K; so no tile is left with a few columns
    that reread every value block of its block row.  Informational (the
    tiles printed beside K4's times): the kernel cuts its own tiles
    (csrc/bsr_kernels.cu::ragged_tile_width, the same width), and the
    `cuda` test `test_bell_spmm_bf16_ragged_every_column_tiling` holds
    the kernel to its plain version at every K up to 776."""
    if k <= 0:
        return []
    n = -(-k // RAGGED_MAX_TILE)
    width = (-(-k // n) + 7) // 8 * 8
    return [(c, min(width, k - c)) for c in range(0, k, width)]


def bf16_variant(vals, B, C, out) -> str:
    """K4[bf16]'s variant: `bf16` (wgmma fed by TMA, which needs 16-byte
    row strides and bases) when K % 8 == 0, every operand starts on 16
    bytes and there is a slot to read, else `bf16_ragged` (wgmma on B's
    rows brought as 8-row groups and shifted into place)."""
    aligned = all(t.data_ptr() % 16 == 0 for t in (vals, B, C, out))
    tma = B.shape[1] % 8 == 0 and vals.shape[1] > 0 and aligned
    return "bf16" if tma else "bf16_ragged"


def f64_body(B, C, out) -> str:
    """The body K4[f64]'s launcher runs on these operands, as the launcher
    itself decides it; both issue `mma.sync` f64 on the tensor cores:
    `dmma` (B's rows by 16-byte copies, C and out by pairs) where K is
    even and B, C and out start on 16 bytes, else `dmma_unpaired` (8-byte
    copies and single values: an odd K, an operand at an odd element
    offset)."""
    return F64_BODIES[_kernels.library().sblas_bell_spmm_f64_body(
        B.data_ptr(), C.data_ptr(), out.data_ptr(), B.shape[1])]


def f64_mma_shape() -> str:
    """The f64 `mma.sync` shape K4[f64] issues, e.g. `m16n8k4`."""
    kd = _kernels.library().sblas_bell_spmm_f64_mma()
    return f"m16n8k{kd}" if kd else "m8n8k4"


def bell_spmm(vals, bcol, B, C, alpha, beta, out=None) -> torch.Tensor:
    """beta*C + alpha*(A @ B) for A in BELL layout with 128 x 128 blocks
    (see `bell_spmm_plain`), into `out` (m, K) when given.  CPU tensors
    take the plain version; CUDA tensors launch kernel K4 or raise.  Any
    alignment of B, C and out is taken; a `vals` that does not start on
    16 bytes (no plan makes one: plan values are fresh allocations) is
    first copied to fresh storage, since every K4 body reads the value
    blocks by 16-byte copies or TMA."""
    if vals.device.type == "cpu":
        return bell_spmm_plain(vals, bcol, B, C, alpha, beta, out)
    from ..utils.errors import KernelError, require
    dev = vals.device
    require(dev.type == "cuda", KernelError,
            f"bell_spmm runs on cpu or cuda, not {dev}")
    variant = _kernels.value_suffix(vals.dtype)
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
    if out is None:
        out = torch.empty((m, k), dtype=vals.dtype, device=dev)
    _kernels.check_operand(out, "out", vals.dtype, (m, k), dev)
    if vals.data_ptr() % 16:
        vals = vals.clone()
    if variant == "bf16":
        variant = bf16_variant(vals, B, C, out)
    body = f64_body(B, C, out) if variant == "f64" else None
    _kernels.launch(_kernels.launcher("bell_spmm", variant), dev, vals, bcol,
                    B, C, out, n_brows, L, m, n, k, float(alpha),
                    float(beta))
    if body is not None:
        _kernels.BODIES[f"bell_spmm_f64.{body}"] += 1
    bell_spmm.launches += 1
    return out


bell_spmm.launches = 0   # K4 launches since the last reset


def spmm_bsr_pallas(plan, B: torch.Tensor, alpha, beta,
                    C: torch.Tensor) -> torch.Tensor:
    """C' = beta*C + alpha*A@B with A a `bsr.BsrPlan`, through K4.  Same
    semantics as `bsr.spmm_bsr_plain`."""
    dt = plan.dtype
    return bell_spmm(plan.vals, plan.bcol, B.to(dt).contiguous(),
                     C.to(dt).contiguous(), alpha, beta)
