"""Ops layer of the port: plans, SpMV, SpMM, and the CPU oracle.

Port of `sblas_tpu/ops/__init__.py`.  Six device layouts, chosen by
`make_plan` branch for branch as the JAX package chooses them:

* DIA diagonal (shift-and-FMA) — banded structure;
* Routed (gather/route/stack engine, kernels K1 and K2) — large
  unstructured matrices, SpMV planning;
* BELL block-sparse (batched matmuls; kernel K4 for SpMM at K >= 256) —
  block-friendly structure;
* ELL (gather + row sum) — balanced row occupancy;
* windowed COO (kernel K3 for SpMM) — unstructured;
* padded COO (gather + `index_add_`) — the universal fallback and tier-0
  baseline.

Every kind takes float32, float64 or bfloat16 values, as the JAX
package's do; the ladder's BELL byte caps scale with the value dtype's
size, so a bf16 plan may take another kind than an f32 one.  The
chooser's thresholds were calibrated on a TPU v5e by the JAX package;
re-calibrating them for the H100 is later work.
"""

import torch

from . import cpu_reference  # noqa: F401
from .bsr import BsrPlan, bell_stats, spmm_bsr, spmv_bsr
from .bsr_pallas import spmm_bsr_pallas
from .dia import DiaPlan, dia_stats, spmm_dia, spmv_dia  # noqa: F401
from .elementwise import axpby, plus_scalar  # noqa: F401
from .plans import CooPlan, EllPlan
from .rspmv import RoutedPlan, spmv_routed
from .spmm import spmm as _spmm_tier0
from .spmm import spmm_coo, spmm_ell  # noqa: F401
from .spmv import spmv_coo, spmv_ell
from .wcoo import WcooPlan, spmm_wcoo, spmv_wcoo, wcoo_fill_ratio

from ..config import DEFAULT

# The JAX package's chooser constants (sblas_tpu/ops/__init__.py:27-63),
# kept equal so both packages choose alike; their rationale there is
# TPU-measured.
_WCOO_FILL_LIMIT = 8.0
_BSR_SPMM_BLOWUP_LIMIT = 512.0
_BSR_SPMM_BYTES_CAP = 1 << 30
_BSR_DIA_SPMM_BYTES = 256 << 20
_BSR_SPMV_BLOWUP = 8.0
# B width from which BELL SpMM takes kernel K4.  The JAX package gates
# its Pallas kernel on K >= 256 and a TPU backend; the port gates K4 on
# K >= 256, B on CUDA and the plan's blocks being K4's 128 x 128, so the
# CPU and other block shapes take `spmm_bsr`, as the JAX package's CPU
# backend does.
_BSR_PALLAS_MIN_K = 256


def takes_k4(plan, k: int, on_cuda: bool) -> bool:
    """Whether `spmm` over BELL plan `plan` with a K-wide B runs kernel K4
    (a choice on the plan's block shape, K and the device)."""
    return (on_cuda and k >= _BSR_PALLAS_MIN_K
            and tuple(plan.block) == (128, 128))


def choose_kind(A, dtype=torch.float32, config=DEFAULT, op=None) -> str:
    """The kind `make_plan(A, dtype, config, op=op)` builds, without
    building it: the JAX package's `make_plan` ladder
    (ops/__init__.py:86-125)."""
    kind = None
    m, n = A.shape
    bst = bell_stats(A, config.bsr_block)
    bsr_bytes = bst["blowup"] * max(A.nnz, 1) * dtype.itemsize
    if m <= config.bsr_block[0] and n <= config.bsr_block[1]:
        # tiny matrix: the dense forms win outright
        kind = "dia" if op == "spmv" else "bsr"
    elif op == "spmv":
        if DiaPlan.is_profitable(A, config):
            kind = ("bsr" if bst["blowup"] <= _BSR_SPMV_BLOWUP else "dia")
        elif (RoutedPlan.is_profitable(A, config)
              and bst["blowup"] > config.bsr_blowup_limit):
            kind = "routed"
        elif bst["blowup"] <= config.bsr_blowup_limit:
            kind = "bsr"
        elif EllPlan.is_profitable(A, config):
            kind = "ell"
    else:  # spmm / mixed use
        if (bst["blowup"] <= _BSR_SPMM_BLOWUP_LIMIT
                and bsr_bytes <= _BSR_SPMM_BYTES_CAP):
            kind = ("dia" if (bsr_bytes > _BSR_DIA_SPMM_BYTES
                              and DiaPlan.is_profitable(A, config))
                    else "bsr")
        elif DiaPlan.is_profitable(A, config):
            kind = "dia"
        elif EllPlan.is_profitable(A, config):
            kind = "ell"
    if kind is None:
        kind = "wcoo" if wcoo_fill_ratio(A) <= _WCOO_FILL_LIMIT else "coo"
    return kind


def make_plan(A, dtype=None, config=DEFAULT, force=None, op=None, *,
              device):
    """Choose the single-device layout for CSR matrix `A` and build it on
    `device` (a torch device or its name).

    Same choice as `sblas_tpu.ops.make_plan`: `force` in {"dia", "routed",
    "bsr", "ell", "wcoo", "coo"} overrides; `op` in {None, "spmv",
    "spmm"} biases the choice toward that kernel.  `dtype` is
    torch.float32 (the default), torch.float64 or torch.bfloat16."""
    dtype = dtype or torch.float32
    kind = force if force is not None else choose_kind(A, dtype, config, op)
    kw = dict(dtype=dtype, config=config, device=device)
    if kind == "bsr":
        return BsrPlan.from_csr(A, block=config.bsr_block, **kw)
    cls = {"dia": DiaPlan, "routed": RoutedPlan, "ell": EllPlan,
           "wcoo": WcooPlan, "coo": CooPlan}.get(kind)
    if cls is None:
        raise ValueError(f"unknown plan kind {kind!r}")
    return cls.from_csr(A, **kw)


def make_plan_fast(A, dtype=None, config=DEFAULT, *, device):
    """Plan with no analysis phase, for a first answer while `make_plan`
    builds: ELL when the row distribution allows it, COO otherwise."""
    cls = EllPlan if EllPlan.is_profitable(A, config) else CooPlan
    return cls.from_csr(A, dtype=dtype or torch.float32, config=config,
                        device=device)


_SPMV = {DiaPlan: spmv_dia, RoutedPlan: spmv_routed, BsrPlan: spmv_bsr,
         WcooPlan: spmv_wcoo, EllPlan: spmv_ell, CooPlan: spmv_coo}


def spmv(plan, x, alpha=1.0, beta=1.0, y=None):
    """y' = beta*y + alpha*A@x, dispatched on plan type (`y=None` drops the
    beta term).  x and y are tensors on the plan's device."""
    fn = _SPMV.get(type(plan))
    if fn is None:
        raise TypeError(f"unsupported plan type {type(plan).__name__}")
    if y is None:
        y = torch.zeros(plan.shape[0], dtype=plan.dtype, device=plan.device)
        beta = 0.0
    return fn(plan, x, alpha, beta, y)


def spmm(plan, B, alpha=1.0, beta=1.0, C=None):
    """C' = beta*C + alpha*A@B, dispatched on plan type (`C=None` drops the
    beta term).  B and C are (rows, K) tensors on the plan's device."""
    if isinstance(plan, RoutedPlan):
        raise TypeError(
            "RoutedPlan is SpMV-only (its contribution routing has no "
            "K-wide analog); build an SpMM plan with make_plan(A) or "
            "make_plan(A, op='spmm')")
    if C is None:
        C = torch.zeros((plan.shape[0], B.shape[1]), dtype=plan.dtype,
                        device=plan.device)
        beta = 0.0
    if isinstance(plan, DiaPlan):
        return spmm_dia(plan, B, alpha, beta, C)
    if isinstance(plan, BsrPlan):
        if takes_k4(plan, B.shape[1], B.is_cuda):
            return spmm_bsr_pallas(plan, B, alpha, beta, C)
        return spmm_bsr(plan, B, alpha, beta, C)
    if isinstance(plan, WcooPlan):
        return spmm_wcoo(plan, B, alpha, beta, C)
    return _spmm_tier0(plan, B, alpha, beta, C)
