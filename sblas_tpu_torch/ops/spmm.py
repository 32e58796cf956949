"""Tier-0 SpMM over a `CooPlan` or `EllPlan`:  C' = beta*C + alpha*A@B.

Port of `sblas_tpu/ops/spmm.py`.  B and C are (rows, K) tensors on the
plan's device.

* COO: gather B rows per nnz, scale, and sum per row with `index_add_`
  (the JAX package's sorted `segment_sum`).  The (nnz, K) intermediate
  is bounded by chunking over B's columns, `_MAX_GATHER_ELEMS` elements
  at most, with the same chunk count as the JAX package.
* ELL: one flat B-row gather per column chunk + a slot sum, no scatter.

`_match_vma`, a `shard_map` typing shim, has no torch counterpart.
"""

from __future__ import annotations

import torch

from .plans import CooPlan, EllPlan, sum_dtype

# Cap on the materialised gather intermediate, in elements (1 GiB of f32).
_MAX_GATHER_ELEMS = 256 * 1024 * 1024


def segment_spmm(rows, cols, vals, B, m: int, n_chunks: int = 1):
    """(sorted COO triplets) x B -> (m, k); `n_chunks` > 1 bounds the
    (nnz, k) gather transient by chunking over B's columns."""
    k = B.shape[1]
    kc = max(-(-k // max(n_chunks, 1)), 1)
    outs = []
    for k0 in range(0, max(k, 1), kc):   # k = 0 still yields (m, 0)
        contrib = vals[:, None] * torch.index_select(B[:, k0:k0 + kc], 0,
                                                     cols)
        acc = sum_dtype(contrib.dtype)
        outs.append(torch.zeros((m, contrib.shape[1]), dtype=acc,
                                device=contrib.device).index_add_(
                                    0, rows, contrib.to(acc)
                                ).to(contrib.dtype))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def spmm_coo(plan: CooPlan, B: torch.Tensor, alpha, beta, C: torch.Tensor,
             n_chunks: int = 1) -> torch.Tensor:
    ab = segment_spmm(plan.rows, plan.cols, plan.vals, B, plan.shape[0],
                      n_chunks=n_chunks)
    return beta * C + alpha * ab


def spmm_ell(plan: EllPlan, B: torch.Tensor, alpha, beta, C: torch.Tensor,
             k_chunk: int = None) -> torch.Tensor:
    """ELL SpMM via one flat B-row gather per column chunk."""
    m = plan.shape[0]
    m_pad, L = plan.cols.shape
    k = B.shape[1]
    kc = k_chunk or max(min(k, _MAX_GATHER_ELEMS // max(m_pad * L, 1)), 1)
    flat = plan.cols.reshape(-1)
    outs = []
    for k0 in range(0, max(k, 1), kc):
        gathered = torch.index_select(B[:, k0:k0 + kc], 0, flat)
        gathered = gathered.reshape(m_pad, L, gathered.shape[1])
        outs.append((plan.vals[:, :, None] * gathered).sum(dim=1))
    ab = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return beta * C + alpha * ab[:m]


def _auto_chunks(plan: CooPlan, k: int) -> int:
    total = plan.vals.shape[0] * k
    return max(1, (total + _MAX_GATHER_ELEMS - 1) // _MAX_GATHER_ELEMS)


def spmm(plan, B, alpha=1.0, beta=1.0, C=None):
    """Dispatch on plan type (COO or ELL).  `C=None` drops the beta
    term."""
    if C is None:
        C = torch.zeros((plan.shape[0], B.shape[1]), dtype=plan.dtype,
                        device=plan.device)
        beta = 0.0
    if isinstance(plan, EllPlan):
        return spmm_ell(plan, B, alpha, beta, C)
    if isinstance(plan, CooPlan):
        return spmm_coo(plan, B, alpha, beta, C,
                        n_chunks=_auto_chunks(plan, B.shape[1]))
    raise TypeError(f"unsupported plan type {type(plan).__name__}")
