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

from .plans import CooPlan, EllPlan, fold, sum_dtype

# Cap on the materialised gather intermediate, in elements (1 GiB of f32).
_MAX_GATHER_ELEMS = 256 * 1024 * 1024


def segment_spmm(rows, cols, vals, B, m: int, n_chunks: int = 1,
                 keep_sum: bool = False):
    """(sorted COO triplets) x B -> (m, k); `n_chunks` > 1 bounds the
    (nnz, k) gather transient by chunking over B's columns.  The sums are
    rounded to the products' type, or with `keep_sum` left in the summing
    type (`sum_dtype`: f32 for bf16), for a partial that is summed on."""
    k = B.shape[1]
    kc = max(-(-k // max(n_chunks, 1)), 1)
    outs = []
    dt = torch.promote_types(vals.dtype, B.dtype)
    acc = sum_dtype(dt)
    for k0 in range(0, max(k, 1), kc):   # k = 0 still yields (m, 0)
        gathered = torch.index_select(B[:, k0:k0 + kc], 0, cols)
        # the products in their own type (bf16 rounds each), stored
        # straight into the summing type's buffer
        contrib = torch.mul(vals[:, None], gathered, out=torch.empty(
            gathered.shape, dtype=acc, device=gathered.device))
        outs.append(torch.zeros((m, contrib.shape[1]), dtype=acc,
                                device=contrib.device).index_add_(
                                    0, rows, contrib
                                ).to(acc if keep_sum else dt))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def _auto_chunks(plan: CooPlan, k: int) -> int:
    total = plan.vals.shape[0] * k
    return max(1, (total + _MAX_GATHER_ELEMS - 1) // _MAX_GATHER_ELEMS)


def spmm_coo(plan: CooPlan, B: torch.Tensor, alpha, beta, C: torch.Tensor,
             n_chunks: int = None) -> torch.Tensor:
    """COO SpMM over `n_chunks` column chunks (None: `_auto_chunks`); a
    bf16 plan's sums stay in f32 into the epilogue, which rounds once
    (`plans.fold`)."""
    ab = segment_spmm(plan.rows, plan.cols, plan.vals, B, plan.shape[0],
                      n_chunks=n_chunks or _auto_chunks(plan, B.shape[1]),
                      keep_sum=True)
    return fold(alpha, ab, beta, C, plan.dtype)


def spmm_ell(plan: EllPlan, B: torch.Tensor, alpha, beta, C: torch.Tensor,
             k_chunk: int = None) -> torch.Tensor:
    """ELL SpMM via one flat B-row gather per column chunk.  bf16 forms the
    products and their slot sums in f32 and rounds each sum once."""
    m = plan.shape[0]
    m_pad, L = plan.cols.shape
    k = B.shape[1]
    kc = k_chunk or max(min(k, _MAX_GATHER_ELEMS // max(m_pad * L, 1)), 1)
    flat = plan.cols.reshape(-1)
    dt = torch.promote_types(plan.vals.dtype, B.dtype)
    acc = sum_dtype(dt)
    outs = []
    for k0 in range(0, max(k, 1), kc):
        gathered = torch.index_select(B[:, k0:k0 + kc], 0, flat)
        gathered = gathered.reshape(m_pad, L, gathered.shape[1])
        outs.append((plan.vals[:, :, None].to(acc) * gathered.to(acc)).sum(
            dim=1).to(dt))
    ab = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return beta * C + alpha * ab[:m]


