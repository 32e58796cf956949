"""Operations and bytes of each measured operation, and the chip's peaks.

Every count is what the operation needs from its inputs, whatever a
plan or kernel reads again: each input byte read once, each output byte
written once.  A CSR matrix is counted as 32-bit column indices and
row pointers beside its values, the compact form the reference's own
format stores.  `bound_s` is the least time the chip could take: the
larger of operations over the peak rate and bytes over the peak
bandwidth (`benchmark/peaks.json`, keyed by the card's name).
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple, Optional

INDEX_BYTES = 4
PEAKS_FILE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "peaks.json")


class Work(NamedTuple):
    flops: float
    bytes: float


def spmm(m: int, n: int, nnz: int, k: int, value_bytes: int = 4) -> Work:
    """C' = beta*C + alpha*A@B with an (m, n) A of nnz entries and a
    K-wide B: 2*nnz*K operations; A (values, column indices, row
    pointers), B, C and C' once."""
    csr = nnz * (value_bytes + INDEX_BYTES) + (m + 1) * INDEX_BYTES
    dense = (n * k + 2 * m * k) * value_bytes
    return Work(2.0 * nnz * k, float(csr + dense))


def pagerank_iteration(n: int, nnz: int, value_bytes: int = 4) -> Work:
    """One power-iteration step on an (n, n) P^T of nnz entries:
    r' = a (P^T r + (d . r)/n) + (1 - a)/n and the L1 change.  P^T once,
    r and the dangling mask read once, r' written once; 2*nnz + 7n
    operations (the product, the dot, the update and the change)."""
    csr = nnz * (value_bytes + INDEX_BYTES) + (n + 1) * INDEX_BYTES
    return Work(2.0 * nnz + 7.0 * n, float(csr + 3 * n * value_bytes))


def peaks(kind: str) -> Optional[dict]:
    """The published peaks of the card named `kind`, or None."""
    with open(PEAKS_FILE) as fh:
        return json.load(fh).get(kind)


def bound_s(work: Work, peak: dict, precision: str = "float32") -> float:
    """Seconds the work needs at least on a card with these peaks."""
    return max(work.flops / peak["flops_per_s"][precision],
               work.bytes / peak["hbm_bytes_per_s"])
