"""The benchmark's own inputs and its plain reference.

Nothing here imports the program under test.  The matrix patterns are
frozen copies of the structure-matched proxies the program ships
(`webbase_like`, `fem_shell_like`, and PageRank's `transition`), so a
later change to the program's generators cannot move the yardstick.
Only the patterns are copied: the values an SpMM cell multiplies are
drawn from the run's seed (`draw_values`).

The reference products and the PageRank iteration run in float64 with
plain torch operations (a gather, a product and an `index_add_` over
blocks of stored entries), on whatever device the operands live on.
`tf32` rounds float32 to TF32's 10-bit mantissa: the control puts the
reference, computed from TF32-rounded inputs, in the program's place.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

# stored entries per block of the reference products (bounds the
# (block, K) float64 temporary: 2**20 x 64 x 8 bytes = 512 MiB)
NNZ_BLOCK = 1 << 20


@dataclasses.dataclass(frozen=True)
class Csr:
    """A host CSR matrix: int64 row_ptr (m+1,) and col_idx (nnz,),
    values (nnz,) in the configuration's value type."""

    row_ptr: np.ndarray
    col_idx: np.ndarray
    values: np.ndarray
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return len(self.col_idx)


def _csr_pattern(m: int, n: int, rows, cols):
    """(row_ptr, col_idx) of the unique (row, col) pairs, sorted by row
    then column: the pattern the program's COO-to-CSR conversion gives
    after summing duplicates."""
    key = np.unique(rows.astype(np.int64) * np.int64(n) + cols)
    r, c = key // n, key % n
    row_ptr = np.zeros(m + 1, dtype=np.int64)
    np.cumsum(np.bincount(r, minlength=m), out=row_ptr[1:])
    return row_ptr, c.astype(np.int64)


def webbase_like(n: int = 1_000_000, avg_deg: float = 3.1, seed: int = 211,
                 local_frac: float = 0.6, local_scale: float = 2_000.0):
    """Pattern of the web-graph proxy of webbase-1M: power-law
    out-degrees, 60 % of links to a two-sided geometric neighbourhood of
    the row, the rest to log-uniform (Zipf(1) in-degree) hub columns.
    The random stream is drawn in the program's order, so the pattern
    is the program's `io.generate.webbase_like` pattern."""
    rng = np.random.RandomState(seed)
    raw = np.minimum(rng.zipf(2.1, size=n).astype(np.int64), 5000)
    deg = np.maximum((raw * (avg_deg / raw.mean())).astype(np.int64), 1)
    rows = np.repeat(np.arange(n, dtype=np.int64), deg)
    ne = len(rows)
    is_local = rng.random_sample(ne) < local_frac
    off = rng.geometric(1.0 / local_scale, size=ne).astype(np.int64)
    off *= rng.randint(0, 2, size=ne) * 2 - 1
    local_cols = np.clip(rows + off, 0, n - 1)
    u = rng.random_sample(ne)
    hub_cols = np.minimum(np.exp(u * np.log(n)).astype(np.int64), n - 1)
    cols = np.where(is_local, local_cols, hub_cols)
    return _csr_pattern(n, n, rows, cols), (n, n)


def fem_shell_like(nx: int = 201, ny: int = 75, dof: int = 6,
                   n_target: int = 90_449, seed: int = 211):
    """Pattern of the s3dkq4m2 proxy: the stiffness pattern of a
    circumferentially wrapped nx x ny quadrilateral shell mesh with
    `dof` unknowns a node, two nodes coupled where they share an
    element, cut to `n_target` rows.  Deterministic (`seed` only drew
    the program's values)."""
    del seed
    ii, jj = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    ii, jj = ii.ravel(), jj.ravel()
    p = jj * nx + ii
    a = np.arange(dof)
    rows_l, cols_l = [], []
    for dj in (-1, 0, 1):
        for di in (-1, 0, 1):
            j2 = jj + dj
            keep = (j2 >= 0) & (j2 < ny)
            q = j2 * nx + (ii + di) % nx
            src, dst = p[keep], q[keep]
            upper = src <= dst
            su, du = src[upper], dst[upper]
            shp = (len(su), dof, dof)
            r_idx = np.broadcast_to(
                su[:, None, None] * dof + a[None, :, None], shp).ravel()
            c_idx = np.broadcast_to(
                du[:, None, None] * dof + a[None, None, :], shp).ravel()
            rows_l += [r_idx, c_idx]
            cols_l += [c_idx, r_idx]
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    keep = (rows < n_target) & (cols < n_target)
    return (_csr_pattern(n_target, n_target, rows[keep], cols[keep]),
            (n_target, n_target))


GENERATORS = {"webbase_like": webbase_like, "fem_shell_like": fem_shell_like}


def pattern(spec: dict):
    """((row_ptr, col_idx), shape) of a configuration's `matrix` entry:
    {"generator": name, "params": {...}}."""
    return GENERATORS[spec["generator"]](**spec["params"])


def draw_values(nnz: int, seed: int, dtype=np.float32) -> np.ndarray:
    """A's values, uniform in [0, 1), from the run's seed."""
    return np.random.default_rng([seed, 0]).random(nnz, dtype=np.float64
                                                   ).astype(dtype)


def transition(row_ptr, col_idx, n: int, dtype=np.float32):
    """(P^T, dangling): edge i -> j of the graph contributes
    1/outdeg(i) at (j, i) of P^T; dangling marks pages with no
    out-link.  The program's `examples.pagerank.transition`, copied."""
    outdeg = np.diff(row_ptr)
    src = np.repeat(np.arange(n, dtype=np.int64), outdeg)
    order = np.argsort(col_idx * np.int64(n) + src, kind="stable")
    dst, src = col_idx[order], src[order]
    pt_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(np.bincount(dst, minlength=n), out=pt_ptr[1:])
    vals = (1.0 / np.maximum(outdeg, 1).astype(np.float64))[src]
    return (Csr(pt_ptr, src, vals.astype(dtype), (n, n)),
            (outdeg == 0).astype(dtype))


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest (ties to even) at TF32's 10-bit
    mantissa, the precision a tensor core reads float32 in when TF32 is
    on."""
    bits = x.contiguous().view(torch.int32)
    odd = (bits >> 13) & 1
    return ((bits + 0x0FFF + odd) & ~0x1FFF).view(torch.float32)


class DeviceCsr:
    """A's entries on a device as float64 COO blocks: what the reference
    products read.  `values` may be replaced (`rounded`) to feed the
    control lower-precision inputs."""

    def __init__(self, A: Csr, device, values: torch.Tensor = None):
        self.shape = A.shape
        counts = torch.as_tensor(np.diff(A.row_ptr), device=device)
        self.rows = torch.repeat_interleave(
            torch.arange(A.shape[0], device=device), counts)
        self.cols = torch.as_tensor(A.col_idx, device=device)
        self.values = (values if values is not None else torch.as_tensor(
            A.values, device=device)).to(torch.float64)

    def blocks(self):
        for lo in range(0, len(self.cols), NNZ_BLOCK):
            hi = lo + NNZ_BLOCK
            yield self.rows[lo:hi], self.cols[lo:hi], self.values[lo:hi]

    def matmul(self, X: torch.Tensor, absolute: bool = False):
        """A @ X (or |A| @ |X|) in float64; X is (n,) or (n, K)."""
        X = X.to(torch.float64)
        if absolute:
            X = X.abs()
        out = X.new_zeros((self.shape[0],) + tuple(X.shape[1:]))
        for r, c, v in self.blocks():
            v = v.abs() if absolute else v
            x = X[c]
            out.index_add_(0, r, x * (v[:, None] if x.dim() == 2 else v))
        return out


def spmm(A: DeviceCsr, B, C, alpha: float, beta: float):
    """(beta*C + alpha*A@B, |beta||C| + |alpha||A||B|), both float64:
    the product and the scale each element's error is judged against."""
    C64 = C.to(torch.float64)
    ref = beta * C64 + alpha * A.matmul(B)
    scale = abs(beta) * C64.abs() + abs(alpha) * A.matmul(B, absolute=True)
    return ref, scale


def pagerank_step(PT: DeviceCsr, r, dang, damping: float):
    """One power-iteration step, r' = a (P^T r + (dang . r)/n) + (1-a)/n,
    in r's precision (float64 for the reference)."""
    n = PT.shape[0]
    spread = PT.matmul(r).to(r.dtype)
    return damping * (spread + torch.dot(dang, r) / n) + (1.0 - damping) / n


def pagerank_steps(PT: DeviceCsr, r0, dang, damping: float, steps: int):
    """r after exactly `steps` float64 steps from r0."""
    r = r0.to(torch.float64)
    d = dang.to(torch.float64)
    for _ in range(steps):
        r = pagerank_step(PT, r, d, damping)
    return r


def pagerank_fixed_point(PT: DeviceCsr, dang, damping: float,
                         tol: float = 1e-14, maxiter: int = 1000):
    """The float64 PageRank vector: power iteration from the uniform
    vector until the L1 change is below `tol`."""
    n = PT.shape[0]
    d = dang.to(torch.float64)
    r = torch.full((n,), 1.0 / n, dtype=torch.float64, device=d.device)
    for _ in range(maxiter):
        r_n = pagerank_step(PT, r, d, damping)
        delta = float((r_n - r).abs().sum())
        r = r_n
        if delta < tol:
            break
    return r
