"""Host-resident dense operands: B and C larger than device memory.

Port of `sblas_tpu/memory/dense.py`.  The reference puts the dense
containers in managed memory with the same tuning lifecycle as the sparse
ones (DenseMatrix_um / DenseVector_um, matrix_um.h:735-814): an SpMM
whose C (m x K) exceeds device memory faults pages in and out.  Here
`HostDense` keeps the array in pinned host memory, and
`spmm_um_hostdense` runs over a 2-D grid of host-resident sparse cells,
row bands x column chunks, with

    one A cell + one B column chunk + one C row band

per step on the device (times the in-flight window), whatever m*K or n*K.
The A cells and B chunks stream through `host._stream`; each finished C
band goes into one of `_INFLIGHT` device slots and back to a pinned host
result by a non-blocking device-to-host copy on its own stream, and the
call waits for the last of those copies before it returns.  Structurally
empty cells are skipped.  bf16 cells are sized by 2-byte values and pinned
as bf16, like the bands of `host.py`; a band's cell products are summed
in f32 and rounded once, with the epilogue (`plans.fold`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import DEFAULT, SBlasConfig
from ..containers import CsrMatrix
from ..ops import spmm
from ..ops.plans import fold, host_value_dtype, sum_dtype, value_itemsize
from ..utils import trace
from ..utils.errors import ShapeError, require
from . import host
from .host import (_choose_band_kind, build_band_plan, host_placed,
                   probe_band_dims, tensor_fields)


@dataclasses.dataclass
class HostDense:
    """Dense operand in host memory for the compute device `device`
    (DenseMatrix_um): `values` is pinned when `device` is a CUDA device.
    `apply_gpu_tuning` copies the whole array to the device (only where it
    fits, as in the reference's prefetch mode); `chunk(lo, hi)` gives rows
    [lo, hi) on the device."""

    values: torch.Tensor
    shape: Tuple[int, ...]
    device: torch.device
    _on_device: Optional[torch.Tensor] = None

    @classmethod
    def from_array(cls, arr, *, device) -> "HostDense":
        """A host copy of `arr`, a numpy array or a torch tensor (numpy has
        no bfloat16: pass bf16 values as a tensor), pinned for a CUDA
        `device`."""
        device = torch.device(device)
        t = (arr.detach().cpu() if isinstance(arr, torch.Tensor)
             else torch.from_numpy(np.ascontiguousarray(arr)))
        t = t.contiguous()
        t = t.pin_memory() if device.type == "cuda" else t.clone()
        return cls(values=t, shape=tuple(t.shape), device=device)

    @property
    def tuned(self) -> bool:
        return self._on_device is not None

    def apply_gpu_tuning(self) -> None:
        if self._on_device is None:
            self._on_device = self.values.to(self.device)
            host._sync(self.device)

    def remove_gpu_tuning(self) -> None:
        self._on_device = None

    def apply_cpu_tuning(self) -> None:
        self.remove_gpu_tuning()

    def chunk(self, lo: int, hi: int) -> torch.Tensor:
        """Rows [lo, hi) on the device: a view of the device copy when
        tuned, else a non-blocking copy from host memory on the current
        stream."""
        if self._on_device is not None:
            return self._on_device[lo:hi]
        return self.values[lo:hi].to(self.device, non_blocking=True)

    def to_numpy(self) -> np.ndarray:
        """The host array: a view of `values`, or for bf16 values (numpy
        has no bfloat16) a float32 copy, exact."""
        if self.values.dtype == torch.bfloat16:
            return self.values.float().numpy()
        return self.values.numpy()


@dataclasses.dataclass
class HostResidentGrid:
    """2-D grid of host-resident sparse cells: cell (i, j) holds rows
    [i*band_rows, ...) x columns [j*chunk_cols, ...) of A, columns
    rebased to the chunk.  Missing keys are structurally empty cells."""

    cells: Dict[Tuple[int, int], object]
    band_rows: int
    chunk_cols: int
    n_bands: int
    n_chunks: int
    shape: Tuple[int, int]
    nnz: int
    kind: str
    device: torch.device
    _device_cells: Optional[Dict] = None

    @property
    def dtype(self) -> torch.dtype:
        return next(iter(self.cells.values())).dtype

    @property
    def tuned(self) -> bool:
        return self._device_cells is not None

    def apply_gpu_tuning(self) -> None:
        if self._device_cells is None:
            self._device_cells = {k: v.to(self.device)
                                  for k, v in self.cells.items()}
            host._sync(self.device)

    def remove_gpu_tuning(self) -> None:
        self._device_cells = None

    def apply_cpu_tuning(self) -> None:
        self.remove_gpu_tuning()


def host_resident_grid(A: CsrMatrix, dtype=torch.float32,
                       hbm_budget_bytes: int = 256 << 20, k: int = 64,
                       config: SBlasConfig = DEFAULT,
                       kind: str = None, *, device) -> HostResidentGrid:
    """The row-band x column-chunk cell grid of A for `device`, sized so
    one cell + one B chunk (chunk_cols x k) + one C band (band_rows x k)
    fit in hbm_budget_bytes / _INFLIGHT together."""
    m, n = A.shape
    itemsize = value_itemsize(dtype)
    budget = hbm_budget_bytes / host._INFLIGHT
    # a third of the budget each for the A cell, the B chunk, the C band
    chunk_cols = max(int((budget / 3) // max(k * itemsize, 1)), 128)
    chunk_cols = min(-(-chunk_cols // 128) * 128, -(-max(n, 1) // 128) * 128)
    band_rows = max(int((budget / 3) // max(k * itemsize, 1)), 128)
    band_rows = min(-(-band_rows // 128) * 128, -(-max(m, 1) // 128) * 128)
    n_bands = -(-m // band_rows) if m else 1
    n_chunks = -(-n // chunk_cols) if n else 1
    kind = kind or _choose_band_kind(A, config)

    # slice cells (sub-CSRs with rebased columns)
    cell_csrs: Dict[Tuple[int, int], CsrMatrix] = {}
    coo = A.to_coo()
    band_of = coo.row_idx // band_rows
    chunk_of = coo.col_idx // chunk_cols
    order = np.lexsort((coo.col_idx, coo.row_idx, chunk_of, band_of))
    key = band_of[order] * n_chunks + chunk_of[order]
    starts = np.searchsorted(key, np.arange(n_bands * n_chunks))
    ends = np.append(starts[1:], len(key))
    for cell_id in np.unique(key):
        i, j = int(cell_id) // n_chunks, int(cell_id) % n_chunks
        sel = order[starts[cell_id]:ends[cell_id]]
        rows = coo.row_idx[sel] - i * band_rows
        cols = coo.col_idx[sel] - j * chunk_cols
        rp = np.zeros(band_rows + 1, dtype=np.int64)
        np.add.at(rp, rows + 1, 1)
        rp = np.cumsum(rp)
        cell_csrs[(i, j)] = CsrMatrix(rp, cols, coo.values[sel],
                                      (band_rows, chunk_cols))

    if not cell_csrs:  # empty matrix: one empty cell keeps shapes defined
        cell_csrs[(0, 0)] = CsrMatrix(
            np.zeros(band_rows + 1, np.int64), np.zeros(0, np.int64),
            np.zeros(0, host_value_dtype(dtype)), (band_rows, chunk_cols))

    kind, dim = probe_band_dims(list(cell_csrs.values()), kind, A.nnz,
                                config)
    cells = {key: host_placed(build_band_plan(
        sub, kind, dim, band_rows, chunk_cols, A.nnz, dtype, config,
        device="cpu"), device) for key, sub in cell_csrs.items()}
    return HostResidentGrid(cells=cells, band_rows=band_rows,
                            chunk_cols=chunk_cols, n_bands=n_bands,
                            n_chunks=n_chunks, shape=A.shape, nnz=A.nnz,
                            kind=kind, device=torch.device(device))


class _BandsOut:
    """Finished C bands, written into a ring of `_INFLIGHT` device slots
    and copied back to the pinned host `result` on a side stream; a slot
    is rewritten only after its last copy is done."""

    def __init__(self, result: torch.Tensor, band_rows: int, device):
        self.result, self.device = result, device
        self.cuda = device.type == "cuda"
        depth = host._INFLIGHT
        self.slots = [torch.empty((band_rows, result.shape[1]),
                                  dtype=result.dtype, device=device)
                      for _ in range(depth)]
        self.copied: list = [None] * depth
        self.stream = torch.cuda.Stream(device) if self.cuda else None

    def put(self, i: int, r0: int, r1: int, fill) -> None:
        """Write band i (rows r0:r1) into its slot with `fill(slot)` on
        the current stream, then copy it to `result[r0:r1]`."""
        s = i % len(self.slots)
        slot = self.slots[s][:r1 - r0]
        if not self.cuda:
            fill(slot)
            self.result[r0:r1].copy_(slot)
            return
        current = torch.cuda.current_stream(self.device)
        if self.copied[s] is not None:
            current.wait_event(self.copied[s])
        fill(slot)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            self.result[r0:r1].copy_(slot, non_blocking=True)
            self.copied[s] = torch.cuda.Event()
            self.copied[s].record(self.stream)

    def wait(self) -> None:
        """Block until every copy to `result` has landed."""
        if self.cuda:
            self.stream.synchronize()


def spmm_um_hostdense(grid: HostResidentGrid, B: HostDense, alpha, beta,
                      C: HostDense, tuning: bool = False) -> HostDense:
    """C' = beta*C + alpha*A@B with A, B and C host-resident (reference
    matrix_um.h:735-814: every container in managed memory).

    Returns a new HostDense C', readable as soon as the call returns.
    Device memory: the A-cell and B-chunk ring plus the C-band ring, each
    `_INFLIGHT` deep, whatever m*K / n*K."""
    m, n = grid.shape
    require(B.shape[0] == n, ShapeError,
            f"A width {n} != B height {B.shape[0]}")
    require(C.shape == (m, B.shape[1]), ShapeError,
            f"C shape {C.shape} != ({m}, {B.shape[1]})")
    if tuning:
        grid.apply_gpu_tuning()
        B.apply_gpu_tuning()
    dev, k = grid.device, B.shape[1]
    br, cc = grid.band_rows, grid.chunk_cols
    result = torch.empty((m, k), dtype=torch.promote_types(
        C.values.dtype, grid.dtype), pin_memory=dev.type == "cuda")
    out = _BandsOut(result, br, dev)
    keys = sorted(grid.cells)   # band by band, chunks in order
    cur, acc = 0, None          # the band being summed, and its sum

    def advance(to: int) -> None:
        """Finish bands cur .. to-1 (empty bands: beta*C alone)."""
        nonlocal cur, acc
        while cur < to:
            r0, r1 = cur * br, min((cur + 1) * br, m)
            Ci = C.chunk(r0, r1)
            if acc is None:
                out.put(cur, r0, r1, lambda s: torch.mul(Ci, beta, out=s))
            else:
                out.put(cur, r0, r1, lambda s: fold(
                    alpha, acc[:r1 - r0], beta, Ci, grid.dtype, out=s))
            cur, acc = cur + 1, None

    def on_cell(idx: int, cell, Bj) -> None:
        nonlocal acc
        advance(keys[idx][0])
        prod = spmm(cell, Bj)
        prod = prod.to(sum_dtype(prod.dtype))
        acc = prod if acc is None else acc + prod

    def b_rows(idx: int):
        j = keys[idx][1]
        return j * cc, min((j + 1) * cc, n)

    # the chunk's rows only: cell columns are rebased below c1 - c0, so
    # the kernels read no padding rows
    if grid.tuned:
        for idx, key in enumerate(keys):
            with trace.span("sblas.um.compute", cell=key):
                on_cell(idx, grid._device_cells[key], B.chunk(*b_rows(idx)))
    else:
        names = tensor_fields(grid.cells[keys[0]])
        items = [[getattr(grid.cells[key], f) for f in names]
                 + ([] if B.tuned else [B.values[slice(*b_rows(idx))]])
                 for idx, key in enumerate(keys)]

        def on_device(idx: int, views: list) -> None:
            cell = dataclasses.replace(grid.cells[keys[idx]],
                                       **dict(zip(names, views)))
            Bj = B.chunk(*b_rows(idx)) if B.tuned else views[-1]
            on_cell(idx, cell, Bj)

        side = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        host._stream(items, dev, on_device, side)
    advance(grid.n_bands)
    out.wait()
    return HostDense(values=result, shape=(m, k), device=dev)


def spmv_um_hostdense(grid: HostResidentGrid, x: HostDense, alpha, beta,
                      y: HostDense, tuning: bool = False) -> HostDense:
    """y' = beta*y + alpha*A@x with A, x and y host-resident (reference
    DenseVector_um, matrix_um.h:918-1075): the cell grid with a width-1
    dense operand."""
    require(x.shape == (grid.shape[1],), ShapeError,
            f"x shape {x.shape} != ({grid.shape[1]},)")
    require(y.shape == (grid.shape[0],), ShapeError,
            f"y shape {y.shape} != ({grid.shape[0]},)")

    def column(v: HostDense) -> HostDense:
        return HostDense(values=v.values.reshape(-1, 1),
                         shape=(v.shape[0], 1), device=v.device,
                         _on_device=(None if v._on_device is None
                                     else v._on_device.reshape(-1, 1)))

    out = spmm_um_hostdense(grid, column(x), alpha, beta, column(y),
                            tuning=tuning)
    return HostDense(values=out.values.reshape(-1), shape=(grid.shape[0],),
                     device=out.device)
