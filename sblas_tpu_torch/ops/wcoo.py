"""Windowed-COO plan: unstructured SpMV/SpMM, SpMM through kernel K3.

Port of `sblas_tpu/ops/wcoo.py`.  Entries are tiled 512 at a time in CSR
order; each tile is assigned a 128-aligned row window of depth 256 that
holds all its rows (tiles are split when empty-row gaps would overflow
the window), so every entry's output row is `wb[t] * 128 + relrow`.  The
layout builder is the JAX package's numpy code, carried over, so the plan
arrays are byte-identical.

The JAX package built this layout to avoid the TPU's slow elementwise
gather and scatter (block gathers + one-hot picks, one-hot MXU window
reduces).  The H100 gathers and scatters directly, so:

* SpMV: `vals * x[col]`, then `index_add_` on the absolute row ids;
* SpMM: kernel K3 (`window_reduce`, csrc/wcoo_kernels.cu) gathers the B
  rows and reduces them, one call per column chunk with the JAX package's
  chunk width, so the call count is its chunk count.

K3 balances its work by entries, not rows: the real slots (row-sorted in
CSR order) are cut into units of at most `UNIT` slots, one warp each,
and rows that cross a unit boundary are summed from per-unit carries in
a second pass.  Its tables, `k3_units` and `k3_rows` (`k3_tables`), are
port-only plan fields, built once with the plan and derived from the
JAX package's arrays when a plan comes from there or from an older
cache file.  `visit0`/`visit1` stay for parity of the arrays, though no
kernel here needs them.

bf16 plans: K3 reads bf16 values and B rows, sums each unit's rows and
carries in f32 and rounds each output element once; its plain version
sums in f32 and rounds once too (the JAX kernel accumulated across tiles
in its bf16 output block, so both are at least as accurate as it).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from .. import _kernels
from ..config import DEFAULT, SBlasConfig
from ..containers import CsrMatrix
from ..utils.errors import KernelError, PlanError, require
from .plans import Plan, _round_up, host_value_dtype, sum_dtype

TILE = 512          # nnz per tile
WINDOW = 256        # row-window depth (two 128 blocks)
UNIT = 128          # K3 work unit: at most this many slots, one warp
_LEFT, _RIGHT = 1 << 16, 1 << 17   # k3_units[:, 1] flags above the length

# Transient budget of spmm_wcoo in elements, and the widest K-chunk: kept
# equal to the JAX package's so the chunk count (K3's launch count) is
# the same.
_K_BUDGET_ELEMS = 256 * 1024 * 1024
_K_CHUNK_MAX = 512


@dataclasses.dataclass(frozen=True)
class WcooPlan(Plan):
    """Windowed COO layout (see module docstring).

    xblk: (T*TILE,) i32   column block id of each nnz (col // 128)
    lane: (T*TILE,) i32   lane within the block (col % 128)
    vals: (T*TILE,)       values (padding slots are 0)
    relrow: (T, TILE) i32 row - window start, in [0, WINDOW)
    half_ids: (2T,) i32   destination row-block id of each window half
    wb: (T,) i32          window block id per tile (monotone)
    visit0/visit1: (n_row_blocks,) {0,1} blocks a tile's first/second
                          half visits
    k3_units: (U, 2) i32  K3's work units (port only, `k3_tables`)
    k3_rows: (R, 3) i32   rows K3's second pass writes (port only)
    """

    xblk: torch.Tensor
    lane: torch.Tensor
    vals: torch.Tensor
    relrow: torch.Tensor
    half_ids: torch.Tensor
    wb: torch.Tensor
    visit0: torch.Tensor
    visit1: torch.Tensor
    k3_units: torch.Tensor
    k3_rows: torch.Tensor
    shape: Tuple[int, int]
    nnz: int
    n_tiles: int
    n_row_blocks: int

    @property
    def fill_ratio(self) -> float:
        """Stored slots / true nnz (tile-split + padding overhead)."""
        return self.vals.shape[0] / max(self.nnz, 1)

    @property
    def k3(self) -> "K3Schedule":
        """K3's schedule, the first argument of `window_reduce`."""
        return K3Schedule(self.k3_units, self.k3_rows, self.n_row_blocks)

    PORT_FIELDS = ("k3_units", "k3_rows")

    @staticmethod
    def port_fields(fields: dict, meta: dict) -> dict:
        """The port-only fields, from the plan's host arrays (`fields`) and
        `n_row_blocks` (in `meta`)."""
        return k3_tables(*(np.asarray(fields[k]) for k in
                           ("wb", "relrow", "vals", "xblk", "lane")),
                         int(meta["n_row_blocks"]))

    @classmethod
    def from_numpy(cls, fields: dict, meta: dict, device,
                   dtype=None) -> "WcooPlan":
        """As `Plan.from_numpy`; the port-only fields are derived when the
        fields (e.g. the JAX package's plan) lack them."""
        if any(k not in fields for k in cls.PORT_FIELDS):
            fields = dict(cls.port_fields(fields, meta), **fields)
        return super().from_numpy(fields, meta, device, dtype=dtype)

    @classmethod
    def from_csr(cls, A: CsrMatrix, dtype=torch.float32,
                 config: SBlasConfig = DEFAULT, *,
                 min_tiles: int = 0, device) -> "WcooPlan":
        """`min_tiles` pads the tile count (pad tiles carry val=0 anchored
        at the last window and contribute nothing)."""
        np_val = host_value_dtype(dtype)
        arr = wcoo_plan_arrays(A, min_tiles=min_tiles, np_val=np_val)
        meta = {k: arr.pop(k) for k in ("n_tiles", "n_row_blocks")}
        arr["vals"] = arr["vals"].astype(np_val)
        return cls.from_numpy(arr, dict(meta, shape=A.shape, nnz=A.nnz),
                              device, dtype=dtype)


class K3Schedule(NamedTuple):
    """K3's tables (`k3_tables`) and the height of its row grid, in
    128-row blocks."""
    units: torch.Tensor
    rows: torch.Tensor
    n_row_blocks: int


def _real_slot_counts(relrow: np.ndarray, vals: np.ndarray,
                     xblk: np.ndarray, lane: np.ndarray) -> np.ndarray:
    """(T,) real slots of each tile: one past its last slot that is not
    all zeros.  A tile's padding (val, relrow, xblk, lane all 0) trails
    its entries; an entry that is all zeros adds 0 * B[0] to its row, so
    counting it out changes nothing for finite B."""
    T = relrow.shape[0]
    live = ((relrow.reshape(T, TILE) != 0) | (vals.reshape(T, TILE) != 0)
            | (xblk.reshape(T, TILE) != 0) | (lane.reshape(T, TILE) != 0))
    last = TILE - np.argmax(live[:, ::-1], axis=1)
    return np.where(live.any(axis=1), last, 0)


def k3_tables(wb, relrow, vals, xblk, lane, n_row_blocks: int,
              unit: int = UNIT) -> dict:
    """K3's work tables, from the plan's host arrays.

    The real slots, in slot order, hold non-decreasing rows (CSR order,
    tile after tile).  Each tile's real slots are cut into units of at
    most `unit` slots (`unit` divides TILE, so a unit lies in one tile):

    * ``k3_units`` (U, 2) int32: each unit's first slot, and its length
      with `_LEFT` set where its first row continues from the unit before
      and `_RIGHT` where its last row continues into the unit after.
      Each unit stores the rows that lie wholly inside it; a first row
      marked `_LEFT` goes to its carry 0 and any other last row marked
      `_RIGHT` to its carry 1.
    * ``k3_rows`` (R, 3) int32 `(row, u0, u1)`, by row: every row of the
      grid that no unit stores.  A row spanning units u0 < u1 (a boundary
      row) is carry 1 of u0 plus carry 0 of u0+1 .. u1, in that order;
      a row with no real slot has the empty range (0, -1) and is 0.

    So every row of the `n_row_blocks * 128` grid has exactly one owner."""
    require(TILE % unit == 0, PlanError,
            f"unit {unit} must divide the tile of {TILE}")
    T = wb.shape[0]
    require(T * TILE < 2 ** 31, PlanError,
            f"{T} tiles exceed K3's int32 slot index")
    n_real = _real_slot_counts(relrow, vals, xblk, lane)
    per_tile = -(-n_real // unit)
    tile = np.repeat(np.arange(T), per_tile)
    j = np.arange(tile.size) - np.repeat(np.cumsum(per_tile) - per_tile,
                                         per_tile)
    start = tile * TILE + j * unit
    length = np.minimum(unit, n_real[tile] - j * unit)
    rows = (np.asarray(wb, np.int64)[:, None] * 128
            + relrow.reshape(T, TILE))[np.arange(TILE) < n_real[:, None]]
    require(bool(np.all(np.diff(rows) >= 0)), PlanError,
            "K3 needs the real slots in row order")
    ends = np.cumsum(length)
    first, last = rows[ends - length], rows[ends - 1]
    left = np.zeros(tile.size, bool)
    right = np.zeros(tile.size, bool)
    left[1:] = first[1:] == last[:-1]
    right[:-1] = left[1:]
    brows = np.unique(last[right])
    u0 = np.searchsorted(last, brows, side="left")
    u1 = np.searchsorted(first, brows, side="right") - 1
    empty = np.setdiff1d(np.arange(n_row_blocks * 128), rows)
    k3_rows = np.concatenate([
        np.stack([brows, u0, u1], axis=1),
        np.stack([empty, np.zeros_like(empty), np.full_like(empty, -1)],
                 axis=1)])
    k3_rows = k3_rows[np.argsort(k3_rows[:, 0], kind="stable")]
    info = length | np.where(left, _LEFT, 0) | np.where(right, _RIGHT, 0)
    return {"k3_units": np.stack([start, info], axis=1).astype(np.int32),
            "k3_rows": k3_rows.astype(np.int32)}


def wcoo_plan_arrays(A, min_tiles: int = 0, np_val=np.float32):
    """`wcoo_arrays` plus wb (each tile's first row block) and the
    visit0/visit1 indicators."""
    arr = wcoo_arrays(A, min_tiles=min_tiles)
    wb = arr["half_ids"][0::2]
    nb = arr["n_row_blocks"]
    visit0 = np.zeros(nb, dtype=np_val)
    visit1 = np.zeros(nb, dtype=np_val)
    visit0[wb] = 1
    visit1[np.minimum(wb + 1, nb - 1)] = 1
    arr.update(wb=wb, visit0=visit0, visit1=visit1)
    return arr


def wcoo_tile_count(A: CsrMatrix) -> int:
    """Natural tile count of the windowed-COO layout (the greedy tiling
    loop, no array construction)."""
    rows = np.repeat(np.arange(A.shape[0], dtype=np.int64), A.row_nnz)
    nnz = A.nnz
    if not nnz:
        return 1
    anchors = ((rows >> 7) + WINDOW // 128) * 128
    limit = np.searchsorted(rows, anchors, side="left")
    count, i = 0, 0
    while i < nnz:
        count += 1
        i = min(i + TILE, int(limit[i]))
    return count


def wcoo_fill_ratio(A: CsrMatrix) -> float:
    """`WcooPlan.fill_ratio` of the plan `WcooPlan.from_csr(A)` would
    build: stored slots / true nnz."""
    return wcoo_tile_count(A) * TILE / max(A.nnz, 1)


def wcoo_arrays(A: CsrMatrix, min_tiles: int = 0) -> dict:
    """Windowed-COO layout as host numpy arrays."""
    coo = A.to_coo()  # CSR order: rows ascending
    return _wcoo_layout(coo.row_idx, coo.col_idx, coo.values, A.shape[0],
                        min_tiles)


def _wcoo_layout(rows: np.ndarray, col_ids: np.ndarray,
                 values: np.ndarray, m: int, min_tiles: int = 0) -> dict:
    """Tile one entry class (rows must be ascending)."""
    nnz = len(rows)

    # --- greedy tiling: <= TILE nnz per tile, all rows inside the
    # 128-aligned window of depth WINDOW anchored at the tile's first row
    if nnz:
        # limit[i]: first j whose row leaves the window anchored at i
        anchors = ((rows >> 7) + WINDOW // 128) * 128
        limit = np.searchsorted(rows, anchors, side="left")
        starts = []
        i = 0
        while i < nnz:
            starts.append(i)
            i = min(i + TILE, int(limit[i]))
        starts = np.asarray(starts, dtype=np.int64)
    else:
        starts = np.zeros(1, dtype=np.int64)
    T_real = len(starts)
    T = max(T_real, int(min_tiles))
    ends = np.concatenate([starts[1:], [nnz]])
    counts = np.pad(ends - starts, (0, T - T_real))

    # --- scatter nnz into (T, TILE) slots
    slot_tile = np.repeat(np.arange(T), counts)
    slot_pos = np.arange(nnz) - np.repeat(starts, counts[:T_real])
    vals = np.zeros((T, TILE), dtype=values.dtype)
    xblk = np.zeros((T, TILE), dtype=np.int64)
    lane = np.zeros((T, TILE), dtype=np.int64)
    relrow = np.zeros((T, TILE), dtype=np.int64)
    window = np.zeros(T, dtype=np.int64)
    if nnz:
        window[:T_real] = (rows[starts] // 128) * 128
        # pad tiles (min_tiles) anchor at the LAST real window, keeping
        # the tile->window sequence monotone
        window[T_real:] = window[T_real - 1]
        vals[slot_tile, slot_pos] = values
        xblk[slot_tile, slot_pos] = col_ids >> 7
        lane[slot_tile, slot_pos] = col_ids & 127
        relrow[slot_tile, slot_pos] = rows - window[slot_tile]
    assert relrow.max(initial=0) < WINDOW

    # --- two 128-row halves per tile, in tile order
    half_ids = np.stack([window // 128, window // 128 + 1],
                        axis=1).reshape(-1)          # (2T,)
    m_pad = _round_up(max(m, 1), 128)
    n_row_blocks = m_pad // 128 + 1  # +1: windows may overhang the edge

    return {
        "xblk": xblk.reshape(-1).astype(np.int32),
        "lane": lane.reshape(-1).astype(np.int32),
        "vals": vals.reshape(-1),
        "relrow": relrow.astype(np.int32),
        "half_ids": half_ids.astype(np.int32),
        "n_tiles": T,
        "n_row_blocks": n_row_blocks,
    }


def _x_blocks(plan: WcooPlan, x: torch.Tensor) -> torch.Tensor:
    """x zero-padded to whole 128-lane blocks, viewed (n_pad/128, 128)."""
    n_pad = _round_up(plan.shape[1], 128)
    return torch.nn.functional.pad(x, (0, n_pad - x.shape[0])).reshape(
        -1, 128)


def _gathered_contrib(plan: WcooPlan, x: torch.Tensor) -> torch.Tensor:
    """contrib[i] = vals[i] * x[cols[i]], one (xblk, lane) gather."""
    return plan.vals * _x_blocks(plan, x)[plan.xblk, plan.lane]


def _row_ids(wb: torch.Tensor, relrow: torch.Tensor) -> torch.Tensor:
    """(T*TILE,) absolute output row of every slot (int64)."""
    return (wb.long()[:, None] * 128 + relrow).reshape(-1)


def _window_reduce(plan: WcooPlan, contrib: torch.Tensor) -> torch.Tensor:
    """(T*TILE,) contributions -> (n_row_blocks*128,) y (bf16 summed in
    f32 and rounded once, as K3 does)."""
    acc = sum_dtype(contrib.dtype)
    return torch.zeros(plan.n_row_blocks * 128, dtype=acc,
                       device=contrib.device).index_add_(
                           0, _row_ids(plan.wb, plan.relrow),
                           contrib.to(acc)).to(contrib.dtype)


def spmv_wcoo(plan: WcooPlan, x: torch.Tensor, alpha, beta,
              y: torch.Tensor) -> torch.Tensor:
    m = plan.shape[0]
    ax = _window_reduce(plan, _gathered_contrib(plan, x))[:m]
    return beta * y + alpha * ax


# ---------------------------------------------------------------------------
# Kernel K3 and the SpMM
# ---------------------------------------------------------------------------

def window_reduce_plain(k3: K3Schedule, wb, relrow, vals, xblk, lane, B,
                        k0: int, width: int) -> torch.Tensor:
    """Plain PyTorch K3: (nb*128, width) rows of A @ B[:, k0:k0+width]
    on the plan's padded row grid, nb = `k3.n_row_blocks`: every slot adds
    vals * B[xblk*128 + lane, k0:k0+width] into row wb*128 + relrow.  bf16
    sums in f32 and rounds once."""
    acc = sum_dtype(vals.dtype)
    cols = xblk.long() * 128 + lane
    contrib = vals.to(acc)[:, None] * torch.index_select(
        B[:, k0:k0 + width], 0, cols).to(acc)
    return torch.zeros((k3.n_row_blocks * 128, width), dtype=acc,
                       device=vals.device).index_add_(
                           0, _row_ids(wb, relrow), contrib).to(vals.dtype)


def window_reduce(k3: K3Schedule, wb, relrow, vals, xblk, lane, B, k0: int,
                  width: int) -> torch.Tensor:
    """Windowed reduce (see `window_reduce_plain`).  CPU tensors take the
    plain version; CUDA tensors launch kernel K3 (two device launches:
    the units, then the carry combine) or raise."""
    if vals.device.type == "cpu":
        return window_reduce_plain(k3, wb, relrow, vals, xblk, lane, B,
                                   k0, width)
    dev = vals.device
    require(dev.type == "cuda", KernelError,
            f"window_reduce runs on cpu or cuda, not {dev}")
    fn = _kernels.launcher("window_reduce", _kernels.value_suffix(vals.dtype))
    T = wb.shape[0]
    U, R = k3.units.shape[0], k3.rows.shape[0]
    require(B.dim() == 2 and 0 <= k0 and k0 + width <= B.shape[1],
            KernelError, f"columns {k0}:{k0 + width} out of B "
            f"{tuple(B.shape)}")
    _kernels.check_operand(k3.units, "k3.units", torch.int32, (U, 2), dev)
    _kernels.check_operand(k3.rows, "k3.rows", torch.int32, (R, 3), dev)
    _kernels.check_operand(wb, "wb", torch.int32, (T,), dev)
    _kernels.check_operand(relrow, "relrow", torch.int32, (T, TILE), dev)
    _kernels.check_operand(vals, "vals", vals.dtype, (T * TILE,), dev)
    _kernels.check_operand(xblk, "xblk", torch.int32, (T * TILE,), dev)
    _kernels.check_operand(lane, "lane", torch.int32, (T * TILE,), dev)
    _kernels.check_operand(B, "B", vals.dtype, tuple(B.shape), dev)
    out = torch.empty((k3.n_row_blocks * 128, width), dtype=vals.dtype,
                      device=dev)
    carry = torch.empty((U, 2, width), dtype=sum_dtype(vals.dtype),
                        device=dev)
    _kernels.launch(fn, dev, k3.units, k3.rows, wb, relrow, vals, xblk, lane,
                    B, out, carry, U, R, B.shape[1], k0, width)
    window_reduce.launches += 1
    return out


window_reduce.launches = 0   # K3 calls (two device launches each)


def k_chunk_width(n_tiles: int, k: int) -> int:
    """The JAX package's K-chunk width: bounded by `_K_CHUNK_MAX` and by
    `_K_BUDGET_ELEMS` over the slot count."""
    return max(min(k, _K_CHUNK_MAX,
                   _K_BUDGET_ELEMS // max(n_tiles * TILE, 1)), 1)


def _window_reduce_range(plan: WcooPlan, B: torch.Tensor, k0: int,
                         k1: int) -> torch.Tensor:
    """One K-chunk: (n_row_blocks*128, k1-k0) rows of A @ B[:, k0:k1]."""
    return window_reduce(plan.k3, plan.wb, plan.relrow, plan.vals,
                         plan.xblk, plan.lane, B, k0, k1 - k0)


def spmm_wcoo(plan: WcooPlan, B: torch.Tensor, alpha, beta, C: torch.Tensor,
              k_chunk: int = None) -> torch.Tensor:
    """C' = beta*C + alpha*A@B: one K3 launch per K-chunk of width
    `k_chunk` (default: the JAX package's choice)."""
    m, k = plan.shape[0], B.shape[1]
    B = B.to(plan.dtype).contiguous()
    kc = k_chunk or k_chunk_width(plan.n_tiles, k)
    outs = [_window_reduce_range(plan, B, k0, min(k0 + kc, k))[:m]
            for k0 in range(0, max(k, 1), kc)]
    ab = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return beta * C + alpha * ab
