"""Routed SpMV: the gather/route/stack engine, on PyTorch and CUDA.

Port of `sblas_tpu/ops/rspmv.py`.  The JAX package built this engine for a
TPU, whose elementwise gather ran at ~2.3 ns/element (JAX package's v5e
measurement): every stage replaces per-element addressing with 128-lane
primitives.

1. **Slab-bucket gather (kernel K2, csrc/rspmv_kernels.cu).**  x, after a
   balanced column relabel (one small route), is viewed as (n/16384)
   slabs of (128, 128).  Nonzeros are grouped per slab and bucketed by
   row of the slab, so each (128, 128) gather tile reads all its x values
   from one slab row by row: out = gvals * x_slab[r, gidx].  The
   distributed per-shard SpMV copies each tile's slab out first and runs
   kernel K2' (`tile_gather`) over the copies, as the JAX package does
   inside `shard_map`.
2. **Routed permutation (ops/route.py, kernel K1).**  Contributions move
   from gather order to reduce order through the Clos/Benes layer program
   (lane shuffles + transposes, tables from plan-time edge colouring).
3. **Lane-stack reduce.**  Rows are relabelled by descending degree; the
   row of rank r' owns lane r' % 128 of block r' // 128 and its
   contributions stack vertically in that lane, so the reduce is one
   row-granular segment sum over the (S, 128) stack (`segment_reduce`
   here: the same order of additions on every run).
   Heavy rows overflow into an appendix merged by one small scatter-add,
   and a second route un-relabels y.

Hub columns (in-degree >= config.routed_peel_threshold) bypass the slab
buckets: their entries fill whole 128-lane rows that each broadcast one x
element.

Route transport (`config.routed_transport`, the JAX package's opt-in):
"f32" routes the contributions at the value dtype; "bf16" (float32 values
only) forms each product at f32, rounds it once to bf16 as K2 or K2'
stores it, moves it through the main route as bf16 with int16 tables (K1
on 16-bit lanes: half the bytes of every pass), and upcasts the stack to
x's dtype before the segment sum.  The x-relabel and unrank routes stay
at x's dtype with int32 tables.  `RoutedPlan.with_transport` switches an
existing plan either way.  Plans also take bfloat16 values (at f32
transport): the host layout is built in float32 and narrowed once when
it is placed, and every stage computes at x's dtype, as the JAX
package's does.

The plan layout (`RoutedPlan.from_csr` and the helpers below) is the JAX
package's numpy code, carried over so both packages build byte-identical
arrays; plans are frozen dataclasses of torch tensors on an explicit
device.  Between the two kernels everything stays plain torch, as it was
XLA in the JAX package.  Planning is analysis-heavy (edge colouring over
~nnz edges, seconds at 1M rows with the native library): build once, run
many.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import _kernels
from ..config import DEFAULT, SBlasConfig
from ..containers import CsrMatrix
from ..io import native
from .plans import HOST_VALUE, host_value_dtype
from .route import LANES, apply_route, build_route, routable_size

SLAB = 128 * 128     # x window served by one gather tile


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# numpy integer floor-divide/mod are unvectorized per-element divides on
# the JAX package's host — over nnz-sized arrays that is seconds of plan-
# build time, so every power-of-two divisor below uses shift/mask.
_SLAB_SHIFT = SLAB.bit_length() - 1   # 14
_LANE_SHIFT = 7                       # LANES == 128


def _pow2_shift(d: int):
    """log2(d) when d is a power of two, else None (caller falls back to
    the generic divide)."""
    return d.bit_length() - 1 if d > 0 and (d & (d - 1)) == 0 else None


def _run_local_pos(keys_sorted: np.ndarray, nnz: int) -> np.ndarray:
    """Position of each element within its run of equal keys (keys sorted).

    Streaming replacement for `arange - searchsorted(keys, keys, "left")`
    (the binary search measured ~2 s per 12M-entry call at stress scale):
    mark run starts with one shifted compare, hold each run's start index
    with a cummax, subtract."""
    idx = np.arange(nnz, dtype=np.int32)
    if nnz == 0:
        return idx
    run_start = np.empty(nnz, dtype=bool)
    run_start[0] = True
    np.not_equal(keys_sorted[1:], keys_sorted[:-1], out=run_start[1:])
    return idx - np.maximum.accumulate(np.where(run_start, idx, 0))


# ---------------------------------------------------------------------------
# Layout math (numpy, carried from the JAX package; see routed_plan_arrays)
# ---------------------------------------------------------------------------

def _balanced_relabel(n: int, res_cols: np.ndarray):
    """Column permutation pi (n,) balancing residual gather load across
    (slab, bucket) pairs: columns sorted by descending count snake-fill
    the buckets, so every bucket's total lands within one column of the
    mean and tiles_per_slab collapses to ~ceil(mean/128).

    Without this the bucket maxima govern the tile count: on the skewed
    webbase proxy T_g*SLAB was 4.9M slots for 2.43M residual nnz; balanced
    it is ~3.1M, which (with the stack bound) pulls route_n from 6.29M
    down to 4.19M.  Lane index = fill cycle (< 128 by construction since
    buckets hold ceil(n / (n_slabs*128)) <= 128 columns)."""
    counts = np.bincount(res_cols, minlength=n).astype(np.int64)
    n_slabs = max(-(-n // SLAB), 1)
    B = n_slabs * LANES
    order = np.argsort(-counts, kind="stable").astype(np.int32)
    r = np.arange(n, dtype=np.int32)
    cycle, pos = r // B, r % B
    b = np.where(cycle % 2 == 0, pos, B - 1 - pos)
    slot = (b * LANES + cycle).astype(np.int32)
    pi = np.empty(n, dtype=np.int32)
    native.scatter(pi, order, slot)
    return pi, n_slabs


def _gather_layout(cols: np.ndarray, nnz: int, n_slabs_min: int = 0):
    """Slab/bucket gather tiling: returns (gslot (nnz,) i32, tiles_per_slab
    (n_slabs,) i64, n_slabs).  Natural tile count = tiles_per_slab.sum()."""
    slab = cols >> _SLAB_SHIFT
    bucket = (cols >> _LANE_SHIFT) & (LANES - 1)
    key = (slab * LANES + bucket).astype(np.int32)
    order = np.argsort(key, kind="stable")
    key_s = key[order]
    pos = _run_local_pos(key_s, nnz)
    n_slabs = int(slab.max(initial=0)) + 1 if nnz else 1
    n_slabs = max(n_slabs, n_slabs_min, 1)
    counts = np.bincount(key_s, minlength=n_slabs * LANES)
    tiles_per_slab = np.maximum(
        -(-counts.reshape(n_slabs, LANES).max(axis=1) // LANES), 1)
    tile_base = np.concatenate(
        [[0], np.cumsum(tiles_per_slab)]).astype(np.int32)
    tile_of = tile_base[key_s >> _LANE_SHIFT] + (pos >> _LANE_SHIFT)
    gslot_s = (tile_of * SLAB + (key_s & (LANES - 1)) * LANES
               + (pos & (LANES - 1)))
    gslot = np.empty(nnz, dtype=np.int32)
    native.scatter(gslot, order, gslot_s)
    return gslot, tiles_per_slab, n_slabs


def _stack_layout(A: CsrMatrix, cap: int = 0, min_extras: int = 0):
    """Degree-sorted lane-stack layout with capped heavy-row overflow.

    A row's first min(deg, cap) entries stack at its rank position (the
    PRIMARY region — depth per 128-lane block is now bounded by the cap
    instead of the head row's full degree); the remaining entries of
    heavy rows fill size-sorted APPENDIX slots after the primary region.
    Without the cap (cap < 1) a power-law head row sets its whole
    block's depth — the JAX package measured 2.6x stack fill on a webbase
    shard, and crossing a routable-size cliff doubled the route (1.05M
    slots for 202k nnz).

    The appendix partials merge with ONE tiny scatter-add (`merge_ids`
    lists each appendix slot's target rank; appendix slots number
    ~sum(deg)/cap over heavy rows only — hundreds, not m, so the scatter
    costs microseconds where a full rank-space segment-sum measured
    ~440 us as an elementwise 1-D scatter on the JAX package's TPU v5e).

    `min_extras` pads the appendix slot count (the distributed layer
    gives every shard the same one).

    Returns (rank (m,) i32, off64 (n_blocks+1,) i64, depth (n_blocks,)
    i32, n_blocks, srank_of_entry-builder, merge_ids (n_extra,) i32,
    n_extra, merged flag); slot space = [primary m_pad | appendix
    n_extra]."""
    m = A.shape[0]
    deg = A.row_nnz.astype(np.int64)
    rank_order = np.argsort(-deg, kind="stable").astype(np.int32)
    rank = np.empty(m, dtype=np.int32)
    native.scatter(rank, rank_order, np.arange(m, dtype=np.int32))
    m_pad = _round_up(max(m, 1), LANES)

    cap = int(cap) if cap and cap >= 1 else 0
    cap_sh = _pow2_shift(cap) if cap else None
    if cap:
        k_r = np.maximum((deg + cap - 1) >> cap_sh if cap_sh is not None
                         else -(-deg // cap), 1)
    else:
        k_r = np.ones(m, dtype=np.int64)
    ex_r = k_r - 1                      # appendix slots per row
    E = int(ex_r.sum())
    E_eff = max(E, int(min_extras))
    n_extra = _round_up(E_eff, LANES) if E_eff else 0
    merged = n_extra > 0

    # primary depths: rank blocks are degree-sorted, so block depth =
    # first rank's capped degree
    pmin = np.minimum(deg, cap) if cap else deg
    p_pad = np.zeros(m_pad, dtype=np.int64)
    p_pad[:m] = pmin[rank_order]
    depth_p = np.maximum(
        p_pad.reshape(m_pad // LANES, LANES).max(axis=1), 1)

    # appendix slots: chunks 1..k-1 of each heavy row, size-sorted
    ex_row = np.repeat(np.arange(m, dtype=np.int32), ex_r)
    ex_base = np.concatenate([[0], np.cumsum(ex_r)[:-1]]).astype(np.int64)
    sub = (np.arange(E, dtype=np.int64) - ex_base[ex_row]) + 1
    ex_size = np.minimum(deg[ex_row] - sub * cap, cap) if E else \
        np.zeros(0, dtype=np.int64)
    order = np.argsort(-ex_size, kind="stable").astype(np.int64)
    apos_of_extra = np.empty(E, dtype=np.int64)
    apos_of_extra[order] = np.arange(E, dtype=np.int64)
    a_pad = np.zeros(n_extra, dtype=np.int64)
    a_pad[:E] = ex_size[order]
    depth_a = np.maximum(
        a_pad.reshape(-1, LANES).max(axis=1), 1) if n_extra else \
        np.zeros(0, dtype=np.int64)

    depth = np.concatenate([depth_p, depth_a]).astype(np.int32)
    n_blocks = m_pad // LANES + n_extra // LANES
    off64 = np.concatenate([[0], np.cumsum(depth, dtype=np.int64)])

    # merge targets: appendix slot -> its row's rank (pads add zero to
    # rank 0, harmless)
    merge_ids = np.zeros(n_extra, dtype=np.int32)
    if E:
        merge_ids[apos_of_extra] = rank[ex_row]

    def srank_of_entry(rows, j_in_row):
        """(srank, within-slot position) for each nnz."""
        if not cap:
            return rank[rows], j_in_row
        sub_e = (j_in_row >> cap_sh if cap_sh is not None
                 else j_in_row // cap)
        j_loc = (j_in_row & (cap - 1) if cap_sh is not None
                 else j_in_row % cap)
        primary = sub_e == 0
        srank = np.where(
            primary, rank[rows],
            m_pad + apos_of_extra[np.where(
                primary, 0, ex_base[rows] + sub_e - 1)]
            if E else 0)
        return srank.astype(np.int32), j_loc

    return (rank, off64, depth, n_blocks, srank_of_entry, merge_ids,
            n_extra, merged)


def _peel_split(cols: np.ndarray, n: int, nnz: int, threshold: int):
    """Boolean mask of entries whose column has >= threshold nonzeros
    (the hub-peel set); all-False when peeling is disabled."""
    if threshold < 1 or nnz == 0:
        return np.zeros(nnz, dtype=bool)
    cnt = np.bincount(cols, minlength=n)
    return cnt[cols] >= threshold


def _peel_layout(pcols: np.ndarray, pvals_in: np.ndarray):
    """Lay peeled entries out as whole 128-lane rows per hub column.

    Entry j of hub c lands at row base[c] + j//128, lane j%128; every row
    carries ONE column id, so the device gathers x once per ROW (128x
    fewer addressed elements than slot-granular gather) and broadcasts.
    Returns (pslot (k,) i64 within-peel slots ordered like pcols sorted,
    order (k,), prow_col (R_p,) i32, pvals (R_p*128,) values, R_p)."""
    # int32 throughout (the JAX package's host paid ~14x for 64-bit random
    # access); R_p is bounded BEFORE any int32 slot math so a near-2^31
    # nnz peel raises the typed error instead of silently wrapping
    from ..utils.errors import PlanError, require
    order = np.argsort(pcols, kind="stable").astype(np.int32)
    pc_s = pcols[order]
    k = len(pc_s)
    j_in_col = _run_local_pos(pc_s, k)
    uniq, first = np.unique(pc_s, return_index=True)
    cnt_p = np.diff(np.append(first, k))
    rows_per_col = (-(-cnt_p // LANES)).astype(np.int64)
    row_base64 = np.concatenate([[0], np.cumsum(rows_per_col)])
    require(int(row_base64[-1]) * LANES < 2**31, PlanError,
            f"peeled hub rows overflow int32 slots "
            f"(R_p={int(row_base64[-1])}); the matrix is too large/ragged "
            f"for a single routed plan")
    row_base = row_base64.astype(np.int32)
    col_group = np.repeat(np.arange(len(uniq), dtype=np.int32),
                          cnt_p)
    prow = row_base[col_group] + (j_in_col >> _LANE_SHIFT)
    pslot = prow * LANES + (j_in_col & (LANES - 1))
    R_p = int(row_base[-1])
    prow_col = np.repeat(uniq.astype(np.int32), rows_per_col)
    pvals = np.zeros(R_p * LANES, dtype=pvals_in.dtype)
    native.scatter(pvals, pslot, pvals_in[order])
    return pslot, order, prow_col, pvals, R_p


def routed_shard_sizes(A: CsrMatrix, config: SBlasConfig = DEFAULT):
    """Natural (n_gtiles, n_srows, n_prows, n_sranks) a RoutedPlan over A
    would use — the cheap prefix of the plan build (no edge colouring).
    The distributed layer probes every shard with this, takes
    element-wise maxima, and passes them back as from_csr(min_gtiles=...,
    min_srows=..., min_prows=..., min_sranks=...) so all shard plans
    share one static shape."""
    coo = A.to_coo()
    cols = coo.col_idx.astype(np.int32)
    peeled = _peel_split(cols, A.shape[1], A.nnz,
                         config.routed_peel_threshold)
    res = cols[~peeled]
    if len(res) and config.routed_relabel:
        pi, n_slabs_x = _balanced_relabel(A.shape[1], res)
        res = pi[res]
    else:
        n_slabs_x = 1
    _, tiles_per_slab, _ = _gather_layout(res, len(res),
                                          n_slabs_min=n_slabs_x)
    _, off64, _, _, _, _, n_extra, _ = _stack_layout(
        A, cap=config.routed_stack_cap)
    pc = cols[peeled]
    if len(pc):
        _, cnts = np.unique(pc, return_counts=True)
        n_prows = int((-(-cnts // LANES)).sum())
    else:
        n_prows = 0
    return (int(tiles_per_slab.sum()), int(off64[-1]), n_prows,
            int(n_extra))


# ---------------------------------------------------------------------------
# Plan
# ---------------------------------------------------------------------------

DATA_FIELDS = ("gslab", "gidx", "gvals", "pvals", "prow_col", "tables",
               "brow_ids", "merge_ids", "unrank_tables", "xroute_tables")
META_FIELDS = ("schedule", "unrank_schedule", "xroute_schedule", "shape",
               "nnz", "n_gtiles", "n_srows", "n_prows", "n_blocks",
               "n_rank_pad", "merged", "route_n", "unrank_n", "xroute_n",
               "transport")
_TABLE_FIELDS = ("tables", "unrank_tables", "xroute_tables")

TRANSPORTS = ("f32", "bf16")
# index dtype of the main route's tables under each transport
_MAIN_INDEX = {"f32": torch.int32, "bf16": torch.int16}


@dataclasses.dataclass(frozen=True)
class RoutedPlan:
    """Plan for the three-stage routed SpMV (see module docstring); every
    tensor lies on `device`.

    gslab: (T_g,) i32        x-slab id per gather tile
    gidx:  (T_g,128,128) i32 in-slab lane per slot (pads 0)
    gvals: (T_g,128,128)     values per slot (pads 0)
    pvals: (R_p,128)         peeled hub-column values (pads 0)
    prow_col: (R_p,) i32     the single x column each peeled row reads
    tables / schedule        route layers: gather order -> lane stack
    brow_ids: (S,) i32       block id per stack row (sorted)
    brow_offsets: (n_blocks+1,) i64  first stack row of each block, then S
                             (port only: the segment sum's offsets)
    merge_ids: (n_extra,) i32  appendix slot -> target row rank (heavy-row
                             overflow merge; empty when `merged` is False)
    unrank_tables / unrank_schedule  route layers: rank order -> row order
    xroute_tables / xroute_schedule  route layers: x -> relabelled x
                             (empty when xroute_n == 0)

    The route source space is [gather slots | peeled slots].  `transport`
    is the main route's element precision ("f32": the value dtype;
    "bf16": bf16 contributions, int16 `tables`)."""

    gslab: torch.Tensor
    gidx: torch.Tensor
    gvals: torch.Tensor
    pvals: torch.Tensor
    prow_col: torch.Tensor
    tables: Tuple[torch.Tensor, ...]
    brow_ids: torch.Tensor
    brow_offsets: torch.Tensor
    merge_ids: torch.Tensor
    unrank_tables: Tuple[torch.Tensor, ...]
    xroute_tables: Tuple[torch.Tensor, ...]
    schedule: Tuple
    unrank_schedule: Tuple
    xroute_schedule: Tuple
    shape: Tuple[int, int]
    nnz: int
    n_gtiles: int
    n_srows: int
    n_prows: int
    n_blocks: int
    n_rank_pad: int
    merged: bool
    route_n: int
    unrank_n: int
    xroute_n: int  # 0 = no balanced relabel (no residual entries)
    transport: str = "f32"   # main-route element precision, TRANSPORTS

    @property
    def device(self) -> torch.device:
        return self.gvals.device

    @property
    def dtype(self) -> torch.dtype:
        return self.gvals.dtype

    @property
    def gather_fill(self) -> float:
        return ((self.n_gtiles * SLAB + self.n_prows * LANES)
                / max(self.nnz, 1))

    @property
    def stack_fill(self) -> float:
        return self.n_srows * LANES / max(self.nnz, 1)

    @property
    def n_route_gathers(self) -> int:
        """K1 launches one SpMV makes: `gather` layers of all three
        routes."""
        return sum(1 for sched in (self.xroute_schedule, self.schedule,
                                   self.unrank_schedule)
                   for op in sched if op[0] == "gather")

    PORT_FIELDS = ("brow_offsets",)

    def with_transport(self, transport: str) -> "RoutedPlan":
        """The same plan at another route transport, without a rebuild: the
        main route's tables change width with it (int16 under bf16, int32
        under f32).  Returns `self` when the transport does not change."""
        from ..utils.errors import PlanError, require
        require(transport in TRANSPORTS, PlanError,
                f"routed_transport must be 'f32' or 'bf16', "
                f"got {transport!r}")
        if transport == self.transport:
            return self
        require(transport == "f32" or self.dtype == torch.float32,
                PlanError,
                "bf16 route transport is only valid with float32 values")
        idx = _MAIN_INDEX[transport]
        return dataclasses.replace(
            self, transport=transport,
            tables=tuple(t.to(idx) for t in self.tables))

    @staticmethod
    def port_fields(fields: dict, meta: dict) -> dict:
        """The port-only fields, from the plan's host `brow_ids` and
        `n_blocks` (in `meta`)."""
        return {"brow_offsets": np.searchsorted(
            np.asarray(fields["brow_ids"]),
            np.arange(int(meta["n_blocks"]) + 1)).astype(np.int64)}

    def to(self, device) -> "RoutedPlan":
        """The same plan with every tensor on `device`."""
        moved = {}
        for name in DATA_FIELDS + self.PORT_FIELDS:
            v = getattr(self, name)
            moved[name] = (tuple(t.to(device) for t in v)
                           if name in _TABLE_FIELDS else v.to(device))
        return dataclasses.replace(self, **moved)

    @classmethod
    def from_numpy(cls, fields: dict, meta: dict, device,
                   dtype=None) -> "RoutedPlan":
        """Plan from host arrays: `fields` maps each of DATA_FIELDS to a
        numpy array (the three table fields to sequences of arrays), `meta`
        each of META_FIELDS to its value.  Accepts the JAX package's plan
        fields (`np.asarray` of each) as they are, a bf16-transport plan's
        int16 tables included: the port-only fields (`PORT_FIELDS`) are
        derived when absent.  `dtype` (e.g. torch.bfloat16, whose host
        layout is float32) narrows the values once, as they are placed."""
        from ..utils.errors import PlanError, require
        transport = meta.get("transport", "f32")
        require(transport in TRANSPORTS, PlanError,
                f"routed_transport must be 'f32' or 'bf16', "
                f"got {transport!r}")

        def tensor(a):
            a = np.ascontiguousarray(a)
            if not a.flags.writeable:   # e.g. np.asarray of a jax.Array
                a = a.copy()
            return torch.from_numpy(a).to(device)

        if any(k not in fields for k in cls.PORT_FIELDS):
            fields = dict(cls.port_fields(fields, meta), **fields)
        data = {name: (tuple(tensor(t) for t in fields[name])
                       if name in _TABLE_FIELDS else tensor(fields[name]))
                for name in DATA_FIELDS + cls.PORT_FIELDS}
        if dtype is not None:
            for name in ("gvals", "pvals"):
                data[name] = data[name].to(dtype)
        require(data["gvals"].dtype in HOST_VALUE, PlanError,
                f"routed plans hold float32, float64 or bfloat16 values, "
                f"got {data['gvals'].dtype}")
        require(transport == "f32" or data["gvals"].dtype == torch.float32,
                PlanError, "bf16 route transport is only valid with float32 "
                "values")
        m = {name: meta[name] for name in META_FIELDS if name in meta}
        m["shape"] = tuple(int(d) for d in m["shape"])
        return cls(**data, **m)

    @classmethod
    def from_csr(cls, A: CsrMatrix, dtype=torch.float32,
                 config: SBlasConfig = DEFAULT, *, min_gtiles: int = 0,
                 min_srows: int = 0, min_prows: int = 0,
                 min_sranks: int = 0, device) -> "RoutedPlan":
        """Build the plan on the host (numpy + the native library) and
        place it on `device`.  Arrays are byte-identical to
        `sblas_tpu.ops.rspmv.RoutedPlan.from_csr` for the same matrix,
        dtype, config and `min_*` sizes.

        `min_gtiles` / `min_srows` / `min_prows` / `min_sranks` pad the
        gather-tile count, lane-stack depth, peeled-row count and appendix
        slot count up to shared sizes, so the distributed layer's
        per-shard plans share one shape and one route schedule (pad tiles
        hold val=0 and contribute nothing)."""
        fields, meta = routed_plan_arrays(
            A, dtype, config, min_gtiles=min_gtiles, min_srows=min_srows,
            min_prows=min_prows, min_sranks=min_sranks)
        return cls.from_numpy(fields, meta, device, dtype=dtype)

    @classmethod
    def is_profitable(cls, A: CsrMatrix,
                      config: SBlasConfig = DEFAULT) -> bool:
        """Routing pays off (on the TPU it was designed for) for large
        unstructured matrices: enough nnz to amortize the fixed stage costs
        and a wide enough x for the slab buckets to fill."""
        return (A.nnz >= config.routed_min_nnz
                and A.shape[1] >= config.routed_min_width)


def routed_plan_arrays(A: CsrMatrix, dtype=torch.float32,
                       config: SBlasConfig = DEFAULT, *, min_gtiles: int = 0,
                       min_srows: int = 0, min_prows: int = 0,
                       min_sranks: int = 0):
    """Host-side plan build: (fields, meta) as `RoutedPlan.from_numpy`
    takes them (the values in float32 for a bfloat16 plan: pass `dtype`
    there); the `min_*` sizes as in `RoutedPlan.from_csr`."""
    from ..utils.errors import PlanError, require
    np_val = host_value_dtype(dtype)
    transport = str(config.routed_transport)
    require(transport in TRANSPORTS, PlanError,
            f"routed_transport must be 'f32' or 'bf16', got {transport!r}")
    require(transport == "f32" or dtype == torch.float32, PlanError,
            "bf16 route transport is only valid with float32 values "
            "(f64 would lose 45 mantissa bits; bf16 values already route "
            "at width)")
    m, n = A.shape
    coo = A.to_coo()  # CSR order (rows ascending)
    nnz = A.nnz
    require(max(m, n, nnz) < 2**31, PlanError,
            "routed plans are int32-indexed")
    rows = coo.row_idx.astype(np.int32)
    cols = coo.col_idx.astype(np.int32)
    vals_np = coo.values.astype(np_val)

    # ---- hub peel: high-in-degree columns bypass the slab buckets ----
    peeled = _peel_split(cols, n, nnz, config.routed_peel_threshold)
    res_idx = np.flatnonzero(~peeled)
    pe_idx = np.flatnonzero(peeled)
    res_cols = cols[res_idx]

    # ---- balanced relabel + x route (skipped when nothing is residual or
    # config.routed_relabel is off; min_gtiles > 0 means a distributed
    # shard, where every shard must carry the same x-route schedule, so an
    # empty shard builds the identity relabel) ----
    if (len(res_idx) or min_gtiles) and config.routed_relabel:
        if len(res_idx):
            pi, n_slabs_x = _balanced_relabel(n, res_cols)
        else:
            n_slabs_x = max(-(-n // SLAB), 1)
            pi = np.arange(n, dtype=np.int32)
        p_cols = pi[res_cols]
        N_x = routable_size(n_slabs_x * SLAB)
        perm_x = np.full(N_x, -1, dtype=np.int32)
        native.scatter(perm_x, pi, np.arange(n, dtype=np.int32))
        perm_x[perm_x < 0] = np.arange(n, N_x, dtype=np.int32)
        progx = build_route(perm_x)
    else:
        p_cols, n_slabs_x, N_x, progx = res_cols, 1, 0, None

    # ---- gather tiling: per (slab, bucket) runs of <= 128 lanes ----
    gslot_res, tiles_per_slab, n_slabs = _gather_layout(
        p_cols, len(res_idx), n_slabs_min=n_slabs_x)
    T_g = max(int(tiles_per_slab.sum()), int(min_gtiles))

    gidx = np.zeros(T_g * SLAB, dtype=np.int32)
    gvals = np.zeros(T_g * SLAB, dtype=np_val)
    native.scatter(gidx, gslot_res, (p_cols & (LANES - 1)).astype(np.int32))
    native.scatter(gvals, gslot_res, vals_np[res_idx])
    gslab_arr = np.repeat(np.arange(n_slabs, dtype=np.int32), tiles_per_slab)
    gslab_arr = np.pad(gslab_arr, (0, T_g - len(gslab_arr)))

    # ---- peeled layout: whole 128-lane rows per hub column ----
    pslot, p_order, prow_col, pvals_flat, R_p = _peel_layout(
        cols[pe_idx], vals_np[pe_idx])
    R_p = max(R_p, int(min_prows))
    prow_col = np.pad(prow_col, (0, R_p - len(prow_col)))
    pvals_flat = np.pad(pvals_flat, (0, R_p * LANES - len(pvals_flat)))
    require(T_g * SLAB + R_p * LANES < 2**31, PlanError,
            f"gather tiling overflows int32 slots (T_g={T_g}, R_p={R_p}); "
            f"the matrix is too large/ragged for a single routed plan")

    # global source slots: [gather space | peeled space]
    gslot = np.empty(nnz, dtype=np.int32)
    gslot[res_idx] = gslot_res
    native.scatter(gslot, pe_idx[p_order],
                   (T_g * SLAB + pslot).astype(np.int32))

    # ---- reduce layout: capped lane stack with heavy-row overflow
    # appendix (see _stack_layout) ----
    (rank, off64, depth, n_blocks, srank_of_entry, merge_ids,
     n_extra, merged) = _stack_layout(A, cap=config.routed_stack_cap,
                                      min_extras=min_sranks)
    S = max(int(off64[-1]), int(min_srows))
    require(S * LANES < 2**31, PlanError,
            f"lane stack overflows int32 slots (S={S}); one row's nnz is "
            f"too extreme for a single routed plan")
    off = off64.astype(np.int32)
    m_padr = _round_up(max(m, 1), LANES)
    # nnz slot: j-th entry of row r (CSR position - row start) stacks at
    # sublane off[block] + within, lane srank % 128
    j_in_row = np.arange(nnz, dtype=np.int32) - np.repeat(
        A.row_ptr[:-1].astype(np.int32), A.row_nnz)
    srank, within = srank_of_entry(rows, j_in_row)
    rslot = ((off[srank >> _LANE_SHIFT] + within) * LANES
             + (srank & (LANES - 1)))
    brow_ids = np.concatenate([
        np.repeat(np.arange(n_blocks, dtype=np.int32), depth),
        # stack pad rows attach to the last block (stays sorted; the
        # routed pad slots carry zeros, so they add nothing)
        np.full(S - int(off64[-1]), n_blocks - 1, dtype=np.int32)])

    # ---- route 1: [gather | peeled] order -> lane-stack order ----
    N = routable_size(max(T_g * SLAB + R_p * LANES, S * LANES))
    perm = np.full(N, -1, dtype=np.int32)
    native.scatter(perm, rslot, gslot)
    src_used = np.zeros(N, dtype=bool)
    native.scatter(src_used, gslot, True)
    perm[perm < 0] = np.flatnonzero(~src_used).astype(np.int32)
    prog = build_route(perm)

    # ---- route 2: rank order -> row order (un-relabel y) ----
    N2 = routable_size(m_padr)
    perm2 = np.concatenate([rank, np.arange(m, N2, dtype=np.int32)])
    prog2 = build_route(perm2)

    def tables(pr, idx_dtype=np.int32):
        return tuple(op[1].astype(idx_dtype, copy=False)
                     for op in pr.ops if op[0] in ("gather", "mix"))

    # bf16 transport: the main route's tables are int16 (lane indices
    # < 128 and mix ranks < the layer arity are exact in int16): the
    # index stream halves with the value stream
    main_idx = np.int16 if transport == "bf16" else np.int32

    fields = dict(
        gslab=gslab_arr,
        gidx=gidx.reshape(T_g, LANES, LANES),
        gvals=gvals.reshape(T_g, LANES, LANES),
        pvals=pvals_flat.reshape(R_p, LANES),
        prow_col=prow_col.astype(np.int32),
        tables=tables(prog, main_idx),
        brow_ids=brow_ids,
        # each block's first stack row; the pad rows join the last block
        brow_offsets=np.append(off64[:-1], S).astype(np.int64),
        merge_ids=merge_ids,
        unrank_tables=tables(prog2),
        xroute_tables=tables(progx) if progx is not None else (),
    )
    meta = dict(
        schedule=prog.schedule,
        unrank_schedule=prog2.schedule,
        xroute_schedule=progx.schedule if progx is not None else (),
        shape=tuple(A.shape), nnz=nnz, n_gtiles=T_g, n_srows=S,
        n_prows=R_p, n_blocks=n_blocks, n_rank_pad=m_padr, merged=merged,
        route_n=prog.n, unrank_n=prog2.n, xroute_n=N_x, transport=transport)
    return fields, meta


# ---------------------------------------------------------------------------
# Kernel K2 and the SpMV
# ---------------------------------------------------------------------------

def _variant(dtype: torch.dtype, out_dtype) -> str:
    """K2/K2' variant: the value type, then the stored type where it
    differs (`f32_bf16`: the bf16 transport's cast on store)."""
    sfx = _kernels.value_suffix(dtype)
    if out_dtype is None or out_dtype == dtype:
        return sfx
    return f"{sfx}_{_kernels.value_suffix(out_dtype)}"


def _stored(prod: torch.Tensor, out_dtype) -> torch.Tensor:
    """A product as K2 stores it: rounded once to `out_dtype`."""
    return prod if out_dtype is None else prod.to(out_dtype)


def slab_gather_plain(gslab, x_slabs, gidx, gvals,
                      out_dtype=None) -> torch.Tensor:
    """Plain PyTorch K2:
    out[t, r, c] = gvals[t, r, c] * x_slabs[gslab[t], r, gidx[t, r, c]],
    formed at the values' dtype and stored as `out_dtype` (default the
    same)."""
    tiles = torch.index_select(x_slabs, 0, gslab)
    return _stored(gvals * torch.gather(tiles, 2, gidx), out_dtype)


def slab_gather(gslab, x_slabs, gidx, gvals, out_dtype=None) -> torch.Tensor:
    """Slab-bucket gather (see `slab_gather_plain`) over (T_g, 128, 128)
    tiles.  CPU tensors take the plain version; CUDA tensors launch kernel
    K2 (csrc/rspmv_kernels.cu) or raise."""
    if x_slabs.device.type == "cpu":
        return slab_gather_plain(gslab, x_slabs, gidx, gvals, out_dtype)
    from ..utils.errors import KernelError, require
    dev = x_slabs.device
    require(dev.type == "cuda", KernelError,
            f"slab_gather runs on cpu or cuda, not {dev}")
    fn = _kernels.launcher("slab_gather", _variant(x_slabs.dtype, out_dtype))
    require(x_slabs.dim() == 3 and tuple(x_slabs.shape[1:]) == (LANES, LANES),
            KernelError, f"x_slabs must be (n_slabs, {LANES}, {LANES}), "
            f"got {tuple(x_slabs.shape)}")
    T_g = gslab.shape[0]
    tile_shape = (T_g, LANES, LANES)
    _kernels.check_operand(gslab, "gslab", torch.int32, (T_g,), dev)
    _kernels.check_operand(x_slabs, "x_slabs", x_slabs.dtype, x_slabs.shape,
                           dev)
    _kernels.check_operand(gidx, "gidx", torch.int32, tile_shape, dev)
    _kernels.check_operand(gvals, "gvals", x_slabs.dtype, tile_shape, dev)
    out = torch.empty(tile_shape, dtype=out_dtype or x_slabs.dtype,
                      device=dev)
    _kernels.launch(fn, dev, gslab, x_slabs, gidx, gvals, out, T_g)
    slab_gather.launches += 1
    return out


slab_gather.launches = 0   # K2 launches since the last reset


def tile_gather_plain(x_tiles, gidx, gvals, out_dtype=None) -> torch.Tensor:
    """Plain PyTorch K2':
    out[t, r, c] = gvals[t, r, c] * x_tiles[t, r, gidx[t, r, c]], stored
    as `out_dtype` (see `slab_gather_plain`)."""
    return _stored(gvals * torch.gather(x_tiles, 2, gidx), out_dtype)


def tile_gather(x_tiles, gidx, gvals, out_dtype=None) -> torch.Tensor:
    """Tile gather over slabs pre-gathered per tile (see
    `tile_gather_plain`), (T_g, 128, 128) throughout.  CPU tensors take
    the plain version; CUDA tensors launch kernel K2'
    (csrc/rspmv_kernels.cu) or raise."""
    if x_tiles.device.type == "cpu":
        return tile_gather_plain(x_tiles, gidx, gvals, out_dtype)
    from ..utils.errors import KernelError, require
    dev = x_tiles.device
    require(dev.type == "cuda", KernelError,
            f"tile_gather runs on cpu or cuda, not {dev}")
    fn = _kernels.launcher("tile_gather", _variant(x_tiles.dtype, out_dtype))
    T_g = x_tiles.shape[0]
    tile_shape = (T_g, LANES, LANES)
    _kernels.check_operand(x_tiles, "x_tiles", x_tiles.dtype, tile_shape,
                           dev)
    _kernels.check_operand(gidx, "gidx", torch.int32, tile_shape, dev)
    _kernels.check_operand(gvals, "gvals", x_tiles.dtype, tile_shape, dev)
    out = torch.empty(tile_shape, dtype=out_dtype or x_tiles.dtype,
                      device=dev)
    _kernels.launch(fn, dev, x_tiles, gidx, gvals, out, T_g)
    tile_gather.launches += 1
    return out


tile_gather.launches = 0   # K2' launches since the last reset


def x_slabs_of(plan: RoutedPlan, x: torch.Tensor) -> torch.Tensor:
    """x after the balanced relabel (one small route), padded and viewed
    as (n_slabs, 128, 128) slabs."""
    n = plan.shape[1]
    n_slabs = _round_up(n, SLAB) // SLAB
    if plan.xroute_n:
        xr = apply_route(plan.xroute_schedule,
                         F.pad(x, (0, plan.xroute_n - n)),
                         plan.xroute_tables)
        return xr[: n_slabs * SLAB].reshape(n_slabs, LANES, LANES)
    return F.pad(x, (0, n_slabs * SLAB - n)).reshape(n_slabs, LANES, LANES)


def contrib_dtype(plan: RoutedPlan, x: torch.Tensor) -> torch.dtype:
    """The dtype the contributions route in: bf16 under the bf16
    transport, else x's."""
    return torch.bfloat16 if plan.transport == "bf16" else x.dtype


def _gathered_contrib(plan: RoutedPlan, x: torch.Tensor,
                      pregather: bool = False) -> torch.Tensor:
    """(T_g*SLAB,) contributions vals[i]*x[col[i]] in gather order,
    formed at x's dtype and stored as `contrib_dtype`.

    `pregather` takes the JAX package's `shard_map` branch: each tile's
    slab is first copied out with one row-granular `index_select` (plain
    torch, as the JAX package leaves it to XLA), then kernel K2' reads
    the tiles in order.  The distributed per-shard SpMV takes it; the
    single-device SpMV keeps K2, as the JAX package does."""
    x_slabs = x_slabs_of(plan, x)
    gvals = plan.gvals.to(x.dtype)
    out_dtype = contrib_dtype(plan, x)
    if pregather:
        x_tiles = torch.index_select(x_slabs, 0, plan.gslab)
        return tile_gather(x_tiles, plan.gidx, gvals,
                           out_dtype).reshape(-1)
    return slab_gather(plan.gslab, x_slabs, plan.gidx, gvals,
                       out_dtype).reshape(-1)


def peel_contrib(plan: RoutedPlan, x: torch.Tensor) -> torch.Tensor:
    """(R_p, 128) contributions of the peeled hub columns: one x element
    per 128-lane row, broadcast; formed at x's dtype and stored as
    `contrib_dtype` (casting x itself would square the rounding)."""
    xp = torch.index_select(x, 0, plan.prow_col)
    return _stored(plan.pvals.to(x.dtype) * xp[:, None],
                   contrib_dtype(plan, x))


def reduce_routed(plan: RoutedPlan, routed: torch.Tensor,
                  dtype=None) -> torch.Tensor:
    """A@x (m,) from the contributions in lane-stack order: the sorted
    segment sum, the heavy-row merge and the un-relabel route.  The
    stack is summed in `dtype` (x's; default the contributions'): the
    bf16 transport's contributions are upcast to it first."""
    stack = routed[: plan.n_srows * LANES].reshape(plan.n_srows, LANES)
    if dtype is not None:
        stack = stack.to(dtype)
    # sorted segment sum over the stack rows: brow_ids is sorted, so each
    # block's rows are one run (brow_offsets), summed in row order (no
    # atomics: the same bits on every run, and the CPU's index_add_ order)
    blocks = torch.segment_reduce(stack, "sum", offsets=plan.brow_offsets,
                                  axis=0, unsafe=True)
    y_srank = blocks.reshape(-1)  # (m_pad + n_extra,): primary | appendix
    y_rank = y_srank[: plan.n_rank_pad]
    if plan.merged:
        # heavy-row overflow merge; merge_ids repeats targets (pad slots
        # all add zero into rank 0).  index_put_(accumulate=True) adds the
        # duplicates in id order on every device (CUDA's index_add_ uses
        # atomics in no fixed order), so every run, an eager solve and
        # its CUDA graph, gives the same bits
        y_rank = y_rank.index_put_((plan.merge_ids,),
                                   y_srank[plan.n_rank_pad:],
                                   accumulate=True)
    y_rank = F.pad(y_rank, (0, plan.unrank_n - y_rank.shape[0]))
    return apply_route(plan.unrank_schedule, y_rank,
                       plan.unrank_tables)[: plan.shape[0]]


def spmv_routed(plan: RoutedPlan, x: torch.Tensor, alpha, beta,
                y: torch.Tensor, pregather: bool = False) -> torch.Tensor:
    """y' = beta*y + alpha*A@x on the plan's device (`pregather`: see
    `_gathered_contrib`)."""
    contrib = _gathered_contrib(plan, x, pregather)
    if plan.n_prows:
        contrib = torch.cat([contrib, peel_contrib(plan, x).reshape(-1)])
    contrib = F.pad(contrib, (0, plan.route_n - contrib.shape[0]))
    routed = apply_route(plan.schedule, contrib, plan.tables)
    return beta * y + alpha * reduce_routed(plan, routed, x.dtype)
