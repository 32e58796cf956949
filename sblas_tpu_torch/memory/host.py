"""Host-resident band plans streamed into device memory (the UM analog).

Port of `sblas_tpu/memory/host.py`, the reference's CUDA Unified-Memory
stack (matrix_um.h / spmm_um.h / spmv_um.h).  Where the reference puts
the matrix in managed memory and steers its pages with `cudaMemAdvise` /
`cudaMemPrefetchAsync` (applyGpuTuning / removeGpuTuning /
applyCpuTuning, matrix_um.h:529-614), the port cuts it into row bands
sized to a device-memory budget and keeps every band in page-locked
(pinned) host memory, from where the card copies it asynchronously:

* `HostResidentPlan`        <- the `*_um` containers (matrix_um.h:122-1075)
* `.apply_gpu_tuning()`     <- applyGpuTuning: copy every band to the
                               device once and keep it there
* `.remove_gpu_tuning()`    <- removeGpuTuning: drop the device copies
* `.apply_cpu_tuning()`     <- applyCpuTuning: the same (host-resident is
                               the default)
* `spmm_um` / `spmv_um`     <- sblas_spmm_csr_v2 / spmv_v1 with the
                               trailing `tuning` flag (spmm_um.h:167,
                               185-187)

The bands are the JAX package's, byte for byte (`probe_band_dims`,
`build_band_plan`, `_choose_band_kind` are its code).  Untuned, a call
streams them (`_stream`): a ring of `_INFLIGHT` device slots, band i+1's
host-to-device copy on a side stream while band i computes on the
current stream, the compute stream waiting on an event recorded after
each copy and the copy stream waiting on the compute-done event of the
band whose slot it is about to refill.  So at most `_INFLIGHT` bands are
on the device and the host never waits inside the call.  Each band's
product goes straight into its rows of the result, `beta*C[r0:r1] +
alpha*part`; no full-height intermediate is built.

Bands take float32, float64 or bfloat16 values.  A bf16 band is sized by
2-byte values, as the JAX package sizes it, narrowed once as it is built
and pinned as bf16, so each copy moves bf16 value bytes; its WCOO SpMM
runs K3's bf16 variant, and each band's epilogue rounds once
(`plans.fold`).

What the JAX package needs only for the TPU's compile path has no
counterpart: the stacked tuned operand and its `lax.scan` fallback above
`_UNROLL_MAX_BANDS` (a tuned call here loops over the device bands), the
`SBLAS_STREAM_CHUNK` batching of bands into one dispatch (a CUDA launch
costs microseconds, not a dispatch), and the unused `band_device`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import DEFAULT, SBlasConfig
from ..containers import CsrMatrix
from ..ops import spmm, spmv
from ..ops.bsr import BsrPlan
from ..ops.plans import (CooPlan, EllPlan, fold, host_value_dtype,
                         value_itemsize)
from ..ops.wcoo import WcooPlan
from ..utils.errors import PartitionError, ShapeError, require
from ..utils import trace

# Bands on the device at once while streaming: band i computes while the
# next ones copy in.
_INFLIGHT = 3

# Windowed-COO band fallback: if tile-splitting stores more than this many
# slots per true nnz across all bands, plain COO bands stream less data.
_WCOO_BAND_FILL_LIMIT = 8.0

_PLAN_OF_KIND = {"bsr": BsrPlan, "ell": EllPlan, "wcoo": WcooPlan,
                 "coo": CooPlan}


class StreamStats(NamedTuple):
    """What one streamed (untuned) call moved: bands copied, the most
    bands on the device at once, and the bytes copied host -> device."""
    bands: int
    peak_resident: int
    bytes: int


def tensor_fields(plan) -> List[str]:
    """Names of a plan's tensor fields, in field order."""
    return [f.name for f in dataclasses.fields(plan)
            if isinstance(getattr(plan, f.name), torch.Tensor)]


def host_placed(plan, device):
    """`plan`'s host tensors as a host-resident operand for `device`: for
    a CUDA device each copied once into page-locked (pinned) memory
    (`pin_memory` raises when it cannot pin), else as they are."""
    if torch.device(device).type != "cuda":
        return plan
    return dataclasses.replace(plan, **{
        k: getattr(plan, k).pin_memory() for k in tensor_fields(plan)})


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _band_meta(kind: str, fields: dict, shape, nnz: int) -> dict:
    """A band plan's static fields, from its arrays (`fields`), its local
    shape and the whole matrix's nnz."""
    meta = dict(shape=tuple(shape), nnz=int(nnz))
    if kind == "bsr":
        meta["block"] = tuple(int(d) for d in np.shape(fields["vals"])[2:])
    elif kind == "wcoo":
        meta.update(n_tiles=int(np.shape(fields["wb"])[0]),
                    n_row_blocks=int(np.shape(fields["visit0"])[0]))
    return meta


@dataclasses.dataclass
class HostResidentPlan:
    """Row-band plans in host memory for the compute device `device`.

    `bands[i]` covers rows [i*band_rows, (i+1)*band_rows); every band has
    the same local shape (band_rows, n) and tensor shapes (the last band
    is padded), except K3's tables (`WcooPlan.k3_units`, `k3_rows`),
    whose lengths differ from band to band.  Their tensors are pinned when
    `device` is a CUDA device.  Underscore fields are residency state, not
    saved by the plan cache."""

    bands: List
    band_rows: int
    shape: Tuple[int, int]
    nnz: int
    kind: str
    _device: torch.device = torch.device("cpu")
    _device_bands: Optional[List] = None
    _copy_stream: Optional[object] = None
    _last_stream: Optional[StreamStats] = None

    HOST_RESIDENT = True   # the plan cache loads the bands to the host

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def dtype(self) -> torch.dtype:
        return self.bands[0].dtype

    @property
    def n_bands(self) -> int:
        return len(self.bands)

    @property
    def tuned(self) -> bool:
        return self._device_bands is not None

    @property
    def last_stream(self) -> Optional[StreamStats]:
        """`StreamStats` of the last untuned call (None before one)."""
        return self._last_stream

    @property
    def band_bytes(self) -> int:
        """Bytes of all bands' tensors (what an untuned call copies)."""
        return sum(getattr(b, k).numel() * getattr(b, k).element_size()
                   for b in self.bands for k in tensor_fields(b))

    # --- residency control (reference matrix_um.h:529-614) ---
    def apply_gpu_tuning(self) -> None:
        """Copy every band to the device and keep it there."""
        if self._device_bands is None:
            self._device_bands = [b.to(self.device) for b in self.bands]
            _sync(self.device)

    def remove_gpu_tuning(self) -> None:
        """Drop the device copies; the bands stay in host memory."""
        self._device_bands = None

    def apply_cpu_tuning(self) -> None:
        """Alias of remove_gpu_tuning, as in the reference's API."""
        self.remove_gpu_tuning()

    def placed(self, device) -> "HostResidentPlan":
        """The same bands as a host-resident plan for `device` (pinned for
        a CUDA device), untuned."""
        device = torch.device(device)
        return HostResidentPlan(
            [host_placed(b, device) for b in self.bands], self.band_rows,
            tuple(self.shape), self.nnz, self.kind, _device=device)

    def copy_stream(self):
        """The side stream this plan's copies run on (CUDA only)."""
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        return self._copy_stream

    @classmethod
    def from_numpy(cls, bands: Sequence[dict], meta: dict,
                   device) -> "HostResidentPlan":
        """The plan from host arrays: `bands[i]` maps each tensor field of
        band i's plan to an array (the JAX package's band plans, `np.asarray`
        of each field, are taken as they are; K3's tables are derived);
        `meta` holds `band_rows`, `shape`, `nnz` and `kind`."""
        kind, band_rows = meta["kind"], int(meta["band_rows"])
        shape, nnz = tuple(int(d) for d in meta["shape"]), int(meta["nnz"])
        plans = [_PLAN_OF_KIND[kind].from_numpy(
            f, _band_meta(kind, f, (band_rows, shape[1]), nnz), "cpu")
            for f in bands]
        return cls(plans, band_rows, shape, nnz, kind).placed(device)


def _choose_band_kind(A: CsrMatrix, config: SBlasConfig) -> str:
    """BSR when block-friendly, ELL when rows are balanced, windowed-COO
    otherwise, so any CSR streams (the JAX package's chooser, kept as it
    is so that the bands are its bands)."""
    from ..ops.bsr import bell_stats
    if (bell_stats(A, config.bsr_block)["blowup"]
            <= config.bsr_blowup_limit):
        return "bsr"
    if EllPlan.is_profitable(A, config):
        return "ell"
    return "wcoo"


def host_resident_plan(A: CsrMatrix, dtype=torch.float32,
                       hbm_budget_bytes: int = 256 << 20,
                       config: SBlasConfig = DEFAULT,
                       kind: str = None, *, device) -> HostResidentPlan:
    """Band-partitioned, host-resident plan of A for `device`.

    Band height is chosen so one band's arrays fit in
    `hbm_budget_bytes / _INFLIGHT` (the streaming window).  `kind` in
    {"bsr", "ell", "wcoo", "coo", None}; None picks by structure (wcoo is
    the unstructured layout; coo the fallback when wcoo's tile-splitting
    blows up on huge empty-row gaps)."""
    from ..ops.bsr import bell_stats
    m, n = A.shape
    itemsize = value_itemsize(dtype)
    kind = kind or _choose_band_kind(A, config)
    nnz_per_row = A.nnz / max(m, 1)
    budget = hbm_budget_bytes / _INFLIGHT

    if kind == "bsr":
        R, C = config.bsr_block
        st = bell_stats(A, config.bsr_block)
        bytes_per_brow = st["slots"] * R * C * (itemsize + 4 / (R * C))
        brows_per_band = max(int(budget // max(bytes_per_brow, 1)), 1)
        band_rows = brows_per_band * R
    elif kind == "ell":
        L = max(int(A.row_nnz.max()), 1)
        bytes_per_row = L * (itemsize + 4)
        band_rows = max(int(budget // max(bytes_per_row, 1)), 8)
        band_rows = (band_rows // 8) * 8
    else:  # wcoo / coo: ~nnz-proportional layouts
        slot_bytes = (itemsize + 12) if kind == "wcoo" else (itemsize + 8)
        bytes_per_row = max(nnz_per_row, 0.1) * slot_bytes * 1.4
        band_rows = max(int(budget // max(bytes_per_row, 1)), 128)
        band_rows = (band_rows // 128) * 128

    band_rows = min(band_rows, max(m, 1))
    n_bands = -(-m // band_rows) if m else 1

    # slice A into row bands (empty tail rows pad the last band)
    band_csrs = []
    for i in range(n_bands):
        r0, r1 = i * band_rows, min((i + 1) * band_rows, m)
        lo, hi = int(A.row_ptr[r0]), int(A.row_ptr[r1])
        rp = np.concatenate([A.row_ptr[r0:r1 + 1] - lo,
                             np.full(band_rows - (r1 - r0), hi - lo,
                                     dtype=A.row_ptr.dtype)])
        band_csrs.append(CsrMatrix(rp, A.col_idx[lo:hi], A.values[lo:hi],
                                   (band_rows, n)))

    kind, dim = probe_band_dims(band_csrs, kind, A.nnz, config)
    bands = [build_band_plan(sub, kind, dim, band_rows, n, A.nnz, dtype,
                             config, device="cpu") for sub in band_csrs]
    return HostResidentPlan(bands, band_rows, A.shape, A.nnz,
                            kind).placed(device)


def probe_band_dims(band_csrs, kind: str, total_nnz: int,
                    config: SBlasConfig):
    """Common static layout dimension across bands (max slots / ELL width /
    tile count / padded nnz).  Returns (kind, dim); `kind` may fall back
    from wcoo to coo when tile-splitting blows up."""
    if kind == "bsr":
        from ..ops.bsr import bell_stats
        return kind, max(max(bell_stats(sub, config.bsr_block)["slots"]
                             for sub in band_csrs), 1)
    if kind == "ell":
        return kind, max(max(int(sub.row_nnz.max()) if sub.nnz else 1
                             for sub in band_csrs), 1)
    if kind == "wcoo":
        from ..ops.wcoo import wcoo_tile_count
        tiles = [wcoo_tile_count(sub) for sub in band_csrs]
        if sum(tiles) * 128 <= _WCOO_BAND_FILL_LIMIT * max(total_nnz, 1):
            return kind, max(tiles)
        kind = "coo"  # pathological tile-splitting: fall back
    if kind == "coo":
        nt = config.nnz_tile
        return kind, max(-(-max(sub.nnz for sub in band_csrs) // nt) * nt,
                         nt)
    raise PartitionError(f"unknown band kind {kind!r}")


def build_band_plan(sub: CsrMatrix, kind: str, dim: int, band_rows: int,
                    n: int, total_nnz: int, dtype: torch.dtype,
                    config: SBlasConfig, *, device):
    """One band's plan on `device`: `sub` is the (band_rows, n) local CSR,
    `dim` the shared dimension from `probe_band_dims`.  Every band carries
    the same static metadata (shape (band_rows, n), nnz `total_nnz`); a
    bf16 band is laid out in f32 and narrowed once, as it is placed."""
    np_val = host_value_dtype(dtype)
    if kind == "bsr":
        from ..ops.bsr import bell_arrays
        R, C = config.bsr_block
        vals, bcol = bell_arrays(sub, config.bsr_block)
        n_brows_t = -(-band_rows // R)
        vals = np.pad(vals, ((0, n_brows_t - vals.shape[0]),
                             (0, dim - vals.shape[1]),
                             (0, 0), (0, 0))).astype(np_val)
        bcol = np.pad(bcol, ((0, n_brows_t - bcol.shape[0]),
                             (0, dim - bcol.shape[1])))
        return BsrPlan.from_numpy(
            dict(vals=vals, bcol=bcol.astype(np.int32)),
            dict(shape=(band_rows, n), nnz=total_nnz,
                 block=tuple(config.bsr_block)), device, dtype=dtype)
    if kind == "ell":
        from ..ops.plans import ell_arrays
        cols, vals = ell_arrays(sub)
        m_pad_t = -(-band_rows // 8) * 8
        cols = np.pad(cols, ((0, m_pad_t - cols.shape[0]),
                             (0, dim - cols.shape[1])))
        vals = np.pad(vals, ((0, m_pad_t - vals.shape[0]),
                             (0, dim - vals.shape[1])))
        return EllPlan.from_numpy(
            dict(cols=cols.astype(np.int32), vals=vals.astype(np_val)),
            dict(shape=(band_rows, n), nnz=total_nnz), device, dtype=dtype)
    if kind == "wcoo":
        from ..ops.wcoo import wcoo_plan_arrays
        r = wcoo_plan_arrays(sub, min_tiles=dim, np_val=np_val)
        meta = dict(shape=(band_rows, n), nnz=total_nnz,
                    n_tiles=r.pop("n_tiles"),
                    n_row_blocks=r.pop("n_row_blocks"))
        r["vals"] = r["vals"].astype(np_val)
        return WcooPlan.from_numpy(r, meta, device, dtype=dtype)
    if kind == "coo":
        coo = sub.to_coo()
        pad = dim - sub.nnz
        rows = np.concatenate([coo.row_idx,
                               np.full(pad, band_rows - 1, np.int64)])
        cols = np.concatenate([coo.col_idx, np.zeros(pad, np.int64)])
        vals = np.concatenate([coo.values, np.zeros(pad, coo.values.dtype)])
        return CooPlan.from_numpy(
            dict(rows=rows.astype(np.int32), cols=cols.astype(np.int32),
                 vals=vals.astype(np_val)),
            dict(shape=(band_rows, n), nnz=total_nnz), device, dtype=dtype)
    raise PartitionError(f"unknown band kind {kind!r}")


# ---------------------------------------------------------------------------
# The streaming executor
# ---------------------------------------------------------------------------

def _stream(items: Sequence[Sequence[torch.Tensor]], device: torch.device,
            compute: Callable[[int, list], None],
            copy_stream=None) -> StreamStats:
    """Call `compute(i, views)` for every item, `views` being item i's host
    tensors copied into one of `_INFLIGHT` device slots.

    Each slot holds one buffer per field, as long as that field's longest
    item, and item i's views are its true shapes over the buffers'
    prefixes.  On a CUDA device the copies run on `copy_stream`,
    non-blocking from pinned memory; the current stream (where `compute`
    launches) waits on each item's copy-done event, and a slot is refilled
    only after the compute-done event of the item that last used it.  The
    host never waits: the events bound the device to `_INFLIGHT` items.
    On the CPU the same ring runs with plain copies."""
    n = len(items)
    if n == 0:
        return StreamStats(0, 0, 0)
    cuda = device.type == "cuda"
    depth = min(_INFLIGHT, n)
    n_fields = len(items[0])
    longest = [max(it[f].numel() for it in items) for f in range(n_fields)]
    slots = [[torch.empty(longest[f], dtype=items[0][f].dtype, device=device)
              for f in range(n_fields)] for _ in range(depth)]
    compute_stream = torch.cuda.current_stream(device) if cuda else None
    if cuda:
        # fresh slots may reuse memory that queued compute still reads
        copy_stream.wait_stream(compute_stream)
    copied: list = [None] * n
    freed: list = [None] * depth
    views: list = [None] * n
    resident = peak = nbytes = 0

    def issue_copy(i: int) -> None:
        nonlocal resident, peak, nbytes
        s = i % depth
        with trace.span("sblas.um.copy", band=i):
            if cuda:
                with torch.cuda.stream(copy_stream):
                    if freed[s] is not None:
                        copy_stream.wait_event(freed[s])
                    views[i] = [buf[:t.numel()].view(t.shape).copy_(
                        t, non_blocking=True)
                        for buf, t in zip(slots[s], items[i])]
                    copied[i] = torch.cuda.Event()
                    copied[i].record(copy_stream)
            else:
                views[i] = [buf[:t.numel()].view(t.shape).copy_(t)
                            for buf, t in zip(slots[s], items[i])]
        nbytes += sum(t.numel() * t.element_size() for t in items[i])
        resident += 1
        peak = max(peak, resident)

    for i in range(depth):
        issue_copy(i)
    for i in range(n):
        with trace.span("sblas.um.compute", band=i):
            if cuda:
                compute_stream.wait_event(copied[i])
            compute(i, views[i])
            if cuda:
                freed[i % depth] = torch.cuda.Event()
                freed[i % depth].record(compute_stream)
        views[i] = None
        resident -= 1
        if i + depth < n:
            issue_copy(i + depth)
    if cuda:
        for buf in (b for slot in slots for b in slot):
            buf.record_stream(copy_stream)
    return StreamStats(n, peak, nbytes)


def stream_plans(plans: Sequence, device: torch.device,
                 compute: Callable[[int, object], None],
                 copy_stream=None) -> StreamStats:
    """`_stream` over band plans: `compute(i, plan i on the device)`."""
    names = tensor_fields(plans[0])
    items = [[getattr(p, k) for k in names] for p in plans]

    def on_device(i: int, views: list) -> None:
        compute(i, dataclasses.replace(plans[i], **dict(zip(names, views))))

    return _stream(items, device, on_device, copy_stream)


def each_band(hplan: HostResidentPlan,
              compute: Callable[[int, object], None]) -> None:
    """`compute(i, band i on the device)` for every band: from the device
    copies when tuned, streamed otherwise (recorded in `last_stream`)."""
    if hplan.tuned:
        for i, band in enumerate(hplan._device_bands):
            with trace.span("sblas.um.compute", band=i):
                compute(i, band)
        return
    side = hplan.copy_stream() if hplan.device.type == "cuda" else None
    hplan._last_stream = stream_plans(hplan.bands, hplan.device, compute,
                                      side)


def _check_operand(hplan: HostResidentPlan, rows: int) -> None:
    require(rows == hplan.shape[1], ShapeError,
            f"A width {hplan.shape[1]} != operand height {rows}")


def spmm_um(hplan: HostResidentPlan, B, alpha, beta, C,
            tuning: bool = False) -> torch.Tensor:
    """C' = beta*C + alpha*A@B with A host-resident; B and C on the plan's
    device (reference spmm_um.h:167: the trailing `tuning` keeps the
    bands on the device)."""
    _check_operand(hplan, B.shape[0])
    if tuning:
        hplan.apply_gpu_tuning()
    m, br = hplan.shape[0], hplan.band_rows
    out = torch.empty((m, B.shape[1]),
                      dtype=torch.promote_types(C.dtype, hplan.dtype),
                      device=C.device)

    def compute(i: int, band) -> None:
        r0, r1 = i * br, min((i + 1) * br, m)
        part = spmm(band, B)
        fold(alpha, part[:r1 - r0], beta, C[r0:r1], hplan.dtype,
             out=out[r0:r1])

    each_band(hplan, compute)
    return out


def spmv_um(hplan: HostResidentPlan, x, alpha, beta, y,
            tuning: bool = False) -> torch.Tensor:
    """y' = beta*y + alpha*A@x with A host-resident (reference
    spmv_um.h:39,51-53)."""
    _check_operand(hplan, x.shape[0])
    if tuning:
        hplan.apply_gpu_tuning()
    m, br = hplan.shape[0], hplan.band_rows
    out = torch.empty(m, dtype=torch.promote_types(y.dtype, hplan.dtype),
                      device=y.device)

    def compute(i: int, band) -> None:
        r0, r1 = i * br, min((i + 1) * br, m)
        part = spmv(band, x)
        fold(alpha, part[:r1 - r0], beta, y[r0:r1], hplan.dtype,
             out=out[r0:r1])

    each_band(hplan, compute)
    return out
