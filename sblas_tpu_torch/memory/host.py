"""Band plans with shared static dimensions.

Port of the part of `sblas_tpu/memory/host.py` that the distributed
shard builders use: `probe_band_dims` finds one set of dimensions that
every band (or shard) of a matrix fits, and `build_band_plan` lays one
band out with them, so that all bands carry the same shapes.  The numpy
code is the JAX package's, so the arrays are byte-identical.  The
host-streamed execution around it (pinned bands, the in-flight window)
is later work.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SBlasConfig
from ..containers import CsrMatrix
from ..ops.bsr import BsrPlan
from ..ops.plans import CooPlan, EllPlan, np_value_dtype
from ..utils.errors import PartitionError

# Windowed-COO band fallback: if tile-splitting stores more than this many
# slots per true nnz across all bands, plain COO bands stream less data.
_WCOO_BAND_FILL_LIMIT = 8.0


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
    the same static metadata (shape (band_rows, n), nnz `total_nnz`)."""
    np_val = np_value_dtype(dtype)
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
                 block=tuple(config.bsr_block)), device)
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
            dict(shape=(band_rows, n), nnz=total_nnz), device)
    if kind == "wcoo":
        from ..ops.wcoo import WcooPlan, wcoo_plan_arrays
        r = wcoo_plan_arrays(sub, min_tiles=dim, np_val=np_val)
        meta = dict(shape=(band_rows, n), nnz=total_nnz,
                    n_tiles=r.pop("n_tiles"),
                    n_row_blocks=r.pop("n_row_blocks"))
        r["vals"] = r["vals"].astype(np_val)
        return WcooPlan.from_numpy(r, meta, device)
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
            dict(shape=(band_rows, n), nnz=total_nnz), device)
    raise PartitionError(f"unknown band kind {kind!r}")
