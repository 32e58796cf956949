"""Extraction cost constants of the xfoot planner.

Port of the device-side data-movement constants of
`sblas_tpu/scaling.py`: `GATHER_NS`, the cost of one element of a flat
gather, and `ROUTE_NS`, the cost of one element of padded route space of
a routed permutation (`ops/route.py`).  `parallel/xfoot.py` prices its two
extraction engines with them (flat: GATHER_NS x out_slots; route:
ROUTE_NS x route space) and builds the cheaper one.

The JAX package's values (and its `scaling_calib.json`) were measured on
a TPU v5e, whose elementwise gather was slow; the port never reads them.
Its defaults are the H100's own, measured by `chip_smoke.py`'s
`[xfoot-extract]` phase (rank 0's extraction of webbase-1M at 4 and 16
shards, each engine forced; the mean of the two sizes' ns per element).
`SBLAS_GATHER_NS` / `SBLAS_ROUTE_NS` override them.

The rest of the JAX module (the ICI/DCN ring model, `project*`,
`scorecard_lines`, `measured_multichip`) is not ported yet.
"""

from __future__ import annotations

import os

# Measured on an NVIDIA H100 80GB HBM3 at a 700.00 W power limit
# (chip_smoke.py [xfoot-extract], see PERF.md): ns per element of
# `out_slots` for the flat gather, of route space for the routed one.
_H100_GATHER_NS = 0.05355
_H100_ROUTE_NS = 0.20419


def _const(env: str, default: float):
    """(value, provenance): the environment variable over the default."""
    if env in os.environ:
        return float(os.environ[env]), f"env {env}"
    return default, "H100 default (chip_smoke.py [xfoot-extract])"


GATHER_NS, GATHER_NS_SRC = _const("SBLAS_GATHER_NS", _H100_GATHER_NS)
ROUTE_NS, ROUTE_NS_SRC = _const("SBLAS_ROUTE_NS", _H100_ROUTE_NS)


def param_provenance() -> str:
    """One line telling measured constants from overridden ones."""
    return (f"gather_ns={GATHER_NS:.4f} ({GATHER_NS_SRC}), "
            f"route_ns={ROUTE_NS:.4f} ({ROUTE_NS_SRC})")
