"""The plan-selection experiment's structure classes, for the port.

The JAX package's `experiments/plan_matrix.py` measures every forced
layout against `make_plan`'s auto choice over ten synthetic structure
classes; its `matrix_classes` are the matrices, at the experiment's full
size (the chooser's thresholds are scale-aware, so smaller ones would
take other branches).  This is that function, built with
`sblas_tpu_torch.io.generate` (the same seeded generators, so the same
matrices): `tests/test_torch_plan_choices.py` pins the port's choices
on them.  The timing harness itself is not ported.
"""

from __future__ import annotations

import numpy as np


def matrix_classes() -> dict:
    """name -> zero-argument generator of the class's float32 matrix."""
    from ..io.generate import (adversarial_skew, block_dominant,
                               fem_banded_like, fem_shell_like,
                               pattern_symmetric, road_network_like,
                               scattered_sparse, uniform_random,
                               webbase_like)
    f32 = np.float32
    return {
        # the two tuned-on classes, at reduced scale (controls)
        "shell_fem": lambda: fem_shell_like(nx=101, ny=50, dof=6,
                                            n_target=30_300, dtype=f32),
        "web_power": lambda: webbase_like(n=200_000, dtype=f32),
        # the classes the heuristics were not tuned on
        "dense_band": lambda: fem_banded_like(n=30_000, half_band=36,
                                              dtype=f32),
        "block_dom": lambda: block_dominant(dtype=f32),
        "road_local": lambda: road_network_like(dtype=f32),
        "uniform": lambda: uniform_random(100_000, 100_000, 8, dtype=f32),
        "rect_wide": lambda: uniform_random(20_000, 200_000, 16, dtype=f32),
        "near_empty": lambda: scattered_sparse(dtype=f32),
        "skew_rows": lambda: adversarial_skew(m=65_536, n=65_536,
                                              heavy_rows=8, heavy_nnz=32_768,
                                              light_nnz=2, dtype=f32),
        "small_sym": lambda: pattern_symmetric(),
    }
