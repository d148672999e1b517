"""Depth-frame repair and scaling (vectorized).

Equivalent of the reference's per-column host loop
(PEANUT nav/agent/agent_helper.py:197-217), vectorized over columns:
  * invalid (zero) pixels become the column max when >90% of the column is
    invalid, else a far sentinel;
  * pixels beyond 0.99 of the depth range are zeroed then sent to the far
    sentinel;
  * output is converted to centimetres within [min_d, max_d].
"""

from __future__ import annotations

import numpy as np


def preprocess_depth(depth: np.ndarray, min_d: float, max_d: float) -> np.ndarray:
    """depth: (..., H, W, 1) or (..., H, W) normalized [0, 1] -> (..., H, W)
    in cm.  Batched over leading axes (column stats are per-image)."""
    if depth.shape[-1] == 1:
        depth = depth[..., 0]
    depth = depth.astype(np.float32).copy()

    invalid = depth == 0.0
    col_invalid_frac = invalid.mean(axis=-2)                   # (..., W)
    col_max = depth.max(axis=-2)                               # (..., W)
    fill = np.where(col_invalid_frac > 0.9, col_max, 100.0)
    depth = np.where(invalid, fill[..., None, :], depth)

    depth[depth > 0.99] = 0.0
    depth[depth == 0.0] = 100.0
    return min_d * 100.0 + depth * (max_d - min_d) * 100.0
