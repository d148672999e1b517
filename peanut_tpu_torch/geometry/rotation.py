"""Rodrigues rotation matrices (numpy — built at trace time, not per step).

Matches PEANUT nav/agent/utils/rotation_utils.py:27-37 (a copy of
peanut_tpu.geometry.rotation).
"""

from __future__ import annotations

import numpy as np

ANGLE_EPS = 0.001


def normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


def get_r_matrix(axis, angle: float) -> np.ndarray:
    """Rotation matrix about ``axis`` by ``angle`` radians (Rodrigues)."""
    ax = normalize(np.asarray(axis, dtype=np.float64))
    if np.abs(angle) > ANGLE_EPS:
        s_hat = np.array(
            [[0.0, -ax[2], ax[1]],
             [ax[2], 0.0, -ax[0]],
             [-ax[1], ax[0], 0.0]], dtype=np.float32)
        r = (np.eye(3) + np.sin(angle) * s_hat
             + (1 - np.cos(angle)) * np.linalg.matrix_power(s_hat, 2))
    else:
        r = np.eye(3)
    return r
