"""Point-cloud frame transforms (torch port of
``peanut_tpu.geometry.transforms``; PEANUT depth_utils.py:158-195).

The rotation matrices are built on the host from static angles and applied
as one matmul over the flattened cloud.
"""

from __future__ import annotations

import numpy as np
import torch

from .rotation import get_r_matrix


def _rotate(xyz: torch.Tensor, r: np.ndarray) -> torch.Tensor:
    rt = torch.as_tensor(r.T, dtype=xyz.dtype, device=xyz.device)
    return (xyz.reshape(-1, 3) @ rt).reshape(xyz.shape)


def transform_camera_view(xyz: torch.Tensor, sensor_height: float,
                          camera_elevation_deg: float) -> torch.Tensor:
    """Rotate camera-frame points by the camera elevation and lift by
    ``sensor_height`` (same units as xyz)."""
    r = get_r_matrix([1.0, 0.0, 0.0], angle=np.deg2rad(camera_elevation_deg))
    out = _rotate(xyz, r)
    out[..., 2] += sensor_height            # in place on the fresh matmul
    return out


def transform_pose(xyz: torch.Tensor, pose_xyt) -> torch.Tensor:
    """Transform points into the frame (x, y, theta_radians); ``pose_xyt``
    is static (the mapper only uses the fixed shift_loc)."""
    x0, y0, theta = pose_xyt
    r = get_r_matrix([0.0, 0.0, 1.0], angle=theta - np.pi / 2.0)
    out = _rotate(xyz, r)
    out[..., 0] += x0
    out[..., 1] += y0
    return out
