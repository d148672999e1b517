"""Pinhole camera model and depth back-projection (torch).

Port of ``peanut_tpu.geometry.camera``; numerics match PEANUT's
nav/agent/utils/depth_utils.py:27-34,129-155: principal point at
((W-1)/2, (H-1)/2), focal length (W/2)/tan(hfov/2), and an image-space grid
whose vertical axis is flipped so Z increases upward.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class CameraMatrix(NamedTuple):
    xc: float
    zc: float
    f: float


def get_camera_matrix(width: int, height: int, fov_deg: float) -> CameraMatrix:
    """Camera intrinsics from image size and horizontal FOV (degrees)."""
    xc = (width - 1.0) / 2.0
    zc = (height - 1.0) / 2.0
    f = (width / 2.0) / np.tan(np.deg2rad(fov_deg / 2.0))
    return CameraMatrix(xc=float(xc), zc=float(zc), f=float(f))


def point_cloud_from_depth(depth: torch.Tensor, camera: CameraMatrix,
                           scale: int = 1) -> torch.Tensor:
    """Back-project a depth image into a camera-frame point cloud.

    depth: (..., H, W).  Returns (..., H//scale, W//scale, 3) with axis order
    (X right, Y forward into the image, Z up).
    """
    h, w = depth.shape[-2], depth.shape[-1]
    grid_x = torch.arange(w, dtype=depth.dtype, device=depth.device)[None, :]
    grid_z = torch.arange(h - 1, -1, -1, dtype=depth.dtype,
                          device=depth.device)[:, None]
    y = depth[..., ::scale, ::scale]
    gx = grid_x[:, ::scale]
    gz = grid_z[::scale, :]
    x = (gx - camera.xc) * y / camera.f
    z = (gz - camera.zc) * y / camera.f
    return torch.stack((x, y, z), dim=-1)
