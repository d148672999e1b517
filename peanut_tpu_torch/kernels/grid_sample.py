"""Affine sampling grids + bilinear resampling: torch built-ins.

Port of ``peanut_tpu.kernels.grid_sample``, which re-implements exactly these
two torch functions for XLA.  PEANUT warps each egocentric map into the
allocentric frame with ``F.affine_grid`` (align_corners **False**) followed by
``F.grid_sample`` with align_corners **True** and zero padding
(nav/agent/utils/model.py:40-41, nav/agent/mapping.py:172-173); the port keeps
that mixed convention.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def affine_grid(theta: torch.Tensor, size, align_corners: bool = False):
    """(N, 2, 3) affine matrices -> (N, H, W, 2) grid of (x, y) coords."""
    return F.affine_grid(theta, list(size), align_corners=align_corners)


def grid_sample(inp: torch.Tensor, grid: torch.Tensor,
                align_corners: bool = True) -> torch.Tensor:
    """Bilinear sampling with zero padding (N, C, H, W) -> (N, C, Ho, Wo)."""
    return F.grid_sample(inp, grid, mode="bilinear", padding_mode="zeros",
                         align_corners=align_corners)


def pose_warp_grids(st_pose: torch.Tensor, size):
    """Rotation + translation sampling grids from a normalized pose
    (PEANUT nav/agent/utils/model.py:7-43).  ``st_pose`` is (N, 3)
    [x_norm, y_norm, theta_deg]; returns (rot_grid, trans_grid)."""
    x = st_pose[:, 0]
    y = st_pose[:, 1]
    t = st_pose[:, 2] * (np.pi / 180.0)
    cos_t, sin_t = torch.cos(t), torch.sin(t)
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    theta1 = torch.stack([torch.stack([cos_t, -sin_t, zero], dim=1),
                          torch.stack([sin_t, cos_t, zero], dim=1)], dim=1)
    theta2 = torch.stack([torch.stack([one, zero, x], dim=1),
                          torch.stack([zero, one, y], dim=1)], dim=1)
    return (affine_grid(theta1, size, align_corners=False),
            affine_grid(theta2, size, align_corners=False))
