"""Planar pose math: host numpy functions and the batched torch twin.

Port of ``peanut_tpu.geometry.pose`` (PEANUT nav/agent/utils/pose.py).  The
host float32 twin ``integrate_pose_np`` is a verbatim copy: the runtime
integrates poses on the host so that the host state machines and the device
stamping agree on agent cells, and both packages must get the same cells.
"""

from __future__ import annotations

import numpy as np
import torch


def get_l2_distance(x1, x2, y1, y2):
    return ((x1 - x2) ** 2 + (y1 - y2) ** 2) ** 0.5


def get_rel_pose_change(pos2, pos1):
    """Relative (dx, dy, dtheta) of pos2 w.r.t. pos1; poses are (x, y, o_rad)."""
    x1, y1, o1 = pos1
    x2, y2, o2 = pos2
    theta = np.arctan2(y2 - y1, x2 - x1) - o1
    dist = get_l2_distance(x1, x2, y1, y2)
    dx = dist * np.cos(theta)
    dy = dist * np.sin(theta)
    do = o2 - o1
    return dx, dy, do


def get_new_pose(pose, rel_pose_change):
    """Integrate a relative pose change; orientation in degrees."""
    x, y, o = pose
    dx, dy, do = rel_pose_change
    global_dx = dx * np.sin(np.deg2rad(o)) + dy * np.cos(np.deg2rad(o))
    global_dy = dx * np.cos(np.deg2rad(o)) - dy * np.sin(np.deg2rad(o))
    x += global_dy
    y += global_dx
    o += np.rad2deg(do)
    if o > 180.0:
        o -= 360.0
    return x, y, o


RAD2DEG = 57.29577951308232


def integrate_pose(pose: torch.Tensor, rel: torch.Tensor) -> torch.Tensor:
    """Batched pose integration in degrees (PEANUT mapping.py:143-158,
    including the double-fmod heading wraparound).

    pose: (B, 3) [x, y, o_deg]; rel: (B, 3) [dx, dy, do_rad].
    """
    o_rad = pose[:, 2] / RAD2DEG
    y = pose[:, 1] + rel[:, 0] * torch.sin(o_rad) + rel[:, 1] * torch.cos(o_rad)
    x = pose[:, 0] + rel[:, 0] * torch.cos(o_rad) - rel[:, 1] * torch.sin(o_rad)
    o = pose[:, 2] + rel[:, 2] * RAD2DEG
    o = torch.fmod(o - 180.0, 360.0) + 180.0
    o = torch.fmod(o + 180.0, 360.0) - 180.0
    return torch.stack([x, y, o], dim=1)


def integrate_pose_np(pose: np.ndarray, rel: np.ndarray) -> np.ndarray:
    """Host float32 twin of :func:`integrate_pose`.

    pose: (B, 3) [x, y, o_deg]; rel: (B, 3) [dx, dy, do_rad].
    """
    pose = np.asarray(pose, np.float32)
    rel = np.asarray(rel, np.float32)
    o_rad = pose[:, 2] / np.float32(RAD2DEG)
    y = pose[:, 1] + rel[:, 0] * np.sin(o_rad) + rel[:, 1] * np.cos(o_rad)
    x = pose[:, 0] + rel[:, 0] * np.cos(o_rad) - rel[:, 1] * np.sin(o_rad)
    o = pose[:, 2] + rel[:, 2] * np.float32(RAD2DEG)
    o = np.fmod(o - 180.0, 360.0) + 180.0
    o = np.fmod(o + 180.0, 360.0) - 180.0
    return np.stack([x, y, o], axis=1).astype(np.float32)


def threshold_poses(coords, shape):
    coords[0] = min(max(0, coords[0]), shape[0] - 1)
    coords[1] = min(max(0, coords[1]), shape[1] - 1)
    return coords
