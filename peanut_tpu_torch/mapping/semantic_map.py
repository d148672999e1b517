"""Per-step semantic map update, batched over parallel episodes (torch port
of ``peanut_tpu.mapping.semantic_map``).

Behavioural twin of PEANUT's ``Semantic_Mapping`` (nav/agent/mapping.py:
10-179): depth -> camera-frame point cloud -> egocentric voxel splat ->
height-band projections -> pose-warped paste into the allocentric local map
-> max fuse.  Two paths, selected by ``exact_splat`` (``NavConfig.
exact_parity``): the exact path splats into the voxel grid with per-corner
rounding and warps with two bilinear passes (``F.affine_grid`` +
``F.grid_sample``, PEANUT's mixed align_corners convention); the fast path
folds the z bands into per-point masses (dense matmuls) and warps a small
window around the egocentric support with one composed affine.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import NavConfig
from ..geometry import (
    get_camera_matrix,
    point_cloud_from_depth,
    transform_camera_view,
    transform_pose,
)
from ..geometry.pose import integrate_pose
from ..kernels import splat_feat_nd, grid_sample, pose_warp_grids
from ..kernels.splat import splat_projected_2d


class MapperParams(NamedTuple):
    """Static geometry of the mapper."""
    frame_h: int
    frame_w: int
    resolution: int          # cm per cell
    z_resolution: int
    map_size_cm: int         # local map extent in cm
    vision_range: int
    hfov: float
    du_scale: int
    cat_pred_threshold: float
    exp_pred_threshold: float
    map_pred_threshold: float
    num_sem_categories: int
    agent_height_cm: float
    max_h_idx: int           # int(360 / z_res)
    min_h_idx: int           # int(-40 / z_res)
    exact_splat: bool

    @classmethod
    def from_config(cls, cfg: NavConfig) -> "MapperParams":
        return cls(
            frame_h=cfg.frame_height,
            frame_w=cfg.frame_width,
            resolution=cfg.map_resolution,
            z_resolution=cfg.map_resolution,
            map_size_cm=cfg.map_size_cm // cfg.global_downscaling,
            vision_range=cfg.vision_range,
            hfov=cfg.hfov,
            du_scale=cfg.du_scale,
            cat_pred_threshold=cfg.cat_pred_threshold,
            exp_pred_threshold=cfg.exp_pred_threshold,
            map_pred_threshold=cfg.map_pred_threshold,
            num_sem_categories=cfg.num_sem_categories,
            agent_height_cm=cfg.camera_height * 100.0,
            max_h_idx=int(360 / cfg.map_resolution),
            min_h_idx=int(-40 / cfg.map_resolution),
            exact_splat=cfg.exact_parity,
        )


def _masked_quantile(values, mask, q: float):
    """``torch.quantile(values[mask], q)`` per row (linear interpolation)
    with a static shape: invalid entries sort to +inf, the position comes
    from the valid count.  +inf when the mask is empty (callers guard)."""
    v, _ = torch.sort(torch.where(mask, values, torch.inf), dim=-1)
    n = mask.sum(dim=-1)
    pos = q * (torch.clamp(n, min=1) - 1).to(values.dtype)
    lo = torch.floor(pos).long()
    hi = torch.ceil(pos).long()
    frac = pos - lo.to(values.dtype)
    vlo = torch.gather(v, -1, lo[..., None])[..., 0]
    vhi = torch.gather(v, -1, hi[..., None])[..., 0]
    return vlo * (1 - frac) + vhi * frac


def _stair_mask(xyz_std, feat, p: MapperParams):
    """PEANUT's stair-suppression heuristic (mapping.py:90-97), batched:
    points on a low raised surface move out of range (99999) unless they
    carry the toilet category."""
    z = xyz_std[:, 2, :]                                  # (B, N), normalized
    zz = z * 2.0 + 1.6
    in_range = (z > -1) & (z < 1)
    n_valid = in_range.sum(dim=-1)
    q03 = _masked_quantile(zz, in_range, 0.03)
    frac_step = (((zz > 0.2) & (zz < 0.7)) & in_range).sum(dim=-1)
    trigger = (n_valid > 0) & (q03 > 0.2) & (
        frac_step > 0.2 * n_valid.to(zz.dtype))
    below_floor = zz < 0.7
    # toilet = semantic category 4 -> feat channel 1 + 4 (mapping.py:96)
    no_toilet = feat[:, 1 + 4, :] == 0
    kill = trigger[:, None] & below_floor & no_toilet
    return torch.where(kill[:, None, :], 99999.0, xyz_std)


def _theta_pixel_affine(theta, m: int):
    """Pixel-space affine (B, 3, 3) of one warp pass (affine_grid with
    align_corners=False, grid_sample with align_corners=True): output pixel
    (i, j, 1) -> source pixel (sy, sx)."""
    def f(i, j):
        gx = (2.0 * j + 1.0) / m - 1.0
        gy = (2.0 * i + 1.0) / m - 1.0
        vx = theta[:, 0, 0] * gx + theta[:, 0, 1] * gy + theta[:, 0, 2]
        vy = theta[:, 1, 0] * gx + theta[:, 1, 1] * gy + theta[:, 1, 2]
        sx = (vx + 1.0) * 0.5 * (m - 1)
        sy = (vy + 1.0) * 0.5 * (m - 1)
        return torch.stack([sy, sx], dim=-1)              # (B, 2)

    f00 = f(0.0, 0.0)
    fi = f(1.0, 0.0) - f00
    fj = f(0.0, 1.0) - f00
    bot = theta.new_tensor([0.0, 0.0, 1.0]).expand(theta.shape[0], 3)
    return torch.stack([
        torch.stack([fi[:, 0], fj[:, 0], f00[:, 0]], dim=1),
        torch.stack([fi[:, 1], fj[:, 1], f00[:, 1]], dim=1),
        bot], dim=1)


def _windowed_warp(agent_view, st_pose, vr: int, local_m: int):
    """Fast-mode pose warp: rotation and translation composed into one
    pixel-space affine, sampled bilinearly over a small window around the
    projected egocentric support and pasted into a zero canvas."""
    b, c, m, _ = agent_view.shape
    support_diam = int(math.ceil(vr * 1.4142)) + 6
    win = min(m, max(128, -(-support_diam // 32) * 32))

    t = st_pose[:, 2] * (np.pi / 180.0)
    zeros, ones = torch.zeros_like(t), torch.ones_like(t)
    theta1 = torch.stack([
        torch.stack([torch.cos(t), -torch.sin(t), zeros], dim=1),
        torch.stack([torch.sin(t), torch.cos(t), zeros], dim=1)], dim=1)
    theta2 = torch.stack([
        torch.stack([ones, zeros, st_pose[:, 0]], dim=1),
        torch.stack([zeros, ones, st_pose[:, 1]], dim=1)], dim=1)
    ftot = _theta_pixel_affine(theta1, m) @ _theta_pixel_affine(theta2, m)

    # output window origin: preimage of the support centre
    src_cy = m / 2.0 + vr / 2.0
    src_cx = m / 2.0
    a11, a12 = ftot[:, 0, 0], ftot[:, 0, 1]
    a21, a22 = ftot[:, 1, 0], ftot[:, 1, 1]
    b1 = src_cy - ftot[:, 0, 2]
    b2 = src_cx - ftot[:, 1, 2]
    det = a11 * a22 - a12 * a21
    cy = (a22 * b1 - a12 * b2) / det
    cx = (a11 * b2 - a21 * b1) / det
    oy = torch.clamp(torch.round(cy).long() - win // 2, 0, m - win)
    ox = torch.clamp(torch.round(cx).long() - win // 2, 0, m - win)

    rows = torch.arange(win, dtype=torch.float32, device=agent_view.device)
    ii = oy[:, None, None].float() + rows[None, :, None]
    jj = ox[:, None, None].float() + rows[None, None, :]
    sy = ftot[:, 0, 0, None, None] * ii + ftot[:, 0, 1, None, None] * jj \
        + ftot[:, 0, 2, None, None]
    sx = ftot[:, 1, 0, None, None] * ii + ftot[:, 1, 1, None, None] * jj \
        + ftot[:, 1, 2, None, None]
    y0, x0 = torch.floor(sy), torch.floor(sx)
    wy1, wx1 = sy - y0, sx - x0
    batch = torch.arange(b, device=agent_view.device).view(b, 1, 1)

    def tap(yf, xf, w):
        inside = (yf >= 0) & (yf <= m - 1) & (xf >= 0) & (xf <= m - 1)
        yi = torch.clamp(yf, 0, m - 1).long()
        xi = torch.clamp(xf, 0, m - 1).long()
        vals = agent_view.permute(0, 2, 3, 1)[batch, yi, xi]  # (B, win, win, C)
        return vals * (w * inside)[..., None]

    window = (tap(y0, x0, (1 - wy1) * (1 - wx1))
              + tap(y0, x0 + 1, (1 - wy1) * wx1)
              + tap(y0 + 1, x0, wy1 * (1 - wx1))
              + tap(y0 + 1, x0 + 1, wy1 * wx1))
    window = window.permute(0, 3, 1, 2)                  # (B, C, win, win)

    # paste each env's window at (oy, ox) with one advanced-index write
    canvas = torch.zeros_like(agent_view)
    rr = (oy[:, None] + torch.arange(win, device=oy.device))[:, :, None]
    cc = (ox[:, None] + torch.arange(win, device=ox.device))[:, None, :]
    canvas.permute(0, 2, 3, 1)[batch, rr, cc] = window.permute(0, 2, 3, 1)
    return canvas


class SemanticMapper:
    """Map update for one geometry (stateless: the maps are arguments)."""

    def __init__(self, cfg_or_params):
        if isinstance(cfg_or_params, MapperParams):
            self.params = cfg_or_params
        else:
            self.params = MapperParams.from_config(cfg_or_params)
        p = self.params
        self.cam = get_camera_matrix(p.frame_w, p.frame_h, p.hfov)
        self.nz = p.max_h_idx - p.min_h_idx
        self.local_m = p.map_size_cm // p.resolution
        self.shift_loc = (p.vision_range * p.resolution // 2, 0, np.pi / 2.0)
        self.min_z = int(25 / p.z_resolution - p.min_h_idx)
        self.max_z = int((p.agent_height_cm + 1) / p.z_resolution
                         - p.min_h_idx)

    def update_core(self, obs: torch.Tensor, current_poses: torch.Tensor,
                    maps_last: torch.Tensor):
        """Map update with the post-integration pose supplied by the caller
        (the batched runtime integrates poses on the host).

        obs: (B, 4+nsc, H, W); current_poses: (B, 3) [x, y, o_deg];
        maps_last: (B, 4+nsc, M, M).  Returns (fp_map, new_map, poses)."""
        p = self.params
        vr = p.vision_range
        local_m = self.local_m
        b, c = obs.shape[0], obs.shape[1]
        depth = obs[:, 3, :, :]

        pc = point_cloud_from_depth(depth, self.cam, scale=p.du_scale)
        pc = transform_camera_view(pc, p.agent_height_cm, 0.0)
        pc = transform_pose(pc, self.shift_loc)

        xyz = pc.float()
        xy = xyz[..., :2] / p.resolution
        xy = (xy - vr // 2.0) / vr * 2.0
        z = xyz[..., 2] / p.z_resolution
        z = (z - (p.max_h_idx + p.min_h_idx) // 2.0) / (
            p.max_h_idx - p.min_h_idx) * 2.0
        xyz = torch.cat([xy, z[..., None]], dim=-1)

        # features: occupancy + semantic channels (avg-pooled by du_scale)
        sem = obs[:, 4:, :, :]
        if p.du_scale > 1:
            sem = torch.nn.functional.avg_pool2d(sem, p.du_scale)
        n_pt = sem.shape[-2] * sem.shape[-1]
        feat = torch.cat([torch.ones((b, 1, n_pt), dtype=torch.float32,
                                     device=obs.device),
                          sem.reshape(b, c - 4, n_pt)], dim=1)

        coords = xyz.reshape(b, n_pt, 3).transpose(1, 2)     # (B, 3, N)
        coords = _stair_mask(coords, feat, p)

        if p.exact_splat:
            init_grid = torch.zeros((b, 1 + p.num_sem_categories, vr, vr,
                                     self.nz), dtype=torch.float32,
                                    device=obs.device)
            voxels = splat_feat_nd(init_grid, feat, coords, exact=True)
            voxels = voxels.transpose(2, 3)                # PEANUT .transpose(2,3)
            agent_height_proj = voxels[..., self.min_z:self.max_z].sum(dim=4)
            all_height_proj = voxels.sum(dim=4)
        else:
            agent_height_proj, all_height_proj = splat_projected_2d(
                feat, coords, vr, self.nz, self.min_z, self.max_z)
        # full-height override for thin/elevated categories (mapping.py:
        # 107-113), in place on the fresh projection
        over = (1 + 5, 1 + 2) if p.num_sem_categories <= 16 \
            else (1 + 3, 1 + 9, 1 + 14)
        for ch in over:
            agent_height_proj[:, ch] = all_height_proj[:, ch]

        fp_map = torch.clamp(agent_height_proj[:, 0:1] / p.map_pred_threshold,
                             0, 1)
        fp_exp = torch.clamp(all_height_proj[:, 0:1] / p.exp_pred_threshold,
                             0, 1)

        agent_view = torch.zeros((b, c, local_m, local_m),
                                 dtype=torch.float32, device=obs.device)
        x1 = local_m // 2 - vr // 2
        x2 = x1 + vr
        y1 = local_m // 2
        y2 = y1 + vr
        agent_view[:, 0:1, y1:y2, x1:x2] = fp_map
        agent_view[:, 1:2, y1:y2, x1:x2] = fp_exp
        agent_view[:, 4:, y1:y2, x1:x2] = torch.clamp(
            agent_height_proj[:, 1:] / p.cat_pred_threshold, 0, 1)

        st_pose = torch.stack([
            -(current_poses[:, 0] * 100.0 / p.resolution
              - local_m // 2) / (local_m // 2),
            -(current_poses[:, 1] * 100.0 / p.resolution
              - local_m // 2) / (local_m // 2),
            90.0 - current_poses[:, 2],
        ], dim=1)

        if p.exact_splat:
            rot_grid, trans_grid = pose_warp_grids(
                st_pose, (b, c, local_m, local_m))
            rotated = grid_sample(agent_view, rot_grid, align_corners=True)
            translated = grid_sample(rotated, trans_grid, align_corners=True)
        else:
            translated = _windowed_warp(agent_view, st_pose, vr, local_m)

        new_map = torch.maximum(maps_last, translated)
        return fp_map, new_map, current_poses

    def __call__(self, obs, pose_delta, maps_last, poses_last):
        """PEANUT-shaped entry: integrates the relative pose, then runs the
        core update.  Returns (fp_map, fused_map, current_poses)."""
        return self.update_core(obs, integrate_pose(poses_last, pose_delta),
                                maps_last)
