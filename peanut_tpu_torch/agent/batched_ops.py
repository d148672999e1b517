"""Device-side batched ops for the parallel-episode runtime (torch port of
``peanut_tpu.agent.batched_ops``).

Each function is the batched (B leading axis) equivalent of a host-side step
of the single-env agent; together they keep the per-tick host<->device
traffic down to poses, flags and an 11x11 planning window per episode.

Index semantics follow JAX's, which torch does not share by default:
``dynamic_slice`` / ``dynamic_update_slice`` clamp their start so the window
fits (``_clamp_start``), and the ``.at[]`` scatters clip their indices.  The
stamps write in place into a fresh result of the caller's tick.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..kernels import eikonal_distance, masked_fill_unreachable
from ..kernels.morphology import disk
# the morphology ops take any leading (batch) dims
from ..kernels.morphology import binary_dilation as batch_dilate  # noqa: F401
from ..kernels.morphology import binary_erosion as batch_erode  # noqa: F401


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, device=like.device)


def mark_agent(maps: torch.Tensor, loc_r, loc_c, radius: int,
               channels: Tuple[int, ...], value: float = 1.0):
    """Stamp a (2r+1)^2 square at per-env (loc_r, loc_c) into ``channels``
    of maps (B, C, H, W), clipped at the edges; in place, returns maps."""
    b, _, h, w = maps.shape
    dr = torch.arange(-radius, radius + 1, device=maps.device)
    rr = torch.clamp(loc_r[:, None] + dr, 0, h - 1)[:, :, None]    # (B,K,1)
    cc = torch.clamp(loc_c[:, None] + dr, 0, w - 1)[:, None, :]    # (B,1,K)
    bi = _arange(b, maps)[:, None, None]
    for ch in channels:
        maps[bi, ch, rr, cc] = value
    return maps


def fill_disk(maps: torch.Tensor, channel: int, loc_r, loc_c, selem_idx_r,
              selem_idx_c, offset: int):
    """Set a disk footprint of cells to 1 in one channel per env (the
    explored-under-agent fill); in place, returns maps."""
    b, _, h, w = maps.shape
    sr = torch.as_tensor(np.asarray(selem_idx_r), device=maps.device)
    sc = torch.as_tensor(np.asarray(selem_idx_c), device=maps.device)
    rr = torch.clamp(loc_r[:, None] + sr - offset, 0, h - 1)
    cc = torch.clamp(loc_c[:, None] + sc - offset, 0, w - 1)
    maps[_arange(b, maps)[:, None], channel, rr, cc] = 1.0
    return maps


def _clamp_start(start: torch.Tensor, size: int, dim: int) -> torch.Tensor:
    """JAX dynamic_slice semantics: the start moves so the window fits."""
    return torch.clamp(start, 0, dim - size)


def _window_index(lmb: torch.Tensor, full_h: int, full_w: int, hl: int,
                  wl: int):
    r0 = _clamp_start(lmb[:, 0], hl, full_h)
    c0 = _clamp_start(lmb[:, 2], wl, full_w)
    rr = (r0[:, None] + torch.arange(hl, device=lmb.device))[:, :, None]
    cc = (c0[:, None] + torch.arange(wl, device=lmb.device))[:, None, :]
    bi = torch.arange(lmb.shape[0], device=lmb.device)[:, None, None]
    return bi, rr, cc


def window_shuttle_out(full_maps: torch.Tensor, local_maps: torch.Tensor,
                       lmb: torch.Tensor) -> torch.Tensor:
    """Write each env's local window back into its full map (in place on
    full_maps, returned).  lmb: (B, 4) [gx1, gx2, gy1, gy2]."""
    hl, wl = local_maps.shape[-2:]
    bi, rr, cc = _window_index(lmb, full_maps.shape[-2], full_maps.shape[-1],
                               hl, wl)
    full_maps.permute(0, 2, 3, 1)[bi, rr, cc] = local_maps.permute(0, 2, 3, 1)
    return full_maps


def window_shuttle_in(full_maps: torch.Tensor, lmb: torch.Tensor,
                      local_h: int, local_w: int) -> torch.Tensor:
    """Slice each env's local window out of its full map (a new tensor)."""
    bi, rr, cc = _window_index(lmb, full_maps.shape[-2], full_maps.shape[-1],
                               local_h, local_w)
    return full_maps.permute(0, 2, 3, 1)[bi, rr, cc].permute(0, 3, 1, 2)


class PlanOutputs(NamedTuple):
    window: torch.Tensor       # (B, K, K) distance window around each agent
    distance: torch.Tensor     # (B,) raw fmm distance at the agent cell
    fmax: torch.Tensor         # (B,) per-env max finite distance (debug)


def build_traversible(obstacle, collision, visited, loc_r, loc_c,
                      col_rad: int, close_left, close_right, close_top,
                      close_bottom):
    """Batched traversibility (agent/planner.py _traversible + border
    closing), without the +1 boundary ring (the padded solve adds it).
    obstacle/collision/visited: (B, H, W); close_*: (B,) bool flags for
    global-map-edge walls.  Returns (traversible, grid)."""
    b, h, w = obstacle.shape
    grid = torch.round(obstacle)
    rows = torch.arange(h, device=grid.device)[None, :, None]
    cols = torch.arange(w, device=grid.device)[None, None, :]
    edge = ((close_top[:, None, None] & (rows == 0))
            | (close_bottom[:, None, None] & (rows == h - 1))
            | (close_left[:, None, None] & (cols == 0))
            | (close_right[:, None, None] & (cols == w - 1)))
    grid = torch.where(edge, 1.0, grid)

    trav = ~batch_dilate(grid, disk(col_rad))
    trav = trav & ~(collision > 0)
    trav = trav | (visited > 0)

    # agent 3x3 always traversible (in place on the fresh mask)
    dr = torch.arange(-1, 2, device=grid.device)
    rr = torch.clamp(loc_r[:, None] + dr, 0, h - 1)[:, :, None]
    cc = torch.clamp(loc_c[:, None] + dr, 0, w - 1)[:, None, :]
    trav[_arange(b, trav)[:, None, None], rr, cc] = True
    return trav, grid


def dilate_goal(goal, found_goal, is_toilet):
    """Goal-region dilation with a per-env footprint (planner._get_stg):
    disk(8) found / disk(6) found+toilet / disk(2) otherwise."""
    d8 = batch_dilate(goal, disk(8))
    d6 = batch_dilate(goal, disk(6))
    d2 = batch_dilate(goal, disk(2))
    found = found_goal[:, None, None] > 0
    toilet = is_toilet[:, None, None]
    return torch.where(found & toilet, d6, torch.where(found, d8, d2))


def plan_distance_fields(traversible, goal_dilated, loc_r, loc_c,
                         n_iters: int = 2, win: int = 5, block: int = 16,
                         inner: int = 40, plain: bool = False) -> PlanOutputs:
    """Batched boundary-padded eikonal solve + per-env window extraction.

    Equivalent to FMMPlanner construction with add_boundary (traversible
    ring of 1s, goal ring of 0s) followed by fmm_dist filling; returns the
    (2*win+1)^2 window centred at each agent (agent at loc+1 in padded
    coordinates), padded with the host planner's sentinel shape^2.
    ``plain`` goes to ``eikonal_distance``.
    """
    b, h, w = traversible.shape
    trav_b = torch.nn.functional.pad(traversible.float(), (1, 1, 1, 1),
                                     value=1.0)
    goal_b = torch.nn.functional.pad(goal_dilated.float(), (1, 1, 1, 1),
                                     value=0.0)
    d = eikonal_distance(trav_b, goal_b, n_iters=n_iters, block=block,
                         inner=inner, plain=plain)
    d = masked_fill_unreachable(d)

    sentinel = float((h + 2) ** 2)
    dp = torch.nn.functional.pad(d, (win, win, win, win), value=sentinel)
    k = 2 * win + 1
    # agent at (r+1, c+1) in padded solve coords; +win for the pad
    r0 = _clamp_start(loc_r + 1, k, dp.shape[-2])
    c0 = _clamp_start(loc_c + 1, k, dp.shape[-1])
    kk = torch.arange(k, device=d.device)
    window = dp[torch.arange(b, device=d.device)[:, None, None],
                (r0[:, None] + kk)[:, :, None], (c0[:, None] + kk)[:, None, :]]
    distance = window[:, win, win]
    fmax = torch.amax(torch.where(torch.isfinite(d), d, 0.0), dim=(1, 2))
    return PlanOutputs(window=window, distance=distance, fmax=fmax)
