"""Fast-marching local planner (port of ``peanut_tpu.planning.fmm_planner``).

Behavioural twin of PEANUT's FMMPlanner (nav/agent/utils/fmm_planner.py:
39-133), with the geodesic solve running through
``peanut_tpu_torch.kernels.fmm`` on the planner's device instead of host
skfmm.  The short-term-goal extraction (an argmin over a step_size annulus
around the agent) stays host-side numpy.

``FMMPlanner.solve_batch`` is the batched path of the multi-episode runtime:
N traversible/goal maps solve as one call (the fused schedule on CUDA).
Single-grid (2-D) solves run with ``device="cpu"``; on CUDA they need the
first-order sweep kernel (ROADMAP B4) and raise.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np

from ..kernels import eikonal_distance, masked_fill_unreachable


@functools.lru_cache(maxsize=16)
def step_mask(sx: float, sy: float, scale: float, step_size: int) -> np.ndarray:
    """Ring of cells one step away (PEANUT get_mask, fmm_planner.py:8-22)."""
    size = int(step_size // scale) * 2 + 1
    mask = np.zeros((size, size))
    for i in range(size):
        for j in range(size):
            cond1 = ((i + 0.5) - (size // 2 + sx)) ** 2 + \
                    ((j + 0.5) - (size // 2 + sy)) ** 2 <= step_size ** 2
            cond2 = ((i + 0.5) - (size // 2 + sx)) ** 2 + \
                    ((j + 0.5) - (size // 2 + sy)) ** 2 > (step_size - 1) ** 2
            if cond1 and cond2:
                mask[i, j] = 1
    mask[size // 2, size // 2] = 1
    return mask


@functools.lru_cache(maxsize=16)
def step_dist(sx: float, sy: float, scale: float, step_size: int) -> np.ndarray:
    """Euclidean step distances (PEANUT get_dist, fmm_planner.py:25-36)."""
    size = int(step_size // scale) * 2 + 1
    mask = np.zeros((size, size)) + 1e-10
    for i in range(size):
        for j in range(size):
            d2 = ((i + 0.5) - (size // 2 + sx)) ** 2 + \
                 ((j + 0.5) - (size // 2 + sy)) ** 2
            if d2 <= step_size ** 2:
                mask[i, j] = max(5, d2 ** 0.5)
    return mask


class FMMPlanner:
    def __init__(self, traversible: np.ndarray, scale: int = 1,
                 step_size: int = 5, n_iters: int = 2, device=None):
        self.device = device
        self.scale = scale
        self.step_size = step_size
        self.n_iters = n_iters
        if scale != 1:
            import cv2
            t = cv2.resize(traversible.astype(np.float32),
                           (traversible.shape[1] // scale,
                            traversible.shape[0] // scale),
                           interpolation=cv2.INTER_NEAREST)
            self.traversible = np.rint(t)
        else:
            self.traversible = traversible
        self.du = int(self.step_size / (self.scale * 1.0))
        self.fmm_dist: Optional[np.ndarray] = None

    def set_goal(self, goal, auto_improve: bool = False) -> None:
        """Single-cell goal (fmm_planner.py:56-66).

        ``auto_improve`` snaps a goal that fell on a non-traversible cell
        to the nearest traversible one first (fmm_planner.py:59-60; dead
        on PEANUT's own call path — set_goal is only reached with
        auto_improve's default False — but part of the planner's API)."""
        gx = int(goal[0] / self.scale)
        gy = int(goal[1] / self.scale)
        if self.traversible[gx, gy] == 0.0 and auto_improve:
            gx, gy = self._find_nearest_goal([gx, gy])
        sources = np.zeros_like(self.traversible)
        sources[gx, gy] = 1
        self._solve(sources)

    def _find_nearest_goal(self, goal) -> Tuple[int, int]:
        """Nearest traversible cell to an off-map goal, by Euclidean
        distance over an obstacle-free plane (fmm_planner.py:118-133:
        the helper solves on an all-traversible grid, then masks to this
        planner's traversible cells and takes the argmin)."""
        free = np.ones_like(self.traversible)
        helper = FMMPlanner(free, n_iters=self.n_iters, device=self.device)
        helper.set_goal(goal)
        dist_map = helper.fmm_dist * self.traversible
        dist_map[dist_map == 0] = dist_map.max()
        idx = int(dist_map.argmin())
        return np.unravel_index(idx, dist_map.shape)

    def set_multi_goal(self, goal_map: np.ndarray) -> None:
        """Distance field to the set of goal cells."""
        self._solve(goal_map == 1)

    def _solve(self, sources) -> None:
        d = eikonal_distance(self.traversible, sources, n_iters=self.n_iters,
                             device=self.device)
        self.fmm_dist = masked_fill_unreachable(d).cpu().numpy()

    @staticmethod
    def solve_batch(traversibles, goal_maps, n_iters: int = 2,
                    device=None) -> np.ndarray:
        """Batched distance solve for the parallel-episode runtime: (N, H, W)
        host arrays, solved on ``device``, returned to the host."""
        d = eikonal_distance(traversibles, goal_maps, n_iters=n_iters,
                             device=device)
        return masked_fill_unreachable(d).cpu().numpy()

    def get_short_term_goal(self, state) -> Tuple[float, float, float, bool, bool]:
        """Pick the next waypoint: argmin of the distance field within a
        step_size ring around the agent (fmm_planner.py:77-116).

        Returns (stg_x, stg_y, distance, stop, replan)."""
        scale = self.scale * 1.0
        state = [x / scale for x in state]
        dx, dy = state[0] - int(state[0]), state[1] - int(state[1])
        mask = step_mask(dx, dy, scale, self.step_size)
        dist_mask = step_dist(dx, dy, scale, self.step_size)
        state = [int(x) for x in state]

        dist = np.pad(self.fmm_dist, self.du, "constant",
                      constant_values=self.fmm_dist.shape[0] ** 2)
        subset = dist[state[0]:state[0] + 2 * self.du + 1,
                      state[1]:state[1] + 2 * self.du + 1].copy()
        assert subset.shape == (2 * self.du + 1, 2 * self.du + 1), \
            f"planning window {subset.shape}"

        subset *= mask
        subset += (1 - mask) * self.fmm_dist.shape[0] ** 2
        distance = subset[self.du, self.du]
        stop = bool(subset[self.du, self.du] < 0.25 * 100 / 5.0)

        subset -= subset[self.du, self.du]
        ratio1 = subset / dist_mask
        subset[ratio1 < -1.5] = 1

        stg_x, stg_y = np.unravel_index(np.argmin(subset), subset.shape)
        replan = bool(subset[stg_x, stg_y] > -0.0001)
        return ((stg_x + state[0] - self.du) * scale,
                (stg_y + state[1] - self.du) * scale,
                distance, stop, replan)
