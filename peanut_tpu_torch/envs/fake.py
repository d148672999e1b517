"""Synthetic ObjectNav environment for tests and benchmarks.

A raycast 2D gridworld exposing the same observation dict contract as the
habitat task the reference targets (configs/challenge_objectnav2022:
640x480 RGB-D, HFOV 79, GPS+compass, objectgoal; actions STOP/FWD/LEFT/
RIGHT at 25cm / 30deg).  Depth comes from a per-column 2D raycast against
the occupancy grid, so the agent's mapping pipeline sees geometrically
consistent walls; the goal object renders into a ground-truth segmentation
channel when visible.  No habitat required.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..config import NavConfig


class FakeNavEnv:
    FORWARD_M = 0.25
    # candidate positions ``reset`` draws before it gives up: 12x the most
    # a reset that succeeds took over seeds 0-299 (843, in a 6.5 m square,
    # whose goal region is four thin corners), and ~0.2 s of one that
    # cannot (no free cell ``goal_min_dist`` from the start)
    MAX_DRAWS = 10_000

    def __init__(self, cfg: NavConfig, size_m: float = 12.0, seed: int = 0,
                 max_steps: Optional[int] = None,
                 objects_in_depth: bool = False,
                 goal_min_dist: float = 3.0,
                 goal_max_dist: Optional[float] = None,
                 goal_line_of_sight: bool = False,
                 goal_unique: bool = False,
                 emit_gt_seg: bool = True):
        self.cfg = cfg
        self.size = size_m
        self.seed = seed
        self.rng = np.random.RandomState(seed)
        self.res = 0.05  # occupancy resolution (m/cell)
        self.n = int(size_m / self.res)
        self.max_steps = max_steps or cfg.max_episode_length
        self.episode_over = False
        # objects_in_depth renders objects into the depth image at their
        # true range (geometrically consistent: the mapper then places the
        # goal at the object's position, as real RGB-D would).  Default off
        # to keep the pinned golden-map observation stream byte-stable;
        # the navigation-quality suite opts in.
        self.objects_in_depth = objects_in_depth
        # minimum straight-line spawn distance of the goal object; the
        # quality suite lowers it so goals sit inside a small test map's
        # vision range (CPU-affordable local maps)
        self.goal_min_dist = goal_min_dist
        self.goal_max_dist = goal_max_dist
        # require an unobstructed ray from the start pose to the goal, so
        # the episode tests see->map->plan->stop rather than exploration
        # luck through random walls (the navigation-quality suite's mode)
        self.goal_line_of_sight = goal_line_of_sight
        # exclude distractors of the goal's category: success here is
        # distance to THE goal object, so a same-category distractor makes
        # a correct category-level stop read as failure (real ObjectNav
        # counts any instance).  Default off for byte-stable pinned streams.
        self.goal_unique = goal_unique
        # emit_gt_seg=False skips building the (H, W, 10) ground-truth
        # stack + goal channel (12 MB/step of zeros) when the consumer runs
        # the real Mask R-CNN (use_gt_seg=0) and never reads either key;
        # rgb/depth rendering is unchanged either way
        self.emit_gt_seg = emit_gt_seg
        self._metrics = {}

    # ------------------------------------------------------------------
    def _build_world(self):
        n = self.n
        occ = np.zeros((n, n), bool)
        occ[0, :] = occ[-1, :] = occ[:, 0] = occ[:, -1] = True
        # a few interior walls with gaps
        for _ in range(3):
            r = self.rng.randint(n // 4, 3 * n // 4)
            gap = self.rng.randint(n // 6, n - n // 6)
            if self.rng.rand() < 0.5:
                occ[r, :gap - 10] = True
                occ[r, gap + 10:] = True
            else:
                occ[:gap - 10, r] = True
                occ[gap + 10:, r] = True
        return occ

    def reset(self) -> Dict:
        self.occ = self._build_world()
        self.steps = 0
        self.episode_over = False
        self.called_stop = False
        # agent pose: x (m), y (m), heading (rad, 0 = +x)
        self.pose = np.array([self.size / 2, self.size / 2, 0.0])
        self.start_pose = self.pose.copy()
        # place semantic objects (map categories 0..8) in free space; the
        # first one is the episode goal
        self.objects = []  # (x, y, category)
        self.goal_id = self.rng.randint(0, 6)
        from ..constants import hm3d_to_coco

        goal_cat = hm3d_to_coco[self.goal_id]
        n_objects = 8
        draws = 0
        while len(self.objects) < n_objects:
            if draws == self.MAX_DRAWS:
                raise RuntimeError(
                    f"FakeNavEnv.reset: {len(self.objects)} of {n_objects} "
                    f"objects placed after {draws} candidate draws (size "
                    f"{self.size} m, seed {self.seed}, goal_min_dist "
                    f"{self.goal_min_dist} m): no free cell may lie "
                    f"goal_min_dist from the start")
            draws += 1
            gx, gy = self.rng.rand(2) * (self.size - 2) + 1
            if self._occupied(gx, gy):
                continue
            if not self.objects:
                d0 = np.hypot(gx - self.pose[0], gy - self.pose[1])
                if d0 <= self.goal_min_dist or \
                        (self.goal_max_dist and d0 > self.goal_max_dist):
                    continue
                if self.goal_line_of_sight:
                    gang = np.arctan2(gy - self.pose[1], gx - self.pose[0])
                    if self._raycast(np.array([gang]))[0] <= d0 - 0.1:
                        continue
                cat = goal_cat
            else:
                cat = self.rng.randint(0, 9)
                if self.goal_unique and cat == goal_cat:
                    continue
            self.objects.append((gx, gy, cat))
        self.goal_pos = np.array([self.objects[0][0], self.objects[0][1]])
        # habitat-style SPL bookkeeping: straight-line start->goal stands
        # in for the geodesic shortest path (a lower bound, so SPL here is
        # conservative); path length accumulates actual displacement
        self.start_goal_dist = float(
            np.hypot(*(self.goal_pos - self.pose[:2])))
        self.path_length = 0.0
        return self._obs()

    def _occupied(self, x, y) -> bool:
        i = int(np.clip(y / self.res, 0, self.n - 1))
        j = int(np.clip(x / self.res, 0, self.n - 1))
        return bool(self.occ[i, j])

    # ------------------------------------------------------------------
    def _raycast(self, angles) -> np.ndarray:
        """Distances (m) along each angle until a wall, from the agent.

        float32 marching + flat occupancy indexing: ~2x cheaper than the
        float64 form at 640 rays x ~130 samples, identical hit cells except
        for sub-resolution (<1e-6 m) boundary rounding.
        """
        max_d = self.cfg.max_depth + 1.0
        step = self.res * 0.9
        n_steps = int(max_d / step)
        ds = (np.arange(1, n_steps + 1) * step).astype(np.float32)
        a = np.asarray(angles, np.float32)
        xs = np.float32(self.pose[0]) + np.cos(a)[:, None] * ds[None, :]
        ys = np.float32(self.pose[1]) + np.sin(a)[:, None] * ds[None, :]
        inv = np.float32(1.0 / self.res)
        ii = np.clip((ys * inv).astype(np.int32), 0, self.n - 1)
        jj = np.clip((xs * inv).astype(np.int32), 0, self.n - 1)
        hit = self.occ.ravel()[ii * self.n + jj]
        first = np.where(hit.any(axis=1), hit.argmax(axis=1), n_steps - 1)
        return ds[first].astype(np.float64)

    def _obs(self) -> Dict:
        cfg = self.cfg
        w, h = cfg.env_frame_width, cfg.env_frame_height
        half = np.deg2rad(cfg.hfov) / 2
        angles = self.pose[2] + np.linspace(half, -half, w)
        dist = self._raycast(angles)  # (W,)
        # planar distance -> perpendicular depth (pinhole convention)
        depth_m = dist * np.cos(angles - self.pose[2])
        depth = np.clip((depth_m - cfg.min_depth)
                        / (cfg.max_depth - cfg.min_depth), 0.0, 1.0)
        depth_img = np.tile(depth[None, :], (h, 1)).astype(np.float32)[..., None]

        rgb = np.full((h, w, 3), 127, np.uint8)

        # ground-truth segmentation: every visible in-range object paints
        # its category channel; 'goalseg' keeps the reference contract
        # (goal category only), 'gtsem' is the full (H, W, 10) stack
        gtsem = (np.zeros((h, w, 10), np.float32)
                 if self.emit_gt_seg else None)
        from ..constants import hm3d_to_coco

        goal_cat = hm3d_to_coco[self.goal_id]
        for ox, oy, cat in self.objects:
            gvec = np.array([ox, oy]) - self.pose[:2]
            gdist = np.hypot(*gvec)
            gang = np.arctan2(gvec[1], gvec[0])
            rel = (gang - self.pose[2] + np.pi) % (2 * np.pi) - np.pi
            if abs(rel) < half and cfg.min_depth < gdist < cfg.max_depth:
                col = int((half - rel) / (2 * half) * (w - 1))
                ray_d = self._raycast(np.array([gang]))[0]
                if ray_d > gdist - 0.1:  # not behind a wall
                    cw = max(3, int(0.4 / gdist * w / (2 * half)))
                    c0, c1 = max(0, col - cw), min(w, col + cw)
                    if gtsem is not None:
                        gtsem[h // 3:2 * h // 3, c0:c1, cat] = 1.0
                    color = (40 + 20 * cat, 200 - 15 * cat, 40)
                    rgb[h // 3:2 * h // 3, c0:c1] = color
                    if self.objects_in_depth:
                        # perpendicular (pinhole) depth of the object's
                        # pixels, so the splat maps it at its true range
                        od = gdist * np.cos(rel)
                        odn = np.clip((od - cfg.min_depth)
                                      / (cfg.max_depth - cfg.min_depth),
                                      0.0, 1.0)
                        depth_img[h // 3:2 * h // 3, c0:c1, 0] = np.minimum(
                            depth_img[h // 3:2 * h // 3, c0:c1, 0],
                            np.float32(odn))
        # habitat gps convention: x forward-ish, see peanut_agent.py:77-84
        gps = np.array([self.pose[0] - self.start_pose[0],
                        -(self.pose[1] - self.start_pose[1])])
        compass = np.array([self.pose[2] - self.start_pose[2]])
        obs = {
            "rgb": rgb,
            "depth": depth_img,
            "gps": gps,
            "compass": compass,
            "objectgoal": np.array([self.goal_id]),
        }
        if gtsem is not None:
            obs["goalseg"] = gtsem[:, :, goal_cat].copy()
            obs["gtsem"] = gtsem
        return obs

    # ------------------------------------------------------------------
    def step(self, action) -> Dict:
        if isinstance(action, dict):
            action = action["action"]
        self.steps += 1
        turn = np.deg2rad(self.cfg.turn_angle)
        if action == 0:
            self.called_stop = True
            self.episode_over = True
        elif action == 1:
            nx = self.pose[0] + np.cos(self.pose[2]) * self.FORWARD_M
            ny = self.pose[1] + np.sin(self.pose[2]) * self.FORWARD_M
            # slide-free collision: blocked moves do nothing
            if not self._occupied(nx, ny):
                self.path_length += float(
                    np.hypot(nx - self.pose[0], ny - self.pose[1]))
                self.pose[0], self.pose[1] = nx, ny
        elif action == 2:  # left
            self.pose[2] += turn
        elif action == 3:  # right
            self.pose[2] -= turn
        if self.steps >= self.max_steps:
            self.episode_over = True
        if self.episode_over:
            d = float(np.hypot(*(self.goal_pos - self.pose[:2])))
            success = float(self.called_stop and d < 1.0)
            # habitat's SPL / SoftSPL (habitat-lab nav.py measures), with
            # the straight-line start->goal distance as the shortest-path
            # term (geodesic lower bound -> conservative ratios)
            d0 = self.start_goal_dist
            ratio = d0 / max(self.path_length, d0, 1e-5)
            soft = max(0.0, 1.0 - d / max(d0, 1e-5))
            self._metrics = {"success": success, "distance_to_goal": d,
                             "spl": success * ratio,
                             "soft_spl": soft * ratio,
                             "steps": self.steps}
        return self._obs()

    def get_metrics(self) -> Dict:
        return self._metrics


class BatchedFakeNavEnv:
    """Vectorized batch of FakeNavEnvs: one numpy call per tick for all
    raycasts (VERDICT r4 item 1a — 16 serial env steps were ~10 ms each
    of small-array numpy on the 1-core bench host).

    Observations are BIT-IDENTICAL to the per-env class: the same float32
    expressions evaluate per batch row (elementwise broadcasting changes
    neither operation order nor rounding), and episode logic (reset, RNG,
    object placement, metrics) stays on the individual ``FakeNavEnv``
    instances.  Only ``_obs``'s per-env work — the 640-ray wall cast, the
    per-object visibility casts, and the depth image assembly — runs
    batched.  tests/test_batched_fake_env.py pins byte equality.
    """

    def __init__(self, envs):
        self.envs = list(envs)
        self.n = len(envs)
        cfg = envs[0].cfg
        sizes = {e.n for e in envs}
        if len(sizes) != 1:
            raise ValueError("batched envs must share one grid size")
        self.cfg = cfg

    # -- helpers -------------------------------------------------------
    def _raycast_all(self, angles):
        """(B, K) angles -> (B, K) wall distances, batched over envs.

        Identical math to FakeNavEnv._raycast row by row; the occupancy
        gather uses one stacked grid."""
        cfg = self.cfg
        e0 = self.envs[0]
        max_d = cfg.max_depth + 1.0
        step = e0.res * 0.9
        n_steps = int(max_d / step)
        ds = (np.arange(1, n_steps + 1) * step).astype(np.float32)
        a = np.asarray(angles, np.float32)                   # (B, K)
        px = np.array([e.pose[0] for e in self.envs],
                      np.float32)[:, None, None]
        py = np.array([e.pose[1] for e in self.envs],
                      np.float32)[:, None, None]
        xs = px + np.cos(a)[:, :, None] * ds[None, None, :]
        ys = py + np.sin(a)[:, :, None] * ds[None, None, :]
        inv = np.float32(1.0 / e0.res)
        nn = e0.n
        ii = np.clip((ys * inv).astype(np.int32), 0, nn - 1)
        jj = np.clip((xs * inv).astype(np.int32), 0, nn - 1)
        occ = np.stack([e.occ.ravel() for e in self.envs])   # (B, n*n)
        flat = ii * nn + jj
        hit = np.take_along_axis(occ, flat.reshape(self.n, -1),
                                 axis=1).reshape(flat.shape)
        any_hit = hit.any(axis=2)
        first = np.where(any_hit, hit.argmax(axis=2), n_steps - 1)
        return ds[first].astype(np.float64)

    def _obs_all(self):
        cfg = self.cfg
        w, h = cfg.env_frame_width, cfg.env_frame_height
        half = np.deg2rad(cfg.hfov) / 2
        heading = np.array([e.pose[2] for e in self.envs])
        angles = heading[:, None] + np.linspace(half, -half, w)[None, :]
        dist = self._raycast_all(angles)                     # (B, W)
        depth_m = dist * np.cos(angles - heading[:, None])
        depth = np.clip((depth_m - cfg.min_depth)
                        / (cfg.max_depth - cfg.min_depth), 0.0, 1.0)
        depth_imgs = np.tile(depth.astype(np.float32)[:, None, :, None],
                             (1, h, 1, 1))                   # (B, H, W, 1)

        # batched single-ray visibility casts for every (env, object)
        from ..constants import hm3d_to_coco

        obj_ang = np.zeros((self.n, 8))
        obj_rel = np.zeros((self.n, 8))
        obj_dist = np.zeros((self.n, 8))
        for b, e in enumerate(self.envs):
            for k, (ox, oy, cat) in enumerate(e.objects):
                gvec = np.array([ox, oy]) - e.pose[:2]
                obj_dist[b, k] = np.hypot(*gvec)
                gang = np.arctan2(gvec[1], gvec[0])
                obj_ang[b, k] = gang
                obj_rel[b, k] = (gang - e.pose[2] + np.pi) % (2 * np.pi) \
                    - np.pi
        ray_d = self._raycast_all(obj_ang)                   # (B, 8)

        out = []
        for b, e in enumerate(self.envs):
            rgb = np.full((h, w, 3), 127, np.uint8)
            depth_img = depth_imgs[b]
            goal_cat = hm3d_to_coco[e.goal_id]
            gtsem = (np.zeros((h, w, 10), np.float32)
                     if e.emit_gt_seg else None)
            for k, (ox, oy, cat) in enumerate(e.objects):
                rel = obj_rel[b, k]
                gdist = obj_dist[b, k]
                if abs(rel) < half and cfg.min_depth < gdist < cfg.max_depth:
                    col = int((half - rel) / (2 * half) * (w - 1))
                    if ray_d[b, k] > gdist - 0.1:
                        cw = max(3, int(0.4 / gdist * w / (2 * half)))
                        c0, c1 = max(0, col - cw), min(w, col + cw)
                        if gtsem is not None:
                            gtsem[h // 3:2 * h // 3, c0:c1, cat] = 1.0
                        color = (40 + 20 * cat, 200 - 15 * cat, 40)
                        rgb[h // 3:2 * h // 3, c0:c1] = color
                        if e.objects_in_depth:
                            od = gdist * np.cos(rel)
                            odn = np.clip(
                                (od - cfg.min_depth)
                                / (cfg.max_depth - cfg.min_depth), 0.0, 1.0)
                            depth_img = depth_img.copy()
                            depth_img[h // 3:2 * h // 3, c0:c1, 0] = \
                                np.minimum(
                                    depth_img[h // 3:2 * h // 3, c0:c1, 0],
                                    np.float32(odn))
            gps = np.array([e.pose[0] - e.start_pose[0],
                            -(e.pose[1] - e.start_pose[1])])
            compass = np.array([e.pose[2] - e.start_pose[2]])
            obs = {"rgb": rgb, "depth": depth_img, "gps": gps,
                   "compass": compass,
                   "objectgoal": np.array([e.goal_id])}
            if gtsem is not None:
                obs["goalseg"] = gtsem[:, :, goal_cat].copy()
                obs["gtsem"] = gtsem
            out.append(obs)
        return out

    # -- lifecycle (observation-free twins of FakeNavEnv methods) ------
    def reset_all(self):
        for e in self.envs:
            e.reset()             # full per-env reset (obs discarded)
        return self._obs_all()

    def reset_one(self, i: int):
        self.envs[i].reset()

    def step_all(self, actions, on_done=None):
        """Advance every env; episodes that end are reported through
        ``on_done(i)`` (which may reset env i in place) BEFORE the batched
        observation pass, mirroring BatchRunner._step_env's sequencing."""
        for i, (e, action) in enumerate(zip(self.envs, actions)):
            if isinstance(action, dict):
                action = action["action"]
            e.steps += 1
            turn = np.deg2rad(e.cfg.turn_angle)
            if action == 0:
                e.called_stop = True
                e.episode_over = True
            elif action == 1:
                nx = e.pose[0] + np.cos(e.pose[2]) * e.FORWARD_M
                ny = e.pose[1] + np.sin(e.pose[2]) * e.FORWARD_M
                if not e._occupied(nx, ny):
                    e.path_length += float(
                        np.hypot(nx - e.pose[0], ny - e.pose[1]))
                    e.pose[0], e.pose[1] = nx, ny
            elif action == 2:
                e.pose[2] += turn
            elif action == 3:
                e.pose[2] -= turn
            if e.steps >= e.max_steps:
                e.episode_over = True
            if e.episode_over:
                d = float(np.hypot(*(e.goal_pos - e.pose[:2])))
                success = float(e.called_stop and d < 1.0)
                d0 = e.start_goal_dist
                ratio = d0 / max(e.path_length, d0, 1e-5)
                soft = max(0.0, 1.0 - d / max(d0, 1e-5))
                e._metrics = {"success": success, "distance_to_goal": d,
                              "spl": success * ratio,
                              "soft_spl": soft * ratio, "steps": e.steps}
                if on_done is not None:
                    on_done(i)
        return self._obs_all()
