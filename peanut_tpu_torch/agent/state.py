"""Agent map/prediction/goal state (torch port of
``peanut_tpu.agent.state``).

Behavioural twin of PEANUT's Agent_State (nav/agent/agent_state.py:26-455):
owns the full allocentric map and the sliding local window, runs the
mapping step and the target-prediction network, and selects long-term
goals by weighting predicted target probability with geodesic reachability.

Device/host split, as in the JAX package: the maps are host numpy and the
episodic control flow (window shuttling, preset-goal cycling, found-goal
logic) runs on the host.  Each step the local window goes to the device,
``SemanticMapper.update_core`` updates it as a batch of one and the window
comes back; the prediction network and the goal-weighting geodesic solve
run on the device and return their maps to the host.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .. import resolve_device, upload
from ..config import NavConfig
from ..geometry.pose import integrate_pose_np
from ..kernels import eikonal_distance, masked_fill_unreachable
from ..kernels.morphology import disk, np_binary_dilation, np_binary_erosion
from ..mapping import SemanticMapper
from ..prediction import PredictionModel
from ..utils.profiler import StageTimer


class NavAgentState:
    def __init__(self, cfg: NavConfig, prediction_model=None, device=None,
                 timer: Optional[StageTimer] = None):
        """device: where mapping, prediction and the goal solve run
        (``resolve_device``: the card unless ``"cpu"``).  With
        ``only_explore=0`` and no ``prediction_model``, the PSPNet at
        ``cfg.pred_model_wts`` is loaded (FileNotFoundError when missing).
        ``timer`` records the stages of a step (a fresh one if unset)."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.timer = timer if timer is not None else StageTimer()
        np.random.seed(1 if cfg.seed is None else cfg.seed)

        self.nc = cfg.num_map_channels
        self.full_w = self.full_h = cfg.map_size
        self.local_w = int(self.full_w / cfg.global_downscaling)
        self.local_h = int(self.full_h / cfg.global_downscaling)

        # Map channels (agent_state.py:47-52): 0 obstacle, 1 explored,
        # 2 current location, 3 visited, 4+ semantic categories.
        self.full_map = np.zeros((self.nc, self.full_w, self.full_h),
                                 np.float32)
        self.local_map = np.zeros((self.nc, self.local_w, self.local_h),
                                  np.float32)
        self.full_pose = np.zeros(3, np.float32)
        self.local_pose = np.zeros(3, np.float32)
        self.origins = np.zeros(3)
        self.lmb = np.zeros(4, int)
        self.planner_pose_inputs = np.zeros(7)

        self.mapper = SemanticMapper(cfg)

        # Stubborn preset corner goals for explore-only collection
        self.global_goal_presets = [(0.1, 0.1), (0.9, 0.1), (0.9, 0.9),
                                    (0.1, 0.9)]
        self.global_goal_preset_id = 0

        if cfg.only_explore == 0 and prediction_model is None:
            prediction_model = PredictionModel(cfg, device=self.device)
        self.prediction_model = (prediction_model if cfg.only_explore == 0
                                 else None)

        self.selem = disk(cfg.col_rad)
        self.selem_idx = np.where(disk(cfg.col_rad + 1) > 0)
        self.target_pred = None
        self.value = None
        self.dd_wt = None
        self.last_global_goal = None
        self.helper = None  # set by the agent facade (collision/visited maps)

    # ------------------------------------------------------------------
    def reset(self):
        self.l_step = 0
        self.step = 0
        self.goal_cat = -1
        self.found_goal = False
        self.init_map_and_pose()
        self.target_pred = None
        self.value = None
        self.dd_wt = None
        self.last_global_goal = None

    def init_map_and_pose(self):
        cfg = self.cfg
        self.full_map[:] = 0.0
        self.full_pose[:] = 0.0
        self.full_pose[:2] = cfg.map_size_cm / 100.0 / 2.0

        locs = self.full_pose.copy()
        self.planner_pose_inputs[:3] = locs
        r, c = locs[1], locs[0]
        loc_r = int(r * 100.0 / cfg.map_resolution)
        loc_c = int(c * 100.0 / cfg.map_resolution)
        self.full_map[2:4, loc_r - 1:loc_r + 2, loc_c - 1:loc_c + 2] = 1.0

        self.lmb = self.get_local_map_boundaries(
            (loc_r, loc_c), (self.local_w, self.local_h),
            (self.full_w, self.full_h))
        self.planner_pose_inputs[3:] = self.lmb
        self.origins = np.array([self.lmb[2] * cfg.map_resolution / 100.0,
                                 self.lmb[0] * cfg.map_resolution / 100.0,
                                 0.0])
        self.local_map = self.full_map[:, self.lmb[0]:self.lmb[1],
                                       self.lmb[2]:self.lmb[3]].copy()
        self.local_pose = self.full_pose - self.origins.astype(np.float32)

    def get_local_map_boundaries(self, agent_loc, local_sizes, full_sizes):
        """Window placement incl. the grid_resolution snap
        (agent_state.py:154-177)."""
        loc_r, loc_c = agent_loc
        local_w, local_h = local_sizes
        full_w, full_h = full_sizes
        cfg = self.cfg
        if cfg.global_downscaling > 1:
            gx1, gy1 = loc_r - local_w // 2, loc_c - local_h // 2
            gx1 -= gx1 % cfg.grid_resolution
            gy1 -= gy1 % cfg.grid_resolution
            gx2, gy2 = gx1 + local_w, gy1 + local_h
            if gx1 < 0:
                gx1, gx2 = 0, local_w
            if gx2 > full_w:
                gx1, gx2 = full_w - local_w, full_w
            if gy1 < 0:
                gy1, gy2 = 0, local_h
            if gy2 > full_h:
                gy1, gy2 = full_h - local_h, full_h
        else:
            gx1, gx2, gy1, gy2 = 0, full_w, 0, full_h
        return [gx1, gx2, gy1, gy2]

    # ------------------------------------------------------------------
    def _map_step(self, obs: np.ndarray) -> None:
        """Integrate the pose on the host, update the local window on the
        device as a batch of one, and bring it back (a writable host
        copy)."""
        new_pose = integrate_pose_np(self.local_pose[None],
                                     self.poses[None])
        with self.timer.stage("mapping"):
            _, local_map, _ = self.mapper.update_core(
                upload(obs[None], self.device),
                upload(new_pose, self.device),
                upload(self.local_map[None], self.device))
            self.local_map = local_map[0].cpu().numpy()
        self.local_pose = new_pose[0]

    def init_with_obs(self, obs, info: Dict):
        self.l_step = 0
        self.step = 0
        self.poses = np.asarray(info["sensor_pose"], np.float32)
        self._map_step(obs)

        locs = self.local_pose
        r, c = locs[1], locs[0]
        loc_r = int(r * 100.0 / self.cfg.map_resolution)
        loc_c = int(c * 100.0 / self.cfg.map_resolution)
        self.local_map[2:4, loc_r - 1:loc_r + 2, loc_c - 1:loc_c + 2] = 1.0

        rgoal = [0.1, 0.1]
        self.global_goals = [[int(rgoal[0] * self.local_w),
                              int(rgoal[1] * self.local_h)]]
        self.global_goals = [[min(x, self.local_w - 1),
                              min(y, self.local_h - 1)]
                             for x, y in self.global_goals]
        self.goal_map = np.zeros((self.local_w, self.local_h))
        self.goal_map[self.global_goals[0][0], self.global_goals[0][1]] = 1

        self.planner_inputs = {
            "obstacle": self.local_map[0].copy(),
            "exp_pred": self.local_map[1].copy(),
            "pose_pred": self.planner_pose_inputs,
            "goal": self.goal_map,
            "new_goal": 1,
            "found_goal": 0,
        }
        if self.cfg.visualize:
            self.planner_inputs["sem_map_pred"] = self._sem_map_vis()

    def _sem_map_vis(self):
        """The local map's semantic argmax for the dashboard (the last
        channel nearly 0, so empty cells take it)."""
        vlm = self.local_map[4:].copy()
        vlm[-1] = 1e-5
        return vlm.argmax(0)

    # ------------------------------------------------------------------
    def update_state(self, obs, info: Dict) -> Dict:
        cfg = self.cfg
        self.goal_cat = info["goal_cat_id"]
        self.poses = np.asarray(info["sensor_pose"], np.float32)

        self.update_local_map(obs)

        if self.l_step == cfg.num_local_steps - 1:
            self.l_step = 0
            self.update_full_map()
            if self.step < cfg.switch_step:
                preset = self.global_goal_presets[self.global_goal_preset_id]
                g = [[int(preset[0] * self.local_w),
                      int(preset[1] * self.local_h)]]
                self.global_goals = [[min(x, self.local_w - 1),
                                      min(y, self.local_h - 1)]
                                     for x, y in g]

        if ((self.step % cfg.update_goal_freq == cfg.update_goal_freq - 1
             or self.step == 0
             or self.dist_to_goal < cfg.goal_reached_dist)
                and self.step >= cfg.switch_step):
            self.update_prediction()
            self.update_global_goal()

        self.update_goal_map(info)

        p_input = {
            "obstacle": self.local_map[0].copy(),
            "exp_pred": self.local_map[1].copy(),
            "pose_pred": self.planner_pose_inputs,
            "goal": self.goal_map,
            "found_goal": self.found_goal,
            "goal_name": info["goal_name"],
        }
        if cfg.visualize:
            p_input["sem_map_pred"] = self._sem_map_vis()

        self.inc_step()
        return p_input

    def update_local_map(self, obs):
        cfg = self.cfg
        self._map_step(obs)

        locs = self.local_pose
        self.planner_pose_inputs[:3] = locs + self.origins
        self.local_map[2, :, :] = 0.0
        r, c = locs[1], locs[0]
        loc_r = int(r * 100.0 / cfg.map_resolution)
        loc_c = int(c * 100.0 / cfg.map_resolution)

        traj_rad = 2
        self.local_map[2:4, loc_r - traj_rad:loc_r + traj_rad + 1,
                       loc_c - traj_rad:loc_c + traj_rad + 1] = 1.0

        # explored under the agent footprint (disk col_rad+1)
        to_fill = (self.selem_idx[0] - (cfg.col_rad + 1) + loc_r,
                   self.selem_idx[1] - (cfg.col_rad + 1) + loc_c)
        self._fill_explored(to_fill)

        self.dist_to_goal = np.sqrt(
            (loc_r - self.global_goals[0][0]) ** 2 +
            (loc_c - self.global_goals[0][1]) ** 2) * cfg.map_resolution
        if self.dist_to_goal < cfg.goal_reached_dist:
            to_fill = (self.selem_idx[0] - (cfg.col_rad + 1)
                       + self.global_goals[0][0],
                       self.selem_idx[1] - (cfg.col_rad + 1)
                       + self.global_goals[0][1])
            self._fill_explored(to_fill)

        self.loc_r = loc_r
        self.loc_c = loc_c

    def _fill_explored(self, to_fill):
        rr = np.clip(to_fill[0], 0, self.local_w - 1)
        cc = np.clip(to_fill[1], 0, self.local_h - 1)
        self.local_map[1][rr, cc] = 1.0

    def update_full_map(self):
        cfg = self.cfg
        self.full_map[:, self.lmb[0]:self.lmb[1], self.lmb[2]:self.lmb[3]] = \
            self.local_map
        self.full_pose = self.local_pose + self.origins.astype(np.float32)
        locs = self.full_pose
        r, c = locs[1], locs[0]
        loc_r = int(r * 100.0 / cfg.map_resolution)
        loc_c = int(c * 100.0 / cfg.map_resolution)
        self.lmb = self.get_local_map_boundaries(
            (loc_r, loc_c), (self.local_w, self.local_h),
            (self.full_w, self.full_h))
        self.planner_pose_inputs[3:] = self.lmb
        self.origins = np.array([self.lmb[2] * cfg.map_resolution / 100.0,
                                 self.lmb[0] * cfg.map_resolution / 100.0,
                                 0.0])
        self.local_map = self.full_map[:, self.lmb[0]:self.lmb[1],
                                       self.lmb[2]:self.lmb[3]].copy()
        self.local_pose = self.full_pose - self.origins.astype(np.float32)
        locs = self.local_pose
        self.loc_r = int(locs[1] * 100.0 / cfg.map_resolution)
        self.loc_c = int(locs[0] * 100.0 / cfg.map_resolution)

    def next_preset_goal(self):
        self.global_goal_preset_id = (self.global_goal_preset_id + 1) % \
            len(self.global_goal_presets)

    # ------------------------------------------------------------------
    def update_prediction(self):
        """Run the target-prediction CNN on the current full map
        (agent_state.py:345-373)."""
        cfg = self.cfg
        self.full_map[:, self.lmb[0]:self.lmb[1], self.lmb[2]:self.lmb[3]] = \
            self.local_map

        with self.timer.stage("prediction"):
            if self.full_w == cfg.prediction_window == self.full_h:
                object_preds = self.prediction_model.get_prediction(
                    self.full_map)
            else:
                x1 = self.full_w // 2 - cfg.prediction_window // 2
                x2 = x1 + cfg.prediction_window
                y1 = self.full_h // 2 - cfg.prediction_window // 2
                y2 = y1 + cfg.prediction_window
                preds = self.prediction_model.get_prediction(
                    self.full_map[:, x1:x2, y1:y2])
                object_preds = np.zeros((preds.shape[0], self.full_w,
                                         self.full_h))
                object_preds[:, x1:x2, y1:y2] = preds

        target_pred = object_preds[self.goal_cat,
                                   self.lmb[0]:self.lmb[1],
                                   self.lmb[2]:self.lmb[3]]
        target_pred = target_pred * (self.local_map[1] < 0.5)  # unexplored
        self.target_pred = target_pred

    def _goal_distance(self, trav, sources, order, blk, inner):
        """masked_fill_unreachable(eikonal_distance(...)) on the device, as
        a host array."""
        with self.timer.stage("goal_solve"):
            return masked_fill_unreachable(eikonal_distance(
                trav, sources, n_iters=self.cfg.fmm_sweeps, order=order,
                block=blk, inner=inner, device=self.device)).cpu().numpy()

    def update_global_goal(self):
        """Goal = argmax of prediction x exp(-geodesic distance / lambda)
        (agent_state.py:376-415)."""
        cfg = self.cfg
        trav = np_binary_dilation(np.rint(self.full_map[0]),
                                  self.selem) != True  # noqa: E712
        trav = trav.astype(float)
        if self.helper is not None:
            trav[self.helper.collision_map == 1] = 0
            trav[self.helper.visited_vis == 1] = 1

        sources = np.zeros_like(trav)
        sources[np.clip(self.loc_r + self.lmb[0], 0, self.full_w - 1),
                np.clip(self.loc_c + self.lmb[2], 0, self.full_h - 1)] = 1

        ds = int(getattr(cfg, "dd_downscale", 1))
        order = int(getattr(cfg, "dd_order", 2))
        blk = int(getattr(cfg, "dd_block", 16))
        inner = int(getattr(cfg, "dd_inner", 40))
        if cfg.dist_weight_temperature <= 0:
            # frontier mode (T=0) thresholds dd at a 60-cell cliff and
            # T=-1 ignores dd: the smooth-weighting argument behind the
            # half-resolution / low-order approximations does not apply,
            # so those modes always solve exactly
            ds, order, blk, inner = 1, 2, 16, 40
        if ds > 1 and trav.shape[0] % ds == 0 and trav.shape[1] % ds == 0:
            # serving-profile approximation (PARITY.md): solve the
            # exp(-dd/temperature) weighting field on an OR-pooled coarse
            # grid (walls are col_rad-dilated first, so they survive the
            # pooling) and upsample nearest
            h2, w2 = trav.shape[0] // ds, trav.shape[1] // ds
            trav_s = trav[:h2 * ds, :w2 * ds].reshape(
                h2, ds, w2, ds).max(axis=(1, 3))
            src_s = sources[:h2 * ds, :w2 * ds].reshape(
                h2, ds, w2, ds).max(axis=(1, 3))
            dd_s = self._goal_distance(trav_s, src_s, order, blk, inner) * ds
            dd = np.repeat(np.repeat(dd_s, ds, axis=0), ds, axis=1)
        else:
            dd = self._goal_distance(trav, sources, order, blk, inner)
        dd[dd == np.max(dd)] = np.inf

        temperature = cfg.dist_weight_temperature / cfg.map_resolution
        dd_wt = np.exp(-dd / temperature)[self.lmb[0]:self.lmb[1],
                                          self.lmb[2]:self.lmb[3]]
        if np.sum(dd_wt) < 10 and self.dd_wt is not None:
            dd_wt = self.dd_wt  # stuck inside an obstacle: reuse last weights

        if cfg.dist_weight_temperature == -1:
            value = self.target_pred
        elif cfg.dist_weight_temperature == 0:  # frontier-based exploration
            dd[dd < 60] = np.inf
            value = np.exp(-dd / 100.0)[self.lmb[0]:self.lmb[1],
                                        self.lmb[2]:self.lmb[3]]
        else:
            value = self.target_pred * dd_wt

        self.dd_wt = dd_wt
        self.value = value

        new_global_goal = [list(np.unravel_index(value.argmax(),
                                                 value.shape))]
        if new_global_goal != self.last_global_goal:
            self.last_global_goal = self.global_goals
            self.global_goals = new_global_goal

    def update_goal_map(self, info: Dict):
        """Found-goal override with erosion denoising
        (agent_state.py:418-446)."""
        cfg = self.cfg
        self.found_goal = 0
        self.goal_map = np.zeros((self.local_w, self.local_h))
        self.goal_map[self.global_goals[0][0], self.global_goals[0][1]] = 1

        if cfg.only_explore == 0:
            cn = self.goal_cat + 4
            if self.local_map[cn].sum() != 0.0:
                cat_map = self.local_map[cn].copy()
                cat_map[cat_map > 0] = 1.0
                temp_goal = cat_map
                if "tv" not in info["goal_name"]:  # tv too thin to erode
                    for _ in range(cfg.goal_erode):
                        temp_goal = np_binary_erosion(
                            temp_goal.astype(bool)).astype(float)
                    temp_goal = np_binary_dilation(
                        temp_goal.astype(bool)).astype(float)
                other = self.local_map[4:10].sum(axis=0) - self.local_map[cn]
                temp_goal = temp_goal * (other == 0)
                if temp_goal.sum() != 0.0:
                    self.goal_map = temp_goal
                    self.found_goal = 1

    def inc_step(self):
        self.l_step += 1
        self.step += 1
        self.l_step = self.step % self.cfg.num_local_steps
