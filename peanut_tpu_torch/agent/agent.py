"""Agent facade: observations in, discrete actions out (torch port of
``peanut_tpu.agent.agent``).

Behavioural twin of PEANUT's PEANUT_Agent (nav/agent/peanut_agent.py:15-95)
and the observation-preprocessing half of Agent_Helper
(agent_helper.py:166-225): GPS/compass -> relative pose deltas; RGB-D +
segmentation -> a (4+nsc, fh, fw) state array (downscaled by strided
sampling, equivalent to PEANUT's PIL NEAREST resize + [ds//2::ds] slicing);
then mapping, prediction, goal selection and local planning.

The facade is environment-agnostic: anything producing dicts with keys
'rgb' (H, W, 3), 'depth' (H, W, 1), 'gps', 'compass', 'objectgoal' can
drive it.  ``timer`` (a StageTimer shared with the state and the planner)
records each step's stages: ``seg``, ``mapping`` (the local window's trip to
the device and back included), ``prediction``, ``goal_solve``, ``plan``
(the whole local planner) and ``plan_solve`` (its geodesic solves).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .. import resolve_device
from ..config import NavConfig
from ..constants import hm3d_names, hm3d_to_coco
from ..geometry.pose import get_rel_pose_change
from ..perception import build_segmenter, preprocess_depth
from ..perception.segmentation import GroundTruthSegmenter
from ..utils.profiler import StageTimer
from .planner import MotionPlanner
from .state import NavAgentState


class PeanutAgent:
    def __init__(self, cfg: NavConfig, segmenter=None, prediction_model=None,
                 device=None):
        """device: where mapping, detection, prediction and the geodesic
        solves run (``resolve_device``: the card unless ``"cpu"``)."""
        self.cfg = cfg
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # f32 convolutions (PSPNet, Mask R-CNN) run in TF32 under cuDNN
            # by default; the JAX reference is held at full f32, as the
            # batched runtime holds it
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.timer = StageTimer()
        self.agent_state = NavAgentState(cfg,
                                         prediction_model=prediction_model,
                                         device=self.device, timer=self.timer)
        self.planner = MotionPlanner(cfg, agent_state=self.agent_state,
                                     device=self.device, timer=self.timer)
        self.agent_state.helper = self.planner
        self.segmenter = (segmenter if segmenter is not None
                          else build_segmenter(cfg, device=self.device))
        self.last_sim_location = None
        self.first_obs = True
        self.timestep = 0

    def reset(self):
        self.planner.reset()
        self.agent_state.reset()
        self.last_sim_location = None
        self.first_obs = True
        self.timestep = 0

    # ------------------------------------------------------------------
    def act(self, observations: Dict) -> Dict:
        self.timestep += 1
        if self.timestep > self.cfg.timestep_limit:
            return {"action": 0}

        goal = int(np.asarray(observations["objectgoal"]).reshape(-1)[0])
        info = {"sensor_pose": list(self.get_pose_change(observations))}
        info["goal_name"] = hm3d_names[goal]
        goal = hm3d_to_coco[goal]

        if hasattr(self.segmenter, "set_observation"):
            self.segmenter.set_observation(observations)
        elif self.cfg.use_gt_seg and isinstance(self.segmenter,
                                                GroundTruthSegmenter):
            self.segmenter.goalseg = observations.get("goalseg")

        obs = self._preprocess_obs(observations["rgb"], observations["depth"],
                                   goal_cat=goal)
        info["goal_cat_id"] = goal
        if self.cfg.visualize:
            self.planner.rgb_vis = np.asarray(
                observations["rgb"], np.uint8)[:, :, ::-1]

        if self.first_obs:
            self.agent_state.init_with_obs(obs, info)
            self.first_obs = False

        planner_inputs = self.agent_state.update_state(obs, info)
        with self.timer.stage("plan"):
            return self.planner.plan_act(planner_inputs)

    # ------------------------------------------------------------------
    def _preprocess_obs(self, rgb, depth,
                        goal_cat: Optional[int]) -> np.ndarray:
        cfg = self.cfg
        with self.timer.stage("seg"):
            sem = self.segmenter(np.asarray(rgb, np.uint8), depth=depth,
                                 goal_cat=goal_cat)
        depth_cm = preprocess_depth(np.asarray(depth), cfg.min_depth,
                                    cfg.max_depth)

        ds = cfg.env_frame_width // cfg.frame_width
        if ds != 1:
            rgb = np.asarray(rgb)[ds // 2::ds, ds // 2::ds]
            depth_cm = depth_cm[ds // 2::ds, ds // 2::ds]
            sem = sem[ds // 2::ds, ds // 2::ds]

        state = np.concatenate(
            [np.asarray(rgb, np.float32),
             depth_cm[:, :, None].astype(np.float32),
             sem.astype(np.float32)], axis=2).transpose(2, 0, 1)
        return state

    # ------------------------------------------------------------------
    def get_sim_location(self, obs):
        """x, y, heading from GPS/compass (peanut_agent.py:77-84)."""
        x = obs["gps"][0]
        y = -obs["gps"][1]
        o = np.asarray(obs["compass"]).reshape(-1)[0]
        if o > np.pi:
            o -= 2 * np.pi
        return x, y, o

    def get_pose_change(self, obs):
        curr = self.get_sim_location(obs)
        if self.last_sim_location is not None:
            dx, dy, do = get_rel_pose_change(curr, self.last_sim_location)
        else:
            dx, dy, do = 0.0, 0.0, 0.0
        self.last_sim_location = curr
        return float(dx), float(dy), float(do)
