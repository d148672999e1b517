"""Local motion planning + collision/untrap state machines (torch port of
``peanut_tpu.agent.planner``).

Behavioural twin of PEANUT's Agent_Helper planning half
(nav/agent/agent_helper.py:51-493): collision-map maintenance from
displacement shortfall, traversibility construction (obstacle dilation minus
collisions plus visited path), FMM short-term-goal extraction with
eroded-map replanning and goal magnification, and the angle-threshold
turn/forward action rule with the Stubborn untrap policy.  The state
machines are host numpy, as in the JAX package; each FMM solve runs on the
planner's device (2-D composed schedule: first-order sweeps B4, order-2
sweeps B2 on a card).

Actions: 0 stop, 1 forward, 2 turn left, 3 turn right.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np

from .. import resolve_device
from ..config import NavConfig
from ..geometry.pose import get_l2_distance, threshold_poses
from ..kernels.morphology import disk, np_binary_dilation, np_binary_erosion
from ..planning import FMMPlanner, UnTrapHelper
from ..utils.drawing import draw_line
from ..utils.profiler import StageTimer


class MotionPlanner:
    def __init__(self, cfg: NavConfig, agent_state=None, device=None,
                 timer: StageTimer = None):
        """device: where the FMM solves run (``resolve_device``: the card
        unless ``"cpu"``); ``timer`` records each solve as ``plan_solve``
        (a fresh one if unset)."""
        self.cfg = cfg
        self.device = resolve_device(device)
        self.timer = timer if timer is not None else StageTimer()
        self.selem = disk(cfg.col_rad)
        self.agent_state = agent_state

        self.map_size = cfg.map_size
        self.full_w = self.full_h = self.map_size
        self.local_w = int(self.full_w / cfg.global_downscaling)
        self.local_h = int(self.full_h / cfg.global_downscaling)

        self.collision_map = None
        self.visited_vis = None
        self.col_width = None
        self.curr_loc = None
        self.last_loc = None
        self.last_action = None
        self.last_start = None
        self.stg = None
        self.found_goal = None
        self.untrap = UnTrapHelper()
        self.episode_no = 0

        # one extra forward after stop to get closer to the goal
        self.forward_after_stop_preset = cfg.move_forward_after_stop
        self.forward_after_stop = self.forward_after_stop_preset

        # stay away from the map edge (agent_helper.py:99)
        self.edge_buffer = 10 if cfg.num_sem_categories <= 16 else 40

        if cfg.visualize:
            from ..utils.visualization import EpisodeVisualizer
            self.vis = EpisodeVisualizer(cfg)
        else:
            self.vis = None
        self.rgb_vis = None

    def reset(self):
        cfg = self.cfg
        map_shape = (self.map_size, self.map_size)
        self.collision_map = np.zeros(map_shape)
        self.visited_vis = np.zeros(map_shape)
        self.col_width = 1
        self.curr_loc = [cfg.map_size_cm / 100.0 / 2.0,
                         cfg.map_size_cm / 100.0 / 2.0, 0.0]
        self.last_action = None
        self.episode_no += 1
        self.timestep = 0
        self.prev_blocked = 0
        self._previous_action = -1
        self.block_threshold = 4
        self.untrap.reset(full=True)
        self.forward_after_stop = self.forward_after_stop_preset
        self.goal_name = None
        self.info: Dict = {}
        if self.vis is not None:
            self.vis.reset()

    # ------------------------------------------------------------------
    def plan_act(self, planner_inputs: Dict) -> Dict:
        """planner_inputs: obstacle, exp_pred, goal, pose_pred (7,),
        found_goal, goal_name -> {'action': int}."""
        self.timestep += 1
        self.goal_name = planner_inputs.get("goal_name")
        action = self._plan(planner_inputs)
        if self.vis is not None and self.rgb_vis is not None:
            st = self.agent_state
            frame = self.vis.render(
                planner_inputs, self.rgb_vis, self.collision_map,
                self.visited_vis, self.stg,
                target_pred=getattr(st, "target_pred", None),
                value=getattr(st, "value", None),
                dd_wt=getattr(st, "dd_wt", None),
                goal_name=self.goal_name or "")
            self.vis.show_or_dump(frame)
        self.last_action = action
        return {"action": action}

    def _plan(self, planner_inputs: Dict) -> int:
        cfg = self.cfg
        self.last_loc = self.curr_loc
        map_pred = np.rint(planner_inputs["obstacle"])
        self.found_goal = planner_inputs["found_goal"]
        goal = planner_inputs["goal"]

        start_x, start_y, start_o, gx1, gx2, gy1, gy2 = \
            planner_inputs["pose_pred"]
        gx1, gx2, gy1, gy2 = int(gx1), int(gx2), int(gy1), int(gy2)
        planning_window = [gx1, gx2, gy1, gy2]

        self.curr_loc = [start_x, start_y, start_o]
        r, c = start_y, start_x
        start_exact = [r * 100.0 / cfg.map_resolution - gx1,
                       c * 100.0 / cfg.map_resolution - gy1]
        start = [int(start_exact[0]), int(start_exact[1])]
        start = threshold_poses(start, map_pred.shape)

        last_start_x, last_start_y = self.last_loc[0], self.last_loc[1]
        last_start = [int(last_start_y * 100.0 / cfg.map_resolution - gx1),
                      int(last_start_x * 100.0 / cfg.map_resolution - gy1)]
        last_start = threshold_poses(last_start, map_pred.shape)
        self.last_start = last_start
        self.visited_vis[gx1:gx2, gy1:gy2] = draw_line(
            last_start, start, self.visited_vis[gx1:gx2, gy1:gy2])

        # Collision check by displacement shortfall (agent_helper.py:283-320)
        if self.last_action == 1:
            x1, y1, t1 = self.last_loc
            x2, y2, _ = self.curr_loc
            buf = 4 if self.prev_blocked < self.block_threshold else 2
            length = 2
            if abs(x1 - x2) < 0.05 and abs(y1 - y2) < 0.05:
                self.col_width += 2
                if self.col_width == 7:
                    length = 4
                    buf = 3
                self.col_width = min(self.col_width, 1)
            else:
                self.col_width = 1
            dist = get_l2_distance(x1, x2, y1, y2)
            if dist < cfg.collision_threshold:  # collision
                self.prev_blocked += 1
                width = self.col_width
                for i in range(length):
                    for j in range(width):
                        wx = x1 + 0.05 * (
                            (i + buf) * np.cos(np.deg2rad(t1))
                            + (j - width // 2) * np.sin(np.deg2rad(t1)))
                        wy = y1 + 0.05 * (
                            (i + buf) * np.sin(np.deg2rad(t1))
                            - (j - width // 2) * np.cos(np.deg2rad(t1)))
                        rr = int(wy * 100 / cfg.map_resolution)
                        cc = int(wx * 100 / cfg.map_resolution)
                        rr, cc = threshold_poses([rr, cc],
                                                 self.collision_map.shape)
                        self.collision_map[rr, cc] = 1
            else:
                if self.prev_blocked >= self.block_threshold:
                    self.untrap.reset()
                self.prev_blocked = 0

        stg, stop = self._get_stg(map_pred, start_exact, np.copy(goal),
                                  planning_window)

        # forward_after_stop bookkeeping (agent_helper.py:326-340)
        if self.forward_after_stop < 0:
            self.forward_after_stop = self.forward_after_stop_preset
        if self.forward_after_stop != self.forward_after_stop_preset:
            if self.forward_after_stop == 0:
                self.forward_after_stop -= 1
                action = 0
            else:
                self.forward_after_stop -= 1
                action = 1
        elif stop and planner_inputs["found_goal"] == 1:
            if self.forward_after_stop == 0:
                action = 0
            else:
                self.forward_after_stop -= 1
                action = 1
        else:
            stg_x, stg_y = stg
            stg_x = np.clip(stg_x, self.edge_buffer,
                            self.local_w - self.edge_buffer - 1)
            stg_y = np.clip(stg_y, self.edge_buffer,
                            self.local_h - self.edge_buffer - 1)
            angle_st_goal = math.degrees(math.atan2(stg_x - start[0],
                                                    stg_y - start[1]))
            angle_agent = start_o % 360.0
            if angle_agent > 180:
                angle_agent -= 360
            relative_angle = (angle_agent - angle_st_goal) % 360.0
            if relative_angle > 180:
                relative_angle -= 360
            if relative_angle > cfg.turn_angle / 2.0:
                action = 3  # right
            elif relative_angle < -cfg.turn_angle / 2.0:
                action = 2  # left
            else:
                action = 1  # forward

        if self.prev_blocked >= self.block_threshold:
            if self._previous_action == 1:
                action = self.untrap.get_action()
            else:
                action = 1
        self._previous_action = action
        return int(action)

    # ------------------------------------------------------------------
    def _traversible(self, grid, planning_window, start):
        """Dilated-obstacle traversibility with collision + visited
        overlays."""
        gx1, gx2, gy1, gy2 = planning_window
        x1, y1 = 0, 0
        x2, y2 = grid.shape
        traversible = np_binary_dilation(grid[x1:x2, y1:y2],
                                         self.selem) != True  # noqa: E712
        traversible = traversible.astype(float)
        traversible[self.collision_map[gx1:gx2, gy1:gy2][x1:x2, y1:y2]
                    == 1] = 0
        traversible[self.visited_vis[gx1:gx2, gy1:gy2][x1:x2, y1:y2]
                    == 1] = 1
        traversible[int(start[0] - x1) - 1:int(start[0] - x1) + 2,
                    int(start[1] - y1) - 1:int(start[1] - y1) + 2] = 1
        return self._add_boundary(traversible)

    @staticmethod
    def _add_boundary(mat, value=1.0):
        h, w = mat.shape
        new_mat = np.zeros((h + 2, w + 2)) + value
        new_mat[1:h + 1, 1:w + 1] = mat
        return new_mat

    def _fmm_planner(self, traversible, goal_dil) -> FMMPlanner:
        """An FMMPlanner on ``traversible`` with the goal cells of
        ``goal_dil`` solved."""
        planner = FMMPlanner(traversible, n_iters=self.cfg.fmm_sweeps,
                             device=self.device)
        self._set_goal(planner, goal_dil)
        return planner

    def _set_goal(self, planner: FMMPlanner, goal_dil) -> None:
        with self.timer.stage("plan_solve"):
            planner.set_multi_goal(goal_dil)

    def _get_stg(self, grid, start, goal, planning_window
                 ) -> Tuple[Tuple[float, float], bool]:
        """Short-term goal via FMM (agent_helper.py:374-493)."""
        cfg = self.cfg
        gx1, gx2, gy1, gy2 = planning_window
        x1, y1 = 0, 0
        x2, y2 = grid.shape

        # close off map borders at the global edge
        if gx2 == self.full_w:
            grid[x2 - 1] = 1
        if gy2 == self.full_h:
            grid[:, y2 - 1] = 1
        if gx1 == 0:
            grid[x1] = 1
        if gy1 == 0:
            grid[y1] = 1

        traversible = self._traversible(grid, planning_window, start)
        goal_b = self._add_boundary(goal, value=0.0)

        is_toilet = self.goal_name == "toilet"
        radius = 8 if self.found_goal == 1 else 2
        if is_toilet:
            radius = 6 if self.found_goal == 1 else 2
        goal_dil = np_binary_dilation(goal_b,
                                      disk(radius)) != True  # noqa: E712
        goal_dil = 1 - goal_dil.astype(float)
        planner = self._fmm_planner(traversible, goal_dil)

        state = [start[0] - x1 + 1, start[1] - y1 + 1]
        stg_x, stg_y, distance, stop, replan = \
            planner.get_short_term_goal(state)

        if replan:
            # planner failed: cycle preset corner (explore mode) and retry
            # with an eroded obstacle map (agent_helper.py:444-469)
            if cfg.only_explore and self.agent_state is not None:
                self.agent_state.next_preset_goal()
            grid = np_binary_erosion(grid.astype(bool)).astype(int)
            traversible = self._traversible(grid, planning_window, start)
            planner = self._fmm_planner(traversible, goal_dil)
            state = [start[0] - x1 + 1, start[1] - y1 + 1]
            stg_x, stg_y, distance, stop, replan = \
                planner.get_short_term_goal(state)

        # unreachable found-goal: magnify the goal region
        # (agent_helper.py:473-489)
        if self.found_goal == 1 and distance > cfg.magnify_goal_when_hard:
            step = 0
            while distance > 100:
                step += 1
                if step > 8 or (is_toilet and step > 2):
                    break
                goal_dil = np_binary_dilation(
                    goal_dil, disk(2)) != True  # noqa: E712
                goal_dil = 1 - goal_dil.astype(float)
                self._set_goal(planner, goal_dil)
                stg_x, stg_y, distance, stop, replan = \
                    planner.get_short_term_goal(state)

        stg_x, stg_y = stg_x + x1 - 1, stg_y + y1 - 1
        self.stg = (stg_x, stg_y)
        return (stg_x, stg_y), stop
