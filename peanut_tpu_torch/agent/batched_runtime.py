"""Parallel-episode runtime: N agents, one device tick per step (torch port
of ``peanut_tpu.agent.batched_runtime``).

Architecture, as in the JAX package:

  * the per-tick pipeline — observation assembly, point scatters, mapping,
    window shuttling, traversibility and the batched geodesic planning
    solve — runs on the runtime's device from one packed upload of the
    per-tick scalars and ends in one packed download (the 11x11 planning
    windows); on CUDA the ops are enqueued asynchronously, so the host
    only waits in ``act_batch_collect``;
  * observations upload as uint8 semantics + f32 depth only (rgb is unused
    by the mapping pipeline and zero-filled on the device);
  * pose integration runs on the host (the numpy f32 twin), so the host
    state machines and the device stamping agree on agent cells; visited
    lines and collision points are host-computed and passed in;
  * all maps are device-resident ``DeviceState`` tensors; the tick
    replaces the state (several steps update fresh tensors in place);
  * rare control paths (replan-with-erosion, goal magnification) run
    focused solves with identical semantics.

This slice runs the explore-only configuration with ground-truth
semantics or with Mask R-CNN (``use_gt_seg=0``): then ``stage_obs`` uploads
each frame's uint8 RGB as soon as its env has stepped and launches a detect
chunk once ``seg_batch_chunk`` frames are staged, and the tick takes the
segmenter's device semantic stack without a host round trip.  The
prediction hook (``only_explore=0``: ``pred_goal_update``, ``pred_program``,
``pred_async``; ROADMAP A8b) and mesh sharding (A14) are not ported; the
models it would run are (``prediction.PredictionModel``).
"""

from __future__ import annotations

import json
import math
import threading
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from .. import resolve_device, upload
from ..config import NavConfig
from ..constants import hm3d_names, hm3d_to_coco
from ..geometry.pose import (get_rel_pose_change, get_l2_distance,
                             integrate_pose_np, threshold_poses)
from ..kernels.morphology import disk, np_binary_dilation, np_binary_erosion
from ..mapping import SemanticMapper
from ..perception import preprocess_depth, build_segmenter
from ..planning import FMMPlanner, UnTrapHelper
from ..planning.fmm_planner import step_mask, step_dist
from ..utils.profiler import StageTimer
from . import batched_ops as B

CROSS = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]], np.uint8)
N_LINE_PTS = 104   # 26 samples x 2x2 squares
N_COL_PTS = 8

# host_pack layout (one f32 upload for all per-tick scalars):
#   [0:3] pose (pre-rebase, mapper frame) | [3:7] lmb_old
#   [7:11] lmb_new | [11] goal_cat | [12] no_erode | [13] is_toilet
#   [14] prediction trigger (0 until A8b) | [15:17] preset_cells
#   [17] preset_override
#   [18] erode_first | [19:21] planner start cells | [21:23] agent cell in
#   the new window | [23:231] line_pts (104 x 2) | [231:335] line_valid
#   [335:351] col_pts (8 x 2) | [351:359] col_valid
PACK = 359


class DeviceState(NamedTuple):
    """All device-resident per-episode tensors."""
    local_maps: torch.Tensor    # (B, nc, Hl, Wl) float32
    full_maps: torch.Tensor     # (B, nc, Hf, Wf) float32
    collision: torch.Tensor     # (B, Hf, Wf) float32
    visited: torch.Tensor       # (B, Hf, Wf) float32
    target_pred: torch.Tensor   # (B, Hl, Wl) float32
    dd_wt: torch.Tensor         # (B, Hl, Wl) float32
    dd_valid: torch.Tensor      # (B,) bool
    cur_goal: torch.Tensor      # (B, 2) int32
    last_goal: torch.Tensor     # (B, 2) int32
    last_goal_valid: torch.Tensor  # (B,) bool


def device_state_from_numpy(arrays: Dict[str, np.ndarray],
                            device) -> DeviceState:
    """DeviceState from the ``dev_<field>`` arrays of an episode checkpoint
    (written by either package's ``save_episode_state``)."""
    return DeviceState(**{k: torch.as_tensor(np.asarray(arrays[f"dev_{k}"]),
                                             device=device)
                          for k in DeviceState._fields})


class TickHandle(NamedTuple):
    """In-flight tick: the device output plus the host-side values the
    collect phase needs (act_batch_dispatch -> act_batch_collect)."""
    packed: torch.Tensor       # (B, 125) device tensor, maybe computing
    starts: np.ndarray
    starts_exact: np.ndarray
    lmb_new: np.ndarray
    goal_cats: np.ndarray
    no_erode: np.ndarray
    is_toilet: np.ndarray
    stop_now: np.ndarray


@dataclass
class EnvSlot:
    """Per-episode host scalars (the sequential state machines)."""
    step: int = 0
    l_step: int = 0
    timestep: int = 0
    goal_name: str = ""
    found_goal: int = 0
    dist_to_goal: float = 1e9
    preset_id: int = 0
    origins: np.ndarray = field(default_factory=lambda: np.zeros(3))
    lmb: np.ndarray = field(default_factory=lambda: np.zeros(4, np.int32))
    pose_inputs: np.ndarray = field(default_factory=lambda: np.zeros(7))
    last_sim_location: Optional[tuple] = None
    # planner state
    curr_loc: List[float] = field(default_factory=lambda: [0.0, 0.0, 0.0])
    last_loc: List[float] = field(default_factory=lambda: [0.0, 0.0, 0.0])
    last_action: Optional[int] = None
    previous_action: int = -1
    col_width: int = 1
    prev_blocked: int = 0
    forward_after_stop: int = 1
    untrap: UnTrapHelper = field(default_factory=UnTrapHelper)


class BatchedNavRuntime:
    BLOCK_THRESHOLD = 4

    def __init__(self, cfg: NavConfig, num_envs: int, segmenter=None,
                 device=None):
        """device: where the maps live and the tick runs (``resolve_device``:
        the card unless ``"cpu"``)."""
        if cfg.only_explore == 0:
            raise NotImplementedError(
                "only_explore=0 needs the batched runtime's prediction hook "
                "(pred_goal_update, pred_program), not ported yet "
                "(ROADMAP A8b)")
        self.cfg = cfg
        self.n = num_envs
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # f32 convolutions run in TF32 under cuDNN by default; the
            # morphology convs are 0/1-exact either way, but state it
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.mapper = SemanticMapper(cfg)
        self.segmenter = segmenter if segmenter is not None \
            else build_segmenter(cfg, device=self.device)

        self.nc = cfg.num_map_channels
        self.Hf = self.Wf = cfg.map_size
        self.Hl = self.Wl = int(self.Hf / cfg.global_downscaling)
        self.selem_idx = np.where(disk(cfg.col_rad + 1) > 0)
        self.presets = [(0.1, 0.1), (0.9, 0.1), (0.9, 0.9), (0.1, 0.9)]
        self.edge_buffer = 10 if cfg.num_sem_categories <= 16 else 40

        self.timer = StageTimer()
        self.slots = [EnvSlot() for _ in range(num_envs)]
        # host shadows of device goal state (for stamping inputs)
        self.goal_shadow = np.zeros((num_envs, 2), np.int32)
        self.local_poses = np.zeros((num_envs, 3), np.float32)
        self.PACK = PACK

        self.state = self._alloc_state()
        self._clear_pending()
        # reset_env runs in the env-step thread pool; serialize its writes
        self._reset_lock = threading.Lock()
        # chunked-detect pipeline: stage_obs launches a detect chunk as soon
        # as seg_chunk envs have stepped (0: one detect call in _pack_obs)
        self._det_lock = threading.Lock()
        self._det_buf: list = []
        self._seg_chunk = int(getattr(self.segmenter, "chunk", 0) or 0) \
            if hasattr(self.segmenter, "batch_device") else 0

    # ------------------------------------------------------------------
    def _alloc_state(self) -> DeviceState:
        n, nc, dev = self.n, self.nc, self.device
        f32 = dict(dtype=torch.float32, device=dev)
        return DeviceState(
            local_maps=torch.zeros((n, nc, self.Hl, self.Wl), **f32),
            full_maps=torch.zeros((n, nc, self.Hf, self.Wf), **f32),
            collision=torch.zeros((n, self.Hf, self.Wf), **f32),
            visited=torch.zeros((n, self.Hf, self.Wf), **f32),
            target_pred=torch.zeros((n, self.Hl, self.Wl), **f32),
            dd_wt=torch.zeros((n, self.Hl, self.Wl), **f32),
            dd_valid=torch.zeros((n,), dtype=torch.bool, device=dev),
            cur_goal=torch.zeros((n, 2), dtype=torch.int32, device=dev),
            last_goal=torch.full((n, 2), -1, dtype=torch.int32, device=dev),
            last_goal_valid=torch.zeros((n,), dtype=torch.bool, device=dev),
        )

    def _clear_pending(self):
        n = self.n
        self._line_pts = np.zeros((n, N_LINE_PTS, 2), np.int32)
        self._line_valid = np.zeros((n, N_LINE_PTS), bool)
        self._col_pts = np.zeros((n, N_COL_PTS, 2), np.int32)
        self._col_valid = np.zeros((n, N_COL_PTS), bool)

    # ------------------------------------------------------------------
    # device programs
    # ------------------------------------------------------------------
    @staticmethod
    def _scatter_max(grid: torch.Tensor, pts: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
        """grid[b, clip(r), clip(c)] = max(grid, valid), in place."""
        b, h, w = grid.shape
        rows = torch.clamp(pts[..., 0], 0, h - 1)
        cols = torch.clamp(pts[..., 1], 0, w - 1)
        flat = grid.view(b, h * w)
        flat.scatter_reduce_(1, rows * w + cols, valid.to(grid.dtype),
                             reduce="amax")
        return grid

    def _goal_maps(self, local_maps, cur_goal, goal_cats, no_erode, found):
        """Found-goal region (update_goal_map) or the single goal cell."""
        cfg = self.cfg
        n = local_maps.shape[0]
        bidx = torch.arange(n, device=self.device)
        cat_maps = local_maps[bidx, goal_cats + 4]
        cat_bin = (cat_maps > 0).float()
        eroded = cat_bin
        for _ in range(cfg.goal_erode):
            eroded = B.batch_erode(eroded, CROSS).float()
        eroded = B.batch_dilate(eroded, CROSS).float()
        temp = torch.where(no_erode[:, None, None], cat_bin, eroded)
        others = local_maps[:, 4:10].sum(dim=1) - cat_maps
        temp = temp * (others == 0)
        single = torch.zeros_like(temp)
        single[bidx, cur_goal[:, 0].long(), cur_goal[:, 1].long()] = 1.0
        return torch.where(found[:, None, None], temp, single)

    def _plan(self, local_maps, collision, visited, lmb, loc_r, loc_c,
              erode_first, goal_maps, found, is_toilet, plain=False):
        cfg = self.cfg
        obstacle = local_maps[:, 0]
        obstacle = torch.where(
            erode_first[:, None, None],
            B.batch_erode(torch.round(obstacle), CROSS).float(), obstacle)
        coll_w = B.window_shuttle_in(collision[:, None], lmb, self.Hl,
                                     self.Wl)[:, 0]
        vis_w = B.window_shuttle_in(visited[:, None], lmb, self.Hl,
                                    self.Wl)[:, 0]
        trav, _ = B.build_traversible(
            obstacle, coll_w, vis_w, loc_r, loc_c, int(cfg.col_rad),
            lmb[:, 2] == 0, lmb[:, 3] == self.Wf,
            lmb[:, 0] == 0, lmb[:, 1] == self.Hf)
        goal_dil = B.dilate_goal(goal_maps, found.float(), is_toilet).float()
        return B.plan_distance_fields(
            trav, goal_dil, loc_r, loc_c, n_iters=cfg.fmm_sweeps,
            block=int(getattr(cfg, "plan_block", 16)),
            inner=int(getattr(cfg, "plan_inner", 40)), plain=plain)

    def _tick(self, state: DeviceState, sem_u8: torch.Tensor,
              depth_cm: torch.Tensor, hp: torch.Tensor):
        """The per-tick device program.  hp: (B, PACK) float32 host_pack.
        Returns (new_state, packed download)."""
        cfg = self.cfg
        res = cfg.map_resolution
        n = hp.shape[0]
        poses_new = hp[:, 0:3]
        lmb_old = hp[:, 3:7].long()
        lmb_new = hp[:, 7:11].long()
        is_toilet = hp[:, 13] > 0.5
        preset_cells = hp[:, 15:17].int()
        preset_override = hp[:, 17] > 0.5
        erode_first = hp[:, 18] > 0.5
        starts = hp[:, 19:21].long()
        line_pts = hp[:, 23:231].long().reshape(n, N_LINE_PTS, 2)
        line_valid = hp[:, 231:335] > 0.5
        col_pts = hp[:, 335:351].long().reshape(n, N_COL_PTS, 2)
        col_valid = hp[:, 351:359] > 0.5

        # --- pending point scatters (visited path / collisions) ----------
        visited = self._scatter_max(state.visited, line_pts, line_valid)
        collision = self._scatter_max(state.collision, col_pts, col_valid)

        # --- observation assembly + map update ---------------------------
        zeros_rgb = torch.zeros((n, 3) + tuple(sem_u8.shape[2:]),
                                dtype=torch.float32, device=self.device)
        obs = torch.cat([zeros_rgb, depth_cm[:, None], sem_u8.float()], dim=1)
        _, local_maps, _ = self.mapper.update_core(obs, poses_new,
                                                   state.local_maps)

        loc_r = (poses_new[:, 1] * 100.0 / res).long()
        loc_c = (poses_new[:, 0] * 100.0 / res).long()
        local_maps[:, 2] = 0.0
        sel_r, sel_c = self.selem_idx
        off = int(cfg.col_rad + 1)
        B.mark_agent(local_maps, loc_r, loc_c, 2, (2, 3))
        B.fill_disk(local_maps, 1, loc_r, loc_c, sel_r, sel_c, off)
        goal_in = state.cur_goal.long()
        d2 = ((loc_r - goal_in[:, 0]) ** 2
              + (loc_c - goal_in[:, 1]) ** 2).double()
        d2g = torch.sqrt(d2).float() * res
        near = d2g < cfg.goal_reached_dist
        filled = B.fill_disk(local_maps.clone(), 1, goal_in[:, 0],
                             goal_in[:, 1], sel_r, sel_c, off)
        local_maps = torch.where(near[:, None, None, None], filled,
                                 local_maps)

        # --- window shuttling ---------------------------------------------
        full_maps = B.window_shuttle_out(state.full_maps, local_maps, lmb_old)
        local_maps = B.window_shuttle_in(full_maps, lmb_new, self.Hl, self.Wl)

        # preset corner goals (explore mode)
        cur_goal = torch.where(preset_override[:, None], preset_cells,
                               state.cur_goal)

        # --- goal map: explore-only has no found goal ---------------------
        found = torch.zeros((n,), dtype=torch.bool, device=self.device)
        single = torch.zeros_like(local_maps[:, 0])
        single[torch.arange(n, device=self.device), cur_goal[:, 0].long(),
               cur_goal[:, 1].long()] = 1.0

        # --- local planning solve -----------------------------------------
        plan = self._plan(local_maps, collision, visited, lmb_new,
                          starts[:, 0], starts[:, 1], erode_first, single,
                          found, is_toilet)

        new_state = state._replace(
            local_maps=local_maps, full_maps=full_maps, collision=collision,
            visited=visited, cur_goal=cur_goal)
        # packed download: windows (121) | found | d2g | goal (2)
        k = plan.window.shape[-1]
        packed = torch.cat([plan.window.reshape(n, k * k),
                            found.float()[:, None], d2g[:, None],
                            cur_goal.float()], dim=1)
        return new_state, packed

    def _replan_program(self, state: DeviceState, lmb, loc_r, loc_c, flags,
                        goal_cats, no_erode, found, is_toilet):
        """Eroded-obstacle re-solve for replan-flagged envs."""
        goal_maps = self._goal_maps(state.local_maps, state.cur_goal,
                                    goal_cats, no_erode, found)
        return self._plan(state.local_maps, state.collision, state.visited,
                          lmb, loc_r, loc_c, flags, goal_maps, found,
                          is_toilet).window

    def _t(self, x, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    # ------------------------------------------------------------------
    def warmup_rare_paths(self):
        """Run the replan and goal-magnify paths once outside any timed
        region: the kernels build at first use (nvcc), and both paths are
        data-dependent, so the build would otherwise land inside whichever
        measured tick first hits them."""
        n = self.n
        lmb = np.stack([s.lmb for s in self.slots])
        starts = np.full((n, 2), self.Hl // 2, np.int64)
        self._replan_program(
            self.state, self._t(lmb).long(), self._t(starts[:, 0]),
            self._t(starts[:, 1]), self._t(np.ones(n, bool)),
            self._t(np.zeros(n, np.int64)), self._t(np.zeros(n, bool)),
            self._t(np.zeros(n, bool)), self._t(np.zeros(n, bool))).cpu()
        # the magnify fallback solves (n, Hl+2, Wl+2) padded fields
        trav = np.ones((n, self.Hl + 2, self.Wl + 2))
        goal = np.zeros_like(trav, dtype=bool)
        goal[:, 1, 1] = True
        FMMPlanner.solve_batch(trav, goal, n_iters=self.cfg.fmm_sweeps,
                               device=self.device)
        self.warmup_tick_variants()

    def warmup_tick_variants(self):
        """Run the tick once on zero inputs and restore the episode state
        (a copy is kept; the tick updates some tensors in place), so warming
        up mid-episode leaves the episodes bit-identical."""
        saved = DeviceState(*(x.clone() for x in self.state))
        cfg = self.cfg
        n = self.n
        fh, fw = cfg.frame_height, cfg.frame_width
        sem = torch.zeros((n, cfg.num_sem_categories, fh, fw),
                          dtype=torch.uint8, device=self.device)
        depth = torch.zeros((n, fh, fw), dtype=torch.float32,
                            device=self.device)
        hp = np.zeros((n, PACK), np.float32)
        hp[:, 3:7] = np.stack([s.lmb for s in self.slots])
        hp[:, 7:11] = hp[:, 3:7]
        self.state, packed = self._tick(self.state, sem, depth, self._t(hp))
        packed.cpu()
        self.state = saved

    # ==================================================================
    # episode lifecycle
    # ==================================================================
    def reset_env(self, i: int):
        cfg = self.cfg
        s = self.slots[i] = EnvSlot()
        s.forward_after_stop = cfg.move_forward_after_stop
        s.untrap.reset(full=True)

        center = cfg.map_size_cm / 100.0 / 2.0
        loc = int(center * 100.0 / cfg.map_resolution)
        pose = np.array([center, center, 0.0], np.float32)
        s.lmb = np.asarray(self._local_boundaries(loc, loc), np.int32)
        s.origins = np.array([s.lmb[2] * cfg.map_resolution / 100.0,
                              s.lmb[0] * cfg.map_resolution / 100.0, 0.0])
        s.pose_inputs[:3] = pose
        s.pose_inputs[3:] = s.lmb
        s.curr_loc = [center, center, 0.0]
        self.local_poses[i] = pose - s.origins.astype(np.float32)
        self.goal_shadow[i] = [int(0.1 * self.Hl), int(0.1 * self.Wl)]

        with self._reset_lock:
            st = self.state
            st.full_maps[i] = 0.0
            st.full_maps[i, 2:4, loc - 1:loc + 2, loc - 1:loc + 2] = 1.0
            r0 = min(max(int(s.lmb[0]), 0), self.Hf - self.Hl)
            c0 = min(max(int(s.lmb[2]), 0), self.Wf - self.Wl)
            st.local_maps[i] = st.full_maps[i, :, r0:r0 + self.Hl,
                                            c0:c0 + self.Wl]
            st.collision[i] = 0.0
            st.visited[i] = 0.0
            st.target_pred[i] = 0.0
            st.dd_wt[i] = 0.0
            st.dd_valid[i] = False
            st.cur_goal[i] = self._t(self.goal_shadow[i])
            st.last_goal[i] = -1
            st.last_goal_valid[i] = False

    # ------------------------------------------------------------------
    # episode checkpoint / resume: the same .npz as the JAX package's
    # BatchedNavRuntime.save_episode_state, so either package resumes the
    # other's episodes
    # ------------------------------------------------------------------
    def save_episode_state(self, path: str) -> None:
        """Checkpoint all cross-tick state (device maps + host state
        machines) to one .npz."""
        arrays = {f"dev_{k}": v.cpu().numpy()
                  for k, v in self.state._asdict().items()}
        arrays["goal_shadow"] = self.goal_shadow
        arrays["local_poses"] = self.local_poses
        slots = []
        for s in self.slots:
            slots.append({
                "step": s.step, "l_step": s.l_step,
                "timestep": s.timestep, "goal_name": s.goal_name,
                "found_goal": s.found_goal,
                "dist_to_goal": s.dist_to_goal,
                "preset_id": s.preset_id,
                "origins": np.asarray(s.origins, np.float64).tolist(),
                "lmb": np.asarray(s.lmb, np.int64).tolist(),
                "pose_inputs": np.asarray(s.pose_inputs,
                                          np.float64).tolist(),
                "last_sim_location":
                    None if s.last_sim_location is None
                    else [float(v) for v in s.last_sim_location],
                "curr_loc": [float(v) for v in s.curr_loc],
                "last_loc": [float(v) for v in s.last_loc],
                "last_action":
                    None if s.last_action is None else int(s.last_action),
                "previous_action": int(s.previous_action),
                "col_width": int(s.col_width),
                "prev_blocked": int(s.prev_blocked),
                "forward_after_stop": int(s.forward_after_stop),
                "untrap": [s.untrap.total_id, s.untrap.epi_id],
            })
        np.savez_compressed(path, __slots__=json.dumps(slots), **arrays)

    def load_episode_state(self, path: str) -> None:
        """Restore a ``save_episode_state`` checkpoint of either package
        (same config and env count), placing the maps on this runtime's
        device."""
        z = np.load(path, allow_pickle=False)
        slots = json.loads(str(z["__slots__"]))
        if len(slots) != self.n:
            raise ValueError(
                f"checkpoint has {len(slots)} episodes, runtime has "
                f"{self.n}")
        self.state = device_state_from_numpy(z, self.device)
        self.goal_shadow = np.asarray(z["goal_shadow"], np.int32)
        self.local_poses = np.asarray(z["local_poses"], np.float32)
        for s, d in zip(self.slots, slots):
            s.step, s.l_step = d["step"], d["l_step"]
            s.timestep = d["timestep"]
            s.goal_name = d["goal_name"]
            s.found_goal = d["found_goal"]
            s.dist_to_goal = d["dist_to_goal"]
            s.preset_id = d["preset_id"]
            s.origins = np.asarray(d["origins"])
            s.lmb = np.asarray(d["lmb"], np.int32)
            s.pose_inputs = np.asarray(d["pose_inputs"])
            s.last_sim_location = (None if d["last_sim_location"] is None
                                   else tuple(d["last_sim_location"]))
            s.curr_loc = list(d["curr_loc"])
            s.last_loc = list(d["last_loc"])
            s.last_action = d["last_action"]
            s.previous_action = d["previous_action"]
            s.col_width = d["col_width"]
            s.prev_blocked = d["prev_blocked"]
            s.forward_after_stop = d["forward_after_stop"]
            s.untrap.total_id, s.untrap.epi_id = d["untrap"]
        self._clear_pending()

    def _local_boundaries(self, loc_r, loc_c):
        cfg = self.cfg
        if cfg.global_downscaling > 1:
            gx1 = loc_r - self.Hl // 2
            gy1 = loc_c - self.Wl // 2
            gx1 -= gx1 % cfg.grid_resolution
            gy1 -= gy1 % cfg.grid_resolution
            gx2, gy2 = gx1 + self.Hl, gy1 + self.Wl
            if gx1 < 0:
                gx1, gx2 = 0, self.Hl
            if gx2 > self.Hf:
                gx1, gx2 = self.Hf - self.Hl, self.Hf
            if gy1 < 0:
                gy1, gy2 = 0, self.Wl
            if gy2 > self.Wf:
                gy1, gy2 = self.Wf - self.Wl, self.Wf
        else:
            gx1, gx2, gy1, gy2 = 0, self.Hf, 0, self.Wf
        return [gx1, gx2, gy1, gy2]

    # ==================================================================
    # per-tick pipeline
    # ==================================================================
    def act_batch(self, observations: Sequence[Dict]) -> List[Dict]:
        return self.act_batch_collect(self.act_batch_dispatch(observations))

    def act_batch_dispatch(self, observations: Sequence[Dict]) -> TickHandle:
        """Phase 1: host bookkeeping + enqueue this tick's device work
        (asynchronous on CUDA).  Collect(t) must run before dispatch(t+1):
        the host state machines mutated here assume the previous tick's
        results landed."""
        cfg = self.cfg
        n = self.n
        T = self.timer

        # ---- host: pose integration + bookkeeping ---------------------
        pose_deltas = np.zeros((n, 3), np.float32)
        goal_cats = np.zeros(n, np.int32)
        stop_now = np.zeros(n, bool)
        for i, s in enumerate(self.slots):
            o = observations[i]
            s.timestep += 1
            if s.timestep > cfg.timestep_limit:
                stop_now[i] = True
            goal = int(np.asarray(o["objectgoal"]).reshape(-1)[0])
            s.goal_name = hm3d_names[goal]
            goal_cats[i] = hm3d_to_coco[goal]
            x = o["gps"][0]
            y = -o["gps"][1]
            th = float(np.asarray(o["compass"]).reshape(-1)[0])
            if th > np.pi:
                th -= 2 * np.pi
            cur = (x, y, th)
            if s.last_sim_location is not None:
                dx, dy, do = get_rel_pose_change(cur, s.last_sim_location)
                pose_deltas[i] = [dx, dy, do]
            s.last_sim_location = cur

        poses_new = integrate_pose_np(self.local_poses, pose_deltas)
        loc_r = (poses_new[:, 1] * 100.0 / cfg.map_resolution).astype(int)
        loc_c = (poses_new[:, 0] * 100.0 / cfg.map_resolution).astype(int)
        d2g_host = np.sqrt((loc_r - self.goal_shadow[:, 0]) ** 2 +
                           (loc_c - self.goal_shadow[:, 1]) ** 2) * \
            cfg.map_resolution

        # window shuttling + preset decisions (host mirrors of the device)
        lmb_old = np.stack([s.lmb for s in self.slots])
        lmb_new = lmb_old.copy()
        preset_cells = np.zeros((n, 2), np.int32)
        preset_override = np.zeros(n, bool)
        for i, s in enumerate(self.slots):
            s.dist_to_goal = float(d2g_host[i])
            s.pose_inputs[:3] = poses_new[i] + s.origins
            if s.l_step == cfg.num_local_steps - 1:
                full_pose = poses_new[i] + s.origins.astype(np.float32)
                fr = int(full_pose[1] * 100.0 / cfg.map_resolution)
                fc = int(full_pose[0] * 100.0 / cfg.map_resolution)
                lmb_new[i] = self._local_boundaries(fr, fc)
                if s.step < cfg.switch_step:
                    preset = self.presets[s.preset_id]
                    preset_cells[i] = [
                        min(int(preset[0] * self.Hl), self.Hl - 1),
                        min(int(preset[1] * self.Wl), self.Wl - 1)]
                    preset_override[i] = True

        # re-base poses for envs that re-windowed (keep the pre-rebase copy
        # for the mapper, which updates in the OLD window's frame)
        poses_pre = poses_new.copy()
        for i, s in enumerate(self.slots):
            if s.l_step == cfg.num_local_steps - 1:
                full_pose = poses_new[i] + s.origins.astype(np.float32)
                s.lmb = lmb_new[i]
                s.origins = np.array(
                    [s.lmb[2] * cfg.map_resolution / 100.0,
                     s.lmb[0] * cfg.map_resolution / 100.0, 0.0])
                s.pose_inputs[3:] = s.lmb
                poses_new[i] = full_pose - s.origins.astype(np.float32)
        self.local_poses = poses_new
        loc_r = (poses_new[:, 1] * 100.0 / cfg.map_resolution).astype(int)
        loc_c = (poses_new[:, 0] * 100.0 / cfg.map_resolution).astype(int)

        # planner-frame cells, visited lines, collision points
        with T.stage("host_points"):
            starts, starts_exact = self._planner_cells(lmb_new)
            self._collect_points(starts, lmb_new)

        # ---- segmentation + obs packing -------------------------------
        with T.stage("pack_obs"):
            sem_u8, depth_cm = self._pack_obs(observations, goal_cats)

        # ---- one packed f32 upload for every small input ---------------
        no_erode = np.array(["tv" in s.goal_name for s in self.slots])
        is_toilet = np.array([s.goal_name == "toilet" for s in self.slots])
        hp = np.zeros((n, PACK), np.float32)
        hp[:, 0:3] = poses_pre
        hp[:, 3:7] = lmb_old
        hp[:, 7:11] = lmb_new
        hp[:, 11] = goal_cats
        hp[:, 12] = no_erode
        hp[:, 13] = is_toilet
        hp[:, 15:17] = preset_cells
        hp[:, 17] = preset_override
        hp[:, 18] = 0.0  # erode_first (replan pass only)
        hp[:, 19:21] = starts
        hp[:, 21] = loc_r
        hp[:, 22] = loc_c
        hp[:, 23:231] = self._line_pts.reshape(n, -1)
        hp[:, 231:335] = self._line_valid
        hp[:, 335:351] = self._col_pts.reshape(n, -1)
        hp[:, 351:359] = self._col_valid

        with T.stage("upload"):
            sem = sem_u8 if torch.is_tensor(sem_u8) else self._t(sem_u8)
            args = (sem, self._t(depth_cm), self._t(hp))
        with T.stage("dispatch"):
            # on CUDA the tick's kernels are enqueued; nothing blocks until
            # collect fetches the packed download
            self.state, packed = self._tick(self.state, *args)
        self._clear_pending()
        return TickHandle(packed, starts, starts_exact, lmb_new, goal_cats,
                          no_erode, is_toilet, stop_now)

    def act_batch_collect(self, h: TickHandle) -> List[Dict]:
        """Phase 2: wait for the tick's packed download, then run the host
        planning tail (STG extraction, rare fallbacks, action rules) and
        advance the per-episode step counters."""
        cfg = self.cfg
        n = self.n
        T = self.timer
        starts, starts_exact, lmb_new = h.starts, h.starts_exact, h.lmb_new
        with T.stage("tick_wait"):
            packed = h.packed.cpu().numpy()

        k = 11
        windows = packed[:, :k * k].reshape(n, k, k)
        found = packed[:, k * k] > 0.5
        self.goal_shadow = packed[:, k * k + 2:k * k + 4].astype(np.int32)
        for i, s in enumerate(self.slots):
            s.found_goal = int(found[i])

        # ---- host: STG extraction + rare fallbacks + action rules ------
        self.last_windows = windows  # debug/vis introspection
        with T.stage("stg"):
            stg_results = [self._stg_from_window(windows[i], starts_exact[i],
                                                 starts[i]) for i in range(n)]
        replan_flags = np.array([r[4] for r in stg_results])
        if replan_flags.any():
            with T.stage("replan"):
                stg_results = self._replan_pass(
                    replan_flags, stg_results, starts, starts_exact, lmb_new,
                    h.goal_cats, h.no_erode, h.is_toilet)
        mag_idxs = [i for i in range(n)
                    if self.slots[i].found_goal == 1
                    and stg_results[i][2] > cfg.magnify_goal_when_hard]
        if mag_idxs:
            with T.stage("magnify"):
                stg_results = self._magnify_goal_batch(
                    mag_idxs, starts, starts_exact, stg_results)

        self.last_stg = stg_results
        actions = self._action_rules(stg_results, starts, h.stop_now)
        for s in self.slots:
            s.l_step += 1
            s.step += 1
            s.l_step = s.step % cfg.num_local_steps
        return [{"action": a} for a in actions]

    # ------------------------------------------------------------------
    def stage_obs(self, obs: Dict) -> None:
        """Preprocess this observation as soon as its env has stepped
        (called from the env-step thread pool): its depth on the host and,
        with a device segmenter, its uint8 RGB up to the device; once
        ``seg_chunk`` frames are staged, launch their detect chunk, so
        detection of the first envs overlaps the others' stepping."""
        cfg = self.cfg
        if hasattr(self.segmenter, "batch_device"):
            obs["_rgb_dev"] = upload(np.asarray(obs["rgb"], np.uint8),
                                     self.device)
        d = preprocess_depth(np.asarray(obs["depth"])[None],
                             cfg.min_depth, cfg.max_depth)[0]
        ds = cfg.env_frame_width // cfg.frame_width
        if ds != 1:
            d = d[ds // 2::ds, ds // 2::ds]
        obs["_depth_np"] = d
        if self._seg_chunk:
            goal = int(np.asarray(obs["objectgoal"]).reshape(-1)[0])
            obs["_goal_cat"] = int(hm3d_to_coco[goal])
            batch = None
            with self._det_lock:
                self._det_buf.append(obs)
                if len(self._det_buf) >= self._seg_chunk:
                    batch, self._det_buf = self._det_buf, []
            if batch:
                self._launch_detect(batch)

    def _launch_detect(self, batch) -> None:
        """Detect one staged chunk; each obs gets its slice of the device
        semantic stack under ``_sem_dev``.  Nothing in the detect waits for
        the device (NMS solves on the card, host data goes up without
        blocking), so the ``detect`` stage is the host's time to enqueue
        the chunk; its device time overlaps the other envs' stepping and
        shows in the tick's ``tick_wait``."""
        with self.timer.stage("detect"):
            sem = self.segmenter.batch_device(
                torch.stack([o["_rgb_dev"] for o in batch]),
                [o["_goal_cat"] for o in batch])
        for j, o in enumerate(batch):
            o["_sem_dev"] = sem[j]

    def _depth_stack(self, observations) -> np.ndarray:
        cfg = self.cfg
        if all("_depth_np" in o for o in observations):
            return np.stack([o["_depth_np"] for o in observations])
        d_all = preprocess_depth(
            np.stack([np.asarray(o["depth"]) for o in observations]),
            cfg.min_depth, cfg.max_depth)
        ds = cfg.env_frame_width // cfg.frame_width
        if ds != 1:
            d_all = d_all[:, ds // 2::ds, ds // 2::ds]
        return d_all

    def _pack_obs(self, observations, goal_cats):
        cfg = self.cfg
        n = self.n
        fh, fw = cfg.frame_height, cfg.frame_width
        sem_u8 = np.zeros((n, cfg.num_sem_categories, fh, fw), np.uint8)
        depth_cm = np.zeros((n, fh, fw), np.float32)
        ds = cfg.env_frame_width // cfg.frame_width

        if hasattr(self.segmenter, "batch_device"):
            # Mask R-CNN: the semantic stack stays on the device
            with self._det_lock:
                batch, self._det_buf = self._det_buf, []
            if batch:                  # the partial tail chunk stage_obs left
                self._launch_detect(batch)
            if all("_sem_dev" in o for o in observations):
                sem = torch.stack([o.pop("_sem_dev") for o in observations])
            else:
                if all("_rgb_dev" in o for o in observations):
                    rgbs = torch.stack([o["_rgb_dev"] for o in observations])
                else:
                    rgbs = np.stack([np.asarray(o["rgb"], np.uint8)
                                     for o in observations])
                with self.timer.stage("detect"):
                    sem = self.segmenter.batch_device(
                        rgbs, [int(g) for g in goal_cats])
            depth_cm[:] = self._depth_stack(observations)
            return sem, depth_cm

        if cfg.use_gt_seg == 1 and hasattr(self.segmenter, "goalseg"):
            # GroundTruthSegmenter fast path: only the goal channel is
            # nonzero, so subsample it straight into the uint8 stack
            # (byte-identical to the generic path)
            for i, o in enumerate(observations):
                gs = o.get("goalseg")
                if gs is not None:
                    sub = np.asarray(gs)[ds // 2::ds, ds // 2::ds]
                    sem_u8[i, int(goal_cats[i])] = np.clip(
                        sub, 0, 255).astype(np.uint8)
            depth_cm[:] = self._depth_stack(observations)
            return sem_u8, depth_cm

        sems = []
        for i in range(n):
            o = observations[i]
            if cfg.use_gt_seg and hasattr(self.segmenter, "goalseg"):
                self.segmenter.goalseg = o.get("goalseg")
            sems.append(self.segmenter(
                np.asarray(o["rgb"], np.uint8), depth=o["depth"],
                goal_cat=int(goal_cats[i])))
        sem_all = np.stack(sems)
        if ds != 1:
            sem_all = sem_all[:, ds // 2::ds, ds // 2::ds]
        # semantic masks are instance-count accumulations; uint8 is exact
        sem_u8[:] = np.clip(sem_all, 0, 255).astype(np.uint8).transpose(
            0, 3, 1, 2)
        depth_cm[:] = self._depth_stack(observations)
        return sem_u8, depth_cm

    def _planner_cells(self, lmb):
        cfg = self.cfg
        n = self.n
        starts = np.zeros((n, 2), np.int32)
        starts_exact = np.zeros((n, 2))
        for i, s in enumerate(self.slots):
            start_x, start_y, _ = s.pose_inputs[:3]
            gx1, gy1 = int(lmb[i][0]), int(lmb[i][2])
            se = [start_y * 100.0 / cfg.map_resolution - gx1,
                  start_x * 100.0 / cfg.map_resolution - gy1]
            starts_exact[i] = se
            starts[i] = threshold_poses([int(se[0]), int(se[1])],
                                        (self.Hl, self.Wl))
        return starts, starts_exact

    def _collect_points(self, starts, lmb):
        """Visited-line cells + collision cells for this tick's scatters."""
        cfg = self.cfg
        for i, s in enumerate(self.slots):
            start_x, start_y, start_o = s.pose_inputs[:3]
            gx1, gy1 = int(lmb[i][0]), int(lmb[i][2])
            s.last_loc = s.curr_loc
            s.curr_loc = [start_x, start_y, start_o]
            st = starts[i]
            last = threshold_poses(
                [int(s.last_loc[1] * 100.0 / cfg.map_resolution - gx1),
                 int(s.last_loc[0] * 100.0 / cfg.map_resolution - gy1)],
                (self.Hl, self.Wl))
            k = 0
            for t in range(26):
                x = int(np.rint(last[0] + (st[0] - last[0]) * t / 25))
                y = int(np.rint(last[1] + (st[1] - last[1]) * t / 25))
                for dx_ in (-1, 0):
                    for dy_ in (-1, 0):
                        self._line_pts[i, k] = (x + dx_ + gx1, y + dy_ + gy1)
                        self._line_valid[i, k] = True
                        k += 1

            if s.last_action == 1:
                x1l, y1l, t1 = s.last_loc
                x2l, y2l, _ = s.curr_loc
                buf = 4 if s.prev_blocked < self.BLOCK_THRESHOLD else 2
                length = 2
                if abs(x1l - x2l) < 0.05 and abs(y1l - y2l) < 0.05:
                    s.col_width += 2
                    if s.col_width == 7:
                        length = 4
                        buf = 3
                    s.col_width = min(s.col_width, 1)
                else:
                    s.col_width = 1
                dist = get_l2_distance(x1l, x2l, y1l, y2l)
                if dist < cfg.collision_threshold:
                    s.prev_blocked += 1
                    width = s.col_width
                    k = 0
                    for ii in range(length):
                        for jj in range(width):
                            wx = x1l + 0.05 * (
                                (ii + buf) * np.cos(np.deg2rad(t1))
                                + (jj - width // 2) * np.sin(np.deg2rad(t1)))
                            wy = y1l + 0.05 * (
                                (ii + buf) * np.sin(np.deg2rad(t1))
                                - (jj - width // 2) * np.cos(np.deg2rad(t1)))
                            rr = int(wy * 100 / cfg.map_resolution)
                            cc = int(wx * 100 / cfg.map_resolution)
                            rr, cc = threshold_poses(
                                [rr, cc], (self.Hf, self.Wf))
                            self._col_pts[i, k] = (rr, cc)
                            self._col_valid[i, k] = True
                            k += 1
                else:
                    if s.prev_blocked >= self.BLOCK_THRESHOLD:
                        s.untrap.reset()
                    s.prev_blocked = 0

    # ------------------------------------------------------------------
    def _stg_from_window(self, window, start_exact, start):
        """Annulus argmin on the pulled 11x11 window (FMMPlanner
        get_short_term_goal semantics)."""
        du = 5
        dx = start_exact[0] - int(start_exact[0])
        dy = start_exact[1] - int(start_exact[1])
        mask = step_mask(dx, dy, 1.0, du)
        dist_mask = step_dist(dx, dy, 1.0, du)
        sentinel = (self.Hl + 2) ** 2
        subset = window.copy()
        subset *= mask
        subset += (1 - mask) * sentinel
        distance = subset[du, du]
        stop = bool(distance < 0.25 * 100 / 5.0)
        subset = subset - distance
        ratio1 = subset / dist_mask
        subset[ratio1 < -1.5] = 1
        sx, sy = np.unravel_index(np.argmin(subset), subset.shape)
        replan = bool(subset[sx, sy] > -0.0001)
        return (sx + start[0] - du, sy + start[1] - du, distance, stop,
                replan)

    def _replan_pass(self, flags, stg_results, starts, starts_exact, lmb,
                     goal_cats, no_erode, is_toilet):
        """Second solve with eroded obstacle maps for flagged envs."""
        cfg = self.cfg
        for i in np.where(flags)[0]:
            if cfg.only_explore:
                sl = self.slots[i]
                sl.preset_id = (sl.preset_id + 1) % len(self.presets)

        found = np.array([sl.found_goal for sl in self.slots], bool)
        windows = self._replan_program(
            self.state, self._t(lmb).long(), self._t(starts[:, 0]).long(),
            self._t(starts[:, 1]).long(), self._t(flags),
            self._t(goal_cats).long(), self._t(no_erode), self._t(found),
            self._t(is_toilet)).cpu().numpy()
        out = list(stg_results)
        for i in np.where(flags)[0]:
            out[i] = self._stg_from_window(windows[i], starts_exact[i],
                                           starts[i])
        return out

    def _magnify_prepare(self, i, start, local_np, coll_full, vis_full):
        """Build the (padded) traversible + initial dilated goal map for
        one magnify-flagged env from downloaded device state."""
        cfg = self.cfg
        s = self.slots[i]
        obstacle = np.rint(local_np[0])
        gx1, gx2, gy1, gy2 = [int(v) for v in s.lmb]
        coll = coll_full[gx1:gx2, gy1:gy2]
        vis = vis_full[gx1:gx2, gy1:gy2]
        if gx2 == self.Hf:
            obstacle[-1] = 1
        if gy2 == self.Wf:
            obstacle[:, -1] = 1
        if gx1 == 0:
            obstacle[0] = 1
        if gy1 == 0:
            obstacle[:, 0] = 1
        trav = np_binary_dilation(obstacle, disk(cfg.col_rad)) != True  # noqa: E712
        trav = trav.astype(float)
        trav[coll == 1] = 0
        trav[vis == 1] = 1
        trav[start[0] - 1:start[0] + 2, start[1] - 1:start[1] + 2] = 1
        trav = np.pad(trav, 1, constant_values=1)

        goal_cat = hm3d_to_coco[
            {v: k for k, v in hm3d_names.items()}[s.goal_name]]
        cat_map = (local_np[goal_cat + 4] > 0).astype(float)
        temp = cat_map
        if "tv" not in s.goal_name:
            for _ in range(cfg.goal_erode):
                temp = np_binary_erosion(temp.astype(bool)).astype(float)
            temp = np_binary_dilation(temp.astype(bool)).astype(float)
        others = local_np[4:10].sum(axis=0) - local_np[goal_cat + 4]
        temp = temp * (others == 0)
        if s.found_goal and temp.sum() > 0:
            goal = temp
        else:
            goal = np.zeros_like(cat_map)
            goal[self.goal_shadow[i][0], self.goal_shadow[i][1]] = 1.0
        goal = np.pad(goal, 1, constant_values=0)
        radius = 6 if s.goal_name == "toilet" else 8
        goal_dil = 1 - (np_binary_dilation(goal, disk(radius)) != True)  # noqa: E712
        return trav, goal_dil.astype(float)

    def _magnify_goal_batch(self, idxs, starts, starts_exact, stg_results):
        """Goal-magnification fallback (planner.py:473-489), batched: every
        flagged env solves in one batched eikonal call per dilation round.
        Per env: initial solve, then up to 8 (toilet: 2) dilate-and-resolve
        rounds while the agent's annulus distance stays > 100."""
        cfg = self.cfg
        st = self.state
        k = len(idxs)
        ii = torch.as_tensor(idxs, device=self.device)
        locals_np = st.local_maps[ii].cpu().numpy()
        colls = st.collision[ii].cpu().numpy()
        viss = st.visited[ii].cpu().numpy()
        travs, goals = [], []
        for j, i in enumerate(idxs):
            trav, goal_dil = self._magnify_prepare(
                i, starts[i], locals_np[j], colls[j], viss[j])
            travs.append(trav)
            goals.append(goal_dil)
        travs = np.stack(travs)
        goals = np.stack(goals)
        limits = np.array([2 if self.slots[i].goal_name == "toilet" else 8
                           for i in idxs])
        planners = [FMMPlanner(travs[j], n_iters=cfg.fmm_sweeps,
                               device=self.device) for j in range(k)]
        states = [[starts_exact[i][0] + 1, starts_exact[i][1] + 1]
                  for i in idxs]
        results = [None] * k
        active = np.ones(k, bool)
        rnd = 0
        # every solve is padded to the full env count: one solve shape
        pad_n = self.n
        while active.any():
            aw = np.where(active)[0]
            tb = np.ones((pad_n,) + travs.shape[1:], travs.dtype)
            gb = np.zeros((pad_n,) + goals.shape[1:], bool)
            tb[:len(aw)] = travs[aw]
            gb[:len(aw)] = goals[aw] == 1
            gb[len(aw):, 0, 0] = True  # padded rows need one goal cell
            dists = FMMPlanner.solve_batch(tb, gb, n_iters=cfg.fmm_sweeps,
                                           device=self.device)
            for jj, j in enumerate(aw):
                planners[j].fmm_dist = dists[jj]
                results[j] = planners[j].get_short_term_goal(states[j])
            rnd += 1
            for j in aw:
                if results[j][2] <= 100 or rnd > limits[j]:
                    active[j] = False
                else:
                    gd = np_binary_dilation(goals[j], disk(2)) != True  # noqa: E712
                    goals[j] = 1 - gd.astype(float)
        out = list(stg_results)
        for j, i in enumerate(idxs):
            sx, sy, distance, stop, replan = results[j]
            out[i] = (sx - 1, sy - 1, distance, stop, replan)
        return out

    # ------------------------------------------------------------------
    def _action_rules(self, stg_results, starts, stop_now) -> List[int]:
        cfg = self.cfg
        actions = []
        for i, s in enumerate(self.slots):
            if stop_now[i]:
                actions.append(0)
                s.previous_action = 0
                s.last_action = 0
                continue
            stg_x, stg_y, distance, stop, _ = stg_results[i]
            start = starts[i]
            start_o = s.pose_inputs[2]
            if s.forward_after_stop < 0:
                s.forward_after_stop = cfg.move_forward_after_stop
            if s.forward_after_stop != cfg.move_forward_after_stop:
                if s.forward_after_stop == 0:
                    s.forward_after_stop -= 1
                    action = 0
                else:
                    s.forward_after_stop -= 1
                    action = 1
            elif stop and s.found_goal == 1:
                if s.forward_after_stop == 0:
                    action = 0
                else:
                    s.forward_after_stop -= 1
                    action = 1
            else:
                sx = np.clip(stg_x, self.edge_buffer,
                             self.Hl - self.edge_buffer - 1)
                sy = np.clip(stg_y, self.edge_buffer,
                             self.Wl - self.edge_buffer - 1)
                angle_st_goal = math.degrees(
                    math.atan2(sx - start[0], sy - start[1]))
                angle_agent = start_o % 360.0
                if angle_agent > 180:
                    angle_agent -= 360
                relative_angle = (angle_agent - angle_st_goal) % 360.0
                if relative_angle > 180:
                    relative_angle -= 360
                if relative_angle > cfg.turn_angle / 2.0:
                    action = 3
                elif relative_angle < -cfg.turn_angle / 2.0:
                    action = 2
                else:
                    action = 1
            if s.prev_blocked >= self.BLOCK_THRESHOLD:
                if s.previous_action == 1:
                    action = s.untrap.get_action()
                else:
                    action = 1
            s.previous_action = action
            s.last_action = action
            actions.append(int(action))
        return actions
