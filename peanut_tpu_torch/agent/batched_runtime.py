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

With Mask R-CNN (``use_gt_seg=0``) ``stage_obs`` uploads each frame's
uint8 RGB as soon as its env has stepped and launches a detect chunk once
``seg_batch_chunk`` frames are staged, and the tick takes the segmenter's
device semantic stack without a host round trip.

With ``only_explore=0`` trigger ticks run target prediction (PSPNet on the
prediction crop), the geodesic goal weighting and the goal argmax on the
device (``_pred_goal_update``) over the gathered subset of triggered envs
(K = ``predict_chunk`` or all n): inside the tick (the exact profile), or
with ``pred_async`` as a program enqueued after the tick's collect, whose
goal download lands at the next dispatch (the serving profile's one-tick
goal lag).

With a ``mesh`` the episodes shard over its ``mesh_axis`` (the data axis):
shard i holds rows ``[i*m, (i+1)*m)`` of the batch (m = num_envs / axis
size) in a ``DeviceState`` of its own on its device, and every device
program (the tick, the prediction program, the replan and goal-magnify
solves) runs on each shard's rows alone, with shard-local indices: the
trigger subset of a prediction is gathered within a shard, as the JAX
package's shard_map path does (its GSPMD path has no PyTorch
counterpart).  A device may repeat in the mesh (``[cuda:0] * 4``): its
shards still keep their own state and programs.  The prediction model and
the segmenter get one copy on each distinct device.  The detect runs on
the device of the shards whose frames it holds, in fixed groups of
``seg_batch_chunk`` of that device's envs: ``stage_obs(obs, env)``
launches a group's chunk once all its envs have stepped, so on a mesh
that repeats one device the detect chunks are the unsharded runtime's
(whose detect no longer depends on the order the envs finish in), and
the semantic stack never leaves the device.  The
host side (the packed upload, the state machines, the action rules) stays
one batch; ``act_batch_dispatch`` enqueues every shard's tick before
``act_batch_collect`` waits for any.
"""

from __future__ import annotations

import copy
import json
import math
import threading
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device, upload
from ..config import NavConfig
from ..constants import hm3d_names, hm3d_to_coco
from ..core.mesh import (axis_devices, canonical_device, on_device,
                         replicate, shard_slices)
from ..geometry.pose import (get_rel_pose_change, get_l2_distance,
                             integrate_pose_np, threshold_poses)
from ..kernels import eikonal_distance, masked_fill_unreachable
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
#   [14] prediction trigger | [15:17] preset_cells
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


class Shard(NamedTuple):
    """One shard of the episode batch: its device and its rows."""
    device: torch.device
    rows: slice


class TickHandle(NamedTuple):
    """In-flight tick: the device output plus the host-side values the
    collect phase needs (act_batch_dispatch -> act_batch_collect).  The
    device tensors are one a shard."""
    packed: List[torch.Tensor]  # (m, 125) each, maybe computing
    starts: np.ndarray
    starts_exact: np.ndarray
    lmb_new: np.ndarray
    goal_cats: np.ndarray
    no_erode: np.ndarray
    is_toilet: np.ndarray
    stop_now: np.ndarray
    trig: np.ndarray
    hp: Optional[List[torch.Tensor]] = None         # the host_pack rows
    trig_idxs: Optional[List[torch.Tensor]] = None  # (m,) padded, local


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

    def __init__(self, cfg: NavConfig, num_envs: int,
                 prediction_model=None, segmenter=None,
                 predict_chunk: int = 8, device=None, plain: bool = False,
                 mesh=None, mesh_axis: str = "data"):
        """device: where the maps live and the tick runs (``resolve_device``:
        the card unless ``"cpu"``).  prediction_model: the
        ``PredictionModel`` of ``only_explore=0`` (else one is built from
        ``cfg.pred_model_wts``, which raises FileNotFoundError without the
        checkpoint); trigger ticks run it on at most ``predict_chunk`` envs
        of a shard at once unless more of the shard's trigger.  plain: the
        prediction branch's goal-weighting solve through the kernels' plain
        versions, even on the card (the yardstick the kernels are held
        against; ``_plan`` takes its own ``plain``).  mesh: a
        ``core.mesh.Mesh`` whose ``mesh_axis`` the episodes shard over
        (``num_envs`` must divide by its size; ``device`` is then its
        first device); each shard always runs its own programs."""
        self.cfg = cfg
        self.n = num_envs
        self.plain = plain
        if mesh is None:
            devices = [canonical_device(resolve_device(device))]
        else:
            ax = mesh.shape[mesh_axis]
            if num_envs % ax:
                raise ValueError(
                    f"num_envs={num_envs} not divisible by mesh axis "
                    f"'{mesh_axis}'={ax}")
            devices = axis_devices(mesh, mesh_axis)
            if device is not None and canonical_device(device) != devices[0]:
                raise ValueError(f"device {device} is not the mesh's first "
                                 f"device {devices[0]}")
        self.device = devices[0]
        self.shards = [Shard(d, r) for d, r in
                       zip(devices, shard_slices(num_envs, len(devices)))]
        self.m = num_envs // len(devices)
        if self.device.type == "cuda":
            # f32 convolutions run in TF32 under cuDNN by default; the
            # morphology convs are 0/1-exact either way, but state it
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.mapper = SemanticMapper(cfg)
        self.segmenter = segmenter if segmenter is not None \
            else build_segmenter(cfg, device=self.device)
        if cfg.only_explore == 0 and prediction_model is None:
            from ..prediction import PredictionModel

            prediction_model = PredictionModel(cfg, device=self.device)
        self.pred_model = prediction_model if cfg.only_explore == 0 else None
        self.predict_chunk = min(predict_chunk, num_envs)
        # one prediction model and one device segmenter a distinct device
        self._pred_models = {}
        if self.pred_model is not None:
            from ..prediction import PredictionModel

            for d, model in replicate(self.pred_model.model,
                                      devices).items():
                self._pred_models[d] = (
                    self.pred_model if model is self.pred_model.model else
                    PredictionModel(cfg, model=model, device=d))
        self._segs = {d: self.segmenter if d == self.device else
                      type(self.segmenter)(cfg, model=copy.deepcopy(
                          self.segmenter.model), device=d)
                      for d in dict.fromkeys(devices)} \
            if hasattr(self.segmenter, "batch_device") else {}

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

        self.shard_states = [self._alloc_state(sh) for sh in self.shards]
        self._clear_pending()
        # reset_env runs in the env-step thread pool; serialize its writes
        self._reset_lock = threading.Lock()
        # chunked-detect pipeline: a device's envs in groups of seg_chunk,
        # in env order; stage_obs launches a group's detect chunk as soon
        # as all its envs have stepped (_pack_obs the groups left).  A
        # detect's rounding depends on the frames it batches, so fixed
        # groups make it independent of the order the envs finish in
        self._det_lock = threading.Lock()
        self._det_pending: Dict[tuple, Dict[int, Dict]] = {}
        self._det_groups: Dict[int, tuple] = {}    # env -> (device, group)
        self._seg_chunk = int(getattr(self.segmenter, "chunk", 0) or 0) \
            if self._segs else 0
        self._det_envs = {d: [i for sh in self.shards if sh.device == d
                              for i in range(sh.rows.start, sh.rows.stop)]
                          for d in self._segs}
        for d, envs in self._det_envs.items():
            k = min(self._seg_chunk or len(envs), len(envs))
            for g in range(0, len(envs), k):
                group = tuple(envs[g:g + k])
                for i in group:
                    self._det_groups[i] = (d, group)
        # pred_async serving mode: the prediction/goal program is enqueued
        # after the tick's collect, so it runs while the envs step; its goal
        # download (a pinned host copy and an event) lands at the next
        # dispatch, where rows reset since then keep their fresh goal
        self._pred_async = bool(getattr(cfg, "pred_async", 0)) \
            and self.pred_model is not None
        self._pending_goal = None      # (the download's event,) in flight
        self._reset_since_pred = np.zeros(num_envs, bool)
        self._goal_host = torch.empty(
            (num_envs, 2), dtype=torch.int32,
            pin_memory=self.device.type == "cuda")

    # ------------------------------------------------------------------
    @property
    def state(self) -> DeviceState:
        """The episodes' device state: on one device the live tensors, on a
        mesh the shards' rows gathered on the first device (a copy)."""
        if len(self.shards) == 1:
            return self.shard_states[0]
        return DeviceState(*(torch.cat([x.to(self.device) for x in xs])
                             for xs in zip(*self.shard_states)))

    @state.setter
    def state(self, state: DeviceState) -> None:
        """Each shard takes its rows of ``state``, on its device."""
        self.shard_states = [
            DeviceState(*(x[sh.rows].to(sh.device) for x in state))
            for sh in self.shards]

    def _shard_of(self, i: int):
        """(shard index, row within the shard) of env ``i``."""
        return i // self.m, i % self.m

    def _alloc_state(self, shard: Shard) -> DeviceState:
        n, nc, dev = self.m, self.nc, shard.device
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

    def _goal_region(self, local_maps, goal_cats, no_erode):
        """The goal category's eroded-then-dilated cells, free of other
        categories (update_goal_map), and whether any are left."""
        cfg = self.cfg
        n = local_maps.shape[0]
        cat_maps = local_maps[torch.arange(n, device=local_maps.device),
                              goal_cats + 4]
        cat_bin = (cat_maps > 0).float()
        eroded = cat_bin
        for _ in range(cfg.goal_erode):
            eroded = B.batch_erode(eroded, CROSS).float()
        eroded = B.batch_dilate(eroded, CROSS).float()
        temp = torch.where(no_erode[:, None, None], cat_bin, eroded)
        others = local_maps[:, 4:10].sum(dim=1) - cat_maps
        temp = temp * (others == 0)
        found = (cat_maps.sum(dim=(1, 2)) != 0) & (temp.sum(dim=(1, 2)) != 0)
        return temp, found

    def _goal_maps(self, temp, found, cur_goal):
        """The found-goal region ``temp`` where ``found``, else the single
        goal cell."""
        single = torch.zeros_like(temp)
        single[torch.arange(temp.shape[0], device=temp.device),
               cur_goal[:, 0].long(), cur_goal[:, 1].long()] = 1.0
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

    def _pred_goal_update(self, full_maps, local_maps, collision, visited,
                          target_pred, dd_wt, dd_valid, cur_goal, last_goal,
                          last_goal_valid, trig, lmb_new, goal_cats, loc_new,
                          trig_idxs, pred_k: int):
        """Target prediction + geodesic value weighting + goal argmax (the
        update_prediction / update_global_goal twin), shared by the
        synchronous tick and the ``pred_async`` program, on the gathered
        subset of K = pred_k envs ``trig_idxs[:K]`` (padded with repeats,
        which compute the same rows).  Rows whose trigger is off keep their
        state.  Nothing here waits for the device: no host copy and no
        branch on a device value.  Returns the six updated state tensors
        (new tensors; the inputs are not changed)."""
        cfg = self.cfg
        pw = cfg.prediction_window
        px1 = self.Hf // 2 - pw // 2
        py1 = self.Wf // 2 - pw // 2
        dev = full_maps.device
        sub = trig_idxs[:pred_k]                       # (K,)
        k_ar = torch.arange(pred_k, device=dev)
        trig_s = trig[sub]
        lmb_s = lmb_new[sub]
        crop = full_maps[sub, :, px1:px1 + pw, py1:py1 + pw]
        probs = self._pred_models[dev].infer(crop)     # (K, 6, pw, pw)
        chan = probs[k_ar, goal_cats[sub]]
        pred_full = torch.zeros((pred_k, self.Hf, self.Wf),
                                dtype=torch.float32, device=dev)
        pred_full[:, px1:px1 + pw, py1:py1 + pw] = chan
        window = B.window_shuttle_in(pred_full[:, None], lmb_s, self.Hl,
                                     self.Wl)[:, 0]
        cand_tp = window * (local_maps[sub, 1] < 0.5)
        tp_s = torch.where(trig_s[:, None, None], cand_tp, target_pred[sub])
        target_pred = target_pred.clone()
        target_pred[sub] = tp_s

        # geodesic distance weighting over the subset's full maps
        trav = ~B.batch_dilate(torch.round(full_maps[sub, 0]),
                               disk(cfg.col_rad))
        trav = trav & ~(collision[sub] > 0)
        trav = trav | (visited[sub] > 0)
        agent_r = torch.clamp(loc_new[sub, 0] + lmb_s[:, 0], 0, self.Hf - 1)
        agent_c = torch.clamp(loc_new[sub, 1] + lmb_s[:, 2], 0, self.Wf - 1)
        src = torch.zeros_like(trav)
        src[k_ar, agent_r, agent_c] = True
        ds = int(getattr(cfg, "dd_downscale", 1))
        dd_order = int(getattr(cfg, "dd_order", 2))
        dd_blk = int(getattr(cfg, "dd_block", 16))
        dd_inner = int(getattr(cfg, "dd_inner", 40))
        if cfg.dist_weight_temperature <= 0:
            # frontier mode thresholds dd at a 60-cell cliff and T = -1
            # ignores dd: the half-resolution, first-order field is for the
            # smooth weighting only (agent/state.py::update_global_goal)
            ds, dd_order, dd_blk, dd_inner = 1, 2, 16, 40
        solve = dict(n_iters=cfg.fmm_sweeps, order=dd_order, block=dd_blk,
                     inner=dd_inner, plain=self.plain)
        if ds > 1 and self.Hf % ds == 0 and self.Wf % ds == 0:
            # the serving profile's field on an OR-pooled grid (walls are
            # col_rad-dilated, so pooling keeps them), upsampled nearest
            def pool(x):
                return F.max_pool2d(x[:, None].float(), ds)[:, 0] > 0
            dd = eikonal_distance(pool(trav), pool(src), **solve) * ds
            dd = masked_fill_unreachable(dd)
            dd = dd.repeat_interleave(ds, dim=1).repeat_interleave(ds, dim=2)
        else:
            dd = masked_fill_unreachable(eikonal_distance(trav, src, **solve))
        mx = torch.amax(dd, dim=(1, 2), keepdim=True)
        dd = torch.where(dd == mx, torch.inf, dd)
        temperature = cfg.dist_weight_temperature / cfg.map_resolution
        dd_wt_full = torch.exp(-dd / temperature)
        cand_dd = B.window_shuttle_in(dd_wt_full[:, None], lmb_s, self.Hl,
                                      self.Wl)[:, 0]
        # stuck-inside-obstacle fallback (agent_state.py:398-399)
        reuse = (cand_dd.sum(dim=(1, 2)) < 10) & dd_valid[sub]
        cand_dd = torch.where(reuse[:, None, None], dd_wt[sub], cand_dd)
        dd_s = torch.where(trig_s[:, None, None], cand_dd, dd_wt[sub])
        dd_wt = dd_wt.clone()
        dd_wt[sub] = dd_s
        valid_s = dd_valid[sub] | trig_s
        dd_valid = dd_valid.clone()
        dd_valid[sub] = valid_s

        # dist_weight_temperature modes (agent_state.py:402-407): -1 no
        # distance weighting; 0 frontier exploration (cells closer than 60
        # ignored, a flat 100-cell temperature, no prediction multiply)
        if cfg.dist_weight_temperature == -1:
            value = tp_s
        elif cfg.dist_weight_temperature == 0:
            dd_f = torch.where(dd < 60.0, torch.inf, dd)
            value = B.window_shuttle_in(torch.exp(-dd_f / 100.0)[:, None],
                                        lmb_s, self.Hl, self.Wl)[:, 0]
        else:
            value = tp_s * dd_s
        idx = torch.argmax(value.reshape(pred_k, -1), dim=1)
        new_goal = torch.stack([idx // self.Wl, idx % self.Wl],
                               dim=1).to(torch.int32)
        cur_s, last_s = cur_goal[sub], last_goal[sub]
        same = (new_goal == last_s).all(dim=1) & last_goal_valid[sub]
        take = trig_s & ~same
        last_goal_valid_s = last_goal_valid[sub] | take
        last_goal = last_goal.clone()
        last_goal[sub] = torch.where(take[:, None], cur_s, last_s)
        last_goal_valid = last_goal_valid.clone()
        last_goal_valid[sub] = last_goal_valid_s
        cur_goal = cur_goal.clone()
        cur_goal[sub] = torch.where(take[:, None], new_goal, cur_s)
        return (target_pred, dd_wt, dd_valid, cur_goal, last_goal,
                last_goal_valid)

    def _tick(self, state: DeviceState, sem_u8: torch.Tensor,
              depth_cm: torch.Tensor, hp: torch.Tensor,
              trig_idxs: Optional[torch.Tensor] = None, pred_k: int = 0):
        """The per-tick device program.  hp: (B, PACK) float32 host_pack;
        pred_k > 0: the synchronous prediction of the exact profile on the
        K envs ``trig_idxs[:K]``.  Returns (new_state, packed download)."""
        cfg = self.cfg
        res = cfg.map_resolution
        n = hp.shape[0]
        poses_new = hp[:, 0:3]
        lmb_old = hp[:, 3:7].long()
        lmb_new = hp[:, 7:11].long()
        goal_cats = hp[:, 11].long()
        no_erode = hp[:, 12] > 0.5
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
                                dtype=torch.float32, device=hp.device)
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

        # preset corner goals (explore mode / before switch_step)
        cur_goal = torch.where(preset_override[:, None], preset_cells,
                               state.cur_goal)
        pred = (state.target_pred, state.dd_wt, state.dd_valid, cur_goal,
                state.last_goal, state.last_goal_valid)

        # --- prediction + geodesic value weighting (exact profile) -------
        if pred_k and self.pred_model is not None:
            pred = self._pred_goal_update(
                full_maps, local_maps, collision, visited, *pred,
                hp[:, 14] > 0.5, lmb_new, goal_cats, hp[:, 21:23].long(),
                trig_idxs, pred_k)
        cur_goal = pred[3]

        # --- found-goal extraction (update_goal_map) ----------------------
        if cfg.only_explore == 0:
            temp, found = self._goal_region(local_maps, goal_cats, no_erode)
        else:
            temp = torch.zeros_like(local_maps[:, 0])
            found = torch.zeros((n,), dtype=torch.bool, device=hp.device)
        goal_maps = self._goal_maps(temp, found, cur_goal)

        # --- local planning solve -----------------------------------------
        plan = self._plan(local_maps, collision, visited, lmb_new,
                          starts[:, 0], starts[:, 1], erode_first, goal_maps,
                          found, is_toilet)

        new_state = DeviceState(local_maps, full_maps, collision, visited,
                                *pred)
        # packed download: windows (121) | found | d2g | goal (2)
        k = plan.window.shape[-1]
        packed = torch.cat([plan.window.reshape(n, k * k),
                            found.float()[:, None], d2g[:, None],
                            cur_goal.float()], dim=1)
        return new_state, packed

    def _pred_program(self, state: DeviceState, hp: torch.Tensor,
                      trig_idxs: torch.Tensor, pred_k: int):
        """The ``pred_async`` program: the prediction and goal update of a
        tick, run after it on its state (which holds what the tick's own
        prediction block reads), so the goal it computes is the one the
        synchronous tick would have, applied a tick later.  Returns
        (new_state, the new goals)."""
        pred = self._pred_goal_update(
            state.full_maps, state.local_maps, state.collision,
            state.visited, state.target_pred, state.dd_wt, state.dd_valid,
            state.cur_goal, state.last_goal, state.last_goal_valid,
            hp[:, 14] > 0.5, hp[:, 7:11].long(), hp[:, 11].long(),
            hp[:, 21:23].long(), trig_idxs, pred_k)
        return DeviceState(*state[:4], *pred), pred[3]

    def _replan_program(self, state: DeviceState, lmb, loc_r, loc_c, flags,
                        goal_cats, no_erode, found, is_toilet):
        """Eroded-obstacle re-solve for replan-flagged envs."""
        temp, _ = self._goal_region(state.local_maps, goal_cats, no_erode)
        goal_maps = self._goal_maps(temp, found, state.cur_goal)
        return self._plan(state.local_maps, state.collision, state.visited,
                          lmb, loc_r, loc_c, flags, goal_maps, found,
                          is_toilet).window

    def _t(self, x, dtype=None, device=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype,
                               device=self.device if device is None
                               else device)

    # ------------------------------------------------------------------
    def warmup_rare_paths(self):
        """Run the replan and goal-magnify paths once outside any timed
        region: the kernels build at first use (nvcc), and both paths are
        data-dependent, so the build would otherwise land inside whichever
        measured tick first hits them."""
        m = self.m
        for sh, st in zip(self.shards, self.shard_states):
            def t(x, d=sh.device):
                return self._t(x, device=d)
            lmb = np.stack([s.lmb for s in self.slots[sh.rows]])
            starts = np.full((m, 2), self.Hl // 2, np.int64)
            with on_device(sh.device):
                self._replan_program(
                    st, t(lmb).long(), t(starts[:, 0]), t(starts[:, 1]),
                    t(np.ones(m, bool)), t(np.zeros(m, np.int64)),
                    t(np.zeros(m, bool)), t(np.zeros(m, bool)),
                    t(np.zeros(m, bool))).cpu()
                # the magnify fallback solves (m, Hl+2, Wl+2) padded fields
                trav = np.ones((m, self.Hl + 2, self.Wl + 2))
                goal = np.zeros_like(trav, dtype=bool)
                goal[:, 1, 1] = True
                FMMPlanner.solve_batch(trav, goal,
                                       n_iters=self.cfg.fmm_sweeps,
                                       device=sh.device)
        self.warmup_tick_variants()

    def warmup_tick_variants(self):
        """Run every tick variant (without prediction; with it on the small
        and the full subset, or the ``pred_async`` programs instead) once on
        zero inputs on each shard, trigger off, and restore the episode
        state (a copy is kept; the tick updates some tensors in place), so
        warming up mid-episode leaves the episodes bit-identical."""
        cfg = self.cfg
        m = self.m
        fh, fw = cfg.frame_height, cfg.frame_width
        pred_ks = [self._pred_k(1), m] if self.pred_model is not None \
            else []
        tick_ks = [0] + ([] if self._pred_async else pred_ks)
        for s, sh in enumerate(self.shards):
            saved = DeviceState(*(x.clone() for x in self.shard_states[s]))
            d = sh.device
            sem = torch.zeros((m, cfg.num_sem_categories, fh, fw),
                              dtype=torch.uint8, device=d)
            depth = torch.zeros((m, fh, fw), dtype=torch.float32, device=d)
            hp = np.zeros((m, PACK), np.float32)
            hp[:, 3:7] = np.stack([s_.lmb for s_ in self.slots[sh.rows]])
            hp[:, 7:11] = hp[:, 3:7]
            hp, idxs = self._t(hp, device=d), self._t(np.zeros(m, np.int64),
                                                     device=d)
            with on_device(d):
                for k in dict.fromkeys(tick_ks):
                    self.shard_states[s], packed = self._tick(
                        self.shard_states[s], sem, depth, hp, idxs, k)
                    packed.cpu()
                for k in dict.fromkeys(pred_ks if self._pred_async else []):
                    self.shard_states[s], goal = self._pred_program(
                        self.shard_states[s], hp, idxs, k)
                    goal.cpu()
            self.shard_states[s] = saved

    # ==================================================================
    # episode lifecycle
    # ==================================================================
    def reset_env(self, i: int):
        cfg = self.cfg
        self._reset_since_pred[i] = True
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

        k, j = self._shard_of(i)
        with self._reset_lock:
            st = self.shard_states[k]
            st.full_maps[j] = 0.0
            st.full_maps[j, 2:4, loc - 1:loc + 2, loc - 1:loc + 2] = 1.0
            r0 = min(max(int(s.lmb[0]), 0), self.Hf - self.Hl)
            c0 = min(max(int(s.lmb[2]), 0), self.Wf - self.Wl)
            st.local_maps[j] = st.full_maps[j, :, r0:r0 + self.Hl,
                                            c0:c0 + self.Wl]
            st.collision[j] = 0.0
            st.visited[j] = 0.0
            st.target_pred[j] = 0.0
            st.dd_wt[j] = 0.0
            st.dd_valid[j] = False
            st.cur_goal[j] = self._t(self.goal_shadow[i],
                                     device=self.shards[k].device)
            st.last_goal[j] = -1
            st.last_goal_valid[j] = False

    # ------------------------------------------------------------------
    # episode checkpoint / resume: the same .npz as the JAX package's
    # BatchedNavRuntime.save_episode_state, so either package resumes the
    # other's episodes
    # ------------------------------------------------------------------
    def save_episode_state(self, path: str) -> None:
        """Checkpoint all cross-tick state (device maps + host state
        machines) to one .npz.  An in-flight ``pred_async`` goal lands
        first, so the saved host shadow matches the saved device goal."""
        self.wait_pending_goal()
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
        (same config and env count), placing each shard's maps on its
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
        self._pending_goal = None
        self._reset_since_pred[:] = False

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

    def wait_pending_goal(self):
        """Land the ``pred_async`` program's goal download (idempotent):
        wait for its event and take the goals into the host shadow, except
        for rows reset since it was enqueued.  A caller with host work to
        overlap (the runner's observation staging) may call it early;
        ``act_batch_dispatch`` calls it regardless."""
        if self._pending_goal is None:
            return
        with self.timer.stage("pred_goal_wait"):
            events, = self._pending_goal
            for event in events:        # the copies to the host from cards
                event.synchronize()
            g = self._goal_host.numpy().astype(np.int32)
        keep = np.logical_not(self._reset_since_pred)
        self.goal_shadow[keep] = g[keep]
        self._pending_goal = None

    def act_batch_dispatch(self, observations: Sequence[Dict]) -> TickHandle:
        """Phase 1: host bookkeeping + enqueue this tick's device work
        (asynchronous on CUDA).  Collect(t) must run before dispatch(t+1):
        the host state machines mutated here assume the previous tick's
        results landed."""
        cfg = self.cfg
        n = self.n
        T = self.timer

        # ---- pred_async: the goal the prediction program computed while
        # the envs stepped (rows reset since keep their fresh goal) -------
        self.wait_pending_goal()

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
        trig = np.zeros(n, bool)
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
            # the prediction trigger (agent_helper's update cadence)
            trig[i] = ((s.step % cfg.update_goal_freq
                        == cfg.update_goal_freq - 1
                        or s.step == 0
                        or s.dist_to_goal < cfg.goal_reached_dist)
                       and s.step >= cfg.switch_step
                       and self.pred_model is not None)

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
            sems, depth_cm = self._pack_obs(observations, goal_cats)

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
        hp[:, 14] = trig
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

        # trigger ticks: each shard's K triggered envs (shard-local
        # indices) padded with repeats; in the exact profile the tick
        # predicts for them (K = predict_chunk, or the shard's m when more
        # trigger), with pred_async the program after collect
        m = self.m
        idxs, pred_ks = [], []
        for sh in self.shards:
            trig_list = list(np.where(trig[sh.rows])[0])
            idxs.append(np.asarray((trig_list + trig_list[-1:] * m)[:m]
                                   if trig_list else np.zeros(m), np.int64))
            pred_ks.append(self._pred_k(len(trig_list))
                           if trig_list and not self._pred_async else 0)
        with T.stage("upload"):
            args = [(sem if torch.is_tensor(sem)
                     else self._t(sem, device=sh.device),
                     upload(depth_cm[sh.rows], sh.device),
                     upload(hp[sh.rows], sh.device),
                     upload(idx, sh.device))
                    for sh, sem, idx in zip(self.shards, sems, idxs)]
        with T.stage("dispatch"):
            # on CUDA every shard's kernels are enqueued; nothing blocks
            # until collect fetches the packed downloads
            packed = []
            for s, (sh, a) in enumerate(zip(self.shards, args)):
                with on_device(sh.device):
                    self.shard_states[s], p = self._tick(
                        self.shard_states[s], *a, pred_ks[s])
                packed.append(p)
        self._clear_pending()
        return TickHandle(packed, starts, starts_exact, lmb_new, goal_cats,
                          no_erode, is_toilet, stop_now, trig,
                          [a[2] for a in args], [a[3] for a in args])

    def _pred_k(self, n_trig: int) -> int:
        """The prediction subset of a shard for n_trig of its envs
        triggered: the small variant (predict_chunk, at most the shard's
        m) when they fit it, else all m."""
        k_small = min(self.predict_chunk, self.m)
        return k_small if n_trig <= k_small else self.m

    def act_batch_collect(self, h: TickHandle) -> List[Dict]:
        """Phase 2: wait for the tick's packed download, then run the host
        planning tail (STG extraction, rare fallbacks, action rules) and
        advance the per-episode step counters."""
        cfg = self.cfg
        n = self.n
        T = self.timer
        starts, starts_exact, lmb_new = h.starts, h.starts_exact, h.lmb_new
        with T.stage("tick_wait"):
            packed = np.concatenate([p.cpu().numpy() for p in h.packed])

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

        # ---- pred_async: enqueue the prediction/goal program last, so it
        # runs on the card while the caller steps the envs; its goals come
        # down into pinned memory behind an event
        if self._pred_async and h.trig.any():
            with T.stage("pred_dispatch"):
                events = {}
                for s, sh in enumerate(self.shards):
                    n_trig = int(h.trig[sh.rows].sum())
                    with on_device(sh.device):
                        if n_trig:
                            self.shard_states[s], goal = self._pred_program(
                                self.shard_states[s], h.hp[s],
                                h.trig_idxs[s], self._pred_k(n_trig))
                        else:       # a shard with no trigger keeps its goals
                            goal = self.shard_states[s].cur_goal
                        self._goal_host[sh.rows].copy_(goal,
                                                       non_blocking=True)
                        if sh.device.type == "cuda":
                            events[sh.device] = torch.cuda.Event()
                            events[sh.device].record()
                self._pending_goal = (list(events.values()),)
            self._reset_since_pred[:] = False

        self.last_stg = stg_results
        actions = self._action_rules(stg_results, starts, h.stop_now)
        for s in self.slots:
            s.l_step += 1
            s.step += 1
            s.l_step = s.step % cfg.num_local_steps
        return [{"action": a} for a in actions]

    # ------------------------------------------------------------------
    def stage_obs(self, obs: Dict, env: Optional[int] = None) -> None:
        """Preprocess this observation of env ``env`` as soon as it has
        stepped (called from the env-step thread pool): its depth on the
        host and, with a device segmenter, its uint8 RGB up to its
        device; once every env of its detect group (``seg_chunk`` of the
        device's envs, in env order) is staged, launch the group's detect
        chunk there, so detection of the first envs overlaps the others'
        stepping.  Without ``env`` the detect waits for ``_pack_obs``."""
        cfg = self.cfg
        dev, group = self._det_groups.get(env, (self.device, None))
        if self._segs:
            obs["_rgb_dev"] = upload(np.asarray(obs["rgb"], np.uint8), dev)
        d = preprocess_depth(np.asarray(obs["depth"])[None],
                             cfg.min_depth, cfg.max_depth)[0]
        ds = cfg.env_frame_width // cfg.frame_width
        if ds != 1:
            d = d[ds // 2::ds, ds // 2::ds]
        obs["_depth_np"] = d
        if self._seg_chunk and group is not None:
            goal = int(np.asarray(obs["objectgoal"]).reshape(-1)[0])
            obs["_goal_cat"] = int(hm3d_to_coco[goal])
            obs["_env"] = env
            batch = None
            with self._det_lock:
                staged = self._det_pending.setdefault(group, {})
                staged[env] = obs
                if len(staged) == len(group):
                    batch = [staged[i] for i in group]
                    del self._det_pending[group]
            if batch:
                self._launch_detect(batch, dev)

    def _launch_detect(self, batch, dev) -> None:
        """Detect one staged chunk on ``dev``; each obs gets its slice of
        the device semantic stack under ``_sem_dev``.  Nothing in the
        detect waits for the device (NMS solves on the card, host data
        goes up without blocking), so the ``detect`` stage is the host's
        time to enqueue the chunk; its device time overlaps the other
        envs' stepping and shows in the tick's ``tick_wait``."""
        with self.timer.stage("detect"), on_device(dev):
            sem = self._segs[dev].batch_device(
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
        """(each shard's semantic stack, the batch's depth): uint8 on the
        host, or the detect's on the shard's device."""
        cfg = self.cfg
        n = self.n
        fh, fw = cfg.frame_height, cfg.frame_width
        sem_u8 = np.zeros((n, cfg.num_sem_categories, fh, fw), np.uint8)
        depth_cm = np.zeros((n, fh, fw), np.float32)
        ds = cfg.env_frame_width // cfg.frame_width

        if self._segs:
            # Mask R-CNN: the semantic stack stays on the device; first
            # the groups stage_obs did not launch (not every env staged),
            # a device's in one call (it detects them group by group: only
            # a device's last group is short)
            with self._det_lock:
                self._det_pending = {}
            for dev, envs in self._det_envs.items():
                left = [i for i in envs if "_sem_dev" not in observations[i]]
                for i in left:
                    o = observations[i]
                    if "_rgb_dev" not in o:
                        o["_rgb_dev"] = upload(np.asarray(o["rgb"],
                                                          np.uint8), dev)
                    o["_rgb_dev"] = o["_rgb_dev"].to(dev)
                    o["_goal_cat"], o["_env"] = int(goal_cats[i]), i
                if left:
                    self._launch_detect([observations[i] for i in left],
                                        dev)
            sems = [torch.stack([observations[i].pop("_sem_dev")
                                 for i in range(sh.rows.start,
                                                sh.rows.stop)])
                    for sh in self.shards]
            depth_cm[:] = self._depth_stack(observations)
            return sems, depth_cm

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
            return [sem_u8[sh.rows] for sh in self.shards], depth_cm

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
        return [sem_u8[sh.rows] for sh in self.shards], depth_cm

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
        out = list(stg_results)
        for st, sh in zip(self.shard_states, self.shards):
            r = sh.rows
            if not flags[r].any():
                continue

            def t(x, d=sh.device):
                return self._t(x, device=d)
            with on_device(sh.device):
                windows = self._replan_program(
                    st, t(lmb[r]).long(), t(starts[r, 0]).long(),
                    t(starts[r, 1]).long(), t(flags[r]),
                    t(goal_cats[r]).long(), t(no_erode[r]), t(found[r]),
                    t(is_toilet[r])).cpu().numpy()
            for j in np.where(flags[r])[0]:
                i = r.start + j
                out[i] = self._stg_from_window(windows[j], starts_exact[i],
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
        flagged env of a shard solves in one batched eikonal call per
        dilation round on the shard's device.  Per env: initial solve, then
        up to 8 (toilet: 2) dilate-and-resolve rounds while the agent's
        annulus distance stays > 100."""
        out = list(stg_results)
        for st, sh in zip(self.shard_states, self.shards):
            mine = [i for i in idxs if sh.rows.start <= i < sh.rows.stop]
            if mine:
                with on_device(sh.device):
                    self._magnify_shard(st, sh, mine, starts, starts_exact,
                                        out)
        return out

    def _magnify_shard(self, st, sh, idxs, starts, starts_exact, out):
        """``_magnify_goal_batch`` on one shard's envs ``idxs`` (batch
        indices), writing their short-term goals into ``out``."""
        cfg = self.cfg
        k = len(idxs)
        ii = torch.as_tensor([i - sh.rows.start for i in idxs],
                             device=sh.device)
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
                               device=sh.device) for j in range(k)]
        states = [[starts_exact[i][0] + 1, starts_exact[i][1] + 1]
                  for i in idxs]
        results = [None] * k
        active = np.ones(k, bool)
        rnd = 0
        # every solve is padded to the shard's env count: one solve shape
        pad_n = self.m
        while active.any():
            aw = np.where(active)[0]
            tb = np.ones((pad_n,) + travs.shape[1:], travs.dtype)
            gb = np.zeros((pad_n,) + goals.shape[1:], bool)
            tb[:len(aw)] = travs[aw]
            gb[:len(aw)] = goals[aw] == 1
            gb[len(aw):, 0, 0] = True  # padded rows need one goal cell
            dists = FMMPlanner.solve_batch(tb, gb, n_iters=cfg.fmm_sweeps,
                                           device=sh.device)
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
        for j, i in enumerate(idxs):
            sx, sy, distance, stop, replan = results[j]
            out[i] = (sx - 1, sy - 1, distance, stop, replan)

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
