"""Agent configuration of the PyTorch port: a copy of ``peanut_tpu.config``.

The port keeps its own copy so that it never imports the JAX package.  The
fields, names and defaults are the same as the JAX package's ``NavConfig``
(which mirrors PEANUT's ``nav/arguments.py`` flags one-to-one), so a config
built for one package builds the other with ``NavConfig(**asdict(cfg))``.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass
class NavConfig:
    """Agent/navigation configuration.

    Field defaults replicate PEANUT's nav/arguments.py:5-118.
    """

    # General
    # None = "not specified": consumers fall back to the reference default
    # (1, arguments.py:10) or a surface-specific one (collect's fake-env
    # 100) — an explicit --seed 1 is then distinguishable from the default
    seed: Optional[int] = None
    start_ep: int = 0
    end_ep: int = -1
    visualize: int = 0           # 1: on screen, 2: dump jpgs
    exp_name: str = "exp1"
    dump_location: str = "./data/tmp/"

    # Model weights / configs
    seg_model_wts: str = "nav/agent/utils/mask_rcnn_R_101_cat9.pth"
    pred_model_wts: str = "./nav/pred_model_wts.pth"
    pred_model_cfg: str = ""     # optional dict-config path; default built-in
    prediction_window: int = 720

    # Environment frames
    env_frame_width: int = 640
    env_frame_height: int = 480
    frame_width: int = 160
    frame_height: int = 120
    max_episode_length: int = 500
    camera_height: float = 0.88  # metres
    hfov: float = 79.0
    turn_angle: float = 30.0
    min_depth: float = 0.5
    max_depth: float = 5.0

    num_local_steps: int = 20

    # Mapping
    num_sem_categories: int = 10
    sem_pred_prob_thr: float = 0.95
    goal_thr: float = 0.985
    global_downscaling: int = 2
    vision_range: int = 100
    map_resolution: int = 5      # cm per cell
    du_scale: int = 1
    map_size_cm: int = 4800
    cat_pred_threshold: float = 5.0
    map_pred_threshold: float = 0.1
    exp_pred_threshold: float = 1.0

    col_rad: int = 4
    goal_erode: int = 3
    collision_threshold: float = 0.20
    evaluation: Optional[str] = None  # "local" | "remote"

    # Stubborn details (reference arguments.py:93-97)
    timestep_limit: int = 499
    grid_resolution: int = 24
    magnify_goal_when_hard: int = 100
    move_forward_after_stop: int = 1

    # Long-term goal selection (reference arguments.py:99-107)
    dist_weight_temperature: float = 500.0
    goal_reached_dist: float = 75.0
    update_goal_freq: int = 10
    switch_step: int = 0

    # Data collection
    use_gt_seg: int = 0
    only_explore: int = 0

    # --- TPU-framework-specific knobs (no reference counterpart) ---
    num_envs: int = 1            # parallel episodes batched on device
    exact_parity: bool = True    # bit-faithful splat rounding vs. fast path
    serve_bf16: bool = False     # cast CNN weights/activations for serving
    seg_batch_chunk: int = 8     # Mask R-CNN frames per detect program
                                 # (bounds HBM; 16-env runs use 2 chunks)
    fmm_sweeps: int = 2          # fast-sweeping iterations for eikonal solve
    dd_downscale: int = 1        # goal-weighting geodesic field resolution
                                 # divisor; 2 = serving profile (solve the
                                 # exp(-dd/T) weighting field on an OR-
                                 # pooled half-res grid, ~4x cheaper; the
                                 # local planning solve is never downscaled)
    dd_order: int = 2            # goal-weighting field Godunov order;
                                 # 1 = serving profile (skip the order-2
                                 # refinement sweeps; time-neutral on the
                                 # TPU Pallas sweeps, cheaper on the XLA
                                 # CPU path).  The local planning solve
                                 # always stays order 2 (skfmm parity).
                                 # Like dd_downscale, guarded to T > 0.
    plan_block: int = 16         # STG planning-field sweep tiling; the
    plan_inner: int = 40         # serving profile uses block=8/inner=24
                                 # (1.35x faster at 480^2; agent-distance
                                 # error <=2.3 cells at worst-case far-
                                 # field geometry, and stop decisions are
                                 # near-goal where sweeps converge first —
                                 # decision test in test_fmm_oracle.py).
                                 # Default = exact tiling (parity mode).
    pred_async: int = 0          # serving profile: run the prediction +
                                 # goal-weighting program ASYNC after the
                                 # tick (overlapping host env stepping)
                                 # instead of inside it.  Same computation
                                 # (shared pred_goal_update closure, on the
                                 # same post-shuttle maps the sync block
                                 # reads); the selected goal is applied one
                                 # tick later.  Found-goal STOP behavior is
                                 # unaffected (stays in-tick).  0 = exact
                                 # reference phasing (agent_state.py:
                                 # 345-415 runs before the plan solve).
    dd_block: int = 16           # goal-weighting field sweep tiling;
    dd_inner: int = 40           # serving profile uses block=8/inner=24
                                 # (~1.4x faster, max oracle error 1.55 vs
                                 # 1.48 cells on 240^2 cluttered plans;
                                 # decision parity pinned by the goal-
                                 # argmax oracle suite).  The STG planning
                                 # solve always keeps the exact tiling.
                                 # Guarded to T > 0 like dd_downscale.
    platform: Optional[str] = None  # JAX package only; unused by the port

    # ------------------------------------------------------------------
    # Derived geometry
    # ------------------------------------------------------------------
    @property
    def map_size(self) -> int:
        """Cells per side of the full map (reference agent_state.py:41)."""
        return self.map_size_cm // self.map_resolution

    @property
    def full_w(self) -> int:
        return self.map_size

    @property
    def full_h(self) -> int:
        return self.map_size

    @property
    def local_w(self) -> int:
        return int(self.full_w / self.global_downscaling)

    @property
    def local_h(self) -> int:
        return int(self.full_h / self.global_downscaling)

    @property
    def num_map_channels(self) -> int:
        """4 fixed channels + semantic categories (agent_state.py:39)."""
        return 4 + self.num_sem_categories

    def replace(self, **kw) -> "NavConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    # argparse bridge (same flag spelling as the reference CLI)
    # ------------------------------------------------------------------
    @classmethod
    def add_args(cls, parser: argparse.ArgumentParser) -> argparse.ArgumentParser:
        for f in dataclasses.fields(cls):
            name = "--" + f.name
            default = f.default
            if f.name == "visualize":
                parser.add_argument("-v", name, type=int, default=default)
            elif f.name == "dump_location":
                parser.add_argument("-d", name, type=str, default=default)
            elif isinstance(default, bool):
                parser.add_argument(name, type=int, default=int(default))
            elif f.name == "seed":
                parser.add_argument(name, type=int, default=None)
            elif default is None:
                parser.add_argument(name, type=str, default=None)
            else:
                parser.add_argument(name, type=type(default), default=default)
        return parser

    @classmethod
    def from_args(cls, argv=None) -> "NavConfig":
        parser = argparse.ArgumentParser(description="PEANUT-TPU")
        cls.add_args(parser)
        ns, _ = parser.parse_known_args(argv)
        kw = {f.name: getattr(ns, f.name) for f in dataclasses.fields(cls)}
        if isinstance(kw.get("exact_parity"), int):
            kw["exact_parity"] = bool(kw["exact_parity"])
        return cls(**kw)
