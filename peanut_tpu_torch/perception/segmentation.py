"""Segmentation front end (port of ``peanut_tpu.perception.segmentation``).

PEANUT accumulates per-frame instance masks into an (H, W, n_cats+1) channel
stack with a confidence gate ``sem_pred_prob_thr`` and a stricter
``goal_thr`` for the episode's target category (nav/agent/utils/
segmentation.py:28-62).  ``accumulate_instances`` keeps those semantics for
every backend.  This slice ports the ground-truth segmenters
(``use_gt_seg=1``: the goal channel from the simulator; ``use_gt_seg=2``:
the full stack) and the zero segmenter, which only a caller that names it
gets.  The Mask R-CNN segmenter (``use_gt_seg=0``) is ROADMAP A9.
"""

from __future__ import annotations

from typing import Optional, Protocol

import numpy as np

from ..config import NavConfig


def accumulate_instances(classes: np.ndarray, scores: np.ndarray,
                         masks: np.ndarray, n_cats: int,
                         score_thr: float, goal_thr: float,
                         goal_cat: Optional[int], out_hw) -> np.ndarray:
    """Fold per-instance masks into a per-category channel stack.

    classes: (N,), scores: (N,), masks: (N, H, W) bool/float.
    Matches reference segmentation.py:47-61 (additive accumulation, channel
    ``n_cats`` left as the implicit 'other' channel).
    """
    h, w = out_hw
    out = np.zeros((h, w, n_cats + 1), np.float32)
    for cls, score, mask in zip(classes, scores, masks):
        cls = int(cls)
        if cls < 0 or cls >= n_cats:
            continue
        if score < score_thr:
            continue
        if goal_cat is not None and cls == goal_cat and score < goal_thr:
            continue
        out[:, :, cls] += mask.astype(np.float32)
    return out


class Segmenter(Protocol):
    def __call__(self, rgb: np.ndarray, depth: Optional[np.ndarray] = None,
                 goal_cat: Optional[int] = None) -> np.ndarray:
        """rgb: (H, W, 3) uint8 -> (H, W, n_cats+1) float32 mask stack."""
        ...


class GroundTruthSegmenter:
    """use_gt_seg mode: the goal channel comes from the simulator's GT."""

    def __init__(self, cfg: NavConfig):
        self.n_cats = cfg.num_sem_categories - 1
        self.goalseg: Optional[np.ndarray] = None  # set per-step by the agent

    def __call__(self, rgb, depth=None, goal_cat=None):
        h, w = rgb.shape[:2]
        out = np.zeros((h, w, self.n_cats + 1), np.float32)
        if self.goalseg is not None and goal_cat is not None:
            out[:, :, goal_cat] = self.goalseg
        return out


class FullGTSegmenter:
    """use_gt_seg=2: full multi-category ground truth (synthetic envs /
    oracle ablations).  Consumes the env's (H, W, n_cats+1) 'gtsem' stack."""

    def __init__(self, cfg: NavConfig):
        self.n_cats = cfg.num_sem_categories - 1
        self.gtsem: Optional[np.ndarray] = None

    def set_observation(self, obs) -> None:
        self.gtsem = obs.get("gtsem")

    def __call__(self, rgb, depth=None, goal_cat=None):
        h, w = rgb.shape[:2]
        if self.gtsem is not None:
            return np.asarray(self.gtsem, np.float32)
        return np.zeros((h, w, self.n_cats + 1), np.float32)


class ZeroSegmenter:
    """No semantics at all (exploration-only collection without GT).  Only
    a caller that passes it explicitly gets it: build_segmenter never falls
    back to it."""

    def __init__(self, cfg: NavConfig):
        self.n_cats = cfg.num_sem_categories - 1

    def __call__(self, rgb, depth=None, goal_cat=None):
        h, w = rgb.shape[:2]
        return np.zeros((h, w, self.n_cats + 1), np.float32)


def build_segmenter(cfg: NavConfig) -> Segmenter:
    """Pick the segmentation backend for a run."""
    if cfg.use_gt_seg == 2:
        return FullGTSegmenter(cfg)
    if cfg.use_gt_seg:
        return GroundTruthSegmenter(cfg)
    raise NotImplementedError(
        "use_gt_seg=0 needs the Mask R-CNN segmenter, which the PyTorch "
        "port does not have yet (ROADMAP A9)")
