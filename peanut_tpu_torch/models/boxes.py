"""Box utilities for the detection heads (port of
``peanut_tpu.models.boxes``).

detectron2's Box2BoxTransform and batched NMS with fixed sizes: suppressed
or invalid slots carry -inf scores instead of being dropped.  Plain
PyTorch (none of this is a TPU kernel in the JAX package), but for NMS's
keep set, which the CUDA kernel ``kernels/nms.py::nms_keep`` solves on the
card so that no convergence check stops the host.  Orderings are stable
(``torch.sort(stable=True)``), as ``jnp.argsort`` and ``jax.lax.top_k``
are, so equal scores keep their index order.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

from ..kernels.nms import nms_keep


def apply_deltas(deltas: torch.Tensor, boxes: torch.Tensor,
                 weights=(1.0, 1.0, 1.0, 1.0),
                 scale_clamp: float = math.log(1000.0 / 16)) -> torch.Tensor:
    """Box2BoxTransform.apply_deltas: deltas (..., 4) onto XYXY boxes."""
    wx, wy, ww, wh = weights
    widths = boxes[..., 2] - boxes[..., 0]
    heights = boxes[..., 3] - boxes[..., 1]
    ctr_x = boxes[..., 0] + 0.5 * widths
    ctr_y = boxes[..., 1] + 0.5 * heights

    dx = deltas[..., 0] / wx
    dy = deltas[..., 1] / wy
    dw = torch.clamp(deltas[..., 2] / ww, max=scale_clamp)
    dh = torch.clamp(deltas[..., 3] / wh, max=scale_clamp)

    pred_ctr_x = dx * widths + ctr_x
    pred_ctr_y = dy * heights + ctr_y
    pred_w = torch.exp(dw) * widths
    pred_h = torch.exp(dh) * heights
    return torch.stack([pred_ctr_x - 0.5 * pred_w, pred_ctr_y - 0.5 * pred_h,
                        pred_ctr_x + 0.5 * pred_w, pred_ctr_y + 0.5 * pred_h],
                       dim=-1)


def clip_boxes(boxes: torch.Tensor, img_h: float,
               img_w: float) -> torch.Tensor:
    return torch.stack([boxes[..., 0].clamp(0, img_w),
                        boxes[..., 1].clamp(0, img_h),
                        boxes[..., 2].clamp(0, img_w),
                        boxes[..., 3].clamp(0, img_h)], dim=-1)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    return (torch.clamp(boxes[..., 2] - boxes[..., 0], min=0)
            * torch.clamp(boxes[..., 3] - boxes[..., 1], min=0))


def pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, 4) x (..., M, 4) -> (..., N, M) IoU."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a)[..., :, None] + box_area(b)[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def sort_desc(scores: torch.Tensor, dim: int = -1):
    """(values, indices) in descending order, ties in index order (the
    order of ``jax.lax.top_k``)."""
    return torch.sort(scores, dim=dim, descending=True, stable=True)


def top_k(scores: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: stable, unlike torch.topk."""
    vals, idx = sort_desc(scores)
    return vals[..., :k], idx[..., :k]


def nms_fixed(boxes: torch.Tensor, scores: torch.Tensor,
              iou_threshold: float) -> torch.Tensor:
    """Greedy NMS with fixed shapes, batched over leading axes:
    (..., n, 4) boxes and (..., n) scores -> scores with the suppressed
    entries set to -inf (input order kept).

    The greedy keep set is the fixed point of
    ``keep[j] = valid[j] & !any_i(keep[i] & S[i, j])`` (S: the
    higher-scored box i overlaps j past the threshold): ``nms_keep``, on
    the CPU the JAX version's bounding rounds, on the card a kernel."""
    n = boxes.shape[-2]
    lead = boxes.shape[:-2]
    order = torch.sort(-scores, dim=-1, stable=True).indices
    b = torch.gather(boxes, -2, order[..., None].expand(*lead, n, 4))
    valid = torch.isfinite(torch.gather(scores, -1, order))
    iou = pairwise_iou(b, b)
    tri = torch.triu(torch.ones((n, n), dtype=torch.bool,
                                device=boxes.device), 1)
    kept = nms_keep((iou > iou_threshold) & tri, valid)
    keep = torch.zeros_like(kept).scatter(-1, order, kept)
    return torch.where(keep, scores, torch.full_like(scores, -math.inf))


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor, idxs: torch.Tensor,
                iou_threshold: float) -> torch.Tensor:
    """Category-aware NMS by the coordinate-offset trick (boxes of
    different idxs never suppress each other), batched over leading axes."""
    fin = torch.isfinite(scores)[..., None]
    max_coord = torch.where(fin, boxes, torch.zeros_like(boxes)).amax(
        dim=(-2, -1), keepdim=True)
    offsets = idxs.to(boxes.dtype) * (max_coord[..., 0] + 1.0)
    return nms_fixed(boxes + offsets[..., None], scores, iou_threshold)


# ----------------------------------------------------------------------
# Anchor generation (DefaultAnchorGenerator, offset 0)
# ----------------------------------------------------------------------

def generate_cell_anchors(sizes: Sequence[float],
                          aspect_ratios: Sequence[float]) -> np.ndarray:
    """(A, 4) XYXY anchors centred at (0, 0), detectron2's convention."""
    anchors = []
    for size in sizes:
        area = size ** 2
        for ar in aspect_ratios:
            w = math.sqrt(area / ar)
            h = ar * w
            anchors.append([-w / 2.0, -h / 2.0, w / 2.0, h / 2.0])
    return np.asarray(anchors, np.float32)


def anchors_for_level(feat_h: int, feat_w: int, stride: int,
                      cell_anchors: np.ndarray,
                      offset: float = 0.0) -> np.ndarray:
    """(H*W*A, 4) anchors for one pyramid level, in (h, w, a) order."""
    shift_x = (np.arange(feat_w) + offset) * stride
    shift_y = (np.arange(feat_h) + offset) * stride
    sx, sy = np.meshgrid(shift_x, shift_y)
    shifts = np.stack([sx.ravel(), sy.ravel(), sx.ravel(), sy.ravel()],
                      axis=1)
    all_anchors = shifts[:, None, :] + cell_anchors[None, :, :]
    return all_anchors.reshape(-1, 4).astype(np.float32)
