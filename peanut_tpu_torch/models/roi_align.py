"""Multi-level ROIAlign (port of ``peanut_tpu.models.roi_align``).

detectron2's ROIAlignV2 (aligned=True) with its adaptive ratio-0 grid: per
ROI, ``g = ceil(roi_size / pooled_size)`` samples per bin per axis, held in
``gmax`` masked slots so every shape is fixed.  The FPN levels (and the
image batch) are stacked along H into one (rows, max_w, C) buffer, and each
ROI's pooling is ``A_y @ W @ A_x^T`` over a window ``W`` of that buffer with
separable bilinear hat matrices (``kernels/roi_window.py``; on the card the
CUDA kernel B3, on the CPU its plain version).  Window rows and columns that
alias other levels or images carry zero hat weight; cells beyond the buffer
read as zero.

Window exactness, as in the JAX package: a box on a non-coarsest level has
a bounded cell area (784 cells for the standard parameters), so a ROI can
overflow the square ``win x win`` window on one axis only, and is then thin
on the other.  Overflowing ROIs take an x-elongated ``thin x (fin_w + 2)``
or a y-elongated ``long_y x thin`` window.  The JAX package runs those
passes on a fixed tail of 256-ROI chunks after a stable sort, so only the
last ``n_tail * 256`` overflow ROIs in index order get the exact result;
the others keep the square one.  The port keeps that rule (it is part of
the result) and runs the two elongated passes on exactly those ROIs,
through an index list of fixed length, with no host sync.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import upload
from ..kernels.fmm import _fma, _sqrt
from ..kernels.roi_window import roi_window_pool

ROI_CHUNK = 256     # the JAX package's chunk of ROIs (sets the tail budget)
SUB_CHUNK = 64      # its chunk below ROI_CHUNK ROIs (sets the padding)


def assign_fpn_levels(boxes: torch.Tensor, k_min: int = 2, k_max: int = 5,
                      canonical_size: float = 224.0,
                      canonical_level: int = 4) -> torch.Tensor:
    """d2 assign_boxes_to_levels: level = floor(k0 + log2(sqrt(area)/224)),
    returned as 0-based level indices."""
    area = (torch.clamp(boxes[..., 2] - boxes[..., 0], min=0)
            * torch.clamp(boxes[..., 3] - boxes[..., 1], min=0))
    s = _sqrt(area)
    lvl = torch.floor(canonical_level
                      + torch.log2(s / canonical_size + 1e-8))
    return torch.clamp(lvl, k_min, k_max).long() - k_min


def stack_pyramid(feats: Sequence[torch.Tensor]
                  ) -> Tuple[torch.Tensor, np.ndarray, np.ndarray]:
    """Concatenate (..., H_l, W_l, C) levels along H, right zero padding to
    a common W.  Returns (stacked (..., sumH, maxW, C), row offsets (L,),
    heights (L,))."""
    max_w = max(f.shape[-2] for f in feats)
    padded = [F.pad(f, (0, 0, 0, max_w - f.shape[-2])) for f in feats]
    offsets = np.cumsum([0] + [f.shape[-3] for f in feats[:-1]])
    heights = np.array([f.shape[-3] for f in feats])
    return torch.cat(padded, dim=-3), offsets, heights


def _ceil8(v: float) -> int:
    return int(-(-int(np.ceil(v)) // 8) * 8)


def _cell_area_bound(strides: Sequence[int], k_min: int = 2,
                     canonical_size: float = 224.0,
                     canonical_level: int = 4) -> float:
    """Max cell area of a ROI assigned to any non-coarsest level."""
    bound = 0.0
    for i, st in enumerate(list(strides)[:-1]):
        lvl = k_min + i
        smax = canonical_size * (2.0 ** (lvl - canonical_level + 1))
        bound = max(bound, (smax / st) ** 2)
    return bound


def build_roi_stack(feats: Sequence[torch.Tensor],
                    strides: Sequence[int]) -> dict:
    """The stacked pyramid buffer and the static window geometry of
    batched (B, H_l, W_l, C) levels.  Depends only on the pyramid, so one
    context serves both ROI stages of a detect."""
    bsz = feats[0].shape[0]
    c = feats[0].shape[-1]
    stacked, row_off, heights = stack_pyramid(feats)   # (B, sumH, maxW, C)
    sum_h = int(heights.sum())
    max_w = stacked.shape[2]
    stacked = stacked.reshape(bsz * sum_h, max_w, c)

    fin_h, fin_w = feats[0].shape[-3], feats[0].shape[-2]
    max_coarse = max(feats[-1].shape[-3], feats[-1].shape[-2])
    area_bound = _cell_area_bound(strides)
    win = _ceil8(max(max_coarse + 4, np.sqrt(area_bound) + 4))
    win = int(min(win, _ceil8(max(sum_h, max_w))))
    thin = int(np.ceil(area_bound / max(win - 3, 1) + 3)) + 1
    long_y = _ceil8(fin_h + 2)
    square_covers_all = win >= max(_ceil8(fin_w + 2), long_y)
    return dict(stacked=stacked, row_off=row_off, heights=heights,
                widths=np.array([f.shape[-2] for f in feats]), sum_h=sum_h,
                max_w=max_w, win=win, thin=thin, long_y=long_y,
                long_x=fin_w + 2, square_covers_all=square_covers_all,
                fin_h=fin_h, fin_w=fin_w, c=c, bsz=bsz)


def hat_matrix(sam: torch.Tensor, msk: torch.Tensor, origin: torch.Tensor,
               length: int) -> torch.Tensor:
    """(m, p, s) sample coordinates + (m, s) slot mask -> (m, p, length)
    bilinear weights of the window rows origin .. origin + length - 1."""
    r_idx = torch.arange(length, dtype=torch.float32, device=sam.device)
    local = sam - origin[:, None, None]
    hat = torch.clamp(1.0 - torch.abs(local[..., None] - r_idx), 0.0, 1.0)
    return (hat * msk[:, None, :, None]).sum(dim=2)


def overflow_budget(n: int) -> int:
    """How many overflow ROIs get the elongated passes: the JAX package's
    tail of ``n_tail`` 256-ROI chunks (every ROI when they fit in one)."""
    pad_n = (-n) % SUB_CHUNK if n <= ROI_CHUNK else (-n) % ROI_CHUNK
    np_ = n + pad_n
    if np_ <= ROI_CHUNK:
        return n
    n_tail = max(1, (np_ // ROI_CHUNK) // 8)
    return min(n, n_tail * ROI_CHUNK)


def multilevel_roi_align(feats: Sequence[torch.Tensor], boxes: torch.Tensor,
                         strides: Sequence[int], output_size: int,
                         ctx: Optional[dict] = None) -> torch.Tensor:
    """ROIAlign over an FPN pyramid (d2 ROIAlignV2 semantics, the adaptive
    ratio-0 grid).

    Args:
      feats: per-level (B, H_l, W_l, C) maps, fine to coarse.
      boxes: (B, N, 4) XYXY in input-image pixels (box i of image b pools
        from image b's pyramid).
      strides: per-level feature strides (4, 8, 16, 32).
      output_size: pooled resolution P.
      ctx: ``build_roi_stack(feats, strides)``, to share between calls.

    Returns:
      (B, N, P, P, C) pooled features in the features' dtype.
    """
    if ctx is None:
        ctx = build_roi_stack(feats, strides)
    dev = boxes.device
    f32 = dict(dtype=torch.float32, device=dev)
    bsz, nroi = boxes.shape[0], boxes.shape[1]
    c, p = ctx["c"], output_size
    stacked = ctx["stacked"]

    n = bsz * nroi
    boxes = boxes.reshape(n, 4).float()
    levels = assign_fpn_levels(boxes)
    stride = upload(list(strides), dev, torch.float32)[levels]
    batch_off = (torch.arange(bsz, **f32) * ctx["sum_h"]).repeat_interleave(
        nroi)
    lvl_off = upload(ctx["row_off"], dev, torch.float32)[levels] + batch_off
    lvl_h = upload(ctx["heights"], dev, torch.float32)[levels]
    lvl_w = upload(ctx["widths"], dev, torch.float32)[levels]

    # ROI in level-feature coordinates, aligned=True (-0.5 pixel shift)
    x1 = boxes[:, 0] / stride - 0.5
    y1 = boxes[:, 1] / stride - 0.5
    x2 = boxes[:, 2] / stride - 0.5
    y2 = boxes[:, 3] / stride - 0.5
    roi_w = x2 - x1
    roi_h = y2 - y1
    bin_w = roi_w / p
    bin_h = roi_h / p

    # gmax = ceil(finest extent / p) covers every in-image ROI's d2 sample
    # count (the finest level has the largest extent)
    s = max(1, int(-(-max(ctx["fin_h"], ctx["fin_w"]) // p)))
    gx = torch.clamp(torch.ceil(roi_w / p), 1.0, s)
    gy = torch.clamp(torch.ceil(roi_h / p), 1.0, s)

    # bin b, slot j at fraction (j + 0.5) / g of the bin; slots j >= g are
    # masked out of the average
    slots = torch.arange(s, **f32)
    frac_x = (slots[None, :] + 0.5) / gx[:, None]
    frac_y = (slots[None, :] + 0.5) / gy[:, None]
    mask_x = (slots[None, :] < gx[:, None]).float()
    mask_y = (slots[None, :] < gy[:, None]).float()
    bins = torch.arange(p, **f32)
    # (n, p, s) sample coordinates, clamped into the level (d2 clamps).
    # Each is one multiply-add rounded once, as XLA's CPU backend contracts
    # it (an FMA), so the coordinates are the JAX package's bit for bit
    def clamp_to(v, hi):
        return torch.minimum(torch.clamp(v, min=0.0), hi)

    sample_x = clamp_to(_fma(bins[None, :, None] + frac_x[:, None, :],
                             bin_w[:, None, None], x1[:, None, None]),
                        lvl_w[:, None, None] - 1.0)
    sample_y = clamp_to(_fma(bins[None, :, None] + frac_y[:, None, :],
                             bin_h[:, None, None], y1[:, None, None]),
                        lvl_h[:, None, None] - 1.0)

    # live-sample extremes, analytically (first live slot at bin 0
    # fraction 0.5/g, last at bin p-1 fraction (g-0.5)/g): masked slots
    # must not count, or nearly every ROI would look like it overflows
    min_sx = clamp_to(_fma(0.5 / gx, bin_w, x1), lvl_w - 1.0)
    max_sx = clamp_to(_fma((p - 1) + (gx - 0.5) / gx, bin_w, x1),
                      lvl_w - 1.0)
    min_sy = clamp_to(_fma(0.5 / gy, bin_h, y1), lvl_h - 1.0)
    max_sy = clamp_to(_fma((p - 1) + (gy - 0.5) / gy, bin_h, y1),
                      lvl_h - 1.0)
    oy = torch.clamp(torch.floor(min_sy), min=0.0)
    ox = torch.clamp(torch.floor(min_sx), min=0.0)
    win = ctx["win"]
    fit_x = (max_sx - ox) <= win - 2
    fit_y = (max_sy - oy) <= win - 2
    cnt = torch.clamp(gx * gy, min=1.0)[:, None, None, None]
    row0 = (oy + lvl_off).int()
    col0 = ox.int()

    def pool(idx, win_y, win_x):
        """ROIs ``idx`` (a slice or an index list) over win_y x win_x
        windows."""
        ay = hat_matrix(sample_y[idx], mask_y[idx], oy[idx], win_y)
        ax = hat_matrix(sample_x[idx], mask_x[idx], ox[idx], win_x)
        return roi_window_pool(stacked, ay, ax, row0[idx], col0[idx], win_y,
                               win_x)

    out = pool(slice(None), win, win) / cnt
    if not ctx["square_covers_all"] and n:
        overflow = ~(fit_x & fit_y)
        # the stable sort puts the overflow ROIs last, in index order: its
        # tail holds the last `budget` of them (and, when fewer overflow,
        # some ROIs that fit, which keep their square result below)
        budget = overflow_budget(n)
        order = torch.sort(overflow.to(torch.uint8), stable=True).indices
        sel = order[n - budget:]
        pb = pool(sel, ctx["thin"], ctx["long_x"])      # x-elongated
        pc = pool(sel, ctx["long_y"], ctx["thin"])      # y-elongated
        po = torch.where(fit_x[sel][:, None, None, None], pc, pb) / cnt[sel]
        out[sel] = torch.where(overflow[sel][:, None, None, None], po,
                               out[sel])
    return out.to(feats[0].dtype).reshape(bsz, nroi, p, p, c)
