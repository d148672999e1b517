"""Mask R-CNN R101-FPN (detectron2's GeneralizedRCNN) with fixed shapes
(port of ``peanut_tpu.models.mask_rcnn``).

ResNet caffe-style with frozen BN + FPN(256) + the standard RPN +
StandardROIHeads (2-fc box head, 4-conv mask head).  As in the JAX package,
every stage is fixed-size: candidate sets are padded with -inf scores, NMS
returns suppression masks, and ROIAlign pools every ROI of the batch from
one stacked buffer (``roi_align.py``, kernel B3 on the card).

Modules carry detectron2's names (``backbone.bottom_up.res2.0.conv1``,
``proposal_generator.rpn_head.conv``, ``roi_heads.box_head.fc1``, ...), so
a d2 state dict loads through ``load_d2_state``.  Public functions keep the
JAX package's layout: images (B, H, W, 3) and pyramid levels (B, H_l, W_l,
C); inside, the convolutions run NCHW (channels-last in memory when the
caller converts the model).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .boxes import (anchors_for_level, apply_deltas, batched_nms,
                    clip_boxes, generate_cell_anchors, nms_fixed, top_k)
from .fpn import FPN
from .layers import BatchNorm, Conv2d, lecun_normal_
from .resnet import ResNet
from .roi_align import build_roi_stack, multilevel_roi_align

PIXEL_MEAN_BGR = np.array([103.53, 116.28, 123.675], np.float32)
FPN_STRIDES = (4, 8, 16, 32, 64)
ANCHOR_SIZES = ((32,), (64,), (128,), (256,), (512,))
ASPECT_RATIOS = (0.5, 1.0, 2.0)
RPN_NMS_THRESH = 0.7
RPN_PRE_NMS_TOPK = 1000
RPN_POST_NMS_TOPK = 1000
ROI_NMS_THRESH = 0.5
SCORE_THRESH = 0.05
DETECTIONS_PER_IMAGE = 100
BOX_REG_WEIGHTS = (10.0, 10.0, 5.0, 5.0)


def nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


class RPNHead(nn.Module):
    def __init__(self):
        super().__init__()
        a = len(ASPECT_RATIOS)
        self.conv = Conv2d(256, 256, 3, padding=1)
        self.objectness_logits = Conv2d(256, a, 1)
        self.anchor_deltas = Conv2d(256, a * 4, 1)

    def forward(self, feats: Sequence[torch.Tensor]):
        outs = []
        for f in feats:
            t = F.relu(self.conv(f))
            outs.append((self.objectness_logits(t), self.anchor_deltas(t)))
        return outs


class BoxHead(nn.Module):
    """FastRCNNConvFCHead: 0 convs, 2 fc of 1024."""

    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(256 * 7 * 7, 1024)
        self.fc2 = nn.Linear(1024, 1024)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # (N, 7, 7, C) flattened in torch's (C, H, W) order
        x = nchw(x).reshape(x.shape[0], -1)
        return F.relu(self.fc2(F.relu(self.fc1(x))))


class BoxPredictor(nn.Module):
    def __init__(self, num_classes: int):
        super().__init__()
        self.cls_score = nn.Linear(1024, num_classes + 1)
        self.bbox_pred = nn.Linear(1024, num_classes * 4)

    def forward(self, x: torch.Tensor):
        return self.cls_score(x), self.bbox_pred(x)


class MaskHead(nn.Module):
    """MaskRCNNConvUpsampleHead: 4 convs of 256, a 2x deconv, 1x1
    predictor."""

    def __init__(self, num_classes: int):
        super().__init__()
        for i in range(1, 5):
            self.add_module(f"mask_fcn{i}", Conv2d(256, 256, 3, padding=1))
        self.deconv = nn.ConvTranspose2d(256, 256, 2, stride=2)
        self.predictor = Conv2d(256, num_classes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(1, 5):
            x = F.relu(getattr(self, f"mask_fcn{i}")(x))
        return self.predictor(F.relu(self.deconv(x)))


class MaskRCNN(nn.Module):
    def __init__(self, num_classes: int = 9, depth: int = 101,
                 seed: Optional[int] = None):
        """``seed``: random weights from a ``torch.Generator`` with the flax
        model's initialisers (lecun-normal kernels, zero biases, unit BN;
        RPN normal(0.01), cls_score normal(0.01), bbox_pred
        normal(0.001)).  Unset, the weights are left for a state dict."""
        super().__init__()
        self.num_classes = num_classes
        self.backbone = FPN(ResNet(depth=depth))
        self.proposal_generator = nn.Module()
        self.proposal_generator.rpn_head = RPNHead()
        self.roi_heads = nn.Module()
        self.roi_heads.box_head = BoxHead()
        self.roi_heads.box_predictor = BoxPredictor(num_classes)
        self.roi_heads.mask_head = MaskHead(num_classes)
        self._anchors: Dict = {}
        if seed is not None:
            self.init_random(seed)

    @torch.no_grad()
    def init_random(self, seed: int) -> None:
        gen = torch.Generator().manual_seed(seed)
        special = {"proposal_generator.rpn_head.conv": 0.01,
                   "proposal_generator.rpn_head.objectness_logits": 0.01,
                   "proposal_generator.rpn_head.anchor_deltas": 0.01,
                   "roi_heads.box_predictor.cls_score": 0.01,
                   "roi_heads.box_predictor.bbox_pred": 0.001}
        for name, m in self.named_modules():
            if isinstance(m, BatchNorm):
                for buf, v in (("weight", 1.0), ("bias", 0.0),
                               ("running_mean", 0.0), ("running_var", 1.0)):
                    getattr(m, buf).fill_(v)
            if not isinstance(m, (nn.Conv2d, nn.ConvTranspose2d,
                                  nn.Linear)):
                continue
            w = m.weight
            if name in special:
                w.copy_(torch.normal(0.0, special[name], w.shape,
                                     generator=gen))
            else:
                if isinstance(m, nn.ConvTranspose2d):      # (in, out, kh, kw)
                    fan_in = w.shape[0] * w.shape[2] * w.shape[3]
                else:
                    fan_in = int(np.prod(w.shape[1:]))
                cpu = torch.empty(w.shape)
                w.copy_(lecun_normal_(cpu, fan_in, gen))
            if m.bias is not None:
                m.bias.zero_()

    # ------------------------------------------------------------------
    def features(self, images: torch.Tensor) -> List[torch.Tensor]:
        """(B, H, W, 3) BGR minus the pixel mean, padded to /32 ->
        [P2..P6] as NCHW tensors."""
        return self.backbone(nchw(images))

    def _level_anchors(self, lvl: int, h: int, w: int,
                       device) -> torch.Tensor:
        key = (lvl, h, w, str(device))
        if key not in self._anchors:
            cell = generate_cell_anchors(ANCHOR_SIZES[lvl], ASPECT_RATIOS)
            self._anchors[key] = torch.as_tensor(
                anchors_for_level(h, w, FPN_STRIDES[lvl], cell),
                device=device)
        return self._anchors[key]

    def proposals(self, pyramid: Sequence[torch.Tensor], img_h: int,
                  img_w: int):
        """RPN: per-level top-k -> deltas -> clip -> NMS -> global top-k.
        Returns (B, 1000, 4) boxes and (B, 1000) scores (-inf = none)."""
        rpn_outs = self.proposal_generator.rpn_head(pyramid)
        bsz = pyramid[0].shape[0]
        all_boxes, all_scores = [], []
        for lvl, (obj, delt) in enumerate(rpn_outs):
            h, w = obj.shape[2], obj.shape[3]
            anchors = self._level_anchors(lvl, h, w, obj.device)
            scores = nhwc(obj).reshape(bsz, -1)            # (h, w, a) order
            deltas = nhwc(delt).reshape(bsz, -1, 4)
            k = min(RPN_PRE_NMS_TOPK, scores.shape[1])
            top_scores, idx = top_k(scores, k)
            boxes = apply_deltas(
                torch.gather(deltas, 1, idx[..., None].expand(-1, -1, 4)),
                anchors[idx])
            boxes = clip_boxes(boxes, img_h, img_w)
            if k < RPN_PRE_NMS_TOPK:
                # -inf pads neither keep nor suppress in NMS
                pad = RPN_PRE_NMS_TOPK - k
                boxes = F.pad(boxes, (0, 0, 0, pad))
                top_scores = F.pad(top_scores, (0, pad), value=-math.inf)
            all_boxes.append(boxes)
            all_scores.append(top_scores)
        # one batched NMS over (level, image)
        stk_boxes = torch.stack(all_boxes)               # (L, B, K, 4)
        stk_scores = torch.stack(all_scores)             # (L, B, K)
        kept = nms_fixed(stk_boxes, stk_scores, RPN_NMS_THRESH)
        boxes = torch.cat(list(stk_boxes), dim=1)        # level-major
        scores = torch.cat(list(kept), dim=1)
        top_scores, idx = top_k(scores, RPN_POST_NMS_TOPK)
        return (torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4)),
                top_scores)

    def box_inference(self, pyramid, proposals, prop_scores, img_h: int,
                      img_w: int, roi_ctx=None):
        """ROI box head + per-class NMS -> 100 detections per image."""
        bsz, n = proposals.shape[:2]
        nc = self.num_classes
        feats = [nhwc(f) for f in pyramid[:4]]
        pooled = multilevel_roi_align(feats, proposals, FPN_STRIDES[:4], 7,
                                      ctx=roi_ctx)
        x = self.roi_heads.box_head(pooled.reshape((bsz * n,)
                                                   + pooled.shape[2:]))
        scores, deltas = self.roi_heads.box_predictor(x)
        probs = torch.softmax(scores, dim=-1)[:, :nc].reshape(bsz, n, nc)
        valid = torch.isfinite(prop_scores)
        probs = torch.where(valid[..., None], probs, torch.zeros_like(probs))

        deltas = deltas.reshape(bsz, n, nc, 4)
        boxes_per_class = clip_boxes(apply_deltas(
            deltas, proposals[:, :, None, :], weights=BOX_REG_WEIGHTS),
            img_h, img_w)

        flat_scores = probs.reshape(bsz, -1)              # (B, N*C)
        flat_scores = torch.where(flat_scores > SCORE_THRESH,
                                  flat_scores,
                                  torch.full_like(flat_scores, -math.inf))
        flat_boxes = boxes_per_class.reshape(bsz, -1, 4)
        flat_cls = torch.arange(nc, device=proposals.device).repeat(n)

        k = min(RPN_POST_NMS_TOPK, flat_scores.shape[1])
        cand_scores, idx = top_k(flat_scores, k)
        cand_boxes = torch.gather(flat_boxes, 1,
                                  idx[..., None].expand(-1, -1, 4))
        cand_cls = flat_cls[idx]
        kept = batched_nms(cand_boxes, cand_scores, cand_cls, ROI_NMS_THRESH)
        det_scores, didx = top_k(kept, DETECTIONS_PER_IMAGE)
        return (torch.gather(cand_boxes, 1,
                             didx[..., None].expand(-1, -1, 4)),
                det_scores, torch.gather(cand_cls, 1, didx))

    def mask_inference(self, pyramid, det_boxes, det_classes, roi_ctx=None):
        """(B, N, 28, 28) mask probabilities of each detection's class."""
        bsz, n = det_boxes.shape[:2]
        feats = [nhwc(f) for f in pyramid[:4]]
        pooled = multilevel_roi_align(feats, det_boxes, FPN_STRIDES[:4], 14,
                                      ctx=roi_ctx)
        logits = self.roi_heads.mask_head(
            nchw(pooled.reshape((bsz * n,) + pooled.shape[2:])))
        logits = logits.reshape((bsz, n) + logits.shape[1:])  # (B,N,C,28,28)
        idx = det_classes.long()[:, :, None, None, None].expand(
            -1, -1, 1, *logits.shape[-2:])
        return torch.sigmoid(torch.gather(logits, 2, idx)[:, :, 0])

    def roi_context(self, pyramid) -> dict:
        return build_roi_stack([nhwc(f) for f in pyramid[:4]],
                               FPN_STRIDES[:4])

    def detect_batch(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The whole fixed-shape pipeline on preprocessed (B, H, W, 3)
        images."""
        img_h, img_w = images.shape[1], images.shape[2]
        pyramid = self.features(images)
        proposals, prop_scores = self.proposals(pyramid, img_h, img_w)
        roi_ctx = self.roi_context(pyramid)     # serves both ROI stages
        boxes, scores, classes = self.box_inference(
            pyramid, proposals, prop_scores, img_h, img_w, roi_ctx=roi_ctx)
        masks = self.mask_inference(pyramid, boxes, classes, roi_ctx=roi_ctx)
        return {"boxes": boxes, "scores": scores, "classes": classes,
                "masks": masks}


_D2_IGNORED = ("num_batches_tracked", "anchor_generator", "pixel_")


def load_d2_state(model: MaskRCNN, sd: Dict[str, np.ndarray]) -> MaskRCNN:
    """Load a detectron2 state dict (numpy or tensors) into ``model``;
    raises on missing or unexpected parameters."""
    state = {k: torch.tensor(np.asarray(v)) for k, v in sd.items()
             if not any(s in k for s in _D2_IGNORED)}
    model.load_state_dict(state, strict=True)
    return model
