"""Mask R-CNN segmentation on the device (port of the device path of
``peanut_tpu.perception.mask_rcnn_segmenter``).

``batch_device`` takes uint8 RGB frames and returns the (B, n_sem, fh, fw)
float32 semantic stack the tick consumes, without a host round trip:
RGB -> BGR, detectron2's shortest-edge-800 resize (two matrix products),
mean subtraction, padding to /32, detect in chunks of ``seg_batch_chunk``
frames, then each detection's 28x28 mask pasted at the mapper's strided
pixel centres and accumulated per class behind the confidence gates of
PEANUT's segmentation.py:47-61 (``sem_pred_prob_thr``, ``goal_thr``).

The single-env agent's host API, ``__call__`` and ``batch``, returns what the
JAX package's does, (H, W, n_sem) float32 stacks at the env frame's full
resolution, computed through the same preprocessing, detect and device
paste (every env pixel's centre instead of the strided ones) and brought
back to the host.  The JAX package pastes those with cv2, which differs
from the device paste only at the 0.5-tie pixels (PARITY.md delta 5); the
card has no cv2.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device, upload
from ..config import NavConfig
from ..models.checkpoint import load_torch_state_dict
from ..models.mask_rcnn import MaskRCNN, PIXEL_MEAN_BGR, load_d2_state
from ..models.ops import resize_bilinear


def resize_shortest_edge(h: int, w: int, short: int = 800,
                         max_size: int = 1333) -> Tuple[int, int]:
    """detectron2 ResizeShortestEdge output size for (h, w)."""
    scale = short / min(h, w)
    if max(h, w) * scale > max_size:
        scale = max_size / max(h, w)
    nh, nw = h * scale, w * scale
    return int(nh + 0.5), int(nw + 0.5)


def pad_to_multiple(h: int, w: int, div: int = 32) -> Tuple[int, int]:
    return -(-h // div) * div, -(-w // div) * div


class MaskRCNNSegmenter:
    def __init__(self, cfg: NavConfig, state_dict=None,
                 model: Optional[MaskRCNN] = None, device=None):
        """Weights: ``model`` (taken over: moved and cast in place), else
        ``state_dict`` (detectron2 keys), else the checkpoint at
        ``cfg.seg_model_wts`` (FileNotFoundError when it is missing).
        ``device``: ``resolve_device`` (the card unless ``"cpu"``).
        ``cfg.serve_bf16`` casts the weights to bfloat16; detections come
        back as float32."""
        self.cfg = cfg
        self.n_cats = cfg.num_sem_categories - 1
        if model is None:
            if state_dict is None:
                state_dict = load_torch_state_dict(
                    cfg.seg_model_wts, "Mask R-CNN", "seg_model_wts")
            model = load_d2_state(MaskRCNN(num_classes=self.n_cats),
                                  state_dict)
        self.device = resolve_device(device)
        h, w = cfg.env_frame_height, cfg.env_frame_width
        self.rh, self.rw = resize_shortest_edge(h, w)
        self.ph, self.pw = pad_to_multiple(self.rh, self.rw)
        self.dtype = torch.bfloat16 if cfg.serve_bf16 else torch.float32
        model = model.to(device=self.device, dtype=self.dtype).eval()
        if self.device.type == "cuda":
            model = model.to(memory_format=torch.channels_last)
        self.model = model
        # R101-FPN at 800x1088 peaks near 1.2 GB a frame in bf16: detect in
        # chunks of this many frames
        self.chunk = int(getattr(cfg, "seg_batch_chunk", 8) or 8)
        eh, ew = cfg.env_frame_height, cfg.env_frame_width
        ds = ew // cfg.frame_width
        # output pixel centres in env coordinates: the [ds//2::ds]
        # subsample of full-resolution pasted masks (_pack_obs convention)
        self._py = torch.as_tensor(
            np.arange(cfg.frame_height) * ds + ds // 2,
            dtype=torch.float32, device=self.device)
        self._px = torch.as_tensor(
            np.arange(cfg.frame_width) * ds + ds // 2,
            dtype=torch.float32, device=self.device)
        self._scale = (eh / self.rh, ew / self.rw)
        self._mean = upload(PIXEL_MEAN_BGR, self.device)

    def _detect_stage(self, imgs: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Padded preprocessed chunk -> {boxes, scores, classes, masks}.
        Tests swap in a synthetic head here and keep the rest live."""
        return self.model.detect_batch(imgs)

    def paste(self, boxes, scores, classes, masks, goal_cats: torch.Tensor,
              full_res: bool = False) -> torch.Tensor:
        """Gate and paste (B, nd) detections into (B, n_cats, fh, fw), or
        (B, n_cats, eh, ew) with ``full_res``.

        Each 28x28 mask is sampled at the strided env-pixel centres (every
        env pixel's with ``full_res``) with cv2.INTER_LINEAR coordinates
        ((q + 0.5) * src / dst - 0.5) as separable hat matrices, and
        thresholded at 0.5."""
        cfg = self.cfg
        eh, ew = cfg.env_frame_height, cfg.env_frame_width
        scale_y, scale_x = self._scale
        if full_res:
            py = torch.arange(eh, dtype=torch.float32, device=boxes.device)
            px = torch.arange(ew, dtype=torch.float32, device=boxes.device)
        else:
            py, px = self._py, self._px
        x1 = torch.clamp(torch.floor(boxes[..., 0] * scale_x), 0, ew)
        y1 = torch.clamp(torch.floor(boxes[..., 1] * scale_y), 0, eh)
        x2 = torch.clamp(torch.ceil(boxes[..., 2] * scale_x), 0, ew)
        y2 = torch.clamp(torch.ceil(boxes[..., 3] * scale_y), 0, eh)
        bw = x2 - x1
        bh = y2 - y1
        valid = (torch.isfinite(scores) & (scores >= cfg.sem_pred_prob_thr)
                 & (classes >= 0) & (classes < self.n_cats)
                 & (bw > 0) & (bh > 0))
        valid &= torch.where(classes == goal_cats[:, None],
                             scores >= cfg.goal_thr,
                             torch.ones_like(valid))

        sy = (py - y1[..., None] + 0.5) * (28.0 / bh[..., None]) - 0.5
        sx = (px - x1[..., None] + 0.5) * (28.0 / bw[..., None]) - 0.5
        in_y = (py >= y1[..., None]) & (py < y2[..., None])
        in_x = (px >= x1[..., None]) & (px < x2[..., None])
        k = torch.arange(28, dtype=torch.float32, device=boxes.device)
        ay = torch.clamp(1.0 - torch.abs(torch.clamp(sy, 0.0, 27.0)[..., None]
                                         - k), 0.0, 1.0)
        ax = torch.clamp(1.0 - torch.abs(torch.clamp(sx, 0.0, 27.0)[..., None]
                                         - k), 0.0, 1.0)
        t = torch.einsum("bnkl,bnwl->bnkw", masks, ax)
        v = torch.einsum("bnhk,bnkw->bnhw", ay, t)
        m = ((v > 0.5) & in_y[..., :, None] & in_x[..., None, :]
             & valid[..., None, None]).float()
        onehot = (classes[..., None] == torch.arange(
            self.n_cats, device=boxes.device)).float()
        return torch.einsum("bnhw,bnc->bchw", m, onehot)

    def preprocess(self, rgb: torch.Tensor) -> torch.Tensor:
        """(B, eh, ew, 3) uint8 RGB on the device -> (B, ph, pw, 3) BGR
        minus the pixel mean, padded, in the serving type.  The resize runs
        in float32 (the weight matrices promote it, as in the JAX program)
        and meets the serving-rounded mean."""
        img = rgb.flip(-1).to(self.dtype)                  # BGR
        img = resize_bilinear(img, (self.rh, self.rw))
        img = img - self._mean.to(self.dtype)
        img = F.pad(img, (0, 0, 0, self.pw - self.rw, 0, self.ph - self.rh))
        return img.to(self.dtype)

    def batch_device(self, rgbs_u8, goal_cats) -> torch.Tensor:
        """(B, eh, ew, 3) uint8 RGB (numpy, or a tensor already on the
        device) -> (B, n_sem, fh, fw) float32 semantic stack on the
        device."""
        return self._segment(rgbs_u8, goal_cats, self.chunk, False)

    @torch.no_grad()
    def _segment(self, rgbs_u8, goal_cats, chunk: int,
                 full_res: bool) -> torch.Tensor:
        """Preprocess, detect in chunks of ``chunk`` frames (the last
        padded with black frames) and paste: (B, n_sem, fh, fw), or
        (B, n_sem, eh, ew) with ``full_res``."""
        rgb = upload(rgbs_u8, self.device)
        b = rgb.shape[0]
        pad = (-b) % chunk
        goal = upload(np.pad(np.asarray(goal_cats, np.int64), (0, pad)),
                      self.device)
        if pad:
            rgb = torch.cat([rgb, rgb.new_zeros((pad,) + rgb.shape[1:])])
        img = self.preprocess(rgb)
        dets = []
        for lo in range(0, img.shape[0], chunk):
            det = self._detect_stage(img[lo:lo + chunk])
            dets.append({k: v.float() if v.is_floating_point() else v
                         for k, v in det.items()})
        det = {k: torch.cat([d[k] for d in dets]) for k in dets[0]}
        sem = self.paste(det["boxes"], det["scores"], det["classes"],
                         det["masks"], goal, full_res=full_res)
        pad_ch = self.cfg.num_sem_categories - self.n_cats
        return F.pad(sem, (0, 0, 0, 0, 0, pad_ch))[:b]

    def batch(self, rgbs, goal_cats) -> list:
        """Host frames -> a list of (eh, ew, n_sem) float32 stacks (the
        JAX package's ``batch``), detected on the device in chunks of
        ``min(seg_batch_chunk, len(rgbs))`` frames."""
        sem = self._segment(np.stack([np.asarray(r, np.uint8)
                                      for r in rgbs]),
                            [-1 if g is None else g for g in goal_cats],
                            min(self.chunk, len(rgbs)), True)
        return list(sem.permute(0, 2, 3, 1).cpu().numpy())

    def __call__(self, rgb: np.ndarray, depth=None,
                 goal_cat: Optional[int] = None) -> np.ndarray:
        """One (eh, ew, 3) uint8 RGB frame -> (eh, ew, n_sem) float32 mask
        stack on the host (the Segmenter contract)."""
        return self.batch([rgb], [goal_cat])[0]
