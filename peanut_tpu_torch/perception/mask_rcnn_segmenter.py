"""Mask R-CNN segmentation on the device (port of the device path of
``peanut_tpu.perception.mask_rcnn_segmenter``).

``batch_device`` takes uint8 RGB frames and returns the (B, n_sem, fh, fw)
float32 semantic stack the tick consumes, without a host round trip:
RGB -> BGR, detectron2's shortest-edge-800 resize (two matrix products),
mean subtraction, padding to /32, detect in chunks of ``seg_batch_chunk``
frames, then each detection's 28x28 mask pasted at the mapper's strided
pixel centres and accumulated per class behind the confidence gates of
PEANUT's segmentation.py:47-61 (``sem_pred_prob_thr``, ``goal_thr``).

The host paths of the JAX package (``__call__``, ``batch``, cv2 pasting)
serve the single-env agent and are not ported here (ROADMAP A11).
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device, upload
from ..config import NavConfig
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


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A detectron2 checkpoint (bare, or under ``model``/``state_dict``) as
    {name: numpy array}.  The file is the configured model checkpoint, a
    trusted input, read as the JAX package reads it."""
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"Mask R-CNN weights not found at {path!r} (cfg.seg_model_wts); "
            "put the checkpoint there or pass state_dict= or model=")
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, dict):
        if "state_dict" in obj:
            obj = obj["state_dict"]
        elif "model" in obj and isinstance(obj["model"], dict):
            obj = obj["model"]
    return {k[len("module."):] if k.startswith("module.") else k:
            np.asarray(v.detach().cpu().numpy() if torch.is_tensor(v) else v)
            for k, v in obj.items() if hasattr(v, "shape")}


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
                state_dict = load_torch_state_dict(cfg.seg_model_wts)
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

    def paste(self, boxes, scores, classes, masks,
              goal_cats: torch.Tensor) -> torch.Tensor:
        """Gate and paste (B, nd) detections into (B, n_cats, fh, fw).

        Each 28x28 mask is sampled at the strided env-pixel centres with
        cv2.INTER_LINEAR coordinates ((q + 0.5) * src / dst - 0.5) as
        separable hat matrices, and thresholded at 0.5."""
        cfg = self.cfg
        eh, ew = cfg.env_frame_height, cfg.env_frame_width
        scale_y, scale_x = self._scale
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

    @torch.no_grad()
    def batch_device(self, rgbs_u8, goal_cats) -> torch.Tensor:
        """(B, eh, ew, 3) uint8 RGB (numpy, or a tensor already on the
        device) -> (B, n_sem, fh, fw) float32 semantic stack on the
        device."""
        rgb = upload(rgbs_u8, self.device)
        b = rgb.shape[0]
        pad = (-b) % self.chunk
        goal = upload(np.pad(np.asarray(goal_cats, np.int64), (0, pad)),
                      self.device)
        if pad:
            rgb = torch.cat([rgb, rgb.new_zeros((pad,) + rgb.shape[1:])])
        img = self.preprocess(rgb)
        dets = []
        for lo in range(0, img.shape[0], self.chunk):
            det = self._detect_stage(img[lo:lo + self.chunk])
            dets.append({k: v.float() if v.is_floating_point() else v
                         for k, v in det.items()})
        det = {k: torch.cat([d[k] for d in dets]) for k in dets[0]}
        sem = self.paste(det["boxes"], det["scores"], det["classes"],
                         det["masks"], goal)
        pad_ch = self.cfg.num_sem_categories - self.n_cats
        return F.pad(sem, (0, 0, 0, 0, 0, pad_ch))[:b]
