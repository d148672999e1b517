"""The zoo's remaining data-pipeline transforms and test-time
augmentation (port of ``peanut_tpu.prediction.transforms_extra``).

The reference's pipeline ops (transforms.py: Resize:70, Normalize:451,
PhotoMetricDistortion:861, ResizeToMultiple:13, Rerange:493, CLAHE:539,
RGB2Gray:740, AdjustGamma:795, SegRescale:831, RandomCutOut:980,
RandomMosaic:1072; test_time_aug.py MultiScaleFlipAug:11) on host
{"img", "gt"} numpy samples, as the JAX package writes them: the same
``np.random.RandomState`` draws in the same order, so a seed gives the
same bytes.  cv2 is imported inside the calls that use it (the card's
machine may have none).  ``aug_inference`` runs a port model's
``inference`` on tensors.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


class Resize:
    """mmcv Resize: img_scale (h, w) or ratio_range, keep_ratio rescale.
    Bilinear for img, nearest for gt."""

    def __init__(self, img_scale: Optional[Tuple[int, int]] = None,
                 ratio_range: Optional[Tuple[float, float]] = None,
                 keep_ratio: bool = True, rng=None):
        self.img_scale = img_scale
        self.ratio_range = ratio_range
        self.keep_ratio = keep_ratio
        self.rng = rng or np.random

    def _target(self, h, w):
        if self.ratio_range is not None:
            r = self.rng.uniform(*self.ratio_range)
            base = self.img_scale or (h, w)
            th, tw = base[0] * r, base[1] * r
        else:
            th, tw = self.img_scale
        if self.keep_ratio:
            scale = min(th / h, tw / w)
            return max(int(h * scale + 0.5), 1), max(int(w * scale + 0.5), 1)
        return int(th), int(tw)

    def __call__(self, s):
        import cv2
        h, w = s["img"].shape[:2]
        th, tw = self._target(h, w)
        if (th, tw) != (h, w):
            s["img"] = cv2.resize(s["img"], (tw, th),
                                  interpolation=cv2.INTER_LINEAR
                                  ).reshape(th, tw, -1)
            if s.get("gt") is not None:
                gt = s["gt"]
                squeeze = gt.ndim == 2
                s["gt"] = cv2.resize(gt, (tw, th),
                                     interpolation=cv2.INTER_NEAREST)
                if not squeeze:
                    s["gt"] = s["gt"].reshape(th, tw, -1)
        return s


class Normalize:
    """mmcv Normalize: (img - mean) / std, optional BGR->RGB first."""

    def __init__(self, mean: Sequence[float], std: Sequence[float],
                 to_rgb: bool = True):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)
        self.to_rgb = to_rgb

    def __call__(self, s):
        img = s["img"].astype(np.float32)
        if self.to_rgb and img.shape[-1] == 3:
            img = img[..., ::-1]
        s["img"] = (img - self.mean) / self.std
        return s


class PhotoMetricDistortion:
    """mmcv PhotoMetricDistortion: random brightness/contrast/saturation/hue
    jitter in the same order + coin-flips as transforms.py:861."""

    def __init__(self, brightness_delta: float = 32,
                 contrast_range: Tuple[float, float] = (0.5, 1.5),
                 saturation_range: Tuple[float, float] = (0.5, 1.5),
                 hue_delta: float = 18, rng=None):
        self.brightness_delta = brightness_delta
        self.contrast_range = contrast_range
        self.saturation_range = saturation_range
        self.hue_delta = hue_delta
        self.rng = rng or np.random

    def _contrast(self, img):
        if self.rng.randint(2):
            return np.clip(img * self.rng.uniform(*self.contrast_range),
                           0, 255)
        return img

    def __call__(self, s):
        import cv2
        img = s["img"].astype(np.float32)
        if self.rng.randint(2):
            img = np.clip(img + self.rng.uniform(-self.brightness_delta,
                                                 self.brightness_delta),
                          0, 255)
        contrast_last = self.rng.randint(2)
        if not contrast_last:
            img = self._contrast(img)
        if img.shape[-1] == 3:
            hsv = cv2.cvtColor(img.astype(np.uint8), cv2.COLOR_RGB2HSV
                               ).astype(np.float32)
            if self.rng.randint(2):
                hsv[..., 1] = np.clip(
                    hsv[..., 1] * self.rng.uniform(*self.saturation_range),
                    0, 255)
            if self.rng.randint(2):
                hsv[..., 0] = (hsv[..., 0] + self.rng.uniform(
                    -self.hue_delta, self.hue_delta)) % 180
            img = cv2.cvtColor(hsv.astype(np.uint8),
                               cv2.COLOR_HSV2RGB).astype(np.float32)
        if contrast_last:
            img = self._contrast(img)
        s["img"] = img
        return s


def aug_inference(model, img, scales: Sequence[float] = (1.0,),
                  flip: bool = True):
    """Test-time augmentation: the model's ``inference`` at each scale
    (and its horizontal flip), the logits resized back and **averaged as
    logits**: PEANUT's change to the reference's aug_test
    (encoder_decoder.py:273-290), which averaged probabilities, for its
    external sigmoid.

    img: (B, H, W, C), a tensor or a numpy array, run on the model's
    device in its type.  Returns the averaged logits (B, H, W, K), the
    JAX package's layout.
    """
    import torch

    from ..models.ops import resize_bilinear

    p = next(model.parameters())
    x0 = torch.as_tensor(img).to(device=p.device, dtype=p.dtype)
    b, h, w, _ = x0.shape
    acc = None
    n = 0
    with torch.no_grad():
        for s in scales:
            th, tw = max(int(h * s + 0.5), 1), max(int(w * s + 0.5), 1)
            x = resize_bilinear(x0, (th, tw)) if (th, tw) != (h, w) else x0
            variants = [x] + ([x.flip(2)] if flip else [])
            for i, v in enumerate(variants):
                logits = model.inference(v)
                if i == 1:
                    logits = logits.flip(2)
                if logits.shape[1:3] != (h, w):
                    logits = resize_bilinear(logits, (h, w))
                acc = logits if acc is None else acc + logits
                n += 1
    return acc / n


class MultiScaleFlipAug:
    """Test pipeline wrapper (test_time_aug.py): expands one sample into the
    scale x flip variants the reference's aug_test consumes."""

    def __init__(self, img_ratios: Sequence[float] = (1.0,),
                 flip: bool = False):
        self.img_ratios = tuple(img_ratios)
        self.flip = flip

    def __call__(self, s):
        import cv2
        img = s["img"]
        h, w = img.shape[:2]
        out = []
        for r in self.img_ratios:
            th, tw = max(int(h * r + 0.5), 1), max(int(w * r + 0.5), 1)
            x = (cv2.resize(img, (tw, th), interpolation=cv2.INTER_LINEAR)
                 .reshape(th, tw, -1) if (th, tw) != (h, w) else img)
            out.append({"img": x, "flip": False, "scale": r})
            if self.flip:
                out.append({"img": x[:, ::-1].copy(), "flip": True,
                            "scale": r})
        return out


# ---------------------------------------------------------------------------
# The rest of the reference's transforms
# (transforms.py: ResizeToMultiple:13, Rerange:493, CLAHE:539, RGB2Gray:740,
#  AdjustGamma:795, SegRescale:831, RandomCutOut:980, RandomMosaic:1072).
# Same host-side {"img", "gt"} sample contract as the classes above.
# ---------------------------------------------------------------------------


class ResizeToMultiple:
    """Resize img (bilinear) and gt (nearest) up to multiples of divisor."""

    def __init__(self, size_divisor: int = 32):
        self.size_divisor = size_divisor

    def __call__(self, s):
        import cv2
        h, w = s["img"].shape[:2]
        d = self.size_divisor
        th, tw = -(-h // d) * d, -(-w // d) * d
        if (th, tw) != (h, w):
            s["img"] = cv2.resize(s["img"], (tw, th),
                                  interpolation=cv2.INTER_LINEAR
                                  ).reshape(th, tw, -1)
            if s.get("gt") is not None:
                s["gt"] = cv2.resize(s["gt"], (tw, th),
                                     interpolation=cv2.INTER_NEAREST)
        return s


class Rerange:
    """Min-max rescale image values into [min_value, max_value]."""

    def __init__(self, min_value: float = 0, max_value: float = 255):
        assert min_value < max_value
        self.min_value = float(min_value)
        self.max_value = float(max_value)

    def __call__(self, s):
        img = s["img"].astype(np.float32)
        lo, hi = float(img.min()), float(img.max())
        assert lo < hi, "constant image cannot be reranged"
        img = (img - lo) / (hi - lo)
        s["img"] = img * (self.max_value - self.min_value) + self.min_value
        return s


class CLAHE:
    """Per-channel contrast-limited adaptive histogram equalization."""

    def __init__(self, clip_limit: float = 40.0,
                 tile_grid_size: Tuple[int, int] = (8, 8)):
        self.clip_limit = clip_limit
        self.tile_grid_size = tuple(tile_grid_size)

    def __call__(self, s):
        import cv2
        op = cv2.createCLAHE(self.clip_limit, self.tile_grid_size)
        img = s["img"]
        out = np.stack([op.apply(img[..., c].astype(np.uint8))
                        for c in range(img.shape[2])], axis=-1)
        s["img"] = out.astype(img.dtype)
        return s


class RGB2Gray:
    """Weighted channel mean, broadcast back to out_channels."""

    def __init__(self, out_channels: Optional[int] = None,
                 weights: Tuple[float, ...] = (0.299, 0.587, 0.114)):
        assert out_channels is None or out_channels > 0
        self.out_channels = out_channels
        self.weights = tuple(weights)

    def __call__(self, s):
        img = s["img"]
        assert img.ndim == 3 and img.shape[2] == len(self.weights)
        w = np.asarray(self.weights, np.float32).reshape(1, 1, -1)
        gray = (img * w).sum(2, keepdims=True)
        reps = self.out_channels or len(self.weights)
        s["img"] = np.repeat(gray, reps, axis=2)
        return s


class AdjustGamma:
    """uint8 LUT gamma correction: ((i/255)^(1/gamma) * 255)."""

    def __init__(self, gamma: float = 1.0):
        assert gamma > 0
        self.gamma = gamma
        self.table = np.array([(i / 255.0) ** (1.0 / gamma) * 255
                               for i in range(256)]).astype(np.uint8)

    def __call__(self, s):
        s["img"] = self.table[s["img"].astype(np.uint8)].astype(np.float32)
        return s


class SegRescale:
    """Rescale ONLY the segmentation map (nearest)."""

    def __init__(self, scale_factor: float = 1):
        self.scale_factor = scale_factor

    def __call__(self, s):
        if self.scale_factor != 1 and s.get("gt") is not None:
            import cv2
            gt = s["gt"]
            th = int(gt.shape[0] * self.scale_factor + 0.5)
            tw = int(gt.shape[1] * self.scale_factor + 0.5)
            s["gt"] = cv2.resize(gt, (tw, th),
                                 interpolation=cv2.INTER_NEAREST)
        return s


class RandomCutOut:
    """Randomly zero out rectangular regions (arXiv:1708.04552)."""

    def __init__(self, prob: float, n_holes, cutout_shape=None,
                 cutout_ratio=None, fill_in=(0, 0, 0),
                 seg_fill_in: Optional[int] = None, rng=None):
        assert 0 <= prob <= 1
        assert (cutout_shape is None) ^ (cutout_ratio is None)
        if not isinstance(n_holes, tuple):
            n_holes = (n_holes, n_holes)
        self.prob = prob
        self.n_holes = n_holes
        self.fill_in = fill_in
        self.seg_fill_in = seg_fill_in
        self.with_ratio = cutout_ratio is not None
        cands = cutout_ratio if self.with_ratio else cutout_shape
        self.candidates = cands if isinstance(cands, list) else [cands]
        self.rng = rng or np.random

    def __call__(self, s):
        if self.rng.rand() >= self.prob:
            return s
        img = s["img"]
        h, w = img.shape[:2]
        for _ in range(self.rng.randint(self.n_holes[0],
                                        self.n_holes[1] + 1)):
            x1 = self.rng.randint(0, w)
            y1 = self.rng.randint(0, h)
            cand = self.candidates[self.rng.randint(0, len(self.candidates))]
            cw, ch = ((int(cand[0] * w), int(cand[1] * h))
                      if self.with_ratio else cand)
            x2, y2 = min(x1 + cw, w), min(y1 + ch, h)
            img[y1:y2, x1:x2, :] = self.fill_in[:img.shape[2]] \
                if img.shape[2] <= len(self.fill_in) else self.fill_in[0]
            if self.seg_fill_in is not None and s.get("gt") is not None:
                s["gt"][y1:y2, x1:x2] = self.seg_fill_in
        return s


class RandomMosaic:
    """4-image mosaic (transforms.py:1072): paste the sample + 3 mixes
    around a random center on a 2x canvas.  Requires "mix_results" in the
    sample — provided by wrappers.MultiImageMixDataset via get_indexes."""

    def __init__(self, prob: float, img_scale: Tuple[int, int] = (640, 640),
                 center_ratio_range: Tuple[float, float] = (0.5, 1.5),
                 pad_val: float = 0, seg_pad_val: int = 255, rng=None):
        assert 0 <= prob <= 1
        self.prob = prob
        self.img_scale = tuple(img_scale)
        self.center_ratio_range = center_ratio_range
        self.pad_val = pad_val
        self.seg_pad_val = seg_pad_val
        self.rng = rng or np.random

    def get_indexes(self, dataset):
        return [self.rng.randint(0, len(dataset)) for _ in range(3)]

    def _combine(self, loc, cx, cy, iw, ih):
        """Paste/crop rectangles for one quadrant (reference geometry)."""
        sh, sw = self.img_scale
        if loc == "top_left":
            x1, y1, x2, y2 = max(cx - iw, 0), max(cy - ih, 0), cx, cy
            crop = (iw - (x2 - x1), ih - (y2 - y1), iw, ih)
        elif loc == "top_right":
            x1, y1 = cx, max(cy - ih, 0)
            x2, y2 = min(cx + iw, sw * 2), cy
            crop = (0, ih - (y2 - y1), min(iw, x2 - x1), ih)
        elif loc == "bottom_left":
            x1, y1 = max(cx - iw, 0), cy
            x2, y2 = cx, min(sh * 2, cy + ih)
            crop = (iw - (x2 - x1), 0, iw, min(y2 - y1, ih))
        else:
            x1, y1 = cx, cy
            x2, y2 = min(cx + iw, sw * 2), min(sh * 2, cy + ih)
            crop = (0, 0, min(iw, x2 - x1), min(y2 - y1, ih))
        return (x1, y1, x2, y2), crop

    def _paste4(self, patches, canvas, cx, cy, nearest):
        import cv2
        locs = ("top_left", "top_right", "bottom_left", "bottom_right")
        sh, sw = self.img_scale
        for loc, arr in zip(locs, patches):
            h_i, w_i = arr.shape[:2]
            r = min(sh / h_i, sw / w_i)
            interp = cv2.INTER_NEAREST if nearest else cv2.INTER_LINEAR
            arr = cv2.resize(arr, (int(w_i * r), int(h_i * r)),
                             interpolation=interp)
            (x1p, y1p, x2p, y2p), (x1c, y1c, x2c, y2c) = self._combine(
                loc, cx, cy, arr.shape[1], arr.shape[0])
            canvas[y1p:y2p, x1p:x2p] = arr[y1c:y2c, x1c:x2c]
        return canvas

    def __call__(self, s):
        if self.rng.rand() >= self.prob:
            return s
        assert "mix_results" in s, \
            "RandomMosaic needs MultiImageMixDataset (mix_results missing)"
        sh, sw = self.img_scale
        cx = int(self.rng.uniform(*self.center_ratio_range) * sw)
        cy = int(self.rng.uniform(*self.center_ratio_range) * sh)
        imgs = [s["img"]] + [m["img"] for m in s["mix_results"]]
        canvas = np.full((sh * 2, sw * 2, s["img"].shape[2]), self.pad_val,
                         dtype=s["img"].dtype)
        s["img"] = self._paste4(imgs, canvas, cx, cy, nearest=False)
        if s.get("gt") is not None:
            gts = [s["gt"]] + [m["gt"] for m in s["mix_results"]]
            seg = np.full((sh * 2, sw * 2), self.seg_pad_val,
                          dtype=s["gt"].dtype)
            s["gt"] = self._paste4(gts, seg, cx, cy, nearest=True)
        return s
