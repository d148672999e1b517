"""EncoderDecoder segmentor with whole and slide inference (port of
``peanut_tpu.models.encoder_decoder``), registered in ``SEGMENTORS``.

PEANUT's in-tree change to mmseg's EncoderDecoder (encoder_decoder.py:248,
262-271) returns **raw logits** resized to the input instead of an argmax;
the agent applies the sigmoid itself for multi-label probability maps, and
``predict_labels`` gives the stock argmax for zoo use.  ``forward`` runs
NCHW, in eval or (``train=True``, the train step of any zoo config with
one auxiliary head) train mode: batch-statistics batch norms and the
heads' dropout, flax's ``train=True``.  ``inference`` and
``predict_labels`` keep the JAX package's NHWC layout at their boundary.

The backbone, the neck and the heads come from the registries; a type
that is not registered raises NotImplementedError naming it.  As in
the JAX package's ``setup``, ``pretrained`` and ``norm_cfg`` are dropped
from the backbone's config and ``norm_cfg`` and ``loss_decode`` from the
heads'.  A neck without ``in_channels`` is given the backbone's
``out_channels`` (flax infers them).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

# the zoo's modules register their classes when imported
from . import (backbones_zoo, convnext, fpn, heads,  # noqa: F401
               heads_attention, heads_zoo, hrnet, knet, mit, mobilenet,
               necks, resnet, unet, vit)
from ..registry import BACKBONES, HEADS, NECKS, SEGMENTORS, Registry
from .layers import init_flax_random
from .ops import resize_nchw


def build_component(registry: Registry, cfg: Dict[str, Any],
                    drop=()) -> nn.Module:
    """``registry.build(cfg)`` without the keys ``drop``; a type that is
    not registered raises NotImplementedError (the port has every type
    of the JAX package's zoo, the timm adapter's ``TIMMBackbone`` too)."""
    kind = cfg["type"]
    if not isinstance(kind, str) or kind not in registry:
        raise NotImplementedError(
            f"{kind} ({registry.name}) is not a type of the model zoo; "
            f"registered: {sorted(registry.keys())}")
    return registry.build({k: v for k, v in cfg.items() if k not in drop})


# the heads' config keys that only training reads
HEAD_DROP = ("norm_cfg", "loss_decode")


@SEGMENTORS.register()
class EncoderDecoder(nn.Module):
    def __init__(self, backbone: Dict[str, Any], decode_head: Dict[str, Any],
                 auxiliary_head: Optional[Dict[str, Any]] = None,
                 neck: Optional[Dict[str, Any]] = None,
                 train_cfg: Optional[Dict[str, Any]] = None,
                 test_cfg: Optional[Dict[str, Any]] = None,
                 pretrained: Optional[str] = None,
                 seed: Optional[int] = None):
        """``seed``: random weights from a ``torch.Generator`` with the
        flax model's initialisers; unset, the weights are left for a state
        dict."""
        super().__init__()
        self.train_cfg = dict(train_cfg or {})
        self.test_cfg = dict(test_cfg or {})
        self.head_cfg = dict(decode_head if isinstance(decode_head, dict)
                             else decode_head[-1])
        self.backbone = build_component(BACKBONES, backbone,
                                        ("pretrained", "norm_cfg"))
        self.neck = None
        if neck:
            ncfg = dict(neck)
            ncfg.setdefault("in_channels", self.backbone.out_channels)
            self.neck = build_component(NECKS, ncfg)
        self.build_heads(decode_head)
        self.auxiliary_head = (build_component(HEADS, auxiliary_head,
                                               HEAD_DROP)
                               if auxiliary_head else None)
        if seed is not None:
            init_flax_random(self, torch.Generator().manual_seed(seed))
        self.eval()      # built for serving; forward(train=True) trains

    def build_heads(self, decode_head: Dict[str, Any]) -> None:
        self.decode_head = build_component(HEADS, decode_head, HEAD_DROP)

    @property
    def align_corners(self) -> bool:
        return bool(self.head_cfg.get("align_corners", False))

    @property
    def num_classes(self) -> int:
        return int(self.head_cfg["num_classes"])

    @property
    def slides(self) -> bool:
        """Whether inference slides (``test_cfg``'s mode "slide") rather
        than runs one whole forward."""
        return self.test_cfg.get("mode", "whole") == "slide"

    def extract_feat(self, img: torch.Tensor):
        feats = self.backbone(img)
        return self.neck(feats) if self.neck is not None else feats

    def _resize(self, x: torch.Tensor, hw) -> torch.Tensor:
        return resize_nchw(x, hw, self.align_corners)

    def forward(self, img: torch.Tensor, train: Optional[bool] = None,
                with_aux: bool = False,
                generator: Optional[torch.Generator] = None):
        """(B, C, H, W) -> (B, num_classes, H, W) raw logits resized to the
        input, and the auxiliary head's alike with ``with_aux`` (a pair).
        ``train``: first switch the module to train mode (batch-statistics
        BN that updates its running averages, dropout from ``generator``)
        or eval mode, as ``.train(train)`` does; the mode holds after the
        call, since a ``remat`` backward recomputes in it.  Unset, the
        module's mode."""
        if train is not None:
            self.train(train)
        feats = self.extract_feat(img)
        hw = img.shape[-2:]
        logits = self._resize(self.decode_head(feats, generator), hw)
        if with_aux and self.auxiliary_head is not None:
            return logits, self._resize(
                self.auxiliary_head(feats, generator), hw)
        return logits

    def encode_decode(self, img: torch.Tensor) -> torch.Tensor:
        """Backbone, neck and decode head in the module's mode: (B, C, H,
        W) -> logits resized to the input."""
        return self._resize(self.decode_head(self.extract_feat(img)),
                            img.shape[-2:])

    def whole_inference(self, img: torch.Tensor) -> torch.Tensor:
        return self.encode_decode(img)

    def slide_windows(self, h: int, w: int) -> list:
        """The (y1, y2, x1, x2) windows ``slide_inference`` visits over an
        h x w map, rows outer, columns inner: ``crop_size`` every
        ``stride``, the last one of a row or column clamped to end at the
        border; the JAX package's arithmetic and defaults."""
        h_stride, w_stride = self.test_cfg.get("stride", (512, 512))
        h_crop, w_crop = self.test_cfg.get("crop_size", (768, 768))
        h_grids = max(h - h_crop + h_stride - 1, 0) // h_stride + 1
        w_grids = max(w - w_crop + w_stride - 1, 0) // w_stride + 1
        out = []
        for hi in range(h_grids):
            for wi in range(w_grids):
                y1 = min(hi * h_stride, max(h - h_crop, 0))
                x1 = min(wi * w_stride, max(w - w_crop, 0))
                out.append((y1, min(y1 + h_crop, h), x1, min(x1 + w_crop, w)))
        return out

    def slide_inference(self, img: torch.Tensor) -> torch.Tensor:
        """Sliding-window inference over (B, C, H, W): the logits of each
        of ``slide_windows`` summed and divided by the number of windows
        over each pixel, in the input's type."""
        b, _, h, w = img.shape
        preds = img.new_zeros((b, self.num_classes, h, w))
        count = img.new_zeros((b, 1, h, w))
        for y1, y2, x1, x2 in self.slide_windows(h, w):
            preds[:, :, y1:y2, x1:x2] += self.encode_decode(
                img[:, :, y1:y2, x1:x2])
            count[:, :, y1:y2, x1:x2] += 1.0
        return preds / count

    def inference(self, img: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) -> (B, H, W, num_classes) raw logits at the input's
        size, by ``test_cfg``'s mode (slide, else whole); the JAX package's
        layout."""
        x = img.permute(0, 3, 1, 2)
        out = (self.slide_inference(x) if self.slides
               else self.whole_inference(x))
        return out.permute(0, 2, 3, 1)

    def predict_labels(self, img: torch.Tensor) -> torch.Tensor:
        """Stock mmseg: (B, H, W, C) -> the (B, H, W) argmax class map."""
        return self.inference(img).argmax(dim=-1)
