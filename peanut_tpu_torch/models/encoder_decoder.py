"""EncoderDecoder segmentor, whole-image inference (port of
``peanut_tpu.models.encoder_decoder``).

PEANUT's in-tree change to mmseg's EncoderDecoder (encoder_decoder.py:248,
262-271) returns **raw logits** resized to the input instead of an argmax;
the agent applies the sigmoid itself for multi-label probability maps.
``forward`` runs NCHW, in eval or (``train=True``, the train step) train
mode, with the auxiliary head's logits on request; ``inference`` keeps the
JAX package's NHWC layout at its boundary.  Slide inference and the zoo's
other parts are ROADMAP A13.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from .heads import FCNHead, PSPHead, resize_nchw
from .layers import init_flax_random
from .resnet import ResNetV1c

BACKBONES = {"ResNetV1c": ResNetV1c}
HEADS = {"PSPHead": PSPHead, "FCNHead": FCNHead}
# config keys of the JAX package's modules that inference does not read
_IGNORED = ("type", "norm_cfg", "pretrained", "loss_decode", "norm_eval",
            "style", "align_corners")


def _build(registry: Dict[str, type], cfg: Dict[str, Any]) -> nn.Module:
    kind = cfg["type"]
    if kind not in registry:
        raise NotImplementedError(
            f"{kind} is not ported (the model zoo is ROADMAP A13)")
    if cfg.get("align_corners") or cfg.get("style", "pytorch") != "pytorch":
        raise NotImplementedError(
            f"{kind}: only align_corners=False and the pytorch style are "
            "ported")
    return registry[kind](**{k: v for k, v in cfg.items()
                             if k not in _IGNORED})


class EncoderDecoder(nn.Module):
    def __init__(self, backbone: Dict[str, Any], decode_head: Dict[str, Any],
                 auxiliary_head: Optional[Dict[str, Any]] = None,
                 test_cfg: Optional[Dict[str, Any]] = None,
                 seed: Optional[int] = None):
        """``seed``: random weights from a ``torch.Generator`` with the
        flax model's initialisers; unset, the weights are left for a state
        dict."""
        super().__init__()
        mode = (test_cfg or {}).get("mode", "whole")
        if mode != "whole":
            raise NotImplementedError(
                f"test_cfg mode {mode!r}: only whole-image inference is "
                "ported (ROADMAP A13)")
        self.backbone = _build(BACKBONES, backbone)
        self.decode_head = _build(HEADS, decode_head)
        self.auxiliary_head = (_build(HEADS, auxiliary_head)
                               if auxiliary_head else None)
        if seed is not None:
            init_flax_random(self, torch.Generator().manual_seed(seed))
        self.eval()      # built for serving; forward(train=True) trains

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
        feats = self.backbone(img)
        hw = img.shape[-2:]
        logits = resize_nchw(self.decode_head(feats, generator), hw)
        if with_aux and self.auxiliary_head is not None:
            return logits, resize_nchw(self.auxiliary_head(feats, generator),
                                       hw)
        return logits

    def inference(self, img: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) -> (B, H, W, num_classes) raw logits, the JAX
        package's layout."""
        return self(img.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
