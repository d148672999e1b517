"""Segmentors from dict configs (port of ``peanut_tpu.models.builder``):
``build_segmentor`` through the ``SEGMENTORS`` registry, and the PEANUT
prediction model's config."""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..registry import SEGMENTORS
# the segmentors register themselves when imported
from .cascade import CascadeEncoderDecoder  # noqa: F401
from .encoder_decoder import EncoderDecoder  # noqa: F401


def build_segmentor(cfg: Dict[str, Any], seed: Optional[int] = None,
                    device=None) -> torch.nn.Module:
    """A segmentor from an mmseg-style dict config (the ``model`` entry of
    a config file).  ``seed``: random weights from a ``torch.Generator``
    with the flax model's initialisers, drawn on the CPU whatever the
    device, so a seed gives the same weights everywhere; unset, the
    weights are left for a state dict.  ``device``: where the model is
    built (the CPU when unset; ``"meta"`` builds the structure without
    memory, and draws no weights).  A segmentor, backbone, neck or head
    type that the port does not have raises NotImplementedError naming
    ROADMAP A13."""
    cfg = dict(cfg)
    kind = cfg.pop("type")
    if kind not in SEGMENTORS:
        raise NotImplementedError(
            f"{kind} (segmentors) is not ported (the model zoo is ROADMAP "
            "A13)")
    device = torch.device(device if device is not None else "cpu")
    if device.type == "meta":
        with device:
            return SEGMENTORS.get(kind)(**cfg)
    return SEGMENTORS.get(kind)(**cfg, seed=seed).to(device)


def peanut_prediction_config(in_channels: int = 14, num_classes: int = 6,
                             remat: bool = False) -> Dict[str, Any]:
    """The PEANUT target-prediction model config (nav/pred_model_cfg.py:
    2-42).  ``remat`` recomputes the backbone's blocks in backward, as the
    trainer runs the batch-8, crop-960 recipe."""
    return dict(
        type="EncoderDecoder",
        backbone=dict(
            type="ResNetV1c",
            depth=50,
            num_stages=4,
            out_indices=(0, 1, 2, 3),
            dilations=(1, 1, 2, 4),
            strides=(1, 2, 1, 1),
            contract_dilation=True,
            in_channels=in_channels,
            remat=remat,
        ),
        decode_head=dict(
            type="PSPHead",
            in_channels=2048,
            in_index=3,
            channels=512,
            pool_scales=(1, 2, 3, 6),
            dropout_ratio=0.1,
            num_classes=num_classes,
            align_corners=False,
        ),
        auxiliary_head=dict(
            type="FCNHead",
            in_channels=1024,
            in_index=2,
            channels=256,
            num_convs=1,
            concat_input=False,
            dropout_ratio=0.1,
            num_classes=num_classes,
            align_corners=False,
        ),
        test_cfg=dict(mode="whole"),
    )
