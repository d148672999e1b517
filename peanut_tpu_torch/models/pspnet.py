"""The PEANUT prediction model (PSPNet-R50-v1c): its config, a copy of the
JAX package's ``peanut_prediction_config``, and ``build_segmentor`` for the
EncoderDecoder configs the port has (the zoo registry is ROADMAP A13)."""

from __future__ import annotations

from typing import Any, Dict, Optional

from .encoder_decoder import EncoderDecoder


def build_segmentor(cfg: Dict[str, Any],
                    seed: Optional[int] = None) -> EncoderDecoder:
    """An EncoderDecoder from an mmseg-style dict config (ResNetV1c,
    PSPHead, FCNHead); ``seed`` as ``EncoderDecoder``'s."""
    cfg = dict(cfg)
    kind = cfg.pop("type")
    if kind != "EncoderDecoder":
        raise NotImplementedError(
            f"{kind} is not ported (the model zoo is ROADMAP A13)")
    cfg.pop("train_cfg", None)
    cfg.pop("pretrained", None)
    return EncoderDecoder(**cfg, seed=seed)


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
