"""timm backbone adapter (port of ``peanut_tpu.models.timm_adapter``; the
reference's backbones/timm_backbone.py).

The reference wraps ``timm.create_model(features_only=True)`` to expose
a timm classifier as a multi-level segmentation backbone.  As in the JAX
package, timm is not a dependency: the adapter keeps the registry
surface -- ``dict(type='TIMMBackbone', model_name=...)`` builds -- and
maps the common model names onto the zoo's own backbones, raising
NotImplementedError for any other.  The inner backbone is held under
flax's name ``model``, so the JAX package's variables (``backbone/model/
...``) carry over by ``mmseg_import.flax_to_torch_state``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch import nn

from ..registry import BACKBONES
# the modules of the equivalents register them
from . import backbones_zoo, mobilenet, resnet  # noqa: F401

# timm model names with an equivalent backbone in the zoo
_NATIVE_EQUIV = {
    "resnet18": dict(type="ResNet", depth=18),
    "resnet34": dict(type="ResNet", depth=34),
    "resnet50": dict(type="ResNet", depth=50),
    "resnet101": dict(type="ResNet", depth=101),
    "resnext50_32x4d": dict(type="ResNeXt", depth=50, groups=32,
                            base_width=4),
    "resnest50d": dict(type="ResNeSt", depth=50),
    "mobilenetv2_100": dict(type="MobileNetV2"),
    "mobilenetv3_large_100": dict(type="MobileNetV3", arch="large"),
    "mobilenetv3_small_100": dict(type="MobileNetV3", arch="small"),
}


@BACKBONES.register()
class TIMMBackbone(nn.Module):
    """Config-compatible stand-in for the reference's timm adapter: the
    zoo backbone of ``model_name`` (``extra`` updates its config), whose
    stages it returns; a ResNet-like one takes ``in_channels``, a
    MobileNet only 3."""

    def __init__(self, model_name: str = "resnet50",
                 features_only: bool = True, in_channels: int = 3,
                 extra: Optional[Dict[str, Any]] = None):
        super().__init__()
        if model_name not in _NATIVE_EQUIV:
            raise NotImplementedError(
                f"TIMMBackbone: no native equivalent for {model_name!r}; "
                f"available: {sorted(_NATIVE_EQUIV)}. (timm itself is not "
                f"a dependency: the names map onto the zoo's backbones.)")
        cfg = dict(_NATIVE_EQUIV[model_name])
        cfg.update(extra or {})
        if cfg["type"] in ("ResNet", "ResNeXt", "ResNeSt"):
            cfg["in_channels"] = in_channels
        elif in_channels != 3:
            raise NotImplementedError(
                f"{model_name!r} equivalent only supports 3-channel input")
        self.model = BACKBONES.get(cfg.pop("type"))(**cfg)
        self.out_channels = self.model.out_channels

    def forward(self, x: torch.Tensor):
        return self.model(x)
