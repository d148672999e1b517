"""Feature Pyramid Network over a ResNet, in detectron2's layout (port of
``peanut_tpu.models.fpn``).

1x1 lateral convs, nearest 2x top-down upsampling cropped to the finer
level's size, sum fusion, 3x3 output convs, and P6 as the stride-2
subsample of P5 (LastLevelMaxPool: a 1x1 max-pool at stride 2).  Module
names follow detectron2's ``backbone`` (``bottom_up``, ``fpn_lateral2``,
``fpn_output2``, ...).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv2d


class FPN(nn.Module):
    """FPN(256) over the res2..res5 of a ResNet ``bottom_up``."""

    def __init__(self, bottom_up: nn.Module):
        super().__init__()
        self.bottom_up = bottom_up
        self.levels = [2, 3, 4, 5]
        for lvl in self.levels:
            self.add_module(f"fpn_lateral{lvl}",
                            Conv2d(64 * 2 ** lvl, 256, 1))
            self.add_module(f"fpn_output{lvl}", Conv2d(256, 256, 3, padding=1))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """NCHW images -> [P2, P3, P4, P5, P6], each (B, C, H_l, W_l)."""
        feats = self.bottom_up(x)
        lat = [getattr(self, f"fpn_lateral{lvl}")(f)
               for lvl, f in zip(self.levels, feats)]
        for i in range(len(lat) - 2, -1, -1):
            h, w = lat[i].shape[-2:]
            up = F.interpolate(lat[i + 1], scale_factor=2, mode="nearest")
            lat[i] = lat[i] + up[..., :h, :w]
        outs = [getattr(self, f"fpn_output{lvl}")(t)
                for lvl, t in zip(self.levels, lat)]
        outs.append(outs[-1][..., ::2, ::2])
        return outs
