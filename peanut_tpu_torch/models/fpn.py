"""Feature Pyramid Network (port of ``peanut_tpu.models.fpn``).

1x1 lateral convs, nearest 2x top-down upsampling cropped to the finer
level's size, sum fusion, 3x3 output convs, and P6 as the stride-2
subsample of P5 (LastLevelMaxPool: a 1x1 max-pool at stride 2).  Over a
``bottom_up`` ResNet (Mask R-CNN) the module names follow detectron2's
``backbone`` (``bottom_up``, ``fpn_lateral2``, ``fpn_output2``, ...); as
the zoo's neck (sem_fpn, registered in ``NECKS``) it takes the backbone's
levels and names its convs as the flax module does (``lateral2``,
``output2``, ...).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..registry import NECKS
from .layers import Conv2d


@NECKS.register()
class FPN(nn.Module):
    """FPN over res2..res5: of a ResNet ``bottom_up`` (FPN(256), Mask
    R-CNN), or of the levels a segmentor's backbone passes in, whose
    channels are ``in_channels``."""

    def __init__(self, bottom_up: Optional[nn.Module] = None,
                 out_channels: int = 256, num_levels: int = 4,
                 add_p6_pool: bool = True,
                 in_channels: Optional[Sequence[int]] = None):
        super().__init__()
        self.bottom_up = bottom_up
        self.add_p6_pool = add_p6_pool
        self.levels = list(range(2, 2 + num_levels))
        if in_channels is None:
            in_channels = [64 * 2 ** lvl for lvl in self.levels]
        self.prefix = "fpn_" if bottom_up is not None else ""
        for lvl, c in zip(self.levels, in_channels):
            self.add_module(f"{self.prefix}lateral{lvl}",
                            Conv2d(c, out_channels, 1))
            self.add_module(f"{self.prefix}output{lvl}",
                            Conv2d(out_channels, out_channels, 3, padding=1))

    def forward(self, x) -> List[torch.Tensor]:
        """NCHW images (with ``bottom_up``) or the backbone's levels ->
        [P2, ..., P5] and P6 with ``add_p6_pool``, each (B, C, H_l, W_l)."""
        feats = self.bottom_up(x) if self.bottom_up is not None else x
        lat = [getattr(self, f"{self.prefix}lateral{lvl}")(f)
               for lvl, f in zip(self.levels, feats)]
        for i in range(len(lat) - 2, -1, -1):
            h, w = lat[i].shape[-2:]
            up = F.interpolate(lat[i + 1], scale_factor=2, mode="nearest")
            lat[i] = lat[i] + up[..., :h, :w]
        outs = [getattr(self, f"{self.prefix}output{lvl}")(t)
                for lvl, t in zip(self.levels, lat)]
        if self.add_p6_pool:
            outs.append(outs[-1][..., ::2, ::2])
        return outs
