"""Zoo necks, NCHW (port of ``peanut_tpu.models.necks``): JPU, FastFCN's
joint pyramid upsampling.  (The FPN neck is ``fpn.FPN``.)  MLANeck,
MultiLevelNeck, ICNeck and Feature2Pyramid wait for their backbones
(ROADMAP A13).  Submodules are named after the flax modules."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..registry import NECKS
from .heads import resize_like
from .layers import BatchNorm, ConvModule


@NECKS.register()
class JPU(nn.Module):
    """Joint Pyramid Upsampling (jpu.py): the levels from ``start_level``
    upsampled to the finest of them and concatenated, then parallel
    dilated depthwise-separable convs; the fused map replaces the last
    level."""

    def __init__(self, in_channels: Sequence[int] = (512, 1024, 2048),
                 mid_channels: int = 512,
                 dilations: Sequence[int] = (1, 2, 4, 8),
                 start_level: int = 0, align_corners: bool = False):
        super().__init__()
        self.start_level = start_level
        self.align_corners = align_corners
        self.dilations = tuple(dilations)
        for i, c in enumerate(in_channels):
            self.add_module(f"conv{i}", ConvModule(c, mid_channels, 3,
                                                   padding=1))
        cat = len(in_channels) * mid_channels
        for i, d in enumerate(dilations):
            self.add_module(f"dil{i}_dw", nn.Conv2d(
                cat, cat, 3, padding=d, dilation=d, groups=cat, bias=False))
            self.add_module(f"dil{i}_bn", BatchNorm(cat))
            self.add_module(f"dil{i}_pw", ConvModule(cat, mid_channels, 1))

    def forward(self, inputs):
        feats = list(inputs[self.start_level:])
        convs = [getattr(self, f"conv{i}")(f) for i, f in enumerate(feats)]
        hw = convs[0].shape[-2:]
        cat = torch.cat([resize_like(c, hw, self.align_corners)
                         for c in convs], dim=1)
        outs = [getattr(self, f"dil{i}_pw")(F.relu(getattr(
            self, f"dil{i}_bn")(getattr(self, f"dil{i}_dw")(cat))))
            for i in range(len(self.dilations))]
        fused = torch.cat(outs, dim=1)
        return (list(inputs[:self.start_level + 1]) + feats[1:-1]
                + [fused])
