"""U-Net, NCHW maps out (port of ``peanut_tpu.models.unet``): an encoder
of double 3x3 convs with 2x2 max pools between its stages, and a decoder
that resizes bilinearly to the skip's size, concatenates the skip first
and applies a double conv.  Returns the decoder stages and the
bottleneck, finest first, so a head reads any scale.  Submodules are named
after the flax modules (``enc{i}``, ``dec{i}``, ``conv0``, ``conv1``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..registry import BACKBONES
from .heads import resize_like
from .layers import ConvModule


class DoubleConv(nn.Module):
    def __init__(self, in_channels: int, channels: int):
        super().__init__()
        self.conv0 = ConvModule(in_channels, channels, 3, padding=1)
        self.conv1 = ConvModule(channels, channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv1(self.conv0(x))


@BACKBONES.register()
class UNet(nn.Module):
    def __init__(self, base_channels: int = 64, num_stages: int = 5,
                 in_channels: int = 3):
        super().__init__()
        self.num_stages = num_stages
        ch = [base_channels * 2 ** i for i in range(num_stages)]
        cin = in_channels
        for i in range(num_stages):
            self.add_module(f"enc{i}", DoubleConv(cin, ch[i]))
            cin = ch[i]
        for i in range(num_stages - 2, -1, -1):
            self.add_module(f"dec{i}", DoubleConv(ch[i] + cin, ch[i]))
            cin = ch[i]
        self.out_channels = ch

    def forward(self, x: torch.Tensor):
        skips = []
        for i in range(self.num_stages):
            if i > 0:
                x = F.max_pool2d(x, 2, 2)
            x = getattr(self, f"enc{i}")(x)
            skips.append(x)
        outs = [skips[-1]]
        for i in range(self.num_stages - 2, -1, -1):
            x = resize_like(x, skips[i].shape[-2:])
            x = getattr(self, f"dec{i}")(torch.cat([skips[i], x], dim=1))
            outs.append(x)
        return tuple(reversed(outs))
