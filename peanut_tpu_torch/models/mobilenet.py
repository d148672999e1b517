"""MobileNetV2, NCHW maps out (port of ``peanut_tpu.models.mobilenet``):
inverted residual blocks with per-stage strides and dilations (the d8
variant dilates the last stages) and a ``widen_factor``.  Submodules are
named after the flax modules (``conv1``, ``layer{i}_{j}``, ``expand``,
``dw_conv``, ``dw_bn``, ``project``, ``project_bn``).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..registry import BACKBONES
from .layers import BatchNorm, ConvModule, relu6


class InvertedResidual(nn.Module):
    """1x1 expansion (relu6), a depthwise 3x3 conv, a linear 1x1
    projection, and the identity added where the shape is kept."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 expand_ratio: int = 6, dilation: int = 1):
        super().__init__()
        hidden = in_channels * expand_ratio
        self.use_res = stride == 1 and in_channels == out_channels
        self.expand = (ConvModule(in_channels, hidden, 1, act=relu6)
                       if expand_ratio != 1 else None)
        self.dw_conv = nn.Conv2d(hidden, hidden, 3, stride=stride,
                                 padding=dilation, dilation=dilation,
                                 groups=hidden, bias=False)
        self.dw_bn = BatchNorm(hidden)
        self.project = nn.Conv2d(hidden, out_channels, 1, bias=False)
        self.project_bn = BatchNorm(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.expand(x) if self.expand is not None else x
        out = relu6(self.dw_bn(self.dw_conv(out)))
        out = self.project_bn(self.project(out))
        return out + x if self.use_res else out


# expand_ratio, channels, blocks, stride
ARCH_SETTINGS = [
    (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
    (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]


@BACKBONES.register()
class MobileNetV2(nn.Module):
    """Returns the stages of ``out_indices`` (their channels are
    ``out_channels``); each stage's first block takes its stride, and
    every block of a stage its dilation."""

    def __init__(self, widen_factor: float = 1.0,
                 strides: Sequence[int] = (1, 2, 2, 2, 1, 2, 1),
                 dilations: Sequence[int] = (1, 1, 1, 1, 1, 1, 1),
                 out_indices: Sequence[int] = (1, 2, 4, 6),
                 in_channels: int = 3):
        super().__init__()
        self.out_indices = tuple(out_indices)
        ch = int(32 * widen_factor)
        self.conv1 = ConvModule(in_channels, ch, 3, stride=2, padding=1,
                                act=relu6)
        self.stage_blocks = []
        outs = []
        for i, (expand, c, nblocks, _) in enumerate(ARCH_SETTINGS):
            cout = int(c * widen_factor)
            for j in range(nblocks):
                self.add_module(f"layer{i + 1}_{j}", InvertedResidual(
                    ch, cout, stride=strides[i] if j == 0 else 1,
                    expand_ratio=expand, dilation=dilations[i]))
                ch = cout
            self.stage_blocks.append(nblocks)
            outs.append(cout)
        self.out_channels = [outs[i] for i in self.out_indices]

    def forward(self, x: torch.Tensor):
        x = self.conv1(x)
        outs = []
        for i, nblocks in enumerate(self.stage_blocks):
            for j in range(nblocks):
                x = getattr(self, f"layer{i + 1}_{j}")(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)
