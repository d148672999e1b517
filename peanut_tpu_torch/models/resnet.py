"""ResNet bottom-up backbone in detectron2's layout (port of the parts of
``peanut_tpu.models.resnet`` that Mask R-CNN uses).

Bottleneck blocks only, depths 50 and 101, caffe style (the stride on the
1x1 conv, as detectron2's ``stride_in_1x1``), frozen batch norm throughout.
Module names follow detectron2 (``stem.conv1``, ``res2.0.conv1``,
``res2.0.shortcut``) so its state dict loads directly.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from .layers import BatchNorm, Conv2d

STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3)}


class Bottleneck(nn.Module):
    def __init__(self, in_channels: int, planes: int, stride: int = 1,
                 downsample: bool = False):
        super().__init__()
        out = planes * 4
        self.conv1 = Conv2d(in_channels, planes, 1, stride=stride,
                            bias=False, norm=BatchNorm(planes))
        self.conv2 = Conv2d(planes, planes, 3, padding=1, bias=False,
                            norm=BatchNorm(planes))
        self.conv3 = Conv2d(planes, out, 1, bias=False, norm=BatchNorm(out))
        self.shortcut = (Conv2d(in_channels, out, 1, stride=stride,
                                bias=False, norm=BatchNorm(out))
                         if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.conv1(x))
        out = F.relu(self.conv2(out))
        out = self.conv3(out)
        identity = self.shortcut(x) if self.shortcut is not None else x
        return F.relu(out + identity)


class ResNet(nn.Module):
    """Returns res2..res5 (strides 4, 8, 16, 32) of NCHW BGR images."""

    def __init__(self, depth: int = 101):
        super().__init__()
        if depth not in STAGE_BLOCKS:
            raise ValueError(f"ResNet depth {depth}: only 50 and 101")
        self.stem = nn.Module()
        self.stem.conv1 = Conv2d(3, 64, 7, stride=2, padding=3,
                                 bias=False, norm=BatchNorm(64))
        ch = 64
        self.stage_names: List[str] = []
        for i, nb in enumerate(STAGE_BLOCKS[depth]):
            planes = 64 * 2 ** i
            blocks = []
            for j in range(nb):
                stride = 2 if j == 0 and i > 0 else 1
                down = j == 0 and (stride != 1 or ch != planes * 4)
                blocks.append(Bottleneck(ch, planes, stride, down))
                ch = planes * 4
            name = f"res{i + 2}"
            self.add_module(name, nn.Sequential(*blocks))
            self.stage_names.append(name)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = F.relu(self.stem.conv1(x))
        x = F.max_pool2d(x, 3, 2, 1)            # pads with -inf, as torch's
        outs = []
        for name in self.stage_names:
            x = getattr(self, name)(x)
            outs.append(x)
        return outs
