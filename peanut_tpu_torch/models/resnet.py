"""ResNet backbones (port of ``peanut_tpu.models.resnet``), and
Mask R-CNN's in detectron2's layout.

``ResNet``: Mask R-CNN's bottom-up backbone in detectron2's layout:
bottleneck blocks, depths 50 and 101, caffe style (the stride on the 1x1
conv, as detectron2's ``stride_in_1x1``), module names ``stem.conv1``,
``res2.0.conv1``, ``res2.0.shortcut`` so its state dict loads directly.

The zoo's ``ResNet`` (``ZooResNet``, registered as "ResNet"), with
``ResNetV1c`` (the deep stem) and ``ResNeXt`` (grouped 3x3 convs), in
mmseg's layout: ``BasicBlock`` for depths 18 and 34, ``ZooBottleneck``
for 50, 101 and 152, the pytorch style (the stride on the 3x3 conv) or
the caffe one (on the first 1x1), per-stage strides and dilations with
``contract_dilation`` (a dilated stage's first block at half the
dilation), the deep stem of three 3x3 convs (``stem.0``) or the 7x7
``conv1`` + ``bn1``, and module names ``layer1.0.conv1``,
``layer1.0.downsample.0`` as mmseg's, so an mmseg state dict loads
directly.  ``norm_eval`` keeps the batch norms in eval mode in a train-mode
forward.  PEANUT's ResNetV1c is depth 50, strides (1, 2, 1, 1), dilations
(1, 1, 2, 4), 14 input channels (nav/pred_model_cfg.py:4-17).
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import nn

from ..registry import BACKBONES
from .layers import BatchNorm, Conv2d, remat


STAGE_BLOCKS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
# the BasicBlock depths' blocks a stage (the JAX package's ARCH)
BASIC_DEPTHS = {18: (2, 2, 2, 2), 34: (3, 4, 6, 3)}


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
        if depth not in (50, 101):
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


class ZooBottleneck(nn.Module):
    """mmseg's Bottleneck: 1x1, 3x3, 1x1 convs and out = planes * 4.
    ``style``: "pytorch" puts the stride on the 3x3 conv, "caffe" on the
    first 1x1.  ``groups`` > 1 groups the 3x3 conv (ResNeXt) at a width of
    int(planes * base_width / 64) * groups."""

    expansion = 4

    def __init__(self, in_channels: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False,
                 style: str = "pytorch", groups: int = 1,
                 base_width: int = 4):
        super().__init__()
        out = planes * 4
        s1, s2 = (1, stride) if style == "pytorch" else (stride, 1)
        width = (planes if groups == 1
                 else int(planes * (base_width / 64)) * groups)
        self.conv1 = nn.Conv2d(in_channels, width, 1, stride=s1, bias=False)
        self.bn1 = BatchNorm(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride=s2,
                               padding=dilation, dilation=dilation,
                               groups=groups, bias=False)
        self.bn2 = BatchNorm(width)
        self.conv3 = nn.Conv2d(width, out, 1, bias=False)
        self.bn3 = BatchNorm(out)
        self.downsample = (nn.Sequential(
            nn.Conv2d(in_channels, out, 1, stride=stride, bias=False),
            BatchNorm(out)) if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = self.downsample(x) if self.downsample is not None else x
        return F.relu(out + identity)


class BasicBlock(nn.Module):
    """mmseg's BasicBlock: two 3x3 convs, the stride and dilation on the
    first, out = planes."""

    expansion = 1

    def __init__(self, in_channels: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False,
                 style: str = "pytorch"):
        super().__init__()
        self.conv1 = nn.Conv2d(in_channels, planes, 3, stride=stride,
                               padding=dilation, dilation=dilation,
                               bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.bn2 = BatchNorm(planes)
        self.downsample = (nn.Sequential(
            nn.Conv2d(in_channels, planes, 1, stride=stride, bias=False),
            BatchNorm(planes)) if downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = self.downsample(x) if self.downsample is not None else x
        return F.relu(out + identity)


@BACKBONES.register(name="ResNet")
class ZooResNet(nn.Module):
    """The zoo's ResNet: returns the stages of ``out_indices`` of NCHW
    inputs (their channels are ``out_channels``).  ``remat`` recomputes
    each residual block's activations in backward (JAX resnet.py's
    ``nn.remat`` of a block): stage-boundary activation memory for about
    1.3x the step's operations.  ``avg_down`` and ``pretrained`` are
    accepted and read nowhere, as in the JAX package (no avg-down
    shortcut)."""

    def __init__(self, depth: int = 50, in_channels: int = 3,
                 stem_channels: int = 64, base_channels: int = 64,
                 num_stages: int = 4, strides=(1, 2, 2, 2),
                 dilations=(1, 1, 1, 1), out_indices=(0, 1, 2, 3),
                 style: str = "pytorch", deep_stem: bool = False,
                 avg_down: bool = False, contract_dilation: bool = False,
                 norm_eval: bool = False, groups: int = 1,
                 base_width: int = 4, pretrained=None, remat: bool = False):
        super().__init__()
        if depth in BASIC_DEPTHS:
            block, stage_blocks, extra = BasicBlock, BASIC_DEPTHS[depth], {}
        elif depth in STAGE_BLOCKS:
            block, stage_blocks = ZooBottleneck, STAGE_BLOCKS[depth]
            extra = dict(groups=groups, base_width=base_width)
        else:
            raise ValueError(f"ResNet depth {depth}: only "
                             f"{sorted({**BASIC_DEPTHS, **STAGE_BLOCKS})}")
        self.remat = remat
        self.norm_eval = norm_eval
        self.deep_stem = deep_stem
        self.out_channels = tuple(base_channels * 2 ** i * block.expansion
                                  for i in out_indices)
        if deep_stem:
            half = stem_channels // 2
            self.stem = nn.Sequential(
                nn.Conv2d(in_channels, half, 3, stride=2, padding=1,
                          bias=False),
                BatchNorm(half), nn.ReLU(),
                nn.Conv2d(half, half, 3, padding=1, bias=False),
                BatchNorm(half), nn.ReLU(),
                nn.Conv2d(half, stem_channels, 3, padding=1, bias=False),
                BatchNorm(stem_channels), nn.ReLU())
        else:
            self.conv1 = nn.Conv2d(in_channels, stem_channels, 7, stride=2,
                                   padding=3, bias=False)
            self.bn1 = BatchNorm(stem_channels)
        self.out_indices = tuple(out_indices)
        self.num_stages = num_stages
        ch = stem_channels
        for i in range(num_stages):
            planes = base_channels * 2 ** i
            stride, dilation = strides[i], dilations[i]
            blocks = []
            for j in range(stage_blocks[i]):
                first = j == 0
                d = (dilation // 2 if first and dilation > 1
                     and contract_dilation else dilation)
                blocks.append(block(
                    ch, planes, stride if first else 1, d,
                    downsample=first and (
                        stride != 1 or ch != planes * block.expansion),
                    style=style, **extra))
                ch = planes * block.expansion
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))

    def train(self, mode: bool = True):
        """As nn.Module's; under ``norm_eval`` the batch norms stay in eval
        mode (the JAX package's forward runs them with ``train=False``)."""
        super().train(mode)
        if self.norm_eval:
            for m in self.modules():
                if isinstance(m, BatchNorm):
                    m.train(False)
        return self

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        if self.deep_stem:
            x = self.stem(x)
        else:
            x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        outs = []
        rematted = self.remat and torch.is_grad_enabled()
        for i in range(self.num_stages):
            for block in getattr(self, f"layer{i + 1}"):
                x = remat(block, x) if rematted else block(x)
            if i in self.out_indices:
                outs.append(x)
        return outs


@BACKBONES.register()
class ResNetV1c(ZooResNet):
    """The zoo's ResNet with the deep stem (three 3x3 convs): PEANUT's
    backbone."""

    def __init__(self, deep_stem: bool = True, **kw):
        super().__init__(deep_stem=deep_stem, **kw)


@BACKBONES.register()
class ResNeXt(ZooResNet):
    """The zoo's ResNet with grouped 3x3 bottleneck convs (the reference's
    resnext.py; resnext50_32x4d is groups 32, base_width 4)."""

    def __init__(self, groups: int = 32, base_width: int = 4, **kw):
        super().__init__(groups=groups, base_width=base_width, **kw)
