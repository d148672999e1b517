"""HRNet, NCHW maps out (port of ``peanut_tpu.models.hrnet``): parallel
streams at 1/4, 1/8, 1/16 and 1/32 of the input, each stage's modules
ending in a full cross-resolution fusion; the output is every branch,
finest first (the FCN and UPer heads of the HRNet configs upsample and
concatenate them).  Submodules are named after the flax modules
(``stem0``, ``layer1_0``, ``trans1_0``, ``stage2_m0``,
``branch0_block0``, ``fuse1_0_down0``, ...); the residual blocks are the
zoo ResNet's, with mmseg's names inside (``mmseg_import._resnet_name``).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..registry import BACKBONES
from .heads import resize_like
from .layers import BatchNorm, ConvModule
from .resnet import BasicBlock, ZooBottleneck


class HRModule(nn.Module):
    """``num_blocks`` BasicBlocks on each of ``num_branches`` streams, then
    each output the ReLU of its stream plus every other: a lower
    resolution through a 1x1 conv + BN and a bilinear resize, a higher one
    through a chain of stride-2 3x3 convs + BN (ReLU on all but the
    last)."""

    def __init__(self, num_branches: int, num_blocks: int,
                 channels: Sequence[int]):
        super().__init__()
        self.num_branches = num_branches
        self.num_blocks = num_blocks
        ch = channels
        for b in range(num_branches):
            for j in range(num_blocks):
                self.add_module(f"branch{b}_block{j}",
                                BasicBlock(ch[b], ch[b]))
        for i in range(num_branches):
            for j in range(num_branches):
                if j > i:
                    self.add_module(f"fuse{i}_{j}_conv", nn.Conv2d(
                        ch[j], ch[i], 1, bias=False))
                    self.add_module(f"fuse{i}_{j}_bn", BatchNorm(ch[i]))
                elif j < i:
                    cin = ch[j]
                    for k in range(i - j):
                        cout = ch[i] if k == i - j - 1 else ch[j]
                        self.add_module(f"fuse{i}_{j}_down{k}", nn.Conv2d(
                            cin, cout, 3, stride=2, padding=1, bias=False))
                        self.add_module(f"fuse{i}_{j}_down{k}_bn",
                                        BatchNorm(cout))
                        cin = cout

    def forward(self, xs):
        outs = []
        for b in range(self.num_branches):
            x = xs[b]
            for j in range(self.num_blocks):
                x = getattr(self, f"branch{b}_block{j}")(x)
            outs.append(x)
        fused = []
        for i in range(self.num_branches):
            acc = outs[i]
            hw = acc.shape[-2:]
            for j in range(self.num_branches):
                if j == i:
                    continue
                y = outs[j]
                if j > i:
                    y = getattr(self, f"fuse{i}_{j}_bn")(
                        getattr(self, f"fuse{i}_{j}_conv")(y))
                    y = resize_like(y, hw)
                else:
                    for k in range(i - j):
                        y = getattr(self, f"fuse{i}_{j}_down{k}_bn")(
                            getattr(self, f"fuse{i}_{j}_down{k}")(y))
                        if k < i - j - 1:
                            y = F.relu(y)
                acc = acc + y
            fused.append(F.relu(acc))
        return fused


@BACKBONES.register()
class HRNet(nn.Module):
    """HRNet-W``base_channels``: branch i has base * 2^i channels.  Two
    stride-2 3x3 stems, four Bottlenecks at 1/4, then stages 2-4 of
    ``stage_modules[1:]`` HRModules each (``stage_modules[0]`` is stage
    1's, which is always one), a new stride-2 branch after stages 2 and
    3."""

    def __init__(self, base_channels: int = 18,
                 stage_modules: Sequence[int] = (1, 1, 4, 3),
                 stage_blocks: int = 4, in_channels: int = 3):
        super().__init__()
        self.stage_modules = tuple(stage_modules)
        chans = [base_channels * 2 ** i for i in range(4)]
        self.stem0 = ConvModule(in_channels, 64, 3, stride=2, padding=1)
        self.stem1 = ConvModule(64, 64, 3, stride=2, padding=1)
        ch = 64
        for j in range(4):
            self.add_module(f"layer1_{j}", ZooBottleneck(
                ch, 64, downsample=j == 0))
            ch = 256
        self.trans1_0 = ConvModule(ch, chans[0], 3, padding=1)
        self.trans1_1 = ConvModule(ch, chans[1], 3, stride=2, padding=1)
        for stage, n_modules in enumerate(self.stage_modules[1:], start=2):
            for m in range(n_modules):
                self.add_module(f"stage{stage}_m{m}", HRModule(
                    stage, stage_blocks, chans[:stage]))
            if stage < 4:
                self.add_module(f"trans{stage}", ConvModule(
                    chans[stage - 1], chans[stage], 3, stride=2, padding=1))
        # a branch is added after each of stages 2 and 3 that runs
        self.out_channels = chans[:2 + min(len(self.stage_modules) - 1, 2)]

    def forward(self, x: torch.Tensor):
        x = self.stem1(self.stem0(x))
        for j in range(4):
            x = getattr(self, f"layer1_{j}")(x)
        xs = [self.trans1_0(x), self.trans1_1(x)]
        for stage, n_modules in enumerate(self.stage_modules[1:], start=2):
            for m in range(n_modules):
                xs = getattr(self, f"stage{stage}_m{m}")(xs)
            if stage < 4:
                xs = list(xs) + [getattr(self, f"trans{stage}")(xs[-1])]
        return tuple(xs)
