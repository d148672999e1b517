"""Zoo necks, NCHW (port of ``peanut_tpu.models.necks``): JPU,
FastFCN's joint pyramid upsampling; MLANeck, MultiLevelNeck and
Feature2Pyramid, which make a pyramid of a plain transformer's taps;
ICNeck, ICNet's cascade feature fusion.  (The FPN neck is ``fpn.FPN``.)
Submodules are named after the flax modules.  flax infers a layer's
input channels; the port takes them from ``in_channels``, which the
segmentor fills with the backbone's ``out_channels`` when the config
leaves it out."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..registry import NECKS
from .heads import resize_like
from .layers import BatchNorm, ConvModule, LayerNorm, ln_nchw


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


@NECKS.register()
class MLANeck(nn.Module):
    """SETR-MLA's multi-level aggregation (mla_neck.py): an LN on each
    tap, 1x1 ConvModules summed top down (each stream adds the coarser
    one), a 3x3 ConvModule on each."""

    def __init__(self, in_channels: Sequence[int] = (1024, 1024, 1024, 1024),
                 out_channels: int = 256):
        super().__init__()
        for i, c in enumerate(in_channels):
            self.add_module(f"norm{i}", LayerNorm(c))
        for i, c in enumerate(in_channels):
            self.add_module(f"mla_p{i}_1x1", ConvModule(c, out_channels, 1))
        for i in range(len(in_channels)):
            self.add_module(f"mla_p{i}_3x3", ConvModule(
                out_channels, out_channels, 3, padding=1))

    def forward(self, inputs):
        mids = [getattr(self, f"mla_p{i}_1x1")(
            ln_nchw(getattr(self, f"norm{i}"), x))
            for i, x in enumerate(inputs)]
        for i in range(len(mids) - 2, -1, -1):
            mids[i] = mids[i] + mids[i + 1]
        return tuple(getattr(self, f"mla_p{i}_3x3")(m)
                     for i, m in enumerate(mids))


@NECKS.register()
class MultiLevelNeck(nn.Module):
    """A pyramid of a single-resolution backbone (multilevel_neck.py): a
    1x1 conv per input (one input serves every scale), resized by
    ``scales`` (rounded, half-pixel centres), a 3x3 conv."""

    def __init__(self, in_channels: Sequence[int] = (1024, 1024, 1024, 1024),
                 out_channels: int = 256,
                 scales: Sequence[float] = (0.5, 1, 2, 4)):
        super().__init__()
        self.scales = tuple(scales)
        chans = (list(in_channels) if len(in_channels) > 1
                 else list(in_channels) * len(self.scales))
        for i, c in enumerate(chans):
            self.add_module(f"lateral{i}", nn.Conv2d(c, out_channels, 1))
        self.n_out = min(len(chans), len(self.scales))
        for i in range(self.n_out):
            self.add_module(f"conv{i}", nn.Conv2d(out_channels, out_channels,
                                                  3, padding=1))

    def forward(self, inputs):
        if len(inputs) == 1:
            inputs = [inputs[0]] * len(self.scales)
        projected = [getattr(self, f"lateral{i}")(x)
                     for i, x in enumerate(inputs)]
        outs = []
        for i, (x, s) in enumerate(zip(projected, self.scales)):
            hw = (max(int(round(x.shape[-2] * s)), 1),
                  max(int(round(x.shape[-1] * s)), 1))
            outs.append(getattr(self, f"conv{i}")(resize_like(x, hw)))
        return tuple(outs)


@NECKS.register()
class Feature2Pyramid(nn.Module):
    """Equal-resolution transformer taps rescaled into a stride pyramid
    (featurepyramid.py): each resized by ``rescales`` (rounded), then a
    3x3 ConvModule where the scale is not 1."""

    def __init__(self, embed_dim: int = 768,
                 rescales: Sequence[float] = (4, 2, 1, 0.5),
                 in_channels=None):
        super().__init__()
        self.rescales = tuple(rescales)
        chans = list(in_channels or [embed_dim] * len(self.rescales))
        for i, (c, s) in enumerate(zip(chans, self.rescales)):
            if s != 1:
                self.add_module(f"rescale{i}", ConvModule(c, c, 3,
                                                          padding=1))

    def forward(self, inputs):
        outs = []
        for i, (x, s) in enumerate(zip(inputs, self.rescales)):
            y = resize_like(x, (max(int(round(x.shape[-2] * s)), 1),
                                max(int(round(x.shape[-1] * s)), 1)))
            outs.append(getattr(self, f"rescale{i}")(y) if s != 1 else y)
        return tuple(outs)


class _CascadeFeatureFusion(nn.Module):
    """ICNet's CFF unit (ic_neck.py): the low branch resized to the high
    one's size through a dilated 3x3 conv + BN, the high one through a
    1x1 conv + BN, summed, ReLU."""

    def __init__(self, low_channels: int, high_channels: int,
                 out_channels: int, align_corners: bool = False):
        super().__init__()
        self.align_corners = align_corners
        self.conv_low = ConvModule(low_channels, out_channels, 3, padding=2,
                                   dilation=2, with_act=False)
        self.conv_high = ConvModule(high_channels, out_channels, 1,
                                    with_act=False)

    def forward(self, low: torch.Tensor, high: torch.Tensor) -> torch.Tensor:
        low = resize_like(low, high.shape[-2:], self.align_corners)
        return F.relu(self.conv_low(low) + self.conv_high(high))


@NECKS.register()
class ICNeck(nn.Module):
    """ICNet's fusion neck (ic_neck.py): sub4 fused into sub2
    (``cff42``), that into sub1 (``cff21``); returns both and the latter
    resized 2x."""

    def __init__(self, in_channels: Sequence[int] = (64, 256, 256),
                 out_channels: int = 128, align_corners: bool = False):
        super().__init__()
        self.align_corners = align_corners
        c1, c2, c4 = in_channels[-3:]
        self.cff42 = _CascadeFeatureFusion(c4, c2, out_channels,
                                           align_corners)
        self.cff21 = _CascadeFeatureFusion(out_channels, c1, out_channels,
                                           align_corners)

    def forward(self, inputs):
        sub1, sub2, sub4 = inputs[-3], inputs[-2], inputs[-1]
        cff42 = self.cff42(sub4, sub2)
        cff21 = self.cff21(cff42, sub1)
        h, w = cff21.shape[-2:]
        return (cff42, cff21,
                resize_like(cff21, (h * 2, w * 2), self.align_corners))
