"""Decode heads of the PEANUT prediction net (port of the PSPHead and
FCNHead of ``peanut_tpu.models.heads``), NCHW, in mmseg's module layout.

PSPHead: pyramid pooling at scales 1, 2, 3 and 6 (``F.adaptive_avg_pool2d``
has the bins of the JAX package's ``ops.adaptive_avg_pool``), each branch a
1x1 ConvModule resized back bilinearly, then the 3x3 bottleneck and the 1x1
``conv_seg`` classifier (mmseg psp_head.py:11-103).  FCNHead: the auxiliary
head of PSPNet training (fcn_head.py), run by the train step
(``EncoderDecoder.forward(with_aux=True)``); at inference its
``auxiliary_head.*`` keys only load.  Dropout before ``conv_seg`` (flax's
``nn.Dropout``: keep with probability 1 - p, scale by 1 / (1 - p)) runs in
train mode, drawn from the ``generator`` the caller passes; in eval mode
it is the identity.  Resizes use half-pixel centres
(``align_corners=False``).  Logits stay at the head's resolution.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .layers import ConvModule
from .ops import resize_bilinear


def resize_nchw(x: torch.Tensor, size) -> torch.Tensor:
    """``ops.resize_bilinear`` (half-pixel centres) on NCHW maps."""
    return resize_bilinear(x.permute(0, 2, 3, 1), size).permute(0, 3, 1, 2)


class _ClsSeg(nn.Module):
    """The shared tail: dropout (train mode) -> 1x1 ``conv_seg``."""

    def cls_seg(self, x: torch.Tensor,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        if self.training and self.dropout_ratio > 0:
            keep = 1.0 - self.dropout_ratio
            mask = torch.rand(x.shape, generator=generator,
                              device=x.device) < keep
            x = torch.where(mask, x / keep, torch.zeros_like(x))
        return self.conv_seg(x)


class PSPHead(_ClsSeg):
    def __init__(self, in_channels: int = 2048, channels: int = 512,
                 num_classes: int = 19, pool_scales: Sequence[int] = (1, 2,
                                                                      3, 6),
                 in_index: int = 3, dropout_ratio: float = 0.1):
        super().__init__()
        self.in_index = in_index
        self.dropout_ratio = dropout_ratio
        self.psp_modules = nn.ModuleList([
            nn.Sequential(nn.AdaptiveAvgPool2d(s),
                          ConvModule(in_channels, channels, 1))
            for s in pool_scales])
        self.bottleneck = ConvModule(
            in_channels + len(pool_scales) * channels, channels, 3,
            padding=1)
        self.conv_seg = nn.Conv2d(channels, num_classes, 1)

    def forward(self, inputs,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = inputs[self.in_index]
        hw = x.shape[-2:]
        # the resize computes in float32: its branches go back to x's type
        outs = [x] + [resize_nchw(m(x), hw).to(x.dtype)
                      for m in self.psp_modules]
        return self.cls_seg(self.bottleneck(torch.cat(outs, dim=1)),
                            generator)


class FCNHead(_ClsSeg):
    def __init__(self, in_channels: int = 1024, channels: int = 256,
                 num_classes: int = 19, num_convs: int = 1,
                 kernel_size: int = 3, concat_input: bool = False,
                 in_index: int = 2, dilation: int = 1,
                 dropout_ratio: float = 0.1):
        super().__init__()
        self.in_index = in_index
        self.dropout_ratio = dropout_ratio
        pad = (kernel_size // 2) * dilation
        self.convs = nn.ModuleList([
            ConvModule(in_channels if i == 0 else channels, channels,
                       kernel_size, padding=pad, dilation=dilation)
            for i in range(num_convs)])
        self.conv_cat = (ConvModule(in_channels + channels, channels,
                                    kernel_size, padding=kernel_size // 2)
                         if concat_input else None)
        self.conv_seg = nn.Conv2d(channels if num_convs else in_channels,
                                  num_classes, 1)

    def forward(self, inputs,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = inputs[self.in_index]
        feats = x
        for conv in self.convs:
            feats = conv(feats)
        if self.conv_cat is not None:
            feats = self.conv_cat(torch.cat([x, feats], dim=1))
        return self.cls_seg(feats, generator)
