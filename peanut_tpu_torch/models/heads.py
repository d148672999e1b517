"""Decode heads, NCHW (port of ``peanut_tpu.models.heads``): PSPHead and
FCNHead, the two on PEANUT's path, in mmseg's module layout; UPerHead,
DepthwiseSeparableASPPHead, OCRHead, ASPPHead and SegFormerHead for the
zoo, their
submodules named after the flax modules (``ppm0``, ``lateral1``,
``fpn_bottleneck``, ``aspp2``, ...), so ``mmseg_import.
flax_to_torch_state`` carries the JAX package's variables by one rule.

PSPHead: pyramid pooling at scales 1, 2, 3 and 6, each branch a 1x1
ConvModule resized back bilinearly, then the 3x3 bottleneck and the 1x1
``conv_seg`` classifier (mmseg psp_head.py:11-103).  FCNHead: the
auxiliary head of PSPNet training (fcn_head.py), run by the train step
(``EncoderDecoder.forward(with_aux=True)``).  Dropout before ``conv_seg``
(flax's ``nn.Dropout``: keep with probability 1 - p, scale by 1 / (1 - p))
runs in train mode, drawn from the ``generator`` the caller passes; in
eval mode it is the identity.  Logits stay at the head's resolution.
A resize computes in float32 or wider and its result goes back to the
map's type (a bfloat16 model stays bfloat16).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from ..registry import HEADS
from .layers import ConvModule
from .ops import adaptive_avg_pool, resize_nchw


def resize_like(x: torch.Tensor, size,
                align_corners: bool = False) -> torch.Tensor:
    """``resize_nchw`` back in x's type."""
    return resize_nchw(x, size, align_corners).to(x.dtype)


def tokens(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H*W, C), the JAX package's ``reshape(b, h * w,
    c)`` of an NHWC map."""
    return x.flatten(2).transpose(1, 2)


def untokens(t: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, H*W, C) -> (B, C, H, W)."""
    return t.transpose(1, 2).reshape(t.shape[0], t.shape[2], h, w)


class AdaptiveAvgPool(nn.Module):
    """``ops.adaptive_avg_pool`` as a module (no parameters)."""

    def __init__(self, output_size):
        super().__init__()
        self.output_size = output_size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return adaptive_avg_pool(x, self.output_size)


class DecodeHead(nn.Module):
    """The shared tail: dropout (train mode) -> 1x1 ``conv_seg``."""

    def __init__(self, num_classes: int, dropout_ratio: float, in_index,
                 align_corners: bool):
        super().__init__()
        self.num_classes = num_classes
        self.in_index = in_index
        self.dropout_ratio = dropout_ratio
        self.align_corners = align_corners

    def classifier(self, channels: int) -> None:
        """``conv_seg``, made last (as flax makes it) by each head."""
        self.conv_seg = nn.Conv2d(channels, self.num_classes, 1)

    def resize(self, x: torch.Tensor, size) -> torch.Tensor:
        return resize_like(x, size, self.align_corners)

    def cls_seg(self, x: torch.Tensor,
                generator: Optional[torch.Generator]) -> torch.Tensor:
        if self.training and self.dropout_ratio > 0:
            keep = 1.0 - self.dropout_ratio
            mask = torch.rand(x.shape, generator=generator,
                              device=x.device) < keep
            x = torch.where(mask, x / keep, torch.zeros_like(x))
        return self.conv_seg(x)


@HEADS.register()
class PSPHead(DecodeHead):
    def __init__(self, in_channels: int = 2048, channels: int = 512,
                 num_classes: int = 19,
                 pool_scales: Sequence[int] = (1, 2, 3, 6),
                 in_index: int = 3, dropout_ratio: float = 0.1,
                 align_corners: bool = False):
        super().__init__(num_classes, dropout_ratio, in_index, align_corners)
        self.psp_modules = nn.ModuleList([
            nn.Sequential(AdaptiveAvgPool(s),
                          ConvModule(in_channels, channels, 1))
            for s in pool_scales])
        self.bottleneck = ConvModule(
            in_channels + len(pool_scales) * channels, channels, 3,
            padding=1)
        self.classifier(channels)

    def forward(self, inputs,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = inputs[self.in_index]
        hw = x.shape[-2:]
        outs = [x] + [self.resize(m(x), hw) for m in self.psp_modules]
        return self.cls_seg(self.bottleneck(torch.cat(outs, dim=1)),
                            generator)


def _select(inputs, in_index, align_corners: bool) -> torch.Tensor:
    """mmseg's ``resize_concat`` for a tuple ``in_index`` (the selections
    upsampled to the first one's size and concatenated), else one level."""
    if isinstance(in_index, (tuple, list)):
        sel = [inputs[i] for i in in_index]
        hw = sel[0].shape[-2:]
        return torch.cat([resize_like(f, hw, align_corners) for f in sel],
                         dim=1)
    return inputs[in_index]


@HEADS.register()
class FCNHead(DecodeHead):
    def __init__(self, in_channels=1024, channels: int = 256,
                 num_classes: int = 19, num_convs: int = 1,
                 kernel_size: int = 3, concat_input: bool = False,
                 in_index=2, dilation: int = 1, dropout_ratio: float = 0.1,
                 align_corners: bool = False):
        if isinstance(in_channels, (tuple, list)):
            in_channels = sum(in_channels)
        super().__init__(num_classes, dropout_ratio, in_index, align_corners)
        pad = (kernel_size // 2) * dilation
        self.convs = nn.ModuleList([
            ConvModule(in_channels if i == 0 else channels, channels,
                       kernel_size, padding=pad, dilation=dilation)
            for i in range(num_convs)])
        self.conv_cat = (ConvModule(in_channels + channels, channels,
                                    kernel_size, padding=kernel_size // 2)
                         if concat_input else None)
        self.classifier(channels if num_convs or concat_input
                        else in_channels)

    def forward(self, inputs,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = _select(inputs, self.in_index, self.align_corners)
        feats = x
        for conv in self.convs:
            feats = conv(feats)
        if self.conv_cat is not None:
            feats = self.conv_cat(torch.cat([x, feats], dim=1))
        return self.cls_seg(feats, generator)


def _named(module: nn.Module, prefix: str, mods) -> None:
    for i, m in enumerate(mods):
        module.add_module(f"{prefix}{i}", m)


@HEADS.register()
class UPerHead(DecodeHead):
    """Unified Perceptual Parsing (uper_head.py): PPM on the coarsest level
    and FPN fusion over all levels."""

    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 channels: int = 512, num_classes: int = 19,
                 pool_scales: Sequence[int] = (1, 2, 3, 6),
                 dropout_ratio: float = 0.1,
                 in_index: Sequence[int] = (0, 1, 2, 3),
                 align_corners: bool = False):
        super().__init__(num_classes, dropout_ratio, in_index, align_corners)
        self.pool_scales = tuple(pool_scales)
        top = in_channels[-1]
        _named(self, "ppm", [ConvModule(top, channels, 1)
                             for _ in pool_scales])
        _named(self, "lateral", [ConvModule(c, channels, 1)
                                 for c in in_channels[:-1]])
        self.ppm_bottleneck = ConvModule(
            top + len(pool_scales) * channels, channels, 3, padding=1)
        _named(self, "fpn_conv", [ConvModule(channels, channels, 3, padding=1)
                                  for _ in in_channels[:-1]])
        self.fpn_bottleneck = ConvModule(len(in_channels) * channels,
                                         channels, 3, padding=1)
        self.classifier(channels)

    def forward(self, inputs, generator=None) -> torch.Tensor:
        feats = [inputs[i] for i in self.in_index]
        top = feats[-1]
        hw = top.shape[-2:]
        ppm = [top] + [self.resize(getattr(self, f"ppm{i}")(
            adaptive_avg_pool(top, s)), hw)
            for i, s in enumerate(self.pool_scales)]
        lat = [getattr(self, f"lateral{i}")(f)
               for i, f in enumerate(feats[:-1])]
        lat.append(self.ppm_bottleneck(torch.cat(ppm, dim=1)))
        for i in range(len(lat) - 2, -1, -1):
            lat[i] = lat[i] + self.resize(lat[i + 1], lat[i].shape[-2:])
        outs = [getattr(self, f"fpn_conv{i}")(lat[i])
                for i in range(len(lat) - 1)] + [lat[-1]]
        hw0 = outs[0].shape[-2:]
        fused = torch.cat([self.resize(f, hw0) for f in outs], dim=1)
        return self.cls_seg(self.fpn_bottleneck(fused), generator)


class _ASPP(DecodeHead):
    """The image-pool branch and the dilated branches of the ASPP heads."""

    def __init__(self, in_channels, channels, num_classes, dilations,
                 dropout_ratio, in_index, align_corners):
        super().__init__(num_classes, dropout_ratio, in_index, align_corners)
        self.image_pool_conv = ConvModule(in_channels, channels, 1)
        _named(self, "aspp", [
            ConvModule(in_channels, channels, 1 if d == 1 else 3,
                       padding=0 if d == 1 else d, dilation=d)
            for d in dilations])
        self.n_aspp = len(dilations)
        self.bottleneck = ConvModule((len(dilations) + 1) * channels,
                                     channels, 3, padding=1)

    def aspp(self, x: torch.Tensor) -> torch.Tensor:
        img = self.resize(self.image_pool_conv(
            adaptive_avg_pool(x, 1)), x.shape[-2:])
        outs = [img] + [getattr(self, f"aspp{i}")(x)
                        for i in range(self.n_aspp)]
        return self.bottleneck(torch.cat(outs, dim=1))


@HEADS.register()
class ASPPHead(_ASPP):
    """DeepLabV3 (aspp_head.py)."""

    def __init__(self, in_channels: int = 2048, channels: int = 512,
                 num_classes: int = 19,
                 dilations: Sequence[int] = (1, 12, 24, 36),
                 dropout_ratio: float = 0.1, in_index: int = 3,
                 align_corners: bool = False):
        super().__init__(in_channels, channels, num_classes, dilations,
                         dropout_ratio, in_index, align_corners)
        self.classifier(channels)

    def forward(self, inputs, generator=None) -> torch.Tensor:
        return self.cls_seg(self.aspp(inputs[self.in_index]), generator)


@HEADS.register()
class DepthwiseSeparableASPPHead(_ASPP):
    """DeepLabV3+ (sep_aspp_head.py): ASPP and the low-level skip fusion.
    As in the JAX package, its convolutions are plain 3x3 ones, not
    depthwise-separable."""

    def __init__(self, in_channels: int = 2048, channels: int = 512,
                 num_classes: int = 19,
                 dilations: Sequence[int] = (1, 12, 24, 36),
                 c1_in_channels: int = 256, c1_channels: int = 48,
                 c1_index: int = 0, dropout_ratio: float = 0.1,
                 in_index: int = 3, align_corners: bool = False):
        super().__init__(in_channels, channels, num_classes, dilations,
                         dropout_ratio, in_index, align_corners)
        self.c1_index = c1_index
        self.c1_bottleneck = ConvModule(c1_in_channels, c1_channels, 1)
        self.sep_conv0 = ConvModule(channels + c1_channels, channels, 3,
                                    padding=1)
        self.sep_conv1 = ConvModule(channels, channels, 3, padding=1)
        self.classifier(channels)

    def forward(self, inputs, generator=None) -> torch.Tensor:
        feats = self.aspp(inputs[self.in_index])
        c1 = self.c1_bottleneck(inputs[self.c1_index])
        feats = torch.cat([self.resize(feats, c1.shape[-2:]), c1], dim=1)
        return self.cls_seg(self.sep_conv1(self.sep_conv0(feats)),
                            generator)


@HEADS.register()
class OCRHead(DecodeHead):
    """Object-Contextual Representations (ocr_head.py): soft object
    regions (its own ``soft_regions`` conv) gather class centroids, and
    pixels attend over them."""

    def __init__(self, in_channels: int = 2048, channels: int = 512,
                 ocr_channels: int = 256, num_classes: int = 19,
                 dropout_ratio: float = 0.1, in_index: int = 3,
                 align_corners: bool = False, scale: float = 1.0):
        super().__init__(num_classes, dropout_ratio, in_index, align_corners)
        self.scale = scale
        self.ocr_channels = ocr_channels
        self.bottleneck = ConvModule(in_channels, channels, 3, padding=1)
        self.soft_regions = ConvModule(channels, num_classes, 1,
                                       with_norm=False, with_act=False)
        self.query = nn.Linear(channels, ocr_channels)
        self.key = nn.Linear(channels, ocr_channels)
        self.value = nn.Linear(channels, ocr_channels)
        self.up_proj = nn.Linear(ocr_channels, channels)
        self.fuse = ConvModule(2 * channels, channels, 1)
        self.classifier(channels)

    def forward(self, inputs, generator=None,
                prev_logits: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``prev_logits``: a cascade's earlier stage's logits as the soft
        regions (the cascade then drops ``soft_regions``, which flax does
        not create for such a stage)."""
        feats = self.bottleneck(inputs[self.in_index])
        h, w = feats.shape[-2:]
        regions = (self.soft_regions(feats) if prev_logits is None
                   else prev_logits)
        probs = torch.softmax(tokens(regions) * self.scale, dim=1)
        pixels = tokens(feats)                               # (B, HW, C)
        context = torch.einsum("bpk,bpc->bkc", probs, pixels)
        sim = torch.einsum("bpc,bkc->bpk", self.query(pixels),
                           self.key(context)) / math.sqrt(
                               float(self.ocr_channels))
        ocr = torch.einsum("bpk,bkc->bpc", torch.softmax(sim, dim=-1),
                           self.value(context))
        out = untokens(torch.cat([pixels, self.up_proj(ocr)], dim=-1), h, w)
        return self.cls_seg(self.fuse(out), generator)


@HEADS.register()
class SegFormerHead(DecodeHead):
    """SegFormer's all-MLP head (segformer_head.py): a dense projection of
    each level's channels (``linear{i}``), resized to the finest level,
    concatenated, fused by a 1x1 ConvModule."""

    def __init__(self, in_channels: Sequence[int] = (32, 64, 160, 256),
                 channels: int = 256, num_classes: int = 19,
                 dropout_ratio: float = 0.1,
                 in_index: Sequence[int] = (0, 1, 2, 3),
                 align_corners: bool = False):
        super().__init__(num_classes, dropout_ratio, in_index, align_corners)
        _named(self, "linear", [nn.Linear(in_channels[i], channels)
                                for i in range(len(in_index))])
        self.fuse = ConvModule(len(in_index) * channels, channels, 1)
        self.classifier(channels)

    def forward(self, inputs, generator=None) -> torch.Tensor:
        feats = [inputs[i] for i in self.in_index]
        hw0 = feats[0].shape[-2:]
        projected = [self.resize(getattr(self, f"linear{i}")(
            f.permute(0, 2, 3, 1)).permute(0, 3, 1, 2), hw0)
            for i, f in enumerate(feats)]
        return self.cls_seg(self.fuse(torch.cat(projected, dim=1)),
                            generator)
