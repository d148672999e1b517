"""ConvNeXt backbone, NCHW maps out (port of
``peanut_tpu.models.convnext``): a 4x4 patchify stem + LN, blocks of a
depthwise 7x7, LN (1e-6), an inverted MLP with the exact GELU and a
``gamma`` layer scale, 2x2 strided downsampling between stages, an LN
on each output.  Submodules are named after the flax modules."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..registry import BACKBONES
from .layers import LayerNorm, gelu, ln_nchw

ARCHS = {
    "tiny": ((3, 3, 9, 3), (96, 192, 384, 768)),
    "small": ((3, 3, 27, 3), (96, 192, 384, 768)),
    "base": ((3, 3, 27, 3), (128, 256, 512, 1024)),
    "large": ((3, 3, 27, 3), (192, 384, 768, 1536)),
    "xlarge": ((3, 3, 27, 3), (256, 512, 1024, 2048)),
}


class ConvNeXtBlock(nn.Module):
    def __init__(self, dim: int, layer_scale_init_value: float = 1e-6):
        super().__init__()
        self.layer_scale_init_value = layer_scale_init_value
        self.depthwise_conv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = LayerNorm(dim)
        self.pointwise_conv1 = nn.Linear(dim, 4 * dim)
        self.pointwise_conv2 = nn.Linear(4 * dim, dim)
        self.gamma = (nn.Parameter(torch.empty(dim))
                      if layer_scale_init_value > 0 else None)

    @torch.no_grad()
    def flax_init_(self, generator) -> None:
        if self.gamma is not None:
            self.gamma.fill_(self.layer_scale_init_value)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.depthwise_conv(x).permute(0, 2, 3, 1)       # NHWC
        y = self.pointwise_conv2(gelu(self.pointwise_conv1(self.norm(y)),
                                      approximate=False))
        if self.gamma is not None:
            y = y * self.gamma
        return x + y.permute(0, 3, 1, 2)


@BACKBONES.register()
class ConvNeXt(nn.Module):
    def __init__(self, arch: str = "tiny",
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 layer_scale_init_value: float = 1e-6,
                 in_channels: int = 3):
        super().__init__()
        self.depths, dims = ARCHS[arch]
        self.out_indices = tuple(out_indices)
        self.downsample0_conv = nn.Conv2d(in_channels, dims[0], 4, stride=4)
        self.downsample0_norm = LayerNorm(dims[0])
        for i in range(4):
            if i:
                self.add_module(f"downsample{i}_norm", LayerNorm(dims[i - 1]))
                self.add_module(f"downsample{i}_conv", nn.Conv2d(
                    dims[i - 1], dims[i], 2, stride=2))
            for j in range(self.depths[i]):
                self.add_module(f"stage{i}_block{j}", ConvNeXtBlock(
                    dims[i], layer_scale_init_value))
            if i in self.out_indices:
                self.add_module(f"out_norm{i}", LayerNorm(dims[i]))
        self.out_channels = [dims[i] for i in self.out_indices]

    def forward(self, x: torch.Tensor):
        outs = []
        for i in range(4):
            if i == 0:
                x = ln_nchw(self.downsample0_norm, self.downsample0_conv(x))
            else:
                x = getattr(self, f"downsample{i}_conv")(
                    ln_nchw(getattr(self, f"downsample{i}_norm"), x))
            for j in range(self.depths[i]):
                x = getattr(self, f"stage{i}_block{j}")(x)
            if i in self.out_indices:
                outs.append(ln_nchw(getattr(self, f"out_norm{i}"), x))
        return tuple(outs)
