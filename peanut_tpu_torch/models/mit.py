"""Mix Vision Transformer, SegFormer's backbone, NCHW maps out (port of
``peanut_tpu.models.mit``): overlapping patch embeddings, attention whose
keys and values come from a map reduced by a strided conv (+ LN) where
``sr_ratio`` > 1, and the Mix-FFN (a depthwise 3x3 in the MLP, flax's
tanh GELU).  Submodules are named after the flax modules."""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ..registry import BACKBONES
from .heads import tokens, untokens
from .layers import LayerNorm, attend, gelu, heads_merge, heads_split


class EfficientAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, sr_ratio: int = 1):
        super().__init__()
        self.num_heads = num_heads
        self.q = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, stride=sr_ratio)
            self.sr_norm = LayerNorm(dim)
        else:
            self.sr = self.sr_norm = None
        self.kv = nn.Linear(dim, dim * 2)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        xr = x
        if self.sr is not None:
            xr = self.sr_norm(tokens(self.sr(untokens(x, h, w))))
        k, v = self.kv(xr).chunk(2, dim=-1)
        nh = self.num_heads
        q = heads_split(self.q(x), nh)
        out = attend(q, heads_split(k, nh), heads_split(v, nh),
                     divisor=math.sqrt(q.shape[-1]))
        return self.proj(heads_merge(out))


class MixFFN(nn.Module):
    def __init__(self, dim: int, ratio: int = 4):
        super().__init__()
        hidden = dim * ratio
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = nn.Conv2d(hidden, hidden, 3, padding=1, groups=hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        x = tokens(self.dwconv(untokens(self.fc1(x), h, w)))
        return self.fc2(gelu(x, approximate=True))


class MiTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, sr_ratio: int,
                 mlp_ratio: int = 4):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = EfficientAttention(dim, num_heads, sr_ratio)
        self.norm2 = LayerNorm(dim)
        self.ffn = MixFFN(dim, mlp_ratio)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), h, w)
        return x + self.ffn(self.norm2(x), h, w)


@BACKBONES.register()
class MixVisionTransformer(nn.Module):
    """MiT-B0 by default: four stages, each an overlapping patch embedding
    (conv of ``patch_sizes`` at ``patch_strides``, padded by half the
    kernel) + LN, MiT blocks, an output LN."""

    def __init__(self, embed_dims: Sequence[int] = (32, 64, 160, 256),
                 num_layers: Sequence[int] = (2, 2, 2, 2),
                 num_heads: Sequence[int] = (1, 2, 5, 8),
                 sr_ratios: Sequence[int] = (8, 4, 2, 1),
                 patch_sizes: Sequence[int] = (7, 3, 3, 3),
                 patch_strides: Sequence[int] = (4, 2, 2, 2),
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 in_channels: int = 3):
        super().__init__()
        self.num_layers = tuple(num_layers)
        self.out_indices = tuple(out_indices)
        cin = in_channels
        for i, dim in enumerate(embed_dims):
            self.add_module(f"patch_embed{i + 1}", nn.Conv2d(
                cin, dim, patch_sizes[i], stride=patch_strides[i],
                padding=patch_sizes[i] // 2))
            self.add_module(f"embed_norm{i + 1}", LayerNorm(dim))
            for j in range(num_layers[i]):
                self.add_module(f"stage{i + 1}_block{j}", MiTBlock(
                    dim, num_heads[i], sr_ratios[i]))
            self.add_module(f"out_norm{i + 1}", LayerNorm(dim))
            cin = dim
        self.out_channels = [embed_dims[i] for i in self.out_indices]

    def forward(self, x: torch.Tensor):
        outs = []
        for i, depth in enumerate(self.num_layers):
            x = getattr(self, f"patch_embed{i + 1}")(x)
            h, w = x.shape[-2:]
            t = getattr(self, f"embed_norm{i + 1}")(tokens(x))
            for j in range(depth):
                t = getattr(self, f"stage{i + 1}_block{j}")(t, h, w)
            x = untokens(getattr(self, f"out_norm{i + 1}")(t), h, w)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)


# SegFormer's size aliases
@BACKBONES.register(name="MITB0")
class MITB0(MixVisionTransformer):
    pass


@BACKBONES.register(name="MITB2")
class MITB2(MixVisionTransformer):
    def __init__(self, embed_dims: Sequence[int] = (64, 128, 320, 512),
                 num_layers: Sequence[int] = (3, 4, 6, 3), **kw):
        super().__init__(embed_dims=embed_dims, num_layers=num_layers, **kw)
