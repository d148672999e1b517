"""The zoo's transformer backbones beyond ViT, Swin, MiT and ConvNeXt,
NCHW maps out (port of the transformer half of
``peanut_tpu.models.backbones_zoo``): Twins (PCPVT, SVT), BEiT and MAE.
The light CNN half of that file (MobileNet, BiSeNet, STDC, ...) is ROADMAP
A13 part 4.  Submodules and parameters are named after the flax modules.

flax's ``nn.Conv`` pads "SAME" by default (``layers.SameConv2d``); two
parameters take their shape from the input at init, and so here from the
first input or the loaded state dict (``layers.InputShaped``): BEiT's
relative-position table spans the patch grid's height, MAE's positional
embedding every patch.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .. import upload
from ..registry import BACKBONES
from .heads import tokens, untokens
from .layers import (InputShaped, LayerNorm, SameConv2d, attend, gelu,
                     heads_merge, heads_split, normal_)
from .vit import ViTBlock, _rel_pos_index, tap_pyramid


class _SRAttention(nn.Module):
    """Twins' global sub-sampled attention: keys and values from the map
    reduced by an ``sr_ratio`` conv (+ LN)."""

    def __init__(self, dim: int, num_heads: int, sr_ratio: int = 1):
        super().__init__()
        self.num_heads = num_heads
        self.q = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = SameConv2d(dim, dim, sr_ratio, stride=sr_ratio)
            self.sr_norm = LayerNorm(dim)
        else:
            self.sr = self.sr_norm = None
        self.kv = nn.Linear(dim, dim * 2)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, hw) -> torch.Tensor:
        kv_in = x
        if self.sr is not None:
            kv_in = self.sr_norm(tokens(self.sr(untokens(x, *hw))))
        k, v = self.kv(kv_in).chunk(2, dim=-1)
        nh = self.num_heads
        q = heads_split(self.q(x), nh)
        out = attend(q, heads_split(k, nh), heads_split(v, nh),
                     divisor=math.sqrt(q.shape[-1]))
        return self.proj(heads_merge(out))


class _LocalAttention(nn.Module):
    """Twins-SVT's locally grouped attention: windows of ``min(window, h,
    w)`` cells a side over the map padded to whole windows, cropped
    back."""

    def __init__(self, dim: int, num_heads: int, window: int = 7):
        super().__init__()
        self.num_heads = num_heads
        self.window = window
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, hw) -> torch.Tensor:
        b, n, c = x.shape
        h, w = hw
        ws = min(self.window, h, w)
        g = F.pad(x.reshape(b, h, w, c), (0, 0, 0, (-w) % ws, 0, (-h) % ws))
        hh, ww = g.shape[1:3]
        g = (g.reshape(b, hh // ws, ws, ww // ws, ws, c)
             .permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c))
        nh = self.num_heads
        q, k, v = (heads_split(t, nh) for t in self.qkv(g).chunk(3, dim=-1))
        out = self.proj(heads_merge(attend(q, k, v,
                                           divisor=math.sqrt(q.shape[-1]))))
        out = (out.reshape(b, hh // ws, ww // ws, ws, ws, c)
               .permute(0, 1, 3, 2, 4, 5).reshape(b, hh, ww, c))
        return out[:, :h, :w].reshape(b, n, c)


class _TwinsBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, sr_ratio: int = 1,
                 local_window: int = 0, mlp_ratio: int = 4):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = (_LocalAttention(dim, num_heads, local_window)
                     if local_window > 0
                     else _SRAttention(dim, num_heads, sr_ratio))
        self.norm2 = LayerNorm(dim)
        self.fc1 = nn.Linear(dim, dim * mlp_ratio)
        self.fc2 = nn.Linear(dim * mlp_ratio, dim)

    def forward(self, x: torch.Tensor, hw) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), hw)
        return x + self.fc2(gelu(self.fc1(self.norm2(x)), approximate=True))


@BACKBONES.register()
class PCPVT(nn.Module):
    """Twins-PCPVT: a pyramid transformer whose position encoding is a
    depthwise 3x3 conv (PEG, ``peg{s}``) after the first block of each
    stage; ``windows`` > 0 puts locally grouped attention on the even
    blocks (SVT)."""

    def __init__(self, embed_dims: Sequence[int] = (64, 128, 320, 512),
                 num_heads: Sequence[int] = (1, 2, 5, 8),
                 depths: Sequence[int] = (3, 4, 6, 3),
                 sr_ratios: Sequence[int] = (8, 4, 2, 1),
                 mlp_ratios: Sequence[int] = (8, 8, 4, 4),
                 windows: Sequence[int] = (0, 0, 0, 0),
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 in_channels: int = 3):
        super().__init__()
        self.depths = tuple(depths)
        self.out_indices = tuple(out_indices)
        cin = in_channels
        for s, dim in enumerate(embed_dims):
            patch = 4 if s == 0 else 2
            self.add_module(f"patch_embed{s}", SameConv2d(
                cin, dim, patch, stride=patch))
            self.add_module(f"embed_norm{s}", LayerNorm(dim))
            for j in range(depths[s]):
                self.add_module(f"block{s}_{j}", _TwinsBlock(
                    dim, num_heads[s], sr_ratios[s],
                    local_window=windows[s] if j % 2 == 0 else 0,
                    mlp_ratio=mlp_ratios[s]))
                if j == 0:
                    self.add_module(f"peg{s}", nn.Conv2d(
                        dim, dim, 3, padding=1, groups=dim))
            self.add_module(f"out_norm{s}", LayerNorm(dim))
            cin = dim
        self.out_channels = [embed_dims[s] for s in self.out_indices]

    def forward(self, x: torch.Tensor):
        outs = []
        for s, depth in enumerate(self.depths):
            x = getattr(self, f"patch_embed{s}")(x)
            h, w = x.shape[-2:]
            t = getattr(self, f"embed_norm{s}")(tokens(x))
            for j in range(depth):
                t = getattr(self, f"block{s}_{j}")(t, (h, w))
                if j == 0:
                    g = untokens(t, h, w)
                    t = tokens(g + getattr(self, f"peg{s}")(g))
            x = untokens(getattr(self, f"out_norm{s}")(t), h, w)
            if s in self.out_indices:
                outs.append(x)
        return tuple(outs)


@BACKBONES.register()
class SVT(PCPVT):
    """Twins-SVT: PCPVT with locally grouped attention (window 7) on the
    even blocks, global sub-sampled attention on the odd ones."""

    def __init__(self, embed_dims: Sequence[int] = (64, 128, 256, 512),
                 num_heads: Sequence[int] = (2, 4, 8, 16),
                 depths: Sequence[int] = (2, 2, 10, 4),
                 windows: Sequence[int] = (7, 7, 7, 7),
                 mlp_ratios: Sequence[int] = (4, 4, 4, 4), **kw):
        super().__init__(embed_dims=embed_dims, num_heads=num_heads,
                         depths=depths, windows=windows,
                         mlp_ratios=mlp_ratios, **kw)


class _BEiTBlock(InputShaped):
    """A BEiT block: attention with a learned relative-position bias over
    the patch grid and LayerScale (``gamma1``, ``gamma2``).  The table
    (``rel_pos_bias``, ((2g-1)^2, heads)) is shaped by the grid's height
    g, as flax shapes it at init; the bias joins the product only when
    the input has g * g patches (a square grid), as in the JAX
    package."""

    input_shaped = ("rel_pos_bias",)

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.norm1 = LayerNorm(dim)
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
        self.gamma1 = nn.Parameter(torch.empty(dim))
        self.norm2 = LayerNorm(dim)
        self.fc1 = nn.Linear(dim, dim * 4)
        self.fc2 = nn.Linear(dim * 4, dim)
        self.gamma2 = nn.Parameter(torch.empty(dim))

    @torch.no_grad()
    def flax_init_(self, generator) -> None:
        super().flax_init_(generator)
        self.gamma1.fill_(0.1)
        self.gamma2.fill_(0.1)

    def forward(self, x: torch.Tensor, grid: int) -> torch.Tensor:
        n = x.shape[1]
        nh = self.num_heads
        table = self.bind(
            "rel_pos_bias", ((2 * grid - 1) ** 2, nh), x,
            lambda t, g: normal_(t, 0.02, g, truncated=True),
            f"BEiT's relative-position table spans a patch grid of another "
            f"height than {grid}")
        q, k, v = (heads_split(t, nh)
                   for t in self.qkv(self.norm1(x)).chunk(3, dim=-1))
        bias = None
        if n == grid * grid:
            idx = upload(_rel_pos_index(grid).reshape(-1), x.device)
            bias = table[idx].reshape(n, n, nh).permute(2, 0, 1)[None]
        out = attend(q, k, v, divisor=math.sqrt(q.shape[-1]), bias=bias)
        x = x + self.gamma1 * self.proj(heads_merge(out))
        y = self.fc2(gelu(self.fc1(self.norm2(x)), approximate=True))
        return x + self.gamma2 * y


@BACKBONES.register()
class BEiT(nn.Module):
    """BEiT: a ViT of BEiT blocks ("SAME"-padded patch embedding, no
    positional embedding), taps after ``out_indices`` resized into a 4x ..
    0.5x pyramid of the patch grid."""

    def __init__(self, embed_dim: int = 768, depth: int = 12,
                 num_heads: int = 12, patch_size: int = 16,
                 out_indices: Sequence[int] = (3, 5, 7, 11),
                 in_channels: int = 3):
        super().__init__()
        self.depth = depth
        self.out_indices = tuple(out_indices)
        self.patch_embed = SameConv2d(in_channels, embed_dim, patch_size,
                                      stride=patch_size)
        for i in range(depth):
            self.add_module(f"block{i}", _BEiTBlock(embed_dim, num_heads))
        self.out_channels = [embed_dim] * len(
            [i for i in self.out_indices if i < depth][:4])

    def forward(self, x: torch.Tensor):
        x = self.patch_embed(x)
        h, w = x.shape[-2:]
        t = tokens(x)
        taps = []
        for i in range(self.depth):
            t = getattr(self, f"block{i}")(t, h)
            if i in self.out_indices:
                taps.append(untokens(t, h, w))
        return tap_pyramid(taps, h, w, floor=1)


@BACKBONES.register()
class MAE(InputShaped):
    """MAE's fine-tuning encoder: a plain ViT ("SAME"-padded patch
    embedding, a positional embedding per patch), an LN on each tap
    (``tap_norm{i}``), the taps resized into a 4x .. 0.5x pyramid.  The
    embedding (``pos_embed``, (1, h * w, C)) has one row per patch of
    the grid flax initialised it on, so the model takes inputs of that
    many patches alone."""

    input_shaped = ("pos_embed",)

    def __init__(self, embed_dim: int = 768, depth: int = 12,
                 num_heads: int = 12, patch_size: int = 16,
                 out_indices: Sequence[int] = (3, 5, 7, 11),
                 in_channels: int = 3):
        super().__init__()
        self.depth = depth
        self.out_indices = tuple(out_indices)
        self.patch_embed = SameConv2d(in_channels, embed_dim, patch_size,
                                      stride=patch_size)
        for i in range(depth):
            self.add_module(f"block{i}", ViTBlock(embed_dim, num_heads))
            if i in self.out_indices:
                self.add_module(f"tap_norm{i}", LayerNorm(embed_dim))
        self.out_channels = [embed_dim] * len(
            [i for i in self.out_indices if i < depth][:4])

    def forward(self, x: torch.Tensor):
        x = self.patch_embed(x)
        h, w = x.shape[-2:]
        t = tokens(x)
        t = t + self.bind(
            "pos_embed", (1,) + tuple(t.shape[1:]), t,
            lambda p, g: normal_(p, 0.02, g, truncated=True),
            "MAE's positional embedding was shaped for another number of "
            "patches")
        taps = []
        for i in range(self.depth):
            t = getattr(self, f"block{i}")(t)
            if i in self.out_indices:
                taps.append(untokens(getattr(self, f"tap_norm{i}")(t), h, w))
        return tap_pyramid(taps, h, w, floor=1)
