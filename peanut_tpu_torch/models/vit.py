"""ViT and Swin backbones, NCHW maps out (port of
``peanut_tpu.models.vit``).

ViT: a plain patch transformer whose taps are resized into a 4, 2, 1, 0.5
pyramid of its patch grid; Swin: windowed attention with shifted windows
and patch merging.  Attention is the JAX package's: products and a
softmax, the windows as a batch of small dense
attentions.  Tokens are (B, N, C) as in the JAX package; the maps each
backbone returns are (B, C, H, W).  Submodules and parameters are named
after the flax modules, so ``mmseg_import.flax_to_torch_state`` carries
the JAX package's variables.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import upload
from ..registry import BACKBONES
from .heads import resize_like, tokens, untokens
from .layers import LayerNorm, gelu, heads_merge, heads_split, normal_


class MLP(nn.Module):
    """fc1 -> exact-erf GELU -> fc2 (torch's nn.GELU, which the JAX
    package keeps here rather than flax's tanh default)."""

    def __init__(self, dim: int, ratio: int = 4):
        super().__init__()
        self.fc1 = nn.Linear(dim, dim * ratio)
        self.fc2 = nn.Linear(dim * ratio, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x), approximate=False))


@functools.lru_cache(maxsize=16)
def _rel_pos_index(w: int) -> np.ndarray:
    """The relative-position index of a w x w grid (Swin's window, BEiT's
    patch grid): pair (i, j) of its cells -> the row of the ((2w-1)^2,
    heads) table.  Cached; not to be written."""
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w),
                                  indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel = rel + (w - 1)
    return (rel[..., 0] * (2 * w - 1) + rel[..., 1]).astype(np.int64)


class Attention(nn.Module):
    """Multi-head self-attention over (B, N, C) tokens: one ``qkv`` dense,
    the product divided by sqrt(head_dim), an additive bias, softmax,
    ``proj``.  ``window_size`` > 0: Swin's window attention, with a
    learned ((2w-1)^2, heads) relative-position table
    (``rel_pos_bias_table``)."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 0):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
        if window_size:
            self.rel_pos_bias_table = nn.Parameter(torch.empty(
                (2 * window_size - 1) ** 2, num_heads))
            self.register_buffer("rel_index", torch.as_tensor(
                _rel_pos_index(window_size).reshape(-1)), persistent=False)

    @torch.no_grad()
    def flax_init_(self, generator) -> None:
        if self.window_size:
            normal_(self.rel_pos_bias_table, 0.02, generator)

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        """x (B, N, C); ``mask`` an additive (nW, 1, N, N) shift mask, B a
        multiple of nW (the windows of each image in turn)."""
        b, n, _ = x.shape
        h = self.num_heads
        q, k, v = (heads_split(t, h) for t in self.qkv(x).chunk(3, dim=-1))
        attn = torch.einsum("bhnd,bhmd->bhnm", q, k) / math.sqrt(q.shape[-1])
        if self.window_size:
            rel = self.rel_pos_bias_table[self.rel_index].reshape(n, n, h)
            attn = attn + rel.permute(2, 0, 1)[None]
        if mask is not None:
            nw = mask.shape[0]
            attn = (attn.reshape(b // nw, nw, *attn.shape[1:])
                    + mask[None]).reshape(attn.shape)
        out = torch.einsum("bhnm,bhmd->bhnd", torch.softmax(attn, dim=-1), v)
        return self.proj(heads_merge(out))


class ViTBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads)
        self.norm2 = LayerNorm(dim)
        self.mlp = MLP(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


def tap_pyramid(taps, gh: int, gw: int, scales=(4, 2, 1, 0.5), floor=0):
    """(B, C, gh, gw) taps resized to ``int(g * s)`` (at least ``floor``)
    cells a side, scale by scale: the 4x .. 0.5x pyramid the JAX package
    makes of a plain transformer's grid (half-pixel centres)."""
    return tuple(resize_like(t, (max(int(gh * s), floor),
                                 max(int(gw * s), floor)))
                 for t, s in zip(taps, scales))


@BACKBONES.register()
class VisionTransformer(nn.Module):
    """ViT with SETR-style taps after the blocks of ``out_indices``,
    resized into a /4 .. /32-like pyramid of the patch grid.  The
    positional embedding is a (1, base, base, C) grid (base = img_size //
    patch_size), resized bilinearly to the input's patch grid."""

    def __init__(self, embed_dim: int = 768, depth: int = 12,
                 num_heads: int = 12, patch_size: int = 16,
                 out_indices: Sequence[int] = (2, 5, 8, 11),
                 with_pos_embed: bool = True, img_size: int = 224,
                 in_channels: int = 3):
        super().__init__()
        self.embed_dim = embed_dim
        self.out_indices = tuple(out_indices)
        self.patch_embed = nn.Conv2d(in_channels, embed_dim, patch_size,
                                     stride=patch_size)
        base = img_size // patch_size
        self.pos_embed = (nn.Parameter(torch.empty(1, base, base, embed_dim))
                          if with_pos_embed else None)
        for i in range(depth):
            self.add_module(f"block{i}", ViTBlock(embed_dim, num_heads))
        self.depth = depth
        self.out_channels = [embed_dim] * len(
            [i for i in self.out_indices if i < depth][:4])

    @torch.no_grad()
    def flax_init_(self, generator) -> None:
        if self.pos_embed is not None:
            normal_(self.pos_embed, 0.02, generator)

    def forward(self, x: torch.Tensor):
        x = self.patch_embed(x)
        gh, gw = x.shape[-2:]
        t = tokens(x)
        if self.pos_embed is not None:
            pos = resize_like(self.pos_embed.permute(0, 3, 1, 2), (gh, gw))
            t = t + tokens(pos)
        taps = []
        for i in range(self.depth):
            t = getattr(self, f"block{i}")(t)
            if i in self.out_indices:
                taps.append(untokens(t, gh, gw))
        return tap_pyramid(taps, gh, gw)


def _window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) -> (B * nW, ws*ws, C), windows row-major."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, c)


def _window_reverse(wins: torch.Tensor, ws: int, b: int, h: int,
                    w: int) -> torch.Tensor:
    c = wins.shape[-1]
    x = wins.reshape(b, h // ws, w // ws, ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


@functools.lru_cache(maxsize=64)
def _shift_attn_mask(hp: int, wp: int, ws: int, shift: int) -> np.ndarray:
    """Shifted-window attention mask (nW, ws*ws, ws*ws): 0 within one
    region of the rolled map, -100 across the seams the roll brings
    together (Swin's ShiftWindowMSA).  Cached; not to be written."""
    img = np.zeros((1, hp, wp, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for vs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, vs] = cnt
            cnt += 1
    win = (img.reshape(1, hp // ws, ws, wp // ws, ws, 1)
           .transpose(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws))
    diff = win[:, None, :] - win[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


class SwinBlock(nn.Module):
    """One Swin block on a (B, H, W, C) map: LN, padded to whole windows,
    rolled by -shift (with the seam mask), window attention, rolled back,
    cropped; then the residual MLP."""

    def __init__(self, dim: int, num_heads: int, window: int = 7,
                 shift: int = 0):
        super().__init__()
        self.window = window
        self.shift = shift
        self.norm1 = LayerNorm(dim)
        self.attn = Attention(dim, num_heads, window_size=window)
        self.norm2 = LayerNorm(dim)
        self.mlp = MLP(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        ws, s = self.window, self.shift
        y = F.pad(self.norm1(x), (0, 0, 0, (-w) % ws, 0, (-h) % ws))
        hp, wp = y.shape[1:3]
        mask = None
        if s:
            y = torch.roll(y, (-s, -s), dims=(1, 2))
            mask = upload(_shift_attn_mask(hp, wp, ws, s),
                          x.device).to(x.dtype)[:, None]
        wins = self.attn(_window_partition(y, ws), mask)
        y = _window_reverse(wins, ws, b, hp, wp)
        if s:
            y = torch.roll(y, (s, s), dims=(1, 2))
        x = x + y[:, :h, :w]
        return x + self.mlp(self.norm2(x))


@BACKBONES.register()
class SwinTransformer(nn.Module):
    """Swin-T-shaped hierarchical backbone: a 4x4 patch embedding (with
    its LN), stages of shifted-window blocks, an LN on each stage's
    output, and 2x2 patch merging (LN + dense) between stages."""

    def __init__(self, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window: int = 7,
                 patch_size: int = 4, patch_norm: bool = True,
                 in_channels: int = 3):
        super().__init__()
        self.depths = tuple(depths)
        self.patch_embed = nn.Conv2d(in_channels, embed_dim, patch_size,
                                     stride=patch_size)
        self.patch_norm_ln = LayerNorm(embed_dim) if patch_norm else None
        dim = embed_dim
        self.out_channels = []
        for s, (depth, heads) in enumerate(zip(depths, num_heads)):
            for i in range(depth):
                self.add_module(f"stage{s}_block{i}", SwinBlock(
                    dim, heads, window, 0 if i % 2 == 0 else window // 2))
            self.add_module(f"out_norm{s}", LayerNorm(dim))
            self.out_channels.append(dim)
            if s < len(depths) - 1:
                self.add_module(f"merge_norm{s}", LayerNorm(4 * dim))
                self.add_module(f"merge{s}", nn.Linear(4 * dim, 2 * dim))
                dim *= 2

    def forward(self, x: torch.Tensor):
        x = self.patch_embed(x).permute(0, 2, 3, 1)          # NHWC
        if self.patch_norm_ln is not None:
            x = self.patch_norm_ln(x)
        outs = []
        for s, depth in enumerate(self.depths):
            for i in range(depth):
                x = getattr(self, f"stage{s}_block{i}")(x)
            outs.append(getattr(self, f"out_norm{s}")(x).permute(0, 3, 1, 2))
            if s < len(self.depths) - 1:
                h, w = x.shape[1:3]
                x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
                x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2],
                               x[:, 0::2, 1::2], x[:, 1::2, 1::2]], dim=-1)
                x = getattr(self, f"merge{s}")(
                    getattr(self, f"merge_norm{s}")(x))
        return tuple(outs)
