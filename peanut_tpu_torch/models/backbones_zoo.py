"""The zoo's backbones beyond ResNet, ViT, Swin, MiT, ConvNeXt, HRNet,
UNet and MobileNetV2, NCHW maps out (port of
``peanut_tpu.models.backbones_zoo``): the transformers Twins (PCPVT,
SVT), BEiT and MAE, and the light CNNs ResNeSt, MobileNetV3, Fast-SCNN,
CGNet, ERFNet, BiSeNet V1 and V2, STDC (STDCNet, STDCContextPathNet) and
ICNet.  Submodules and parameters are named after the flax modules; a
host backbone (BiSeNetV1's ``context_backbone``, STDC's ``backbone``)
comes from the registry.  Average pools count their padding
(``count_include_pad=True``), as flax's ``nn.avg_pool`` does.

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
from .heads import resize_like, tokens, untokens
from .layers import (BatchNorm, ConvModule, InputShaped, LayerNorm, PReLU,
                     SameConv2d, attend, gelu, heads_merge, heads_split,
                     hsigmoid, hswish, normal_)
from .mobilenet import InvertedResidual
from .ops import adaptive_avg_pool
from .resnet import ZooBottleneck
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
        table = self.table(grid, x)
        q, k, v = self.qkv(self.norm1(x)).chunk(3, dim=-1)
        bias = None
        if n == grid * grid:
            bias = self.bias(table, grid, upload(
                _rel_pos_index(grid).reshape(-1), x.device))
        x = x + self.gamma1 * self.proj(self.mix(q, k, v, bias))
        y = self.fc2(gelu(self.fc1(self.norm2(x)), approximate=True))
        return x + self.gamma2 * y

    def table(self, grid: int, like: torch.Tensor) -> torch.Tensor:
        """``rel_pos_bias``, bound (on ``like``'s device, in its type) by
        the patch grid's height ``grid`` if unbound."""
        return self.bind(
            "rel_pos_bias", ((2 * grid - 1) ** 2, self.num_heads), like,
            lambda t, g: normal_(t, 0.02, g, truncated=True),
            f"BEiT's relative-position table spans a patch grid of another "
            f"height than {grid}")

    def bias(self, table: torch.Tensor, grid: int,
             index: torch.Tensor) -> torch.Tensor:
        """The bias of the queries whose rows of ``_rel_pos_index(grid)``
        ``index`` holds, flattened, against every patch of the g x g grid:
        (1, heads, queries, g * g)."""
        n = grid * grid
        return table[index].reshape(index.shape[0] // n, n,
                                    self.num_heads).permute(2, 0, 1)[None]

    def mix(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            bias) -> torch.Tensor:
        """Projected queries (B, N, C) against keys and values (B, M, C),
        plus ``bias`` where it joins, the heads merged (before ``proj``)."""
        nh = self.num_heads
        q, k, v = (heads_split(t, nh) for t in (q, k, v))
        return heads_merge(attend(q, k, v, divisor=math.sqrt(q.shape[-1]),
                                  bias=bias))


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
        t = t + self.positions(h * w, t)
        taps = []
        for i in range(self.depth):
            t = getattr(self, f"block{i}")(t)
            if i in self.out_indices:
                taps.append(untokens(getattr(self, f"tap_norm{i}")(t), h, w))
        return tap_pyramid(taps, h, w, floor=1)

    def positions(self, n: int, like: torch.Tensor) -> torch.Tensor:
        """``pos_embed``, (1, n, C) for a grid of n patches, bound (on
        ``like``'s device, in its type) if unbound."""
        return self.bind(
            "pos_embed", (1, n, self.patch_embed.out_channels), like,
            lambda p, g: normal_(p, 0.02, g, truncated=True),
            "MAE's positional embedding was shaped for another number of "
            "patches")


# ---------------------------------------------------------------------------
# the light CNN half
# ---------------------------------------------------------------------------


def _avg_pool3(x: torch.Tensor, stride: int) -> torch.Tensor:
    """flax's ``nn.avg_pool(x, (3, 3), strides, padding=((1, 1), (1, 1)))``:
    the padding counts in the mean (``count_include_pad=True``, flax's
    default and ``F.avg_pool2d``'s; not mmseg's False)."""
    return F.avg_pool2d(x, 3, stride, 1, count_include_pad=True)


def _gap(x: torch.Tensor) -> torch.Tensor:
    """The mean over H and W, kept as a (B, C, 1, 1) map."""
    return x.mean(dim=(2, 3), keepdim=True)


class SELayer(nn.Module):
    """Squeeze-excitation (mmcv se_layer.py): the map's mean through
    ``fc1`` (1x1 conv, ReLU) and ``fc2`` (1x1 conv), an h-sigmoid or
    sigmoid gate on the channels."""

    def __init__(self, channels: int, ratio: int = 4,
                 gate: str = "hsigmoid"):
        super().__init__()
        self.gate = gate
        self.fc1 = nn.Conv2d(channels, max(channels // ratio, 1), 1)
        self.fc2 = nn.Conv2d(max(channels // ratio, 1), channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = self.fc2(F.relu(self.fc1(_gap(x))))
        s = hsigmoid(s) if self.gate == "hsigmoid" else torch.sigmoid(s)
        return x * s


# ---- ResNeSt ----------------------------------------------------------


class SplitAttentionConv(nn.Module):
    """resnest.py's SplitAttentionConv2d: a grouped 3x3 conv to ``radix``
    splits of ``channels``, their sum's mean through ``fc1`` (ConvModule)
    and ``fc2``, a softmax over the radix, and the splits weighted by
    it and summed."""

    def __init__(self, in_channels: int, channels: int, radix: int = 2,
                 groups: int = 1, stride: int = 1, dilation: int = 1):
        super().__init__()
        self.radix, self.channels = radix, channels
        self.conv = nn.Conv2d(in_channels, channels * radix, 3,
                              stride=stride, padding=dilation,
                              dilation=dilation, groups=groups * radix,
                              bias=False)
        self.bn0 = BatchNorm(channels * radix)
        inter = max(channels * radix // 4, 32)
        self.fc1 = ConvModule(channels, inter, 1)
        self.fc2 = nn.Conv2d(inter, channels * radix, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn0(self.conv(x)))
        b, _, h, w = y.shape
        r, c = self.radix, self.channels
        splits = y.reshape(b, r, c, h, w)     # NHWC's (..., r, c) channels
        atten = self.fc2(self.fc1(_gap(splits.sum(dim=1))))
        atten = torch.softmax(atten.reshape(b, r, c, 1, 1), dim=1)
        return (splits * atten).sum(dim=1)


class ResNeStBottleneck(nn.Module):
    """ResNeSt's bottleneck: 1x1, (a 3x3 average pool of the stride, the
    ``avg_down_stride`` form) the split-attention 3x3, 1x1 to planes * 4;
    the shortcut average-pooled by the stride (no padding) before its 1x1
    conv."""

    def __init__(self, in_channels: int, planes: int, stride: int = 1,
                 dilation: int = 1, downsample: bool = False,
                 radix: int = 2, avg_down_stride: bool = True):
        super().__init__()
        self.stride = stride
        self.pool_first = avg_down_stride and stride > 1
        self.conv1 = nn.Conv2d(in_channels, planes, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = SplitAttentionConv(
            planes, planes, radix=radix,
            stride=1 if self.pool_first else stride, dilation=dilation)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = BatchNorm(planes * 4)
        if downsample:
            self.downsample_conv = nn.Conv2d(in_channels, planes * 4, 1,
                                             bias=False)
            self.downsample_bn = BatchNorm(planes * 4)
        else:
            self.downsample_conv = self.downsample_bn = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x
        out = F.relu(self.bn1(self.conv1(x)))
        if self.pool_first:
            out = _avg_pool3(out, self.stride)
        out = self.bn3(self.conv3(self.conv2(out)))
        if self.downsample_conv is not None:
            if self.stride > 1:        # the avg-down shortcut
                identity = F.avg_pool2d(identity, self.stride, self.stride)
            identity = self.downsample_bn(self.downsample_conv(identity))
        return F.relu(out + identity)


RESNEST_ARCH = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 200: (3, 24, 36, 3)}


@BACKBONES.register()
class ResNeSt(nn.Module):
    """ResNeSt (resnest.py): the deep stem (``stem0``-``stem2``), a max
    pool, and split-attention bottlenecks ``layer{i}_{j}``."""

    def __init__(self, depth: int = 50, in_channels: int = 3,
                 stem_channels: int = 64, base_channels: int = 64,
                 radix: int = 2, num_stages: int = 4,
                 strides: Sequence[int] = (1, 2, 2, 2),
                 dilations: Sequence[int] = (1, 1, 1, 1),
                 out_indices: Sequence[int] = (0, 1, 2, 3),
                 contract_dilation: bool = False):
        super().__init__()
        self.num_stages = num_stages
        self.out_indices = tuple(out_indices)
        self.stage_blocks = RESNEST_ARCH[depth]
        half = stem_channels // 2
        self.stem0 = ConvModule(in_channels, half, 3, stride=2, padding=1)
        self.stem1 = ConvModule(half, half, 3, padding=1)
        self.stem2 = ConvModule(half, stem_channels, 3, padding=1)
        ch = stem_channels
        for i in range(num_stages):
            planes = base_channels * 2 ** i
            for j in range(self.stage_blocks[i]):
                first = j == 0
                d = dilations[i]
                if first and d > 1 and contract_dilation:
                    d = d // 2
                self.add_module(f"layer{i + 1}_{j}", ResNeStBottleneck(
                    ch, planes, stride=strides[i] if first else 1,
                    dilation=d,
                    downsample=first and (strides[i] != 1
                                          or ch != planes * 4),
                    radix=radix))
                ch = planes * 4
        self.out_channels = [base_channels * 2 ** i * 4
                             for i in self.out_indices]

    def forward(self, x: torch.Tensor):
        x = self.stem2(self.stem1(self.stem0(x)))
        x = F.max_pool2d(x, 3, 2, 1)
        outs = []
        for i in range(self.num_stages):
            for j in range(self.stage_blocks[i]):
                x = getattr(self, f"layer{i + 1}_{j}")(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)


# ---- MobileNetV3 ------------------------------------------------------

# kernel, expand_ch, out_ch, use_se, act, stride
MBV3_ARCH = {
    "small": [
        (3, 16, 16, True, "relu", 2), (3, 72, 24, False, "relu", 2),
        (3, 88, 24, False, "relu", 1), (5, 96, 40, True, "hswish", 2),
        (5, 240, 40, True, "hswish", 1), (5, 240, 40, True, "hswish", 1),
        (5, 120, 48, True, "hswish", 1), (5, 144, 48, True, "hswish", 1),
        (5, 288, 96, True, "hswish", 2), (5, 576, 96, True, "hswish", 1),
        (5, 576, 96, True, "hswish", 1)],
    "large": [
        (3, 16, 16, False, "relu", 1), (3, 64, 24, False, "relu", 2),
        (3, 72, 24, False, "relu", 1), (5, 72, 40, True, "relu", 2),
        (5, 120, 40, True, "relu", 1), (5, 120, 40, True, "relu", 1),
        (3, 240, 80, False, "hswish", 2), (3, 200, 80, False, "hswish", 1),
        (3, 184, 80, False, "hswish", 1), (3, 184, 80, False, "hswish", 1),
        (3, 480, 112, True, "hswish", 1), (3, 672, 112, True, "hswish", 1),
        (5, 672, 160, True, "hswish", 2), (5, 960, 160, True, "hswish", 1),
        (5, 960, 160, True, "hswish", 1)],
}


class MBV3Block(nn.Module):
    """MobileNetV3's block: a 1x1 expansion (where the width changes), a
    depthwise k x k conv (``dw``, dilated), the SE gate, a linear 1x1
    projection, and the identity where the shape is kept."""

    def __init__(self, in_channels: int, kernel: int, expand: int,
                 out_channels: int, use_se: bool, act: str, stride: int,
                 dilation: int = 1):
        super().__init__()
        self.act = hswish if act == "hswish" else F.relu
        self.use_res = stride == 1 and in_channels == out_channels
        self.expand = (ConvModule(in_channels, expand, 1, act=self.act)
                       if expand != in_channels else None)
        pad = (kernel // 2) * dilation
        self.dw = nn.Conv2d(expand, expand, kernel, stride=stride,
                            padding=pad, dilation=dilation, groups=expand,
                            bias=False)
        self.dw_bn = BatchNorm(expand)
        self.se = SELayer(expand) if use_se else None
        self.project = nn.Conv2d(expand, out_channels, 1, bias=False)
        self.project_bn = BatchNorm(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.expand(x) if self.expand is not None else x
        y = self.act(self.dw_bn(self.dw(y)))
        if self.se is not None:
            y = self.se(y)
        y = self.project_bn(self.project(y))
        return y + x if self.use_res else y


@BACKBONES.register()
class MobileNetV3(nn.Module):
    """MobileNetV3 (mobilenet_v3.py), small or large: the h-swish stem
    ``layer0``, the blocks ``layer1`` .. ``layerN`` and the final 1x1
    ``layer{N+1}``; ``dilate_last`` turns the stride-2 blocks among the
    last three into stride 1, dilation 2."""

    def __init__(self, arch: str = "large",
                 out_indices: Sequence[int] = (1, 3, 16),
                 dilate_last: bool = True, in_channels: int = 3):
        super().__init__()
        self.out_indices = tuple(out_indices)
        spec = MBV3_ARCH[arch]
        self.n = n = len(spec)
        self.layer0 = ConvModule(in_channels, 16, 3, stride=2, padding=1,
                                 act=hswish)
        widths = [16]
        for i, (k, e, c, se, act, s) in enumerate(spec):
            dilation = 1
            if dilate_last and i >= n - 3 and s == 2:
                s, dilation = 1, 2
            self.add_module(f"layer{i + 1}", MBV3Block(
                widths[-1], k, e, c, se, act, s, dilation))
            widths.append(c)
        final = 576 if arch == "small" else 960
        self.add_module(f"layer{n + 1}", ConvModule(widths[-1], final, 1,
                                                    act=hswish))
        widths.append(final)
        # an index past the last layer taps nothing, as in the JAX package
        # (the small arch under the large one's default (1, 3, 16))
        self.out_channels = [widths[i] for i in self.out_indices
                             if i < len(widths)]

    def forward(self, x: torch.Tensor):
        outs = []
        for i in range(self.n + 2):
            x = getattr(self, f"layer{i}")(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)


# ---- Fast-SCNN --------------------------------------------------------


class _DSConv(nn.Module):
    """A depthwise 3x3 conv (``dw``) + BN + ReLU, then a 1x1 ConvModule
    (``pw``)."""

    def __init__(self, in_channels: int, features: int, stride: int = 1):
        super().__init__()
        self.dw = nn.Conv2d(in_channels, in_channels, 3, stride=stride,
                            padding=1, groups=in_channels, bias=False)
        self.dw_bn = BatchNorm(in_channels)
        self.pw = ConvModule(in_channels, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pw(F.relu(self.dw_bn(self.dw(x))))


@BACKBONES.register()
class FastSCNN(nn.Module):
    """Fast-SCNN (fast_scnn.py): learning to downsample to 1/8, the
    global feature extractor (inverted residuals to 1/32) with a pyramid
    pooling module, and the feature fusion at 1/8.  Returns (higher_res
    1/8, lower_res 1/32, fusion 1/8) for (aux, aux, decode) heads."""

    def __init__(self, downsample_dw_channels: Sequence[int] = (32, 48),
                 global_in_channels: int = 64,
                 global_block_channels: Sequence[int] = (64, 96, 128),
                 global_block_strides: Sequence[int] = (2, 2, 1),
                 global_out_channels: int = 128,
                 fusion_out_channels: int = 128,
                 pool_scales: Sequence[int] = (1, 2, 3, 6),
                 align_corners: bool = False, in_channels: int = 3):
        super().__init__()
        self.align_corners = align_corners
        self.pool_scales = tuple(pool_scales)
        self.n_stages = len(global_block_channels)
        d0, d1 = downsample_dw_channels
        self.ltd_conv = ConvModule(in_channels, d0, 3, stride=2, padding=1)
        self.ltd_ds0 = _DSConv(d0, d1, stride=2)
        self.ltd_ds1 = _DSConv(d1, global_in_channels, stride=2)
        ch = global_in_channels
        for i, (c, s) in enumerate(zip(global_block_channels,
                                       global_block_strides)):
            for j in range(3):
                self.add_module(f"gfe{i}_{j}", InvertedResidual(
                    ch, c, stride=s if j == 0 else 1, expand_ratio=6))
                ch = c
        quarter = global_out_channels // 4
        for i in range(len(self.pool_scales)):
            self.add_module(f"ppm{i}", ConvModule(ch, quarter, 1))
        self.ppm_bottleneck = ConvModule(
            ch + quarter * len(self.pool_scales), global_out_channels, 3,
            padding=1)
        g = global_out_channels
        self.ffm_dw = nn.Conv2d(g, g, 3, padding=1, groups=g, bias=False)
        self.ffm_dw_bn = BatchNorm(g)
        self.ffm_low_proj = ConvModule(g, fusion_out_channels, 1,
                                       with_act=False)
        self.ffm_high_proj = ConvModule(global_in_channels,
                                        fusion_out_channels, 1,
                                        with_act=False)
        self.out_channels = [global_in_channels, global_out_channels,
                             fusion_out_channels]

    def forward(self, x: torch.Tensor):
        ac = self.align_corners
        higher = self.ltd_ds1(self.ltd_ds0(self.ltd_conv(x)))
        y = higher
        for i in range(self.n_stages):
            for j in range(3):
                y = getattr(self, f"gfe{i}_{j}")(y)
        hw = y.shape[-2:]
        ppm = [y] + [resize_like(getattr(self, f"ppm{i}")(
            adaptive_avg_pool(y, s)), hw, ac)
            for i, s in enumerate(self.pool_scales)]
        lower = self.ppm_bottleneck(torch.cat(ppm, dim=1))
        up = resize_like(lower, higher.shape[-2:], ac)
        up = self.ffm_dw_bn(self.ffm_dw(up))
        up = self.ffm_low_proj(F.relu(up))
        fusion = F.relu(up + self.ffm_high_proj(higher))
        return higher, lower, fusion


# ---- CGNet ------------------------------------------------------------


class ContextGuidedBlock(nn.Module):
    """cgnet.py's CG block: a 1x1 (or, downsampling, a stride-2 3x3)
    ConvModule with a PReLU, the local (``f_loc``) and dilated surrounding
    (``f_sur``) depthwise 3x3 convs concatenated, a joint BN and PReLU
    (``activate``), a 1x1 ``bottleneck`` when downsampling, and the
    global-context channel gate of two dense layers; the input added where
    the channels are kept."""

    def __init__(self, in_channels: int, out_channels: int,
                 dilation: int = 2, reduction: int = 16,
                 downsample: bool = False):
        super().__init__()
        half = out_channels if downsample else out_channels // 2
        self.downsample = downsample
        self.conv1x1 = (ConvModule(in_channels, half, 3, stride=2,
                                   padding=1, act=PReLU()) if downsample
                        else ConvModule(in_channels, half, 1, act=PReLU()))
        self.f_loc = nn.Conv2d(half, half, 3, padding=1, groups=half,
                               bias=False)
        self.f_sur = nn.Conv2d(half, half, 3, padding=dilation,
                               dilation=dilation, groups=half, bias=False)
        self.bn = BatchNorm(2 * half)
        self.activate = PReLU()
        ch = 2 * half
        if downsample:
            self.bottleneck = nn.Conv2d(ch, out_channels, 1, bias=False)
            ch = out_channels
        self.fc1 = nn.Linear(ch, max(ch // reduction, 1))
        self.fc2 = nn.Linear(max(ch // reduction, 1), ch)
        self.residual = not downsample and in_channels == ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1x1(x)
        joi = torch.cat([self.f_loc(y), self.f_sur(y)], dim=1)
        joi = self.activate(self.bn(joi))
        if self.downsample:
            joi = self.bottleneck(joi)
        g = torch.sigmoid(self.fc2(F.relu(self.fc1(joi.mean(dim=(2, 3))))))
        joi = joi * g[:, :, None, None]
        return joi + x if self.residual else joi


@BACKBONES.register()
class CGNet(nn.Module):
    """CGNet (cgnet.py): a stem of three PReLU ConvModules at 1/2 with the
    input injected (a 3x3 average pool), then two levels of CG blocks at
    1/4 and 1/8, each returning the concatenation of its first and last
    block (and, at level 1, the injection resized); one feature a
    stage."""

    def __init__(self, in_channels: int = 3,
                 num_channels: Sequence[int] = (32, 64, 128),
                 num_blocks: Sequence[int] = (3, 21),
                 dilations: Sequence[int] = (2, 4),
                 reductions: Sequence[int] = (8, 16)):
        super().__init__()
        self.num_blocks = tuple(num_blocks)
        c0 = num_channels[0]
        for i in range(3):
            self.add_module(f"stem{i}", ConvModule(
                in_channels if i == 0 else c0, c0, 3,
                stride=2 if i == 0 else 1, padding=1, act=PReLU()))
        ch = c0 + in_channels
        self.out_channels = [ch]
        for s in range(2):
            c = num_channels[s + 1]
            for j in range(num_blocks[s]):
                self.add_module(f"level{s + 1}_{j}", ContextGuidedBlock(
                    ch, c, dilation=dilations[s], reduction=reductions[s],
                    downsample=j == 0))
                ch = c
            ch = 2 * c + (in_channels if s == 0 else 0)
            self.out_channels.append(ch)

    def forward(self, x: torch.Tensor):
        img, y = x, x
        for i in range(3):
            y = getattr(self, f"stem{i}")(y)
        inj1 = _avg_pool3(img, 2)
        y = torch.cat([y, inj1], dim=1)
        outs = [y]
        for s in range(2):
            down = None
            for j in range(self.num_blocks[s]):
                y = getattr(self, f"level{s + 1}_{j}")(y)
                if j == 0:
                    down = y
            cat = [y, down]
            if s == 0:
                cat.append(resize_like(inj1, y.shape[-2:]))
            y = torch.cat(cat, dim=1)
            outs.append(y)
        return tuple(outs)


# ---- ERFNet -----------------------------------------------------------


class _Downsampler(nn.Module):
    """A stride-2 3x3 conv to ``features - in`` channels beside a 2x2 max
    pool of the input, concatenated, BN, ReLU.  On an odd side the two
    halves differ in size (the JAX package's concatenation fails there):
    ValueError."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, features - in_channels, 3,
                              stride=2, padding=1)
        self.bn = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.shape[-2] % 2 or x.shape[-1] % 2:
            raise ValueError(f"ERFNet's downsampler needs even sides, got "
                             f"{tuple(x.shape[-2:])}: its conv and max pool "
                             "halves would differ in size")
        y = torch.cat([self.conv(x), F.max_pool2d(x, 2, 2)], dim=1)
        return F.relu(self.bn(y))


class _NonBottleneck1d(nn.Module):
    """Factorised residual block: (3,1) and (1,3) convs, then the pair
    again dilated along its axis, a BN after each pair."""

    def __init__(self, channels: int, dilation: int = 1):
        super().__init__()
        c, d = channels, dilation
        self.conv3x1_1 = nn.Conv2d(c, c, (3, 1), padding=(1, 0))
        self.conv1x3_1 = nn.Conv2d(c, c, (1, 3), padding=(0, 1))
        self.bn1 = BatchNorm(c)
        self.conv3x1_2 = nn.Conv2d(c, c, (3, 1), padding=(d, 0),
                                   dilation=(d, 1))
        self.conv1x3_2 = nn.Conv2d(c, c, (1, 3), padding=(0, d),
                                   dilation=(1, d))
        self.bn2 = BatchNorm(c)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv1x3_1(F.relu(self.conv3x1_1(x)))
        y = F.relu(self.bn1(y))
        y = self.conv1x3_2(F.relu(self.conv3x1_2(y)))
        return F.relu(self.bn2(y) + x)


@BACKBONES.register()
class ERFNet(nn.Module):
    """ERFNet (erfnet.py): downsamplers and factorised non-bottleneck
    blocks to 1/8 (the second stage's dilations cycling), then a decoder
    of 2x bilinear resizes, 3x3 ConvModules and non-bottleneck blocks to
    1/2.  Returns the decoder's feature."""

    def __init__(self, enc_downsample_channels: Sequence[int] = (16, 64,
                                                                 128),
                 enc_stage_non_bottlenecks: Sequence[int] = (5, 8),
                 dilations: Sequence[int] = (2, 4, 8, 16),
                 dec_upsample_channels: Sequence[int] = (64, 16),
                 dec_stages_non_bottleneck: Sequence[int] = (2, 2),
                 in_channels: int = 3):
        super().__init__()
        e = enc_downsample_channels
        self.enc = tuple(enc_stage_non_bottlenecks)
        self.dec = tuple(dec_stages_non_bottleneck)
        self.down0 = _Downsampler(in_channels, e[0])
        self.down1 = _Downsampler(e[0], e[1])
        for i in range(self.enc[0]):
            self.add_module(f"enc1_{i}", _NonBottleneck1d(e[1]))
        self.down2 = _Downsampler(e[1], e[2])
        for i in range(self.enc[1]):
            self.add_module(f"enc2_{i}", _NonBottleneck1d(
                e[2], dilations[i % len(dilations)]))
        ch = e[2]
        for s, c in enumerate(dec_upsample_channels):
            self.add_module(f"up{s}", ConvModule(ch, c, 3, padding=1))
            for i in range(self.dec[s]):
                self.add_module(f"dec{s}_{i}", _NonBottleneck1d(c))
            ch = c
        self.out_channels = [ch]

    def forward(self, x: torch.Tensor):
        y = self.down1(self.down0(x))
        for i in range(self.enc[0]):
            y = getattr(self, f"enc1_{i}")(y)
        y = self.down2(y)
        for i in range(self.enc[1]):
            y = getattr(self, f"enc2_{i}")(y)
        for s, n in enumerate(self.dec):
            y = resize_like(y, (y.shape[-2] * 2, y.shape[-1] * 2))
            y = getattr(self, f"up{s}")(y)
            for i in range(n):
                y = getattr(self, f"dec{s}_{i}")(y)
        return (y,)


# ---- BiSeNet V1 / V2 --------------------------------------------------


class _ARM(nn.Module):
    """bisenetv1.py's attention refinement: a 3x3 ConvModule gated by the
    sigmoid of its mean through a 1x1 conv + BN."""

    def __init__(self, in_channels: int, features: int):
        super().__init__()
        self.conv = ConvModule(in_channels, features, 3, padding=1)
        self.gate = ConvModule(features, features, 1, with_act=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x)
        return y * torch.sigmoid(self.gate(_gap(y)))


class _ContextFusion(nn.Module):
    """The ARM context path and the feature fusion module that BiSeNetV1
    and STDC's context path share (submodules ``gap_conv``, ``arm32``,
    ``refine32``, ``arm16``, ``refine16``, ``ffm_conv``, ``ffm_fc1``,
    ``ffm_fc2``): the 1/32 feature refined, plus its global mean's
    projection, resized to 1/16, refined, added to the refined 1/16
    feature, resized to the fine map's size, refined, concatenated after
    the fine map and fused under a channel gate.  Returns (ffm, arm16,
    arm32)."""

    def init_fusion(self, c16: int, c32: int, fine: int, context: int,
                    out: int) -> None:
        self.gap_conv = ConvModule(c32, context, 1)
        self.arm32 = _ARM(c32, context)
        self.refine32 = ConvModule(context, context, 3, padding=1)
        self.arm16 = _ARM(c16, context)
        self.refine16 = ConvModule(context, context, 3, padding=1)
        self.ffm_conv = ConvModule(fine + context, out, 1)
        self.ffm_fc1 = nn.Conv2d(out, out // 4, 1)
        self.ffm_fc2 = nn.Conv2d(out // 4, out, 1)

    def fuse(self, fine, c16, c32, align_corners: bool):
        gap = self.gap_conv(_gap(c32))
        a32 = resize_like(self.arm32(c32) + gap, c16.shape[-2:],
                          align_corners)
        a32 = self.refine32(a32)
        a16 = resize_like(self.arm16(c16) + a32, fine.shape[-2:],
                          align_corners)
        a16 = self.refine16(a16)
        fused = self.ffm_conv(torch.cat([fine, a16], dim=1))
        g = torch.sigmoid(self.ffm_fc2(F.relu(self.ffm_fc1(_gap(fused)))))
        return fused + fused * g, a16, a32


@BACKBONES.register()
class BiSeNetV1(_ContextFusion):
    """BiSeNet V1 (bisenetv1.py): a spatial path to 1/8 and a context path
    over a host backbone from the registry (``context_backbone``, a
    ResNet-18 unless ``backbone_cfg`` says otherwise).  Returns
    (ffm_out, context 1/8, context 1/16) for decode + 2 aux heads."""

    def __init__(self, backbone_cfg: dict = None,
                 spatial_channels: Sequence[int] = (64, 64, 64, 128),
                 context_channels: Sequence[int] = (128, 256, 512),
                 out_channels: int = 256, align_corners: bool = False,
                 in_channels: int = 3):
        super().__init__()
        self.align_corners = align_corners
        self.n_spatial = len(spatial_channels)
        ch = in_channels
        for i, c in enumerate(spatial_channels):
            k, s, p = (7, 2, 3) if i == 0 else (3, 2, 1)
            if i == self.n_spatial - 1:
                k, s, p = 1, 1, 0
            self.add_module(f"spatial{i}", ConvModule(ch, c, k, stride=s,
                                                      padding=p))
            ch = c
        bcfg = dict(backbone_cfg or dict(type="ResNet", depth=18))
        bcfg.setdefault("in_channels", in_channels)
        self.context_backbone = BACKBONES.build(bcfg)
        c16, c32 = self.context_backbone.out_channels[-2:]
        cc = context_channels[0]
        self.init_fusion(c16, c32, ch, cc, out_channels)
        self.out_channels = [out_channels, cc, cc]

    def forward(self, x: torch.Tensor):
        sp = x
        for i in range(self.n_spatial):
            sp = getattr(self, f"spatial{i}")(sp)
        feats = self.context_backbone(x)
        return self.fuse(sp, feats[-2], feats[-1], self.align_corners)


class _GELayer(nn.Module):
    """bisenetv2.py's gather-and-expand layer: a 3x3 ConvModule, a
    depthwise 3x3 expansion (``dw1``; at stride 2 a second depthwise
    ``dw2``), a 1x1 projection; at stride 2 a depthwise + pointwise
    shortcut."""

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 expand: int = 6):
        super().__init__()
        cin, mid = in_channels, in_channels * expand
        self.stride = stride
        self.conv1 = ConvModule(cin, cin, 3, padding=1)
        self.dw1 = nn.Conv2d(cin, mid, 3, stride=stride, padding=1,
                             groups=cin, bias=False)
        self.dw1_bn = BatchNorm(mid)
        if stride == 2:
            self.dw2 = nn.Conv2d(mid, mid, 3, padding=1, groups=mid,
                                 bias=False)
            self.dw2_bn = BatchNorm(mid)
        self.project = nn.Conv2d(mid, features, 1, bias=False)
        self.project_bn = BatchNorm(features)
        if stride == 2:
            self.short_dw = nn.Conv2d(cin, cin, 3, stride=2, padding=1,
                                      groups=cin, bias=False)
            self.short_dw_bn = BatchNorm(cin)
            self.short_pw = nn.Conv2d(cin, features, 1, bias=False)
            self.short_pw_bn = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.dw1_bn(self.dw1(self.conv1(x)))
        if self.stride == 2:
            y = self.dw2_bn(self.dw2(F.relu(y)))
        y = self.project_bn(self.project(F.relu(y)))
        if self.stride == 2:
            x = self.short_pw_bn(self.short_pw(self.short_dw_bn(
                self.short_dw(x))))
        return F.relu(y + x)


@BACKBONES.register()
class BiSeNetV2(nn.Module):
    """BiSeNet V2 (bisenetv2.py): a detail branch to 1/8, a semantic branch
    (stem, gather-and-expand stages, context embedding) to 1/32, and the
    bilateral guided aggregation.  Returns (bga_out, stem, s3, s4, s5):
    decode + 4 aux taps."""

    def __init__(self, detail_channels: Sequence[int] = (64, 64, 128),
                 semantic_channels: Sequence[int] = (16, 32, 64, 128),
                 semantic_expansion: int = 6, bga_channels: int = 128,
                 align_corners: bool = False, in_channels: int = 3):
        super().__init__()
        self.align_corners = align_corners
        self.n_detail = len(detail_channels)
        ch = in_channels
        for i, c in enumerate(detail_channels):
            self.add_module(f"detail{i}_down", ConvModule(
                ch, c, 3, stride=2, padding=1))
            self.add_module(f"detail{i}_conv", ConvModule(c, c, 3,
                                                          padding=1))
            ch = c
        dc, sc = ch, tuple(semantic_channels)
        self.stem_conv = ConvModule(in_channels, sc[0], 3, stride=2,
                                    padding=1)
        self.stem_l0 = ConvModule(sc[0], sc[0] // 2, 1)
        self.stem_l1 = ConvModule(sc[0] // 2, sc[0], 3, stride=2, padding=1)
        self.stem_fuse = ConvModule(2 * sc[0], sc[0], 3, padding=1)
        self.stages = []
        ch = sc[0]
        for i, c in enumerate(sc[1:]):
            n_blocks = 4 if i == len(sc) - 2 else 2
            for j in range(n_blocks):
                self.add_module(f"ge{i}_{j}", _GELayer(
                    ch, c, stride=2 if j == 0 else 1,
                    expand=semantic_expansion))
                ch = c
            self.stages.append(n_blocks)
        self.ce_bn = BatchNorm(ch)
        self.ce_conv = ConvModule(ch, sc[-1], 1)
        self.ce_out = ConvModule(sc[-1], sc[-1], 3, padding=1)
        b, s = bga_channels, sc[-1]
        self.bga_d_dw = nn.Conv2d(dc, dc, 3, padding=1, groups=dc,
                                  bias=False)
        self.bga_d_bn = BatchNorm(dc)
        self.bga_d_pw = nn.Conv2d(dc, b, 1)
        self.bga_d_down = ConvModule(dc, b, 3, stride=2, padding=1,
                                     with_act=False)
        self.bga_s_conv = ConvModule(s, b, 3, padding=1, with_act=False)
        self.bga_s_dw = nn.Conv2d(s, s, 3, padding=1, groups=s, bias=False)
        self.bga_s_bn = BatchNorm(s)
        self.bga_s_pw = nn.Conv2d(s, b, 1)
        self.bga_out = ConvModule(b, b, 3, padding=1)
        self.out_channels = [b, sc[0]] + list(sc[1:])

    def forward(self, x: torch.Tensor):
        ac = self.align_corners
        d = x
        for i in range(self.n_detail):
            d = getattr(self, f"detail{i}_conv")(
                getattr(self, f"detail{i}_down")(d))
        s = self.stem_conv(x)
        left = self.stem_l1(self.stem_l0(s))
        right = F.max_pool2d(s, 3, 2, 1)
        s = self.stem_fuse(torch.cat([left, right], dim=1))
        stem_out = s
        taps = []
        for i, n_blocks in enumerate(self.stages):
            for j in range(n_blocks):
                s = getattr(self, f"ge{i}_{j}")(s)
            taps.append(s)
        s = s + self.ce_conv(self.ce_bn(_gap(s)))
        s = self.ce_out(s)
        hw_d = d.shape[-2:]
        d_dw = self.bga_d_pw(self.bga_d_bn(self.bga_d_dw(d)))
        d_down = _avg_pool3(self.bga_d_down(d), 2)
        s_up = resize_like(self.bga_s_conv(s), hw_d, ac)
        s_dw = self.bga_s_pw(self.bga_s_bn(self.bga_s_dw(s)))
        left = d_dw * torch.sigmoid(s_up)
        right = resize_like(d_down * torch.sigmoid(s_dw), hw_d, ac)
        out = self.bga_out(left + right)
        return (out, stem_out) + tuple(taps)


# ---- STDC -------------------------------------------------------------


class STDCModule(nn.Module):
    """stdc.py's Short-Term Dense Concatenate module: a 1x1 ConvModule to
    half the width, then 3x3 ConvModules at a quarter, an eighth, ... (the
    last takes what is left of the width), all concatenated.  At stride 2
    (mmseg's "cat" fusion) the first branch is the 3x3 average pool of the
    1x1's output, and the chain runs on its depthwise stride-2
    ``downsample`` (conv + BN, no activation)."""

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 num_convs: int = 4):
        super().__init__()
        self.stride, self.num_convs = stride, num_convs
        f = features
        self.conv0 = ConvModule(in_channels, f // 2, 1)
        if stride == 2:
            self.downsample = ConvModule(f // 2, f // 2, 3, stride=2,
                                         padding=1, groups=f // 2,
                                         with_act=False)
        self.conv1 = ConvModule(f // 2, f // 4, 3, padding=1)
        widths = [f // 2, f // 4]
        frac = 8
        for i in range(2, num_convs):
            c = f // frac
            if i == num_convs - 1:
                c = f - sum(widths)
            self.add_module(f"conv{i}", ConvModule(widths[-1], c, 3,
                                                   padding=1))
            widths.append(c)
            frac *= 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv0(x)
        if self.stride == 2:
            outs = [_avg_pool3(y, 2)]
            y = self.downsample(y)
        else:
            outs = [y]
        y = self.conv1(y)
        outs.append(y)
        for i in range(2, self.num_convs):
            y = getattr(self, f"conv{i}")(y)
            outs.append(y)
        return torch.cat(outs, dim=1)


@BACKBONES.register()
class STDCNet(nn.Module):
    """stdc.py's STDCNet: two stride-2 3x3 ConvModules (``stem0``,
    ``stem1``) and three stages of STDC modules (2, 2, 2 for STDCNet1; 4,
    5, 3 for STDCNet2), each stage's first at stride 2."""

    def __init__(self, stdc_type: str = "STDCNet1",
                 channels: Sequence[int] = (32, 64, 256, 512, 1024),
                 bottleneck_type: str = "cat", num_convs: int = 4,
                 out_indices: Sequence[int] = (0, 1, 2, 3, 4),
                 in_channels: int = 3):
        super().__init__()
        self.out_indices = tuple(out_indices)
        self.num_modules = ((2, 2, 2) if stdc_type == "STDCNet1"
                            else (4, 5, 3))
        self.stem0 = ConvModule(in_channels, channels[0], 3, stride=2,
                                padding=1)
        self.stem1 = ConvModule(channels[0], channels[1], 3, stride=2,
                                padding=1)
        ch = channels[1]
        for s in range(3):
            for j in range(self.num_modules[s]):
                self.add_module(f"stage{s + 2}_{j}", STDCModule(
                    ch, channels[s + 2], stride=2 if j == 0 else 1,
                    num_convs=num_convs))
                ch = channels[s + 2]
        self.out_channels = [channels[i] for i in self.out_indices]

    def forward(self, x: torch.Tensor):
        outs = []
        x = self.stem0(x)
        if 0 in self.out_indices:
            outs.append(x)
        x = self.stem1(x)
        if 1 in self.out_indices:
            outs.append(x)
        for s in range(3):
            for j in range(self.num_modules[s]):
                x = getattr(self, f"stage{s + 2}_{j}")(x)
            if s + 2 in self.out_indices:
                outs.append(x)
        return tuple(outs)


@BACKBONES.register()
class STDCContextPathNet(_ContextFusion):
    """stdc.py's STDCContextPathNet: an STDCNet host (``backbone``) with
    BiSeNet's ARM refinement and FFM over its 1/8, 1/16 and 1/32 maps.
    Returns (ffm, arm16, arm32, stage 1/8) for decode, aux and detail
    heads."""

    def __init__(self, backbone_cfg: dict = None,
                 last_in_channels: Sequence[int] = (1024, 512),
                 out_channels: int = 128, ffm_channels: int = 256,
                 align_corners: bool = False, in_channels: int = 3):
        super().__init__()
        self.align_corners = align_corners
        bcfg = dict(backbone_cfg or dict(type="STDCNet"))
        bcfg.setdefault("in_channels", in_channels)
        self.backbone = BACKBONES.build(bcfg)
        c8, c16, c32 = self.backbone.out_channels[-3:]
        self.init_fusion(c16, c32, c8, out_channels, ffm_channels)
        self.out_channels = [ffm_channels, out_channels, out_channels, c8]

    def forward(self, x: torch.Tensor):
        feats = self.backbone(x)
        f8 = feats[-3]
        return self.fuse(f8, feats[-2], feats[-1],
                         self.align_corners) + (f8,)


# ---- ICNet ------------------------------------------------------------


@BACKBONES.register()
class ICNet(nn.Module):
    """icnet.py's backbone: a light branch of three stride-2 ConvModules
    at full resolution (sub1, 1/8); the input at half size through a deep
    stem and bottleneck stages 1-2 (sub2, 1/16); that map at half size
    through dilated stages 3-4 and a pyramid pooling (sub4, 1/32).
    Returns (sub1, sub2, sub4) for ICNeck.  The bottlenecks are the zoo
    ResNet's (``layer{i}_{j}``)."""

    def __init__(self, layer_channels: Sequence[int] = (64, 128),
                 light_branch_mid_channels: int = 32,
                 psp_out_channels: int = 512,
                 out_channels: Sequence[int] = (64, 256, 256),
                 depth_blocks: Sequence[int] = (3, 4, 6, 3),
                 pool_scales: Sequence[int] = (1, 2, 3, 6),
                 align_corners: bool = False, in_channels: int = 3):
        super().__init__()
        self.align_corners = align_corners
        self.depth_blocks = tuple(depth_blocks)
        self.pool_scales = tuple(pool_scales)
        mid = light_branch_mid_channels
        ch = in_channels
        for i, c in enumerate((mid, mid, out_channels[0])):
            self.add_module(f"sub1_{i}", ConvModule(ch, c, 3, stride=2,
                                                    padding=1))
            ch = c
        self.stem0 = ConvModule(in_channels, 32, 3, stride=2, padding=1)
        self.stem1 = ConvModule(32, 32, 3, padding=1)
        self.stem2 = ConvModule(32, 64, 3, padding=1)
        planes = (64, 128, 256, 512)
        ch = 64
        for i in range(4):
            for j in range(self.depth_blocks[i]):
                first = j == 0
                self.add_module(f"layer{i + 1}_{j}", ZooBottleneck(
                    ch, planes[i],
                    stride=2 if first and i == 1 else 1,
                    dilation={2: 2, 3: 4}.get(i, 1), downsample=first))
                ch = planes[i] * 4
        self.sub2_proj = ConvModule(planes[1] * 4, out_channels[1], 1)
        self.psp_bottleneck = ConvModule(ch * (1 + len(self.pool_scales)),
                                         psp_out_channels, 3, padding=1)
        self.sub4_proj = ConvModule(psp_out_channels, out_channels[2], 1)
        self.out_channels = list(out_channels)

    def _stages(self, x, stages):
        for i in stages:
            for j in range(self.depth_blocks[i]):
                x = getattr(self, f"layer{i + 1}_{j}")(x)
        return x

    def forward(self, x: torch.Tensor):
        ac = self.align_corners
        y = x
        for i in range(3):
            y = getattr(self, f"sub1_{i}")(y)
        sub1 = y
        h, w = x.shape[-2:]
        z = self.stem2(self.stem1(self.stem0(
            resize_like(x, (h // 2, w // 2), ac))))
        z = self._stages(F.max_pool2d(z, 3, 2, 1), (0, 1))
        sub2 = self.sub2_proj(z)
        q = resize_like(z, (max(z.shape[-2] // 2, 1),
                            max(z.shape[-1] // 2, 1)), ac)
        q = self._stages(q, (2, 3))
        hw = q.shape[-2:]
        ppm = [q] + [resize_like(adaptive_avg_pool(q, s), hw, ac)
                     for s in self.pool_scales]
        sub4 = self.sub4_proj(self.psp_bottleneck(torch.cat(ppm, dim=1)))
        return sub1, sub2, sub4
