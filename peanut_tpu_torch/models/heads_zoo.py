"""Zoo decode heads, NCHW (port of ``peanut_tpu.models.heads_zoo``):
over ResNetV1c, ANN, APC, DM, EMA, Enc (with its Encoding codebook), DNL,
ISA, FPN, PSA and CC; over the transformers, SETR's UP and MLA heads,
Segmenter's mask transformer, DPT and PointRend's point head (with
``point_sample``).  The reference's CUDA ops for CC, PSA and PointRend
(mmcv's ``CrissCrossAttention``, ``PSAMask`` and ``point_sample``) are
dense products and gathers here, as in the JAX package (``torch.einsum``,
``torch.gather``): no hand-written kernel.  Submodules and parameters are
named after the flax modules, so ``mmseg_import.flax_to_torch_state``
carries the JAX package's variables.  The other heads of that file
(LRASPP, DepthwiseSeparableFCN, STDC) wait for their backbones (ROADMAP
A13 part 4).
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..registry import HEADS
from .heads import DecodeHead, _named, tokens, untokens
from .layers import (BatchNorm, ConvModule, InputShaped, LayerNorm,
                     MultiHeadAttention, gelu, lecun_normal_, ln_nchw,
                     normal_)
from .ops import adaptive_avg_pool


def _attend(q, k, v, scale=None):
    """Dense attention: q (B, N, C), k / v (B, M, C[v]) -> (B, N, Cv)."""
    sim = torch.einsum("bnc,bmc->bnm", q, k)
    if scale is not None:
        sim = sim * scale
    return torch.einsum("bnm,bmc->bnc", torch.softmax(sim, dim=-1), v)


def _ppm_sample(x: torch.Tensor, scales: Sequence[int]) -> torch.Tensor:
    """x (B, C, H, W) pooled at each scale, its cells as tokens in the JAX
    package's row-major order, concatenated: (B, M, C)."""
    return torch.cat([tokens(adaptive_avg_pool(x, s)) for s in scales],
                     dim=1)


def _l2norm(x: torch.Tensor, dim: int) -> torch.Tensor:
    return x / (1e-6 + torch.linalg.vector_norm(x, dim=dim, keepdim=True))


def _bn_last(bn: BatchNorm, x: torch.Tensor) -> torch.Tensor:
    """flax's ``nn.BatchNorm`` over the last axis of a (B, K, C) map."""
    return bn(x.transpose(1, 2)[..., None])[..., 0].transpose(1, 2)


@HEADS.register()
class ANNHead(DecodeHead):
    """Asymmetric non-local (ann_head.py): AFNB fuses the low and high
    levels with pyramid-sampled keys, then APNB self-attends on the
    bottleneck."""

    def __init__(self, in_channels: Sequence[int] = (1024, 2048),
                 channels: int = 512, num_classes: int = 19,
                 project_channels: int = 256,
                 query_scales: Sequence[int] = (1,),
                 key_pool_scales: Sequence[int] = (1, 3, 6, 8),
                 dropout_ratio: float = 0.1,
                 in_index: Sequence[int] = (2, 3),
                 align_corners: bool = False):
        super().__init__(num_classes, dropout_ratio, in_index, align_corners)
        low, high = in_channels
        p = project_channels
        self.project_channels = p
        self.key_pool_scales = tuple(key_pool_scales)
        self.afnb_query = nn.Conv2d(high, p, 1)
        self.afnb_key = nn.Conv2d(low, p, 1)
        self.afnb_value = nn.Conv2d(low, channels, 1)
        self.afnb_out = ConvModule(channels + high, channels, 1)
        self.bottleneck = ConvModule(channels, channels, 3, padding=1)
        self.apnb_query = nn.Conv2d(channels, p, 1)
        self.apnb_key = nn.Conv2d(channels, p, 1)
        self.apnb_value = nn.Conv2d(channels, channels, 1)
        self.apnb_out = ConvModule(2 * channels, channels, 1)
        self.classifier(channels)

    def _block(self, prefix, q_in, kv_in):
        h, w = q_in.shape[-2:]
        q = tokens(getattr(self, f"{prefix}_query")(q_in))
        k = _ppm_sample(getattr(self, f"{prefix}_key")(kv_in),
                        self.key_pool_scales)
        v = _ppm_sample(getattr(self, f"{prefix}_value")(kv_in),
                        self.key_pool_scales)
        return untokens(_attend(q, k, v, self.project_channels ** -0.5),
                        h, w)

    def forward(self, inputs, generator=None) -> torch.Tensor:
        low, high = [inputs[i] for i in self.in_index]
        ctx = self._block("afnb", high, low)
        feats = self.bottleneck(self.afnb_out(torch.cat([ctx, high], 1)))
        ctx2 = self._block("apnb", feats, feats)
        return self.cls_seg(self.apnb_out(torch.cat([ctx2, feats], 1)),
                            generator)


@HEADS.register()
class APCHead(DecodeHead):
    """Adaptive pyramid context (apc_head.py): an adaptive context module
    per scale with learned pixel-to-region affinity."""

    def __init__(self, in_channels: int = 2048, channels: int = 512,
                 num_classes: int = 19,
                 pool_scales: Sequence[int] = (1, 2, 3, 6),
                 dropout_ratio: float = 0.1, in_index: int = 3,
                 align_corners: bool = False):
        super().__init__(num_classes, dropout_ratio, in_index, align_corners)
        self.pool_scales = tuple(pool_scales)
        for i in range(len(pool_scales)):
            self.add_module(f"acm{i}_pooled",
                            ConvModule(in_channels, channels, 1))
            self.add_module(f"acm{i}_input",
                            ConvModule(in_channels, channels, 1))
            self.add_module(f"acm{i}_out", ConvModule(channels, channels, 1))
        self.bottleneck = ConvModule(
            len(pool_scales) * channels + in_channels, channels, 3,
            padding=1)
        self.classifier(channels)

    def forward(self, inputs, generator=None) -> torch.Tensor:
        x = inputs[self.in_index]
        h, w = x.shape[-2:]
        outs = []
        for i, s in enumerate(self.pool_scales):
            region = tokens(getattr(self, f"acm{i}_pooled")(
                adaptive_avg_pool(x, s)))
            xr = tokens(getattr(self, f"acm{i}_input")(x))
            aff = torch.softmax(torch.einsum("bnc,bmc->bnm", xr, region),
                                dim=-1)
            z = untokens(torch.einsum("bnm,bmc->bnc", aff, region), h, w)
            outs.append(getattr(self, f"acm{i}_out")(z))
        return self.cls_seg(self.bottleneck(torch.cat(outs + [x], 1)),
                            generator)


@HEADS.register()
class DMHead(DecodeHead):
    """Dynamic multi-scale (dm_head.py): dynamic convolutional modules
    whose depthwise filters each sample generates from its pooled
    context."""

    def __init__(self, in_channels: int = 2048, channels: int = 512,
                 num_classes: int = 19,
                 filter_sizes: Sequence[int] = (1, 3, 5, 7),
                 dropout_ratio: float = 0.1, in_index: int = 3,
                 align_corners: bool = False):
        super().__init__(num_classes, dropout_ratio, in_index, align_corners)
        self.filter_sizes = tuple(filter_sizes)
        for i in range(len(filter_sizes)):
            self.add_module(f"dcm{i}_filter_gen",
                            nn.Conv2d(in_channels, channels, 1))
            self.add_module(f"dcm{i}_input",
                            ConvModule(in_channels, channels, 1))
            self.add_module(f"dcm{i}_bn", BatchNorm(channels))
        self.bottleneck = ConvModule(
            len(filter_sizes) * channels + in_channels, channels, 3,
            padding=1)
        self.classifier(channels)

    def forward(self, inputs, generator=None) -> torch.Tensor:
        x = inputs[self.in_index]
        b, _, h, w = x.shape
        outs = []
        for i, k in enumerate(self.filter_sizes):
            filt = getattr(self, f"dcm{i}_filter_gen")(
                adaptive_avg_pool(x, k))               # (B, C, k, k)
            xr = getattr(self, f"dcm{i}_input")(x)
            c = xr.shape[1]
            # one depthwise conv with the batch folded into the groups:
            # channel b * C + c of the (1, B*C, H, W) view is sample b's c
            y = F.conv2d(xr.reshape(1, b * c, h, w),
                         filt.reshape(b * c, 1, k, k),
                         padding=(k - 1) // 2, groups=b * c)
            y = getattr(self, f"dcm{i}_bn")(y.reshape(b, c, h, w))
            outs.append(F.relu(y))
        return self.cls_seg(self.bottleneck(torch.cat(outs + [x], 1)),
                            generator)


@HEADS.register()
class EMAHead(DecodeHead):
    """Expectation-maximisation attention (ema_head.py): soft assignments
    between the pixels and a learned basis iterated, the pixels rebuilt,
    a residual."""

    def __init__(self, in_channels: int = 2048, channels: int = 512,
                 num_classes: int = 19, ema_channels: int = 512,
                 num_bases: int = 64, num_stages: int = 3,
                 dropout_ratio: float = 0.1, in_index: int = 3,
                 align_corners: bool = False):
        super().__init__(num_classes, dropout_ratio, in_index, align_corners)
        self.num_stages = num_stages
        self.ema_in_conv = ConvModule(in_channels, ema_channels, 3,
                                      padding=1)
        self.ema_mid_conv = ConvModule(ema_channels, ema_channels, 1,
                                       with_norm=False, with_act=False)
        self.bases = nn.Parameter(torch.empty(num_bases, ema_channels))
        self.ema_out_conv = ConvModule(ema_channels, ema_channels, 1,
                                       with_act=False)
        self.bottleneck = ConvModule(ema_channels, channels, 3, padding=1)
        self.classifier(channels)

    @torch.no_grad()
    def flax_init_(self, generator) -> None:
        """The basis: normal rows scaled to unit norm."""
        self.bases.copy_(_l2norm(torch.randn(self.bases.shape,
                                             generator=generator), -1))

    def forward(self, inputs, generator=None) -> torch.Tensor:
        feats = self.ema_in_conv(inputs[self.in_index])
        h, w = feats.shape[-2:]
        pix = tokens(self.ema_mid_conv(feats))              # (B, N, C)
        mu = self.bases.expand(pix.shape[0], -1, -1)
        for _ in range(self.num_stages):
            z = torch.softmax(torch.einsum("bnc,bkc->bnk", pix, mu), dim=-1)
            z = z / (1e-6 + z.sum(dim=1, keepdim=True))
            mu = _l2norm(torch.einsum("bnk,bnc->bkc", z, pix), -1)
        recon = torch.einsum("bnk,bkc->bnc", torch.softmax(
            torch.einsum("bnc,bkc->bnk", pix, mu), dim=-1), mu)
        recon = self.ema_out_conv(F.relu(untokens(recon, h, w)))
        feats = F.relu(feats + recon)
        return self.cls_seg(self.bottleneck(feats), generator)


class Encoding(nn.Module):
    """The context-encoding codebook (mmseg ops/encoding.py): soft
    residual encoding of the pixels against K learned codewords.  The
    parameters hold flax's raw values: the codewords are ``codewords -
    std`` and the smoothing factors ``-scale``, as the flax module applies
    them."""

    def __init__(self, channels: int, num_codes: int):
        super().__init__()
        self.channels = channels
        self.std = 1.0 / math.sqrt(num_codes * channels)
        self.codewords = nn.Parameter(torch.empty(num_codes, channels))
        self.scale = nn.Parameter(torch.empty(num_codes))

    @torch.no_grad()
    def flax_init_(self, generator) -> None:
        self.codewords.copy_(torch.rand(self.codewords.shape,
                                        generator=generator) * 2 * self.std)
        self.scale.copy_(torch.rand(self.scale.shape, generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pix = tokens(x)                                      # (B, N, C)
        codewords = self.codewords - self.std
        resid = pix[:, :, None, :] - codewords[None, None]  # (B, N, K, C)
        dist = (resid * resid).sum(dim=-1)                   # (B, N, K)
        assign = torch.softmax(-self.scale * dist, dim=-1)
        return torch.einsum("bnk,bnkc->bkc", assign, resid)  # (B, K, C)


@HEADS.register()
class EncHead(DecodeHead):
    """Context encoding (enc_head.py): codebook-encoded global context
    gates the features channel-wise.  ``se_layer``, the SE-loss classifier,
    only matters to training: its parameters are kept (they carry over)
    and inference does not run it."""

    def __init__(self, in_channels: Sequence[int] = (512, 1024, 2048),
                 channels: int = 512, num_classes: int = 19,
                 num_codes: int = 32, use_se_loss: bool = True,
                 add_lateral: bool = False, dropout_ratio: float = 0.1,
                 in_index: Sequence[int] = (1, 2, 3),
                 align_corners: bool = False):
        super().__init__(num_classes, dropout_ratio, in_index, align_corners)
        self.add_lateral = add_lateral
        self.bottleneck = ConvModule(in_channels[-1], channels, 3, padding=1)
        if add_lateral:
            _named(self, "lateral", [ConvModule(c, channels, 1)
                                     for c in in_channels[:-1]])
            self.fusion = ConvModule(len(in_channels) * channels, channels,
                                     3, padding=1)
        self.encoding = Encoding(channels, num_codes)
        self.enc_bn = BatchNorm(channels)
        self.fc = nn.Linear(channels, channels)
        self.se_layer = (nn.Linear(channels, num_classes) if use_se_loss
                         else None)
        self.classifier(channels)

    def forward(self, inputs, generator=None) -> torch.Tensor:
        feats = [inputs[i] for i in self.in_index]
        x = self.bottleneck(feats[-1])
        if self.add_lateral:
            lats = [self.resize(getattr(self, f"lateral{i}")(f),
                                x.shape[-2:])
                    for i, f in enumerate(feats[:-1])]
            x = self.fusion(torch.cat([x] + lats, 1))
        enc = F.relu(_bn_last(self.enc_bn, self.encoding(x))).mean(dim=1)
        gamma = torch.sigmoid(self.fc(enc))
        return self.cls_seg(x * gamma[:, :, None, None], generator)


@HEADS.register()
class DNLHead(DecodeHead):
    """Disentangled non-local (dnl_head.py): a whitened pairwise term and a
    unary term, in an FCN tail."""

    def __init__(self, in_channels: int = 2048, channels: int = 512,
                 num_classes: int = 19, reduction: int = 2,
                 temperature: float = 0.05, dropout_ratio: float = 0.1,
                 in_index: int = 3, align_corners: bool = False):
        super().__init__(num_classes, dropout_ratio, in_index, align_corners)
        inter = max(channels // reduction, 1)
        self.temperature = temperature
        self.conv0 = ConvModule(in_channels, channels, 3, padding=1)
        self.theta = nn.Conv2d(channels, inter, 1)
        self.phi = nn.Conv2d(channels, inter, 1)
        self.g = nn.Conv2d(channels, inter, 1)
        self.unary = nn.Conv2d(channels, 1, 1)
        self.conv_out = ConvModule(inter, channels, 1, with_act=False)
        self.conv1 = ConvModule(channels, channels, 3, padding=1)
        self.classifier(channels)

    def forward(self, inputs, generator=None) -> torch.Tensor:
        feats = self.conv0(inputs[self.in_index])
        h, w = feats.shape[-2:]
        theta, phi, g = (tokens(m(feats))
                         for m in (self.theta, self.phi, self.g))
        theta = theta - theta.mean(dim=1, keepdim=True)
        phi = phi - phi.mean(dim=1, keepdim=True)
        pairwise = _attend(theta, phi, g, 1.0 / self.temperature)
        unary = torch.softmax(self.unary(feats).flatten(1), dim=-1)
        unary_out = torch.einsum("bm,bmc->bc", unary, g)[:, None, :]
        y = self.conv_out(untokens(pairwise + unary_out, h, w))
        return self.cls_seg(self.conv1(feats + y), generator)


@HEADS.register()
class ISAHead(DecodeHead):
    """Interlaced sparse self-attention (isa_head.py): long-range
    attention across the block grid, then short-range attention within
    the blocks.  The map is padded to a multiple of ``down_factor`` and
    cropped back."""

    def __init__(self, in_channels: int = 2048, channels: int = 512,
                 num_classes: int = 19, isa_channels: int = 256,
                 down_factor: Sequence[int] = (8, 8),
                 dropout_ratio: float = 0.1, in_index: int = 3,
                 align_corners: bool = False):
        super().__init__(num_classes, dropout_ratio, in_index, align_corners)
        self.isa_channels = isa_channels
        self.down_factor = tuple(down_factor)
        self.in_conv = ConvModule(in_channels, channels, 3, padding=1)
        for p in ("global", "local"):
            self.add_module(f"{p}_q", nn.Linear(channels, isa_channels))
            self.add_module(f"{p}_k", nn.Linear(channels, isa_channels))
            self.add_module(f"{p}_v", nn.Linear(channels, channels))
        self.out_conv = ConvModule(2 * channels, channels, 1)
        self.classifier(channels)

    def _sa(self, t: torch.Tensor, prefix: str) -> torch.Tensor:
        """tokens (G, N, C) -> self-attention with shared projections."""
        q, k, v = (getattr(self, f"{prefix}_{n}")(t) for n in "qkv")
        return _attend(q, k, v, self.isa_channels ** -0.5)

    def forward(self, inputs, generator=None) -> torch.Tensor:
        feats = self.in_conv(inputs[self.in_index])
        b, c, h, w = feats.shape
        ph, pw = self.down_factor
        qh, qw = -(-h // ph), -(-w // pw)
        pad_h, pad_w = qh * ph - h, qw * pw - w
        # the JAX package's NHWC index arithmetic on an NHWC view
        y = F.pad(feats, (pad_w // 2, pad_w - pad_w // 2,
                          pad_h // 2, pad_h - pad_h // 2)).permute(0, 2, 3, 1)
        y = y.reshape(b, ph, qh, pw, qw, c)
        t = y.permute(0, 2, 4, 1, 3, 5).reshape(b * qh * qw, ph * pw, c)
        t = self._sa(t, "global").reshape(b, qh, qw, ph, pw, c)
        t = t.permute(0, 3, 4, 1, 2, 5).reshape(b * ph * pw, qh * qw, c)
        t = self._sa(t, "local").reshape(b, ph, pw, qh, qw, c)
        y = t.permute(0, 1, 3, 2, 4, 5).reshape(b, ph * qh, pw * qw, c)
        y = y[:, pad_h // 2:pad_h // 2 + h, pad_w // 2:pad_w // 2 + w]
        out = self.out_conv(torch.cat([feats, y.permute(0, 3, 1, 2)], 1))
        return self.cls_seg(out, generator)


@HEADS.register()
class FPNHead(DecodeHead):
    """Semantic FPN (fpn_head.py): per-level conv and 2x upsampling chains
    summed at the finest level."""

    def __init__(self, in_channels: Sequence[int] = (256, 256, 256, 256),
                 channels: int = 128, num_classes: int = 19,
                 feature_strides: Sequence[int] = (4, 8, 16, 32),
                 dropout_ratio: float = 0.1,
                 in_index: Sequence[int] = (0, 1, 2, 3),
                 align_corners: bool = False):
        super().__init__(num_classes, dropout_ratio, in_index, align_corners)
        self.feature_strides = tuple(feature_strides)
        self.n_convs = []
        for i, fs in enumerate(feature_strides):
            up = fs != feature_strides[0]
            n = max(1, int(np.log2(fs // feature_strides[0]))) if up else 1
            self.n_convs.append(n)
            for j in range(n):
                self.add_module(f"scale{i}_conv{j}", ConvModule(
                    in_channels[i] if j == 0 else channels, channels, 3,
                    padding=1))
        self.classifier(channels)

    def forward(self, inputs, generator=None) -> torch.Tensor:
        feats = [inputs[i] for i in self.in_index]
        hw0 = feats[0].shape[-2:]
        out = 0.0
        for i, f in enumerate(feats):
            up = self.feature_strides[i] != self.feature_strides[0]
            y = f
            for j in range(self.n_convs[i]):
                y = getattr(self, f"scale{i}_conv{j}")(y)
                if up:
                    y = self.resize(y, (min(y.shape[-2] * 2, hw0[0]),
                                        min(y.shape[-1] * 2, hw0[1])))
            out = out + self.resize(y, hw0)
        return self.cls_seg(out, generator)


def _psa_index(h: int, w: int, device) -> torch.Tensor:
    """idx[p, q]: the channel of the (2H-1)(2W-1) relative-position mask
    stack that links output pixel p = (i, j) to source pixel q = (a, b),
    the gather form of mmcv's PSAMask, made on ``device``."""
    n = torch.arange(h * w, device=device)
    i, j = n // w, n % w
    return ((i[None, :] - i[:, None] + h - 1) * (2 * w - 1)
            + (j[None, :] - j[:, None] + w - 1))


class MaskConv(InputShaped):
    """PSAHead's bias-free 1x1 conv to the (2H-1)(2W-1) relative-position
    masks.  Its output channels follow the feature size, so, as flax
    shapes the kernel at init, the weight takes its shape from the first
    feature map it sees (or from the state dict loaded into it) and is
    held to it after: another size raises, as the JAX package's kernel
    does."""

    input_shaped = ("weight",)

    def __init__(self, in_channels: int):
        super().__init__()
        self.in_channels = in_channels

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        m = (2 * h - 1) * (2 * w - 1)
        weight = self.bind(
            "weight", (m, self.in_channels, 1, 1), x,
            lambda t, g: lecun_normal_(t, self.in_channels, g),
            f"PSAHead's masks were shaped for other relative positions "
            f"than a {h}x{w} feature map's {m}")
        return F.conv2d(x, weight)


@HEADS.register()
class PSAHead(DecodeHead):
    """Point-wise spatial attention (psa_head.py): collect and distribute
    attention from per-pixel relative-position masks of (2H-1)(2W-1)
    channels (the JAX package's, not mmseg's fixed ``mask_size``)."""

    def __init__(self, in_channels: int = 2048, channels: int = 512,
                 num_classes: int = 19, mask_channels: int = 256,
                 psa_softmax: bool = True, dropout_ratio: float = 0.1,
                 in_index: int = 3, align_corners: bool = False):
        super().__init__(num_classes, dropout_ratio, in_index, align_corners)
        self.psa_softmax = psa_softmax
        for p in ("collect", "distribute"):
            self.add_module(f"{p}_reduce",
                            ConvModule(in_channels, mask_channels, 1))
            self.add_module(f"{p}_attn0",
                            ConvModule(mask_channels, mask_channels, 1))
            self.add_module(f"{p}_attn1", MaskConv(mask_channels))
        self.proj = ConvModule(2 * in_channels, channels, 1)
        self.bottleneck = ConvModule(in_channels + channels, channels, 3,
                                     padding=1)
        self.classifier(channels)

    def _branch(self, p: str, x: torch.Tensor, idx: torch.Tensor):
        y = getattr(self, f"{p}_attn0")(getattr(self, f"{p}_reduce")(x))
        mask = tokens(getattr(self, f"{p}_attn1")(y))       # (B, N, M)
        aff = torch.gather(mask, -1, idx.expand(mask.shape[0], -1, -1))
        return torch.softmax(aff, dim=-1) if self.psa_softmax else aff

    def forward(self, inputs, generator=None) -> torch.Tensor:
        x = inputs[self.in_index]
        h, w = x.shape[-2:]
        idx = _psa_index(h, w, x.device)[None]
        val = tokens(x)
        collect = torch.einsum("bnm,bmc->bnc",
                               self._branch("collect", x, idx), val)
        distribute = torch.einsum("bmn,bmc->bnc",
                                  self._branch("distribute", x, idx), val)
        y = self.proj(untokens(torch.cat([collect, distribute], -1), h, w))
        return self.cls_seg(self.bottleneck(torch.cat([x, y], 1)),
                            generator)


@HEADS.register()
class CCHead(DecodeHead):
    """Criss-cross attention (cc_head.py): recurrent attention along each
    pixel's row and column, its own position masked out of the column."""

    def __init__(self, in_channels: int = 2048, channels: int = 512,
                 num_classes: int = 19, recurrence: int = 2,
                 dropout_ratio: float = 0.1, in_index: int = 3,
                 align_corners: bool = False):
        super().__init__(num_classes, dropout_ratio, in_index, align_corners)
        inter = max(channels // 8, 1)
        self.recurrence = recurrence
        self.conv0 = ConvModule(in_channels, channels, 3, padding=1)
        self.cca_query = nn.Conv2d(channels, inter, 1)
        self.cca_key = nn.Conv2d(channels, inter, 1)
        self.cca_value = nn.Conv2d(channels, channels, 1)
        self.cca_gamma = nn.Parameter(torch.zeros(()))
        self.conv1 = ConvModule(in_channels + channels, channels, 3,
                                padding=1)
        self.classifier(channels)

    @torch.no_grad()
    def flax_init_(self, generator) -> None:
        self.cca_gamma.zero_()

    def forward(self, inputs, generator=None) -> torch.Tensor:
        x = inputs[self.in_index]
        feats = self.conv0(x)
        h = feats.shape[-2]
        # diag[i, :, a]: the pixel itself among its column's keys
        diag = torch.eye(h, dtype=torch.bool, device=x.device)[:, None, :]
        y = feats
        for _ in range(self.recurrence):
            # NHWC views, the JAX package's einsum subscripts
            q, k, v = (m(y).permute(0, 2, 3, 1) for m in
                       (self.cca_query, self.cca_key, self.cca_value))
            e_h = torch.einsum("bijc,bajc->bija", q, k)
            e_h = e_h.masked_fill(diag[None], -1e9)
            e_w = torch.einsum("bijc,biuc->biju", q, k)
            attn = torch.softmax(torch.cat([e_h, e_w], -1), dim=-1)
            out = (torch.einsum("bija,bajc->bijc", attn[..., :h], v)
                   + torch.einsum("biju,biuc->bijc", attn[..., h:], v))
            y = y + self.cca_gamma * out.permute(0, 3, 1, 2)
        return self.cls_seg(self.conv1(torch.cat([x, y], 1)), generator)


@HEADS.register()
class SETRUPHead(DecodeHead):
    """SETR's naive / PUP head (setr_up_head.py): an LN on the ViT map,
    then ``num_convs`` ConvModules, each followed by an ``up_scale``
    bilinear upsampling."""

    def __init__(self, in_channels: int = 1024, channels: int = 256,
                 num_classes: int = 19, num_convs: int = 1,
                 up_scale: int = 4, kernel_size: int = 3,
                 dropout_ratio: float = 0.0, in_index: int = -1,
                 align_corners: bool = False):
        super().__init__(num_classes, dropout_ratio, in_index, align_corners)
        self.up_scale = up_scale
        self.norm = LayerNorm(in_channels)
        _named(self, "up_conv", [
            ConvModule(in_channels if i == 0 else channels, channels,
                       kernel_size, padding=kernel_size // 2)
            for i in range(num_convs)])
        self.num_convs = num_convs
        self.classifier(channels)

    def forward(self, inputs, generator=None) -> torch.Tensor:
        x = ln_nchw(self.norm, inputs[self.in_index])
        for i in range(self.num_convs):
            x = getattr(self, f"up_conv{i}")(x)
            x = self.resize(x, (x.shape[-2] * self.up_scale,
                                x.shape[-1] * self.up_scale))
        return self.cls_seg(x, generator)


@HEADS.register()
class SETRMLAHead(DecodeHead):
    """SETR's MLA head (setr_mla_head.py): two 3x3 ConvModules and an
    ``up_scale`` upsampling per stream, the streams concatenated and
    classified."""

    def __init__(self, in_channels: Sequence[int] = (256, 256, 256, 256),
                 channels: int = 512, num_classes: int = 19,
                 mla_channels: int = 128, up_scale: int = 4,
                 dropout_ratio: float = 0.0,
                 in_index: Sequence[int] = (0, 1, 2, 3),
                 align_corners: bool = False):
        super().__init__(num_classes, dropout_ratio, in_index, align_corners)
        self.up_scale = up_scale
        for c, i in zip(in_channels, in_index):
            self.add_module(f"up{i}_conv0", ConvModule(c, mla_channels, 3,
                                                       padding=1))
            self.add_module(f"up{i}_conv1", ConvModule(
                mla_channels, mla_channels, 3, padding=1))
        self.classifier(len(in_index) * mla_channels)

    def forward(self, inputs, generator=None) -> torch.Tensor:
        outs = []
        for i in self.in_index:
            y = getattr(self, f"up{i}_conv1")(
                getattr(self, f"up{i}_conv0")(inputs[i]))
            outs.append(self.resize(y, (y.shape[-2] * self.up_scale,
                                        y.shape[-1] * self.up_scale)))
        return self.cls_seg(torch.cat(outs, dim=1), generator)


class _TransformerLayer(nn.Module):
    """A pre-LN transformer layer: flax's multi-head attention, then an
    MLP with flax's tanh GELU."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: int = 4):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = MultiHeadAttention(dim, num_heads)
        self.norm2 = LayerNorm(dim)
        self.fc1 = nn.Linear(dim, dim * mlp_ratio)
        self.fc2 = nn.Linear(dim * mlp_ratio, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm1(x)
        x = x + self.attn(y, y)
        return x + self.fc2(gelu(self.fc1(self.norm2(x)), approximate=True))


@HEADS.register()
class SegmenterMaskTransformerHead(DecodeHead):
    """Segmenter's mask transformer (segmenter_mask_head.py): the patch
    tokens and learned class tokens (``cls_emb``) through transformer
    layers; the masks are the L2-normalised patch-class similarities,
    layer-normalised over the classes (``mask_norm``).  No ``conv_seg``."""

    def __init__(self, in_channels: int = 768, channels: int = 768,
                 num_classes: int = 19, num_layers: int = 2,
                 num_heads: int = 12, dropout_ratio: float = 0.0,
                 in_index: int = -1, align_corners: bool = False):
        super().__init__(num_classes, dropout_ratio, in_index, align_corners)
        self.channels = channels
        self.proj_dec = nn.Linear(in_channels, channels)
        self.cls_emb = nn.Parameter(torch.empty(1, num_classes, channels))
        _named(self, "layer", [_TransformerLayer(channels, num_heads)
                               for _ in range(num_layers)])
        self.num_layers = num_layers
        self.decoder_norm = LayerNorm(channels)
        self.patch_proj = nn.Linear(channels, channels)
        self.classes_proj = nn.Linear(channels, channels)
        self.mask_norm = LayerNorm(num_classes)

    @torch.no_grad()
    def flax_init_(self, generator) -> None:
        normal_(self.cls_emb, 0.02, generator, truncated=True)

    def forward(self, inputs, generator=None) -> torch.Tensor:
        x = inputs[self.in_index]
        b, _, h, w = x.shape
        t = torch.cat([self.proj_dec(tokens(x)),
                       self.cls_emb.expand(b, -1, -1)], dim=1)
        for i in range(self.num_layers):
            t = getattr(self, f"layer{i}")(t)
        t = self.decoder_norm(t)
        patches = self.patch_proj(t[:, :h * w]) / (self.channels ** 0.5)
        classes = self.classes_proj(t[:, h * w:])
        masks = torch.einsum("bnc,bkc->bnk", _l2norm(patches, -1),
                             _l2norm(classes, -1))
        return untokens(self.mask_norm(masks), h, w)


def _sample_axis(p: torch.Tensor, size: int, align_corners: bool):
    """The low and high cells and the fraction of normalised float32
    coordinates ``p`` on an axis of ``size`` cells, rounded as XLA's CPU
    backend rounds the JAX package's arithmetic under ``jit``: it
    contracts a multiply and the add after it into one rounding, so the
    scaled coordinate is p * size - 0.5 rounded once, and, with
    ``align_corners``, the fraction p * (size - 1) - low rounded once.
    Exact products and sums in float64, then one rounding, do the same."""
    dt = p.dtype
    if align_corners:
        exact = p.double() * (size - 1)
        pos = exact.to(dt)
    else:
        pos = (p.double() * size - 0.5).to(dt)
    lo = torch.clamp(torch.floor(pos), 0, size - 1)
    hi = torch.clamp(lo + 1, 0, size - 1)
    frac = (exact - lo).to(dt) if align_corners else pos - lo
    return lo, hi, torch.clamp(frac, 0.0, 1.0)


def point_sample(feats: torch.Tensor, points: torch.Tensor,
                 align_corners: bool = False) -> torch.Tensor:
    """Bilinear samples of (B, C, H, W) maps at normalised [0, 1]^2 float32
    points (B, P, 2 as (x, y)): (B, C, P), in the maps' type.  The JAX
    package's arithmetic (``_sample_axis``): the corner weights in
    float32, the corners clamped to the map."""
    b, c, h, w = feats.shape
    x0, x1, fx = _sample_axis(points[..., 0], w, align_corners)
    y0, y1, fy = _sample_axis(points[..., 1], h, align_corners)
    flat = feats.reshape(b, c, h * w)

    def gather(yy, xx):
        idx = (yy * w + xx).long()
        return torch.gather(flat, 2, idx[:, None, :].expand(b, c, -1))

    return (gather(y0, x0) * ((1 - fy) * (1 - fx))[:, None]
            + gather(y0, x1) * ((1 - fy) * fx)[:, None]
            + gather(y1, x0) * (fy * (1 - fx))[:, None]
            + gather(y1, x1) * (fy * fx)[:, None]).to(feats.dtype)


@HEADS.register()
class PointHead(DecodeHead):
    """PointRend's point head (point_head.py): an MLP of 1-D convs (kernel
    1, ``fc{i}``, ReLU) over the fine features and the coarse logits
    sampled at the points, the coarse logits joined again after each
    layer (``coarse_pred_each_layer``), ``fc_seg`` to the classes.  The
    cascade (``cascade.CascadeEncoderDecoder``) runs the subdivision."""

    def __init__(self, in_channels: Sequence[int] = (256,),
                 channels: int = 256, num_classes: int = 19,
                 num_fcs: int = 3, coarse_pred_each_layer: bool = True,
                 dropout_ratio: float = 0.0, in_index: Sequence[int] = (0,),
                 align_corners: bool = False):
        super().__init__(num_classes, dropout_ratio, in_index, align_corners)
        self.coarse_pred_each_layer = coarse_pred_each_layer
        extra = num_classes if coarse_pred_each_layer else 0
        cin = sum(in_channels) + num_classes
        for i in range(num_fcs):
            self.add_module(f"fc{i}", nn.Conv1d(cin, channels, 1))
            cin = channels + extra
        self.num_fcs = num_fcs
        self.fc_seg = nn.Conv1d(cin, num_classes, 1)

    def forward(self, fine_feats, coarse_logits: torch.Tensor,
                points: torch.Tensor) -> torch.Tensor:
        """fine_feats: the levels (B, C, H, W); coarse_logits (B, K, h, w);
        points (B, P, 2) normalised -> point logits (B, K, P)."""
        fine = torch.cat([point_sample(fine_feats[i], points,
                                       self.align_corners)
                          for i in self.in_index], dim=1)
        coarse = point_sample(coarse_logits, points, self.align_corners)
        x = torch.cat([fine, coarse], dim=1)
        for i in range(self.num_fcs):
            x = F.relu(getattr(self, f"fc{i}")(x))
            if self.coarse_pred_each_layer:
                x = torch.cat([x, coarse], dim=1)
        return self.fc_seg(x)

    @staticmethod
    def uncertainty(logits: torch.Tensor) -> torch.Tensor:
        """-(top1 - top2) of (B, K, H, W) logits over the classes: (B, H,
        W) (point_head.py calculate_uncertainty)."""
        top2 = torch.topk(logits, 2, dim=1).values
        return top2[:, 1] - top2[:, 0]


@HEADS.register()
class DPTHead(DecodeHead):
    """DPT's head (dpt_head.py): the equal-sized ViT taps reassembled into
    a 4x .. 0.5x pyramid (1x1 projection, resize, 3x3 conv), fused top
    down through residual conv units, projected and classified."""

    def __init__(self, in_channels: Sequence[int] = (768, 768, 768, 768),
                 channels: int = 256, num_classes: int = 19,
                 embed_dims: int = 768,
                 post_process_channels: Sequence[int] = (96, 192, 384, 768),
                 dropout_ratio: float = 0.0,
                 in_index: Sequence[int] = (0, 1, 2, 3),
                 align_corners: bool = False):
        super().__init__(num_classes, dropout_ratio, in_index, align_corners)
        n = min(len(in_index), 4)
        for i in range(n):
            self.add_module(f"reassemble{i}_proj", nn.Conv2d(
                in_channels[i], post_process_channels[i], 1))
            self.add_module(f"reassemble{i}_out", nn.Conv2d(
                post_process_channels[i], channels, 3, padding=1,
                bias=False))
        # the JAX head names the coarsest level's unit "fusion3" whatever
        # the number of levels
        for i in [3] + list(range(n - 2, -1, -1)):
            for j in range(2):
                self.add_module(f"fusion{i}_res_conv{j}", nn.Conv2d(
                    channels, channels, 3, padding=1))
        self.project = ConvModule(channels, channels, 3, padding=1)
        self.classifier(channels)

    def _residual(self, z: torch.Tensor, i: int) -> torch.Tensor:
        y = getattr(self, f"fusion{i}_res_conv0")(F.relu(z))
        return z + getattr(self, f"fusion{i}_res_conv1")(F.relu(y))

    def forward(self, inputs, generator=None) -> torch.Tensor:
        feats = [inputs[i] for i in self.in_index]
        h, w = feats[0].shape[-2:]
        pyramid = []
        for i, (f, s) in enumerate(zip(feats, (4.0, 2.0, 1.0, 0.5))):
            y = self.resize(getattr(self, f"reassemble{i}_proj")(f),
                            (max(int(h * s), 1), max(int(w * s), 1)))
            pyramid.append(getattr(self, f"reassemble{i}_out")(y))
        out = self._residual(pyramid[-1], 3)
        for i in range(len(pyramid) - 2, -1, -1):
            out = self._residual(
                self.resize(out, pyramid[i].shape[-2:]) + pyramid[i], i)
        return self.cls_seg(self.project(out), generator)
