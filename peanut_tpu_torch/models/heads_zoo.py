"""Zoo decode heads over ResNetV1c, NCHW (port of the ResNetV1c half of
``peanut_tpu.models.heads_zoo``): ANN, APC, DM, EMA, Enc (with its
Encoding codebook), DNL, ISA, FPN, PSA and CC.  The reference's CUDA ops
for the last two (mmcv's ``CrissCrossAttention`` and ``PSAMask``) are dense
products and a gather here, as in the JAX package (``torch.einsum``,
``torch.gather``): no hand-written kernel.  Submodules and parameters are
named after the flax modules, so ``mmseg_import.flax_to_torch_state``
carries the JAX package's variables.  The other heads of that file
(LRASPP, DepthwiseSeparableFCN, SETR, Segmenter, STDC, Point, DPT) wait
for their backbones (ROADMAP A13).
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
from .layers import BatchNorm, ConvModule, lecun_normal_
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


class MaskConv(nn.Module):
    """PSAHead's bias-free 1x1 conv to the (2H-1)(2W-1) relative-position
    masks.  Its output channels follow the feature size, so, as flax
    shapes the kernel at init, the weight takes its shape from the first
    feature map it sees (or from the state dict loaded into it) and is
    held to it after: another size raises, as the JAX package's kernel
    does.  Its random values come from a seed ``flax_init_`` draws."""

    def __init__(self, in_channels: int):
        super().__init__()
        self.in_channels = in_channels
        self.register_parameter("weight", None)
        self.seed = None

    @torch.no_grad()
    def flax_init_(self, generator) -> None:
        self.seed = int(torch.randint(0, 2 ** 62, (),
                                      generator=generator))
        self.weight = None

    def _load_from_state_dict(self, state_dict, prefix, *args, **kw):
        w = state_dict.get(prefix + "weight")
        if w is not None and self.weight is None:
            self.weight = nn.Parameter(torch.empty(w.shape, dtype=w.dtype,
                                                   device=w.device))
        super()._load_from_state_dict(state_dict, prefix, *args, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        m = (2 * h - 1) * (2 * w - 1)
        if self.weight is None:
            g = (torch.Generator().manual_seed(self.seed)
                 if self.seed is not None else None)
            self.weight = nn.Parameter(lecun_normal_(
                torch.empty(m, self.in_channels, 1, 1), self.in_channels,
                g).to(device=x.device, dtype=x.dtype))
        elif self.weight.shape[0] != m:
            raise ValueError(
                f"PSAHead's masks were shaped for {self.weight.shape[0]} "
                f"relative positions, a {h}x{w} feature map needs {m}")
        return F.conv2d(x, self.weight)


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
