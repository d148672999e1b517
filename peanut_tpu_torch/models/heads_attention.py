"""Attention decode heads, NCHW (port of
``peanut_tpu.models.heads_attention``): DANet's PAM and CAM and its
DAHead, the non-local NLHead and the global-context GCHead.  Dense
attention products (``torch.einsum`` / ``torch.matmul``), as the JAX
package's; submodules named after the flax modules.  The residual gates
``gamma`` start at 0, as flax's."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..registry import HEADS
from .heads import DecodeHead, tokens, untokens
from .layers import ConvModule


class _Gate(nn.Module):
    """A module with a zero-initialised scalar residual gate ``gamma``."""

    def __init__(self):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(()))

    @torch.no_grad()
    def flax_init_(self, generator) -> None:
        self.gamma.zero_()


class PAM(_Gate):
    """Position attention (DANet)."""

    def __init__(self, channels: int):
        super().__init__()
        inter = max(channels // 8, 1)
        self.query = nn.Conv2d(channels, inter, 1)
        self.key = nn.Conv2d(channels, inter, 1)
        self.value = nn.Conv2d(channels, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[-2:]
        q, k, v = (tokens(m(x)) for m in (self.query, self.key, self.value))
        attn = torch.softmax(torch.einsum("bnc,bmc->bnm", q, k), dim=-1)
        out = untokens(torch.einsum("bnm,bmc->bnc", attn, v), h, w)
        return x + self.gamma * out


class CAM(_Gate):
    """Channel attention (DANet)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        flat = x.flatten(2)                                   # (B, C, N)
        energy = torch.einsum("bcn,bdn->bcd", flat, flat)
        energy = energy.amax(dim=-1, keepdim=True) - energy
        attn = torch.softmax(energy, dim=-1)
        out = torch.einsum("bcd,bdn->bcn", attn, flat).reshape(x.shape)
        return x + self.gamma * out


@HEADS.register()
class DAHead(DecodeHead):
    """Dual attention (da_head.py)."""

    def __init__(self, in_channels: int = 2048, channels: int = 512,
                 num_classes: int = 19, dropout_ratio: float = 0.1,
                 in_index: int = 3, align_corners: bool = False):
        super().__init__(num_classes, dropout_ratio, in_index, align_corners)
        self.pam_in = ConvModule(in_channels, channels, 3, padding=1)
        self.pam = PAM(channels)
        self.pam_out = ConvModule(channels, channels, 3, padding=1)
        self.cam_in = ConvModule(in_channels, channels, 3, padding=1)
        self.cam = CAM()
        self.cam_out = ConvModule(channels, channels, 3, padding=1)
        self.classifier(channels)

    def forward(self, inputs, generator=None) -> torch.Tensor:
        x = inputs[self.in_index]
        pam = self.pam_out(self.pam(self.pam_in(x)))
        cam = self.cam_out(self.cam(self.cam_in(x)))
        return self.cls_seg(pam + cam, generator)


@HEADS.register()
class NLHead(DecodeHead):
    """Non-local (nl_head.py): an FCN conv and an embedded-Gaussian
    non-local block."""

    def __init__(self, in_channels: int = 2048, channels: int = 512,
                 num_classes: int = 19, dropout_ratio: float = 0.1,
                 in_index: int = 3, align_corners: bool = False,
                 reduction: int = 2):
        super().__init__(num_classes, dropout_ratio, in_index, align_corners)
        inter = max(channels // reduction, 1)
        self.conv0 = ConvModule(in_channels, channels, 3, padding=1)
        self.theta = nn.Conv2d(channels, inter, 1)
        self.phi = nn.Conv2d(channels, inter, 1)
        self.g = nn.Conv2d(channels, inter, 1)
        self.out_proj = nn.Conv2d(inter, channels, 1)
        self.conv1 = ConvModule(channels, channels, 3, padding=1)
        self.classifier(channels)

    def forward(self, inputs, generator=None) -> torch.Tensor:
        feats = self.conv0(inputs[self.in_index])
        h, w = feats.shape[-2:]
        theta, phi, g = (tokens(m(feats))
                         for m in (self.theta, self.phi, self.g))
        attn = torch.softmax(torch.einsum("bnc,bmc->bnm", theta, phi),
                             dim=-1)
        y = untokens(torch.einsum("bnm,bmc->bnc", attn, g), h, w)
        feats = feats + self.out_proj(y)
        return self.cls_seg(self.conv1(feats), generator)


@HEADS.register()
class GCHead(DecodeHead):
    """Global context (gc_head.py): an FCN conv and a GC block (softmax
    spatial pooling, a bottleneck MLP with LayerNorm)."""

    def __init__(self, in_channels: int = 2048, channels: int = 512,
                 num_classes: int = 19, dropout_ratio: float = 0.1,
                 in_index: int = 3, align_corners: bool = False,
                 ratio: float = 0.25):
        super().__init__(num_classes, dropout_ratio, in_index, align_corners)
        hidden = max(int(channels * ratio), 1)
        self.conv0 = ConvModule(in_channels, channels, 3, padding=1)
        self.mask = nn.Conv2d(channels, 1, 1)
        self.down = nn.Linear(channels, hidden)
        self.ln = nn.LayerNorm(hidden, eps=1e-6)      # flax's epsilon
        self.up = nn.Linear(hidden, channels)
        self.conv1 = ConvModule(channels, channels, 3, padding=1)
        self.classifier(channels)

    def forward(self, inputs, generator=None) -> torch.Tensor:
        feats = self.conv0(inputs[self.in_index])
        mask = torch.softmax(self.mask(feats).flatten(1), dim=1)  # (B, N)
        context = torch.einsum("bn,bcn->bc", mask, feats.flatten(2))
        t = self.up(F.relu(self.ln(self.down(context))))
        feats = feats + t[:, :, None, None]
        return self.cls_seg(self.conv1(feats), generator)
