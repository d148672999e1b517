"""K-Net's head, NCHW (port of ``peanut_tpu.models.knet``): a kernel-
generating head gives per-class masks and the initial kernels (a learned
``kernel_seed`` per class, the same for every sample), then
``num_stages`` kernel-update stages refine (kernels, masks): each gathers
the pixels under its hard masks, gates them into the kernels
(``KernelUpdator``), runs self-attention over the K kernels (flax's
multi-head attention) and an FFN, and predicts new masks.  Submodules are
named after the flax modules."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..registry import HEADS
from .heads import DecodeHead
from .layers import ConvModule, LayerNorm, MultiHeadAttention, gelu, normal_


class KernelUpdator(nn.Module):
    """The adaptive kernel update: the group features gate, through
    sigmoid gates, how much of each kernel is kept and how much of the
    update is taken."""

    def __init__(self, channels: int = 256):
        super().__init__()
        c = channels
        self.dynamic_layer = nn.Linear(c, 2 * c)
        self.input_layer = nn.Linear(c, 2 * c)
        self.input_gate = nn.Linear(c, c)
        self.input_gate_norm = LayerNorm(c)
        self.update_gate = nn.Linear(c, c)
        self.update_gate_norm = LayerNorm(c)
        self.param_norm = LayerNorm(c)
        self.input_norm = LayerNorm(c)
        self.fc_layer = nn.Linear(c, c)
        self.fc_norm = LayerNorm(c)

    def forward(self, update_feature: torch.Tensor,
                input_feature: torch.Tensor) -> torch.Tensor:
        """(B, K, C) group features and kernels -> updated (B, K, C)."""
        param_in, param_out = self.dynamic_layer(update_feature).chunk(2, -1)
        input_in, input_out = self.input_layer(input_feature).chunk(2, -1)
        gate = input_in * param_in
        input_gate = torch.sigmoid(self.input_gate_norm(
            self.input_gate(gate)))
        update_gate = torch.sigmoid(self.update_gate_norm(
            self.update_gate(gate)))
        features = (update_gate * self.param_norm(param_out)
                    + input_gate * self.input_norm(input_out))
        return F.relu(self.fc_norm(self.fc_layer(features)))


class KernelUpdateHead(nn.Module):
    """One refinement stage over features (B, C, H, W), kernels (B, K, C)
    and mask logits (B, K, H, W)."""

    def __init__(self, channels: int = 256, num_heads: int = 8,
                 feedforward_channels: int = 1024, mask_thr: float = 0.5):
        super().__init__()
        self.mask_thr = mask_thr
        self.kernel_update_conv = KernelUpdator(channels)
        self.attention = MultiHeadAttention(channels, num_heads)
        self.attention_norm = LayerNorm(channels)
        self.ffn_fc1 = nn.Linear(channels, feedforward_channels)
        self.ffn_fc2 = nn.Linear(feedforward_channels, channels)
        self.ffn_norm = LayerNorm(channels)
        self.mask_fc = nn.Linear(channels, channels)
        self.mask_fc_norm = LayerNorm(channels)

    def forward(self, feats, kernels, masks):
        c = feats.shape[1]
        # group features: the mean of the pixels under each hard mask
        hard = (torch.sigmoid(masks) > self.mask_thr).to(feats.dtype)
        denom = torch.clamp(hard.sum(dim=(2, 3)), min=1.0)       # (B, K)
        group = torch.einsum("bkhw,bchw->bkc", hard, feats) / denom[..., None]
        kernels, mask_feat = self.update(group, kernels)
        new_masks = torch.einsum("bkc,bchw->bkhw", mask_feat, feats)
        return kernels, new_masks / math.sqrt(c)

    def update(self, group: torch.Tensor, kernels: torch.Tensor):
        """The (B, K, C) group features and kernels -> the updated kernels
        and the mask features the new masks are their product with."""
        kernels = self.kernel_update_conv(group, kernels)
        kernels = self.attention_norm(
            kernels + self.attention(kernels, kernels))
        y = self.ffn_fc2(gelu(self.ffn_fc1(kernels), approximate=True))
        kernels = self.ffn_norm(kernels + y)
        return kernels, F.relu(self.mask_fc_norm(self.mask_fc(kernels)))


@HEADS.register()
class IterativeDecodeHead(DecodeHead):
    """K-Net's head (knet_head.py IterativeDecodeHead): the final stage's
    mask logits."""

    def __init__(self, in_channels: int = 2048, channels: int = 256,
                 num_classes: int = 19, num_stages: int = 3,
                 num_heads: int = 8, feedforward_channels: int = 1024,
                 dropout_ratio: float = 0.1, in_index: int = 3,
                 align_corners: bool = False):
        super().__init__(num_classes, dropout_ratio, in_index, align_corners)
        self.generate_conv = ConvModule(in_channels, channels, 3, padding=1)
        self.classifier(channels)
        self.kernel_seed = nn.Parameter(torch.empty(num_classes, channels))
        for i in range(num_stages):
            self.add_module(f"kernel_update_head{i}", KernelUpdateHead(
                channels, num_heads, feedforward_channels))
        self.num_stages = num_stages

    @torch.no_grad()
    def flax_init_(self, generator) -> None:
        normal_(self.kernel_seed, 0.02, generator, truncated=True)

    def forward(self, inputs, generator=None) -> torch.Tensor:
        feats = self.generate_conv(inputs[self.in_index])
        masks = self.cls_seg(feats, generator)
        kernels = self.kernel_seed.expand(feats.shape[0], -1, -1)
        for i in range(self.num_stages):
            kernels, masks = getattr(self, f"kernel_update_head{i}")(
                feats, kernels, masks)
        return masks
