"""Building-block layers (NCHW) with detectron2's and mmcv's module layouts
(port of ``peanut_tpu.models.layers``).

``Conv2d`` carries its normalisation as a ``norm`` submodule, as detectron2's
wrapper does, so a d2 state dict (``...conv1.weight``, ``...conv1.norm.*``)
loads through ``load_state_dict``; ``ConvModule`` is mmcv's conv + BN + ReLU
unit (``...conv.weight``, ``...bn.*``) for the mmseg models.  ``BatchNorm``
is the frozen batch norm of inference: eps 1e-5, weight, bias and running
statistics as buffers.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


BN_EPS = 1e-5


class BatchNorm(nn.Module):
    """Frozen BatchNorm2d: (x - mean) * (rsqrt(var + eps) * weight) + bias,
    the order of flax's BatchNorm with running averages."""

    def __init__(self, num_features: int):
        super().__init__()
        self.register_buffer("weight", torch.ones(num_features))
        self.register_buffer("bias", torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean, mul, bias = self._terms()
        return (x - mean) * mul + bias

    def _terms(self):
        """(mean, rsqrt(var + eps) * weight, bias) as (C, 1, 1), kept until
        a buffer is replaced or written: a detect dispatches ~100 of these
        layers, and recomputing the terms in every call made up a large
        share of the operations its host enqueues."""
        bufs = (self.weight, self.bias, self.running_mean, self.running_var)
        key = tuple((b.data_ptr(), b._version) for b in bufs)
        cached = self.__dict__.get("_cached_terms")
        if cached is None or cached[0] != key:
            mul = torch.rsqrt(self.running_var + BN_EPS) * self.weight
            cached = (key, (self.running_mean[:, None, None],
                            mul[:, None, None], self.bias[:, None, None]))
            self.__dict__["_cached_terms"] = cached
        return cached[1]


class Conv2d(nn.Conv2d):
    """nn.Conv2d with an optional ``norm`` applied after the convolution."""

    def __init__(self, *args, norm: Optional[nn.Module] = None, **kw):
        super().__init__(*args, **kw)
        self.norm = norm

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.conv2d(x, self.weight, self.bias, self.stride, self.padding,
                     self.dilation, self.groups)
        return self.norm(x) if self.norm is not None else x


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> torch.Tensor:
    """flax's default kernel init: a normal truncated at +-2 standard
    deviations, scaled to variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


class ConvModule(nn.Module):
    """mmcv's conv -> BN -> ReLU unit with its parameter names (``conv``,
    ``bn``), so an mmseg state dict loads through ``load_state_dict``."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, dilation: int = 1):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size,
                              stride=stride, padding=padding,
                              dilation=dilation, bias=False)
        self.bn = BatchNorm(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.bn(self.conv(x)))


@torch.no_grad()
def init_flax_random(module: nn.Module, generator: torch.Generator) -> None:
    """flax's default initialisers in place: lecun-normal conv kernels,
    zero biases, unit batch norm (weight 1, bias 0, mean 0, variance 1)."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
        elif isinstance(m, nn.Conv2d):
            w = m.weight
            fan_in = w.shape[1] * w.shape[2] * w.shape[3]
            w.copy_(lecun_normal_(torch.empty(w.shape), fan_in, generator))
            if m.bias is not None:
                m.bias.zero_()
