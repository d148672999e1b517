"""The forward of a segmentor with the map's height sharded over devices
(``core.spatial``): the mesh's ``spatial`` axis for PEANUT's PSPNet and
the dry run's, whole-map inference and the train forward alike.

``forward_rows(model, x)`` runs an ``EncoderDecoder`` over a ``Rows`` map
with the same parameters and buffers as ``model(x)``: each module of the
model runs over the row blocks through its sharded form below, a map made
global by a pooling (PSPHead's pyramid) through the module's own forward
on the model's device.  The result equals the unsharded forward in exact
arithmetic:

* convolutions and the stem's max pool take their halo rows from the
  shards that hold them (``spatial.conv2d``, ``spatial.max_pool2d``);
* train-mode batch norms add each shard's sums of x and x^2 and its
  count, then all-reduce them over the data group where there is one
  (``layers.BatchNorm.moments``), and move the running statistics once
  a step from the global mean and variance;
* the heads' dropout draws the global map's mask (``spatial.dropout``);
* ``remat`` recomputes a residual block over all its shards, halos
  included, under one checkpoint (a block's batch norms need every
  shard's statistics);
* the logits are resized to the input's rows shard by shard
  (``spatial.resize``).

Sharded forms exist for ``nn.Conv2d``, ``layers.Conv2d``, ``ConvModule``,
``BatchNorm``, ``nn.ReLU``, ``nn.Sequential``, ``ZooBottleneck``,
``BasicBlock``, ``ZooResNet`` / ``ResNetV1c`` / ``ResNeXt``,
``AdaptiveAvgPool``, ``PSPHead``, ``FCNHead`` and ``EncoderDecoder``
without a neck.  Any other module type raises NotImplementedError naming
it: the model zoo's other families over the spatial axis are ROADMAP A14
part 3.  Nothing falls back to the unsharded model.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..core import spatial
from ..core.spatial import Rows, to
from .encoder_decoder import EncoderDecoder
from .heads import AdaptiveAvgPool, FCNHead, PSPHead
from .layers import BatchNorm, Conv2d, ConvModule, remat
from .resnet import BasicBlock, ResNetV1c, ResNeXt, ZooBottleneck, ZooResNet


@dataclasses.dataclass
class _Context:
    home: torch.device              # the model's device: global maps
    generator: Optional[object]     # the heads' dropout stream


_FORWARDS: Dict[type, Callable] = {}


def _sharded(*types):
    def register(fn):
        for t in types:
            _FORWARDS[t] = fn
        return fn
    return register


def run(m: nn.Module, x, ctx: _Context):
    """``m`` over a row-sharded map (or a list of them, a backbone's
    levels); a global map (a tensor) goes through ``m``'s own forward."""
    if isinstance(x, torch.Tensor):
        return m(x)
    fn = _FORWARDS.get(type(m))
    if fn is None:
        raise NotImplementedError(
            f"{type(m).__name__} has no row-sharded forward: the spatial "
            f"axis over the model zoo's other module types is ROADMAP A14 "
            f"part 3")
    return fn(m, x, ctx)


def _sum_on(parts, device) -> torch.Tensor:
    total = None
    for p in parts:
        p = to(p, device)
        total = p if total is None else total + p
    return total


@_sharded(nn.Conv2d)
def _conv(m: nn.Conv2d, x: Rows, ctx) -> Rows:
    if m.padding_mode != "zeros" or isinstance(m.padding, str):
        raise NotImplementedError(
            f"Conv2d with padding {m.padding!r} ({m.padding_mode}) has no "
            f"row-sharded forward: ROADMAP A14 part 3")
    return spatial.conv2d(x, m.weight, m.bias, m.stride, m.padding,
                          m.dilation, m.groups)


@_sharded(Conv2d)
def _conv_norm(m: Conv2d, x: Rows, ctx) -> Rows:
    y = _conv(m, x, ctx)
    return run(m.norm, y, ctx) if m.norm is not None else y


@_sharded(BatchNorm)
def _batch_norm(m: BatchNorm, x: Rows, ctx) -> Rows:
    if not m.training:
        terms = m.eval_terms()
        return x.map(lambda b: (b - to(terms[0], b.device))
                     * to(terms[1], b.device) + to(terms[2], b.device))
    wide = [b.to(torch.promote_types(b.dtype, torch.float32))
            for b in x.blocks]
    home = m.weight.device
    mean, var = m.moments(_sum_on((m.partial_sums(b) for b in wide), home))
    mul = m.batch_mul(mean, var)
    return Rows([m.normalise(b, to(mean, b.device), to(mul, b.device),
                             to(m.bias, b.device)).to(x.dtype)
                 for b in wide], x.height)


@_sharded(nn.ReLU)
def _relu(m, x: Rows, ctx) -> Rows:
    return x.map(F.relu)


@_sharded(nn.Sequential)
def _sequential(m: nn.Sequential, x, ctx):
    for child in m:
        x = run(child, x, ctx)
    return x


@_sharded(ConvModule)
def _conv_module(m: ConvModule, x: Rows, ctx) -> Rows:
    x = run(m.conv, x, ctx)
    if m.bn is not None:
        x = run(m.bn, x, ctx)
    if not m.with_act:
        return x
    if m.act_module is not None:
        return run(m._modules[m.act_module], x, ctx)
    return x.map(m.act)


def _relu_of(m, x, ctx) -> Rows:
    return run(m, x, ctx).map(F.relu)


@_sharded(ZooBottleneck)
def _bottleneck(m: ZooBottleneck, x: Rows, ctx) -> Rows:
    out = _relu_of(m.bn1, run(m.conv1, x, ctx), ctx)
    out = _relu_of(m.bn2, run(m.conv2, out, ctx), ctx)
    out = run(m.bn3, run(m.conv3, out, ctx), ctx)
    identity = run(m.downsample, x, ctx) if m.downsample is not None else x
    return (out + identity).map(F.relu)


@_sharded(BasicBlock)
def _basic_block(m: BasicBlock, x: Rows, ctx) -> Rows:
    out = _relu_of(m.bn1, run(m.conv1, x, ctx), ctx)
    out = run(m.bn2, run(m.conv2, out, ctx), ctx)
    identity = run(m.downsample, x, ctx) if m.downsample is not None else x
    return (out + identity).map(F.relu)


def _remat_block(block: nn.Module, x: Rows, ctx) -> Rows:
    """``block`` over all of x's shards under one ``layers.remat``: its
    activations, halo rows included, recomputed in backward."""
    def fn(*blocks):
        return tuple(run(block, Rows(blocks, x.height), ctx).blocks)
    out = remat(fn, *x.blocks)
    return Rows(out, sum(b.shape[2] for b in out))


@_sharded(ZooResNet, ResNetV1c, ResNeXt)
def _resnet(m: ZooResNet, x: Rows, ctx):
    if m.deep_stem:
        x = run(m.stem, x, ctx)
    else:
        x = _relu_of(m.bn1, run(m.conv1, x, ctx), ctx)
    x = spatial.max_pool2d(x, 3, 2, 1)
    outs = []
    rematted = m.remat and torch.is_grad_enabled()
    for i in range(m.num_stages):
        for block in getattr(m, f"layer{i + 1}"):
            x = (_remat_block(block, x, ctx) if rematted
                 else run(block, x, ctx))
        if i in m.out_indices:
            outs.append(x)
    return outs


@_sharded(AdaptiveAvgPool)
def _adaptive_pool(m: AdaptiveAvgPool, x: Rows, ctx) -> torch.Tensor:
    return spatial.adaptive_avg_pool(x, m.output_size, ctx.home)


def _resize_like(x, size, align_corners: bool, devices) -> Rows:
    """``heads.resize_like``: the resize back in x's type."""
    dtype = x.dtype
    return spatial.resize(x, size, align_corners, devices).map(
        lambda b: b.to(dtype))


def _cls_seg(m, x: Rows, ctx) -> Rows:
    if m.training and m.dropout_ratio > 0:
        x = spatial.dropout(x, m.dropout_ratio, ctx.generator, ctx.home)
    return run(m.conv_seg, x, ctx)


@_sharded(PSPHead)
def _psp_head(m: PSPHead, inputs, ctx) -> Rows:
    x = inputs[m.in_index]
    hw = (x.height, x.shape[3])
    outs = [x] + [_resize_like(run(branch, x, ctx), hw, m.align_corners,
                               x.devices) for branch in m.psp_modules]
    return _cls_seg(m, run(m.bottleneck, spatial.cat(outs), ctx), ctx)


@_sharded(FCNHead)
def _fcn_head(m: FCNHead, inputs, ctx) -> Rows:
    if isinstance(m.in_index, (tuple, list)):
        sel = [inputs[i] for i in m.in_index]
        hw = (sel[0].height, sel[0].shape[3])
        x = spatial.cat([_resize_like(f, hw, m.align_corners, f.devices)
                         for f in sel])
    else:
        x = inputs[m.in_index]
    feats = x
    for conv in m.convs:
        feats = run(conv, feats, ctx)
    if m.conv_cat is not None:
        feats = run(m.conv_cat, spatial.cat([x, feats]), ctx)
    return _cls_seg(m, feats, ctx)


def forward_rows(model: EncoderDecoder, x: Rows,
                 train: Optional[bool] = None, with_aux: bool = False,
                 generator=None):
    """``model.forward`` over a row-sharded (B, C, H, W) map: the raw
    logits resized to the input, row-sharded as the input is, and the
    auxiliary head's alike with ``with_aux`` (a pair).  ``train`` and
    ``generator`` as there (a ``layers.BatchRows`` under data
    parallelism)."""
    if type(model) is not EncoderDecoder:
        raise NotImplementedError(
            f"{type(model).__name__} has no row-sharded forward: ROADMAP "
            f"A14 part 3")
    if train is not None:
        model.train(train)
    ctx = _Context(next(model.parameters()).device, generator)
    feats = run(model.backbone, x, ctx)
    if model.neck is not None:
        feats = run(model.neck, feats, ctx)
    hw = (x.height, x.shape[3])
    logits = spatial.resize(run(model.decode_head, feats, ctx), hw,
                            model.align_corners)
    if with_aux and model.auxiliary_head is not None:
        return logits, spatial.resize(run(model.auxiliary_head, feats, ctx),
                                      hw, model.align_corners)
    return logits
