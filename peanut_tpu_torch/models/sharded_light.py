"""The row-sharded forms (``models.sharded``) of the zoo's light CNNs, first
half: the backbones ``MobileNetV2`` (``InvertedResidual``),
``MobileNetV3`` (``MBV3Block``, ``SELayer``), ``ResNeSt``
(``ResNeStBottleneck``, ``SplitAttentionConv``), ``HRNet``
(``HRModule``), ``UNet`` (``DoubleConv``), ``FastSCNN`` (``_DSConv``)
and ``TIMMBackbone`` (the zoo backbone it stands for), and the heads
``LRASPPHead`` and ``DepthwiseSeparableFCNHead`` (``SepConvModule``).
Registered through ``sharded._sharded``; ``models.sharded`` imports this
module.

Their depthwise, grouped, strided and dilated convolutions and their max
and average pools take their halo rows from the shards that hold them
(``spatial.conv2d``, ``spatial.max_pool2d``, ``spatial.avg_pool2d``;
zeros above and below the whole map count in an average, as flax's
``nn.avg_pool`` counts them).  The gates (MobileNetV3's squeeze-
excitation, ResNeSt's split attention, LR-ASPP's image pool) are
computed once, on the model's device, from the global mean (each
shard's partial sum; LR-ASPP's through ``spatial.adaptive_avg_pool(x,
1)``, as its unsharded head pools), and each shard multiplies its rows
by them.  HRNet's branches, UNet's decoder and
Fast-SCNN's fusion resize a coarser map's rows onto a finer map's shards
(``spatial.resize``, split by the same ``row_ranges`` as the finer
map's), and Fast-SCNN's pyramid pool is global, as PSPHead's.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from ..core import spatial
from ..core.spatial import Rows, to
from .backbones_zoo import (MBV3Block, FastSCNN, MobileNetV3, ResNeSt,
                            ResNeStBottleneck, SELayer, SplitAttentionConv,
                            _DSConv)
from .heads_zoo import DepthwiseSeparableFCNHead, LRASPPHead, SepConvModule
from .hrnet import HRModule, HRNet
from .layers import hsigmoid, relu6
from .mobilenet import InvertedResidual, MobileNetV2
from .sharded import (_cls_seg, _hw, _pooled, _relu_of, _resize_like,
                      _sharded, _sum_on, run)
from .timm_adapter import TIMMBackbone
from .unet import DoubleConv, UNet


def _global_mean(x: Rows, ctx) -> torch.Tensor:
    """``x.mean(dim=(2, 3), keepdim=True)`` of the whole map, (B, C, 1, 1)
    on the model's device in x's type: each shard's partial sum in
    float32 or wider, added there, over the global count (the exact
    count: a pool's float32 bin weights of 1 / (H W) would round the
    mean of a float64 map)."""
    wide = torch.promote_types(x.dtype, torch.float32)
    total = _sum_on((b.sum(dim=(2, 3), keepdim=True, dtype=wide)
                     for b in x.blocks), ctx.home)
    return (total / (x.height * x.shape[3])).to(x.dtype)


def _gated(x: Rows, gate: torch.Tensor) -> Rows:
    """Each shard's rows times the global (B, C, 1, 1) ``gate``, copied to
    the shard's device."""
    return x.map(lambda b: b * to(gate, b.device))


@_sharded(InvertedResidual)
def _inverted_residual(m: InvertedResidual, x: Rows, ctx) -> Rows:
    out = run(m.expand, x, ctx) if m.expand is not None else x
    out = run(m.dw_bn, run(m.dw_conv, out, ctx), ctx).map(relu6)
    out = run(m.project_bn, run(m.project, out, ctx), ctx)
    return out + x if m.use_res else out


@_sharded(MobileNetV2)
def _mobilenet_v2(m: MobileNetV2, x: Rows, ctx) -> List[Rows]:
    x = run(m.conv1, x, ctx)
    outs = []
    for i, nblocks in enumerate(m.stage_blocks):
        for j in range(nblocks):
            x = run(getattr(m, f"layer{i + 1}_{j}"), x, ctx)
        if i in m.out_indices:
            outs.append(x)
    return outs


@_sharded(SELayer)
def _se_layer(m: SELayer, x: Rows, ctx) -> Rows:
    s = m.fc2(F.relu(m.fc1(_global_mean(x, ctx))))
    return _gated(x, hsigmoid(s) if m.gate == "hsigmoid"
                  else torch.sigmoid(s))


@_sharded(MBV3Block)
def _mbv3_block(m: MBV3Block, x: Rows, ctx) -> Rows:
    y = run(m.expand, x, ctx) if m.expand is not None else x
    y = run(m.dw_bn, run(m.dw, y, ctx), ctx).map(m.act)
    if m.se is not None:
        y = run(m.se, y, ctx)
    y = run(m.project_bn, run(m.project, y, ctx), ctx)
    return y + x if m.use_res else y


@_sharded(MobileNetV3)
def _mobilenet_v3(m: MobileNetV3, x: Rows, ctx) -> List[Rows]:
    outs = []
    for i in range(m.n + 2):
        x = run(getattr(m, f"layer{i}"), x, ctx)
        if i in m.out_indices:
            outs.append(x)
    return outs


@_sharded(LRASPPHead)
def _lraspp_head(m: LRASPPHead, inputs, ctx) -> Rows:
    feats = [inputs[i] for i in m.in_index]
    x = feats[-1]
    # the unsharded head's adaptive pool to 1 x 1 (its bin weights)
    gate = torch.sigmoid(m.image_pool(spatial.adaptive_avg_pool(
        x, 1, ctx.home)))
    y = _gated(run(m.aspp_conv, x, ctx), gate)
    for i, f in enumerate(feats[:-1][::-1]):
        y = _resize_like(y, _hw(f), m.align_corners, None)
        y = run(getattr(m, f"fuse{i}"), spatial.cat(
            [y, run(getattr(m, f"low_proj{i}"), f, ctx)]), ctx)
    return _cls_seg(m, y, ctx)


@_sharded(SplitAttentionConv)
def _split_attention(m: SplitAttentionConv, x: Rows, ctx) -> Rows:
    y = _relu_of(m.bn0, run(m.conv, x, ctx), ctx)
    r, c = m.radix, m.channels

    def splits(b):                    # NHWC's (..., r, c) channels
        return b.reshape(b.shape[0], r, c, b.shape[2], b.shape[3])

    gap = _global_mean(y.map(lambda b: splits(b).sum(dim=1)), ctx)
    atten = m.fc2(m.fc1(gap))
    atten = torch.softmax(atten.reshape(atten.shape[0], r, c, 1, 1), dim=1)
    return y.map(lambda b: (splits(b) * to(atten, b.device)).sum(dim=1))


@_sharded(ResNeStBottleneck)
def _resnest_bottleneck(m: ResNeStBottleneck, x: Rows, ctx) -> Rows:
    out = _relu_of(m.bn1, run(m.conv1, x, ctx), ctx)
    if m.pool_first:
        out = spatial.avg_pool2d(out, 3, m.stride, 1)
    out = run(m.bn3, run(m.conv3, run(m.conv2, out, ctx), ctx), ctx)
    identity = x
    if m.downsample_conv is not None:
        if m.stride > 1:              # the avg-down shortcut
            identity = spatial.avg_pool2d(identity, m.stride, m.stride)
        identity = run(m.downsample_bn, run(m.downsample_conv, identity,
                                            ctx), ctx)
    return (out + identity).map(F.relu)


@_sharded(ResNeSt)
def _resnest(m: ResNeSt, x: Rows, ctx) -> List[Rows]:
    x = run(m.stem2, run(m.stem1, run(m.stem0, x, ctx), ctx), ctx)
    x = spatial.max_pool2d(x, 3, 2, 1)
    outs = []
    for i in range(m.num_stages):
        for j in range(m.stage_blocks[i]):
            x = run(getattr(m, f"layer{i + 1}_{j}"), x, ctx)
        if i in m.out_indices:
            outs.append(x)
    return outs


@_sharded(HRModule)
def _hr_module(m: HRModule, xs, ctx) -> List[Rows]:
    outs = []
    for b in range(m.num_branches):
        x = xs[b]
        for j in range(m.num_blocks):
            x = run(getattr(m, f"branch{b}_block{j}"), x, ctx)
        outs.append(x)
    fused = []
    for i in range(m.num_branches):
        acc = outs[i]
        for j in range(m.num_branches):
            if j == i:
                continue
            y = outs[j]
            if j > i:
                # the coarser branch's rows resized onto this one's shards
                y = run(getattr(m, f"fuse{i}_{j}_bn"), run(
                    getattr(m, f"fuse{i}_{j}_conv"), y, ctx), ctx)
                y = _resize_like(y, _hw(acc), False, None)
            else:
                for k in range(i - j):
                    y = run(getattr(m, f"fuse{i}_{j}_down{k}_bn"), run(
                        getattr(m, f"fuse{i}_{j}_down{k}"), y, ctx), ctx)
                    if k < i - j - 1:
                        y = y.map(F.relu)
            acc = acc + y
        fused.append(acc.map(F.relu))
    return fused


@_sharded(HRNet)
def _hrnet(m: HRNet, x: Rows, ctx) -> List[Rows]:
    x = run(m.stem1, run(m.stem0, x, ctx), ctx)
    for j in range(4):
        x = run(getattr(m, f"layer1_{j}"), x, ctx)
    xs = [run(m.trans1_0, x, ctx), run(m.trans1_1, x, ctx)]
    for stage, n_modules in enumerate(m.stage_modules[1:], start=2):
        for i in range(n_modules):
            xs = run(getattr(m, f"stage{stage}_m{i}"), xs, ctx)
        if stage < 4:
            xs = list(xs) + [run(getattr(m, f"trans{stage}"), xs[-1], ctx)]
    return list(xs)


@_sharded(DoubleConv)
def _double_conv(m: DoubleConv, x: Rows, ctx) -> Rows:
    return run(m.conv1, run(m.conv0, x, ctx), ctx)


@_sharded(UNet)
def _unet(m: UNet, x: Rows, ctx) -> List[Rows]:
    skips = []
    for i in range(m.num_stages):
        if i > 0:
            # a 2x2 window counts from the map's row 0, whichever shard
            # holds its rows
            x = spatial.max_pool2d(x, 2, 2, 0)
        x = run(getattr(m, f"enc{i}"), x, ctx)
        skips.append(x)
    outs = [skips[-1]]
    for i in range(m.num_stages - 2, -1, -1):
        x = _resize_like(x, _hw(skips[i]), False, None)
        x = run(getattr(m, f"dec{i}"), spatial.cat([skips[i], x]), ctx)
        outs.append(x)
    return outs[::-1]


@_sharded(_DSConv)
def _ds_conv(m: _DSConv, x: Rows, ctx) -> Rows:
    return run(m.pw, _relu_of(m.dw_bn, run(m.dw, x, ctx), ctx), ctx)


@_sharded(SepConvModule)
def _sep_conv(m: SepConvModule, x: Rows, ctx) -> Rows:
    return run(m.pointwise, _relu_of(m.dw_bn, run(m.depthwise, x, ctx),
                                     ctx), ctx)


@_sharded(FastSCNN)
def _fast_scnn(m: FastSCNN, x: Rows, ctx) -> List[Rows]:
    ac = m.align_corners
    higher = run(m.ltd_ds1, run(m.ltd_ds0, run(m.ltd_conv, x, ctx), ctx),
                 ctx)
    y = higher
    for i in range(m.n_stages):
        for j in range(3):
            y = run(getattr(m, f"gfe{i}_{j}"), y, ctx)
    ppm = [y] + [_resize_like(_pooled(getattr(m, f"ppm{i}"), y, s, ctx),
                              _hw(y), ac, y.devices)
                 for i, s in enumerate(m.pool_scales)]
    lower = run(m.ppm_bottleneck, spatial.cat(ppm), ctx)
    up = _resize_like(lower, _hw(higher), ac, None)
    up = _relu_of(m.ffm_dw_bn, run(m.ffm_dw, up, ctx), ctx)
    up = run(m.ffm_low_proj, up, ctx)
    fusion = (up + run(m.ffm_high_proj, higher, ctx)).map(F.relu)
    return [higher, lower, fusion]


@_sharded(DepthwiseSeparableFCNHead)
def _sep_fcn_head(m: DepthwiseSeparableFCNHead, inputs, ctx) -> Rows:
    x = inputs[m.in_index]
    y = x
    for i in range(m.num_convs):
        y = run(getattr(m, f"sep{i}"), y, ctx)
    if m.conv_cat is not None:
        y = run(m.conv_cat, spatial.cat([x, y]), ctx)
    return _cls_seg(m, y, ctx)


@_sharded(TIMMBackbone)
def _timm(m: TIMMBackbone, x: Rows, ctx):
    return run(m.model, x, ctx)
