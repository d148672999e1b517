"""The row-sharded forms (``models.sharded``) of the zoo's light CNNs.
First half: the backbones ``MobileNetV2`` (``InvertedResidual``),
``MobileNetV3`` (``MBV3Block``, ``SELayer``), ``ResNeSt``
(``ResNeStBottleneck``, ``SplitAttentionConv``), ``HRNet``
(``HRModule``), ``UNet`` (``DoubleConv``), ``FastSCNN`` (``_DSConv``)
and ``TIMMBackbone`` (the zoo backbone it stands for), and the heads
``LRASPPHead`` and ``DepthwiseSeparableFCNHead`` (``SepConvModule``).
Second half, the two-path real-time nets: ``BiSeNetV1`` and
``STDCContextPathNet`` (their shared context fusion, ``_ARM``),
``STDCNet`` (``STDCModule``) with ``STDCHead``, ``BiSeNetV2``
(``_GELayer``), ``CGNet`` (``ContextGuidedBlock``, ``layers.PReLU``),
``ERFNet`` (``_Downsampler``, ``_NonBottleneck1d``), and ``ICNet`` with
the neck ``ICNeck``.  Registered through ``sharded._sharded``;
``models.sharded`` imports this module.

Their depthwise, grouped, strided and dilated convolutions and their max
and average pools take their halo rows from the shards that hold them
(``spatial.conv2d``, ``spatial.max_pool2d``, ``spatial.avg_pool2d``;
zeros above and below the whole map count in an average, as flax's
``nn.avg_pool`` counts them).  A stride counts from the map's row 0
whichever shard holds it, so the halves of a strided concatenation
(ERFNet's downsampler, STDC's stride-2 module, BiSeNetV2's stride-2
layer and its shortcut) line up on shards that start on an odd row.  The
gates (MobileNetV3's squeeze-excitation, ResNeSt's split attention,
LR-ASPP's image pool, BiSeNet's and STDC's attention refinement and
fusion, BiSeNetV2's context embedding, CGNet's global context) are
computed once, on the model's device, from the global mean (each
shard's partial sum; LR-ASPP's through ``spatial.adaptive_avg_pool(x,
1)``, as its unsharded head pools), their batch norms over that (B, C,
1, 1) mean, and each shard multiplies or adds its rows by them.
HRNet's branches, UNet's decoder, the context paths, BiSeNetV2's guided
aggregation, CGNet's input injection, ERFNet's decoder and ICNet's
branches and neck resize a map's rows onto another map's shards
(``spatial.resize``, split by the same ``row_ranges`` as the target
map's), and Fast-SCNN's and ICNet's pyramid pools are global, as
PSPHead's.  A size the unsharded module reads (ERFNet's even sides,
ICNet's halved input) is the whole map's (``Rows.height``), never a
shard's.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from ..core import spatial
from ..core.spatial import Rows, to
from .backbones_zoo import (CGNet, ERFNet, ICNet, BiSeNetV1, BiSeNetV2,
                            ContextGuidedBlock, FastSCNN, MBV3Block,
                            MobileNetV3, ResNeSt, ResNeStBottleneck, SELayer,
                            SplitAttentionConv, STDCContextPathNet,
                            STDCModule, STDCNet, _ARM, _ContextFusion,
                            _Downsampler, _DSConv, _GELayer,
                            _NonBottleneck1d)
from .heads_zoo import (DepthwiseSeparableFCNHead, LRASPPHead, SepConvModule,
                        STDCHead)
from .hrnet import HRModule, HRNet
from .layers import PReLU, hsigmoid, relu6
from .mobilenet import InvertedResidual, MobileNetV2
from .necks import ICNeck, _CascadeFeatureFusion
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


def _plus(x: Rows, term: torch.Tensor) -> Rows:
    """Each shard's rows plus the global (B, C, 1, 1) ``term``."""
    return x.map(lambda b: b + to(term, b.device))


def _times(x: Rows, y: Rows) -> Rows:
    """Two maps of one height multiplied, block by block."""
    return Rows([a * b for a, b in zip(x.blocks, y.blocks)], x.height)


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


# ---- the two-path real-time nets (3c's second half) --------------------

@_sharded(PReLU)
def _prelu(m: PReLU, x: Rows, ctx) -> Rows:
    return x.map(lambda b: torch.where(
        b >= 0, b, to(m.negative_slope, b.device).to(b.dtype) * b))


@_sharded(_ARM)
def _arm(m: _ARM, x: Rows, ctx) -> Rows:
    y = run(m.conv, x, ctx)
    return _gated(y, torch.sigmoid(m.gate(_global_mean(y, ctx))))


def _fuse(m: _ContextFusion, fine: Rows, c16: Rows, c32: Rows, ctx):
    """``_ContextFusion.fuse``: each coarser map resized onto the finer
    one's shards, the gates from global means."""
    ac = m.align_corners
    gap = m.gap_conv(_global_mean(c32, ctx))
    a32 = _resize_like(_plus(run(m.arm32, c32, ctx), gap), _hw(c16), ac,
                       None)
    a32 = run(m.refine32, a32, ctx)
    a16 = _resize_like(run(m.arm16, c16, ctx) + a32, _hw(fine), ac, None)
    a16 = run(m.refine16, a16, ctx)
    fused = run(m.ffm_conv, spatial.cat([fine, a16]), ctx)
    g = torch.sigmoid(m.ffm_fc2(F.relu(m.ffm_fc1(_global_mean(fused,
                                                              ctx)))))
    return fused + _gated(fused, g), a16, a32


@_sharded(BiSeNetV1)
def _bisenet_v1(m: BiSeNetV1, x: Rows, ctx):
    sp = x
    for i in range(m.n_spatial):
        sp = run(getattr(m, f"spatial{i}"), sp, ctx)
    feats = run(m.context_backbone, x, ctx)
    return _fuse(m, sp, feats[-2], feats[-1], ctx)


@_sharded(STDCModule)
def _stdc_module(m: STDCModule, x: Rows, ctx) -> Rows:
    y = run(m.conv0, x, ctx)
    if m.stride == 2:
        outs = [spatial.avg_pool2d(y, 3, 2, 1)]
        y = run(m.downsample, y, ctx)
    else:
        outs = [y]
    for i in range(1, m.num_convs):
        y = run(getattr(m, f"conv{i}"), y, ctx)
        outs.append(y)
    return spatial.cat(outs)


@_sharded(STDCNet)
def _stdc_net(m: STDCNet, x: Rows, ctx):
    outs = []
    for i in range(2):
        x = run(getattr(m, f"stem{i}"), x, ctx)
        if i in m.out_indices:
            outs.append(x)
    for s in range(3):
        for j in range(m.num_modules[s]):
            x = run(getattr(m, f"stage{s + 2}_{j}"), x, ctx)
        if s + 2 in m.out_indices:
            outs.append(x)
    return tuple(outs)


@_sharded(STDCContextPathNet)
def _stdc_context(m: STDCContextPathNet, x: Rows, ctx):
    feats = run(m.backbone, x, ctx)
    f8 = feats[-3]
    return _fuse(m, f8, feats[-2], feats[-1], ctx) + (f8,)


@_sharded(STDCHead)
def _stdc_head(m: STDCHead, inputs, ctx) -> Rows:
    return _cls_seg(m, run(m.conv0, inputs[m.in_index], ctx), ctx)


@_sharded(_GELayer)
def _ge_layer(m: _GELayer, x: Rows, ctx) -> Rows:
    y = run(m.dw1_bn, run(m.dw1, run(m.conv1, x, ctx), ctx), ctx)
    if m.stride == 2:
        y = run(m.dw2_bn, run(m.dw2, y.map(F.relu), ctx), ctx)
    y = run(m.project_bn, run(m.project, y.map(F.relu), ctx), ctx)
    if m.stride == 2:
        x = run(m.short_dw_bn, run(m.short_dw, x, ctx), ctx)
        x = run(m.short_pw_bn, run(m.short_pw, x, ctx), ctx)
    return (y + x).map(F.relu)


@_sharded(BiSeNetV2)
def _bisenet_v2(m: BiSeNetV2, x: Rows, ctx):
    ac = m.align_corners
    d = x
    for i in range(m.n_detail):
        d = run(getattr(m, f"detail{i}_conv"), run(
            getattr(m, f"detail{i}_down"), d, ctx), ctx)
    s = run(m.stem_conv, x, ctx)
    left = run(m.stem_l1, run(m.stem_l0, s, ctx), ctx)
    s = run(m.stem_fuse, spatial.cat([left, spatial.max_pool2d(s, 3, 2, 1)]),
            ctx)
    stem_out = s
    taps = []
    for i, n_blocks in enumerate(m.stages):
        for j in range(n_blocks):
            s = run(getattr(m, f"ge{i}_{j}"), s, ctx)
        taps.append(s)
    # the context embedding: the global mean's projection on every shard
    s = run(m.ce_out, _plus(s, m.ce_conv(m.ce_bn(_global_mean(s, ctx)))),
            ctx)
    d_dw = run(m.bga_d_pw, run(m.bga_d_bn, run(m.bga_d_dw, d, ctx), ctx),
               ctx)
    d_down = spatial.avg_pool2d(run(m.bga_d_down, d, ctx), 3, 2, 1)
    s_up = _resize_like(run(m.bga_s_conv, s, ctx), _hw(d), ac, None)
    s_dw = run(m.bga_s_pw, run(m.bga_s_bn, run(m.bga_s_dw, s, ctx), ctx),
               ctx)
    left = _times(d_dw, s_up.map(torch.sigmoid))
    right = _resize_like(_times(d_down, s_dw.map(torch.sigmoid)), _hw(d), ac,
                         None)
    return (run(m.bga_out, left + right, ctx), stem_out) + tuple(taps)


@_sharded(ContextGuidedBlock)
def _cg_block(m: ContextGuidedBlock, x: Rows, ctx) -> Rows:
    y = run(m.conv1x1, x, ctx)
    joi = spatial.cat([run(m.f_loc, y, ctx), run(m.f_sur, y, ctx)])
    joi = run(m.activate, run(m.bn, joi, ctx), ctx)
    if m.downsample:
        joi = run(m.bottleneck, joi, ctx)
    mean = _global_mean(joi, ctx).flatten(1)
    g = torch.sigmoid(m.fc2(F.relu(m.fc1(mean))))
    joi = _gated(joi, g[:, :, None, None])
    return joi + x if m.residual else joi


@_sharded(CGNet)
def _cgnet(m: CGNet, x: Rows, ctx):
    y = x
    for i in range(3):
        y = run(getattr(m, f"stem{i}"), y, ctx)
    inj1 = spatial.avg_pool2d(x, 3, 2, 1)
    y = spatial.cat([y, inj1])
    outs = [y]
    for s in range(2):
        down = None
        for j in range(m.num_blocks[s]):
            y = run(getattr(m, f"level{s + 1}_{j}"), y, ctx)
            if j == 0:
                down = y
        cat = [y, down]
        if s == 0:
            cat.append(_resize_like(inj1, _hw(y), False, None))
        y = spatial.cat(cat)
        outs.append(y)
    return tuple(outs)


@_sharded(_Downsampler)
def _downsampler(m: _Downsampler, x: Rows, ctx) -> Rows:
    hw = _hw(x)
    if hw[0] % 2 or hw[1] % 2:
        raise ValueError(f"ERFNet's downsampler needs even sides, got {hw}: "
                         "its conv and max pool halves would differ in size")
    y = spatial.cat([run(m.conv, x, ctx), spatial.max_pool2d(x, 2, 2, 0)])
    return _relu_of(m.bn, y, ctx)


@_sharded(_NonBottleneck1d)
def _non_bottleneck(m: _NonBottleneck1d, x: Rows, ctx) -> Rows:
    y = run(m.conv1x3_1, run(m.conv3x1_1, x, ctx).map(F.relu), ctx)
    y = _relu_of(m.bn1, y, ctx)
    y = run(m.conv1x3_2, run(m.conv3x1_2, y, ctx).map(F.relu), ctx)
    return (run(m.bn2, y, ctx) + x).map(F.relu)


@_sharded(ERFNet)
def _erfnet(m: ERFNet, x: Rows, ctx):
    y = run(m.down1, run(m.down0, x, ctx), ctx)
    for i in range(m.enc[0]):
        y = run(getattr(m, f"enc1_{i}"), y, ctx)
    y = run(m.down2, y, ctx)
    for i in range(m.enc[1]):
        y = run(getattr(m, f"enc2_{i}"), y, ctx)
    for s, n in enumerate(m.dec):
        y = _resize_like(y, (y.height * 2, y.shape[3] * 2), False, None)
        y = run(getattr(m, f"up{s}"), y, ctx)
        for i in range(n):
            y = run(getattr(m, f"dec{s}_{i}"), y, ctx)
    return (y,)


@_sharded(ICNet)
def _icnet(m: ICNet, x: Rows, ctx):
    ac = m.align_corners
    sub1 = x
    for i in range(3):
        sub1 = run(getattr(m, f"sub1_{i}"), sub1, ctx)
    h, w = _hw(x)
    z = _resize_like(x, (h // 2, w // 2), ac, None)
    z = run(m.stem2, run(m.stem1, run(m.stem0, z, ctx), ctx), ctx)
    z = spatial.max_pool2d(z, 3, 2, 1)
    for i in (0, 1):
        for j in range(m.depth_blocks[i]):
            z = run(getattr(m, f"layer{i + 1}_{j}"), z, ctx)
    sub2 = run(m.sub2_proj, z, ctx)
    q = _resize_like(z, (max(z.height // 2, 1), max(z.shape[3] // 2, 1)), ac,
                     None)
    for i in (2, 3):
        for j in range(m.depth_blocks[i]):
            q = run(getattr(m, f"layer{i + 1}_{j}"), q, ctx)
    # the pyramid pool: global bins on the model's device, resized onto
    # q's shards
    ppm = [q] + [_resize_like(spatial.adaptive_avg_pool(q, s, ctx.home),
                              _hw(q), ac, q.devices)
                 for s in m.pool_scales]
    sub4 = run(m.sub4_proj, run(m.psp_bottleneck, spatial.cat(ppm), ctx),
               ctx)
    return sub1, sub2, sub4


def _cff(m: _CascadeFeatureFusion, low: Rows, high: Rows, ctx) -> Rows:
    """``_CascadeFeatureFusion``: the low branch resized onto the high
    one's shards."""
    low = _resize_like(low, _hw(high), m.align_corners, None)
    return (run(m.conv_low, low, ctx) + run(m.conv_high, high, ctx)).map(
        F.relu)


@_sharded(ICNeck)
def _icneck(m: ICNeck, inputs, ctx):
    sub1, sub2, sub4 = inputs[-3], inputs[-2], inputs[-1]
    cff42 = _cff(m.cff42, sub4, sub2, ctx)
    cff21 = _cff(m.cff21, cff42, sub1, ctx)
    return (cff42, cff21, _resize_like(
        cff21, (cff21.height * 2, cff21.shape[3] * 2), m.align_corners,
        None))
