"""The forward of a segmentor with the map's height sharded over devices
(``core.spatial``): the mesh's ``spatial`` axis for PEANUT's PSPNet, the
dry run's and the model zoo's ResNet families, hierarchical transformers,
plain-ViT families (``sharded_vit``) and light CNNs (``sharded_light``),
whole-map inference and the train forward alike.

``forward_rows(model, x)`` runs an ``EncoderDecoder`` (or a cascade) over
a ``Rows`` map with the same parameters and buffers as ``model(x)``: each
module of the model runs over the row blocks through its sharded form
below, a map made global by a pooling (PSPHead's pyramid) through the
module's own forward on the model's device.  The result equals the
unsharded forward in exact arithmetic:

* convolutions and the stem's max pool take their halo rows from the
  shards that hold them (``spatial.conv2d``, ``spatial.max_pool2d``);
  flax's "SAME" padding (``layers.SameConv2d``) is split from the whole
  map's height (``spatial.conv2d_same``);
* train-mode batch norms add each shard's sums of x and x^2 and its
  count, then all-reduce them over the data group where there is one
  (``layers.BatchNorm.moments``), and move the running statistics once
  a step from the global mean and variance;
* the heads' dropout draws the global map's mask (``spatial.dropout``);
* ``remat`` recomputes a residual block over all its shards, halos
  included, under one checkpoint (a block's batch norms need every
  shard's statistics);
* the logits are resized to the input's rows shard by shard
  (``spatial.resize``);
* slide inference (``slide_rows``) sums each window's logits into the
  rows each shard holds, in the unsharded loop's order.

Only what GSPMD would also exchange crosses the shards: halo rows, global
pools and what is computed from them (a pooled branch, region tokens,
dynamic filters, a gate), partial sums over the pixels (a codebook's
aggregation, CAM's energy, EMA's bases, the means of DNL's whitening,
OCR's class centroids, K-Net's group features, PSA's distribution), a
softmax over all pixels as a partial log-sum-exp (GC's and DNL's unary
pooling, OCR's soft regions), the keys and values of whole-map
attention, which each shard reads for its own query rows only (PAM,
NonLocal, DNL, CC's columns, ISA's row classes, PSA's collection; MiT's
and Twins' keys and values of the map reduced by a strided convolution,
each shard reducing and projecting its own rows; the plain ViTs'
global attention, each shard projecting its own tokens), the rows of a window
band that straddles a shard's edge, which each shard that outputs rows
of it computes (ISA's local stage, Twins-SVT's windows, Swin's windows,
whose shifted blocks' last band wraps onto the map's first rows), and
PointRend's cells (each shard's most uncertain, merged; each point's
corners from the shards that hold their rows).  A global vector goes
through its module's own forward on the model's device (``nn.Linear``,
``nn.LayerNorm``, EncHead's ``enc_bn``, K-Net's kernel update, the point
head's MLP); global sums are taken in float32 or wider.  Every
``nn.Linear`` and ``nn.Conv2d`` of a backbone runs on a shard's rows
with their halo or bands; no head gathers a full-height map.

Sharded forms exist for ``nn.Conv2d``, ``layers.Conv2d``,
``layers.SameConv2d``, ``ConvModule``, ``BatchNorm``, ``nn.ReLU``,
``nn.Sequential``, ``ZooBottleneck``, ``BasicBlock``, ``ZooResNet`` /
``ResNetV1c`` / ``ResNeXt``, the hierarchical transformers ``ConvNeXt``
(``ConvNeXtBlock``), ``SwinTransformer`` (``SwinBlock``),
``MixVisionTransformer`` / ``MITB0`` / ``MITB2`` (``MiTBlock``,
``EfficientAttention``, ``MixFFN``) and ``PCPVT`` / ``SVT``
(``_TwinsBlock``, ``_SRAttention``, ``_LocalAttention``),
``AdaptiveAvgPool``, the necks ``FPN`` (a segmentor's, P6 included) and
``JPU``, the heads ``PSPHead``, ``FCNHead``, ``UPerHead``, ``ASPPHead``,
``DepthwiseSeparableASPPHead``, ``FPNHead``, ``SegFormerHead``,
``APCHead``, ``DMHead``, ``EncHead`` (its ``Encoding`` runs on each
shard's block), ``ANNHead``, ``GCHead``, ``EMAHead``, ``DAHead`` with
``PAM`` and ``CAM``, ``NLHead``, ``DNLHead``, ``CCHead``, ``ISAHead``,
``PSAHead`` (its masks bound by the whole map's size), ``OCRHead``,
K-Net's ``IterativeDecodeHead`` and ``PointHead`` (the subdivision and
the training pass), and the segmentors ``EncoderDecoder`` and
``CascadeEncoderDecoder``: every family of the zoo over its ResNets, and
ConvNeXt, Swin, SegFormer and Twins; ``sharded_vit`` adds the plain-ViT
families' types (``VisionTransformer``, ``MAE``, ``BEiT``, their blocks,
the necks ``MLANeck``, ``MultiLevelNeck`` and ``Feature2Pyramid``, the
heads ``SETRUPHead``, ``SETRMLAHead``, ``DPTHead`` and
``SegmenterMaskTransformerHead``); ``sharded_light`` adds the light
CNNs (``MobileNetV2``, ``MobileNetV3``, ``ResNeSt``, ``HRNet``,
``UNet``, ``FastSCNN``, ``TIMMBackbone``, the two-path real-time nets
``BiSeNetV1``, ``BiSeNetV2``, ``STDCNet`` / ``STDCContextPathNet``,
``CGNet``, ``ERFNet`` and ``ICNet``, their blocks and ``layers.PReLU``,
the heads ``LRASPPHead``, ``DepthwiseSeparableFCNHead`` and
``STDCHead``, the neck ``ICNeck``): every type of the port's registries.
``nn.Conv2d`` takes every padding torch accepts: an int or a pair with
zeros, "same" and "valid", and the reflect, replicate and circular modes,
whose rows above and below the map come from the whole map's rows
(``spatial.conv2d``).  ``slide_rows`` is ``slide_inference`` over a
row-sharded map: each window fetched from the shards that hold its rows
and run through ``forward_rows``.  Any other module type, and an FPN
with a bottom-up backbone (Mask R-CNN's), raise NotImplementedError
naming it.  Nothing falls back to the unsharded model.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .. import upload
from ..core import spatial
from ..core.mesh import row_ranges
from ..core.spatial import Rows, to
from .backbones_zoo import (PCPVT, SVT, _LocalAttention, _SRAttention,
                            _TwinsBlock)
from .boxes import top_k
from .cascade import CascadeEncoderDecoder
from .convnext import ConvNeXt, ConvNeXtBlock
from .encoder_decoder import EncoderDecoder
from .fpn import FPN
from .heads import (AdaptiveAvgPool, ASPPHead, DepthwiseSeparableASPPHead,
                    FCNHead, OCRHead, PSPHead, SegFormerHead, UPerHead,
                    tokens, untokens)
from .heads_attention import CAM, DAHead, GCHead, NLHead, PAM
from .heads_zoo import (ANNHead, APCHead, CCHead, DMHead, DNLHead, EMAHead,
                        EncHead, FPNHead, ISAHead, PointHead, PSAHead,
                        _attend, _bn_last, _l2norm, _psa_index,
                        bilinear_points)
from .knet import IterativeDecodeHead
from .layers import (BatchNorm, Conv2d, ConvModule, SameConv2d, attend,
                     gelu, heads_merge, heads_split, remat)
from .mit import (MITB0, MITB2, EfficientAttention, MiTBlock, MixFFN,
                  MixVisionTransformer)
from .necks import JPU
from .resnet import BasicBlock, ResNetV1c, ResNeXt, ZooBottleneck, ZooResNet
from .vit import (SwinBlock, SwinTransformer, _shift_attn_mask,
                  _window_partition, _window_reverse)

@dataclasses.dataclass
class _Context:
    home: torch.device              # the model's device: global maps
    generator: Optional[object]     # the heads' dropout stream
    trace: Optional[dict] = None    # what the heads decided (forward_rows)


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
            f"{type(m).__name__} has no row-sharded forward (every module "
            "type of the port's registries has one)")
    return fn(m, x, ctx)


def _sum_on(parts, device) -> torch.Tensor:
    total = None
    for p in parts:
        p = to(p, device)
        total = p if total is None else total + p
    return total


def _sum_wide(parts, device, dtype: torch.dtype) -> torch.Tensor:
    """The shards' partial sums added on ``device`` in float32 or wider,
    returned in ``dtype``."""
    wide = torch.promote_types(dtype, torch.float32)
    return _sum_on((p.to(wide) for p in parts), device).to(dtype)


def _hw(x: Rows):
    return (x.height, x.shape[3])


@_sharded(nn.Conv2d)
def _conv(m: nn.Conv2d, x: Rows, ctx) -> Rows:
    return spatial.conv2d(x, m.weight, m.bias, m.stride, m.padding,
                          m.dilation, m.groups, m.padding_mode)


@_sharded(SameConv2d)
def _same_conv(m: SameConv2d, x: Rows, ctx) -> Rows:
    return spatial.conv2d_same(x, m.weight, m.bias, m.stride, m.dilation,
                               m.groups)


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
    """``heads.resize_like``: the resize back in x's type (``devices``:
    a global map's shards; a row-sharded map keeps its own)."""
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


# ---- the zoo's necks and convolutional heads -------------------------------

@_sharded(FPN)
def _fpn(m: FPN, feats, ctx) -> List[Rows]:
    if m.bottom_up is not None:
        raise NotImplementedError(
            "FPN with a bottom_up (Mask R-CNN's) has no row-sharded "
            "forward: the JAX package shards no detector's map")
    lat = [run(getattr(m, f"{m.prefix}lateral{lvl}"), f, ctx)
           for lvl, f in zip(m.levels, feats)]
    for i in range(len(lat) - 2, -1, -1):
        lat[i] = lat[i] + spatial.upsample_nearest2(lat[i + 1], _hw(lat[i]))
    outs = [run(getattr(m, f"{m.prefix}output{lvl}"), t, ctx)
            for lvl, t in zip(m.levels, lat)]
    if m.add_p6_pool:
        # P5's even global rows and columns: the pool's stride counts
        # from the map's row 0, whichever shard holds it
        outs.append(spatial.max_pool2d(outs[-1], 1, 2, 0))
    return outs


@_sharded(JPU)
def _jpu(m: JPU, inputs, ctx) -> List[Rows]:
    feats = list(inputs[m.start_level:])
    convs = [run(getattr(m, f"conv{i}"), f, ctx) for i, f in enumerate(feats)]
    hw = _hw(convs[0])
    cat = spatial.cat([_resize_like(c, hw, m.align_corners, None)
                       for c in convs])
    outs = [run(getattr(m, f"dil{i}_pw"), _relu_of(
        getattr(m, f"dil{i}_bn"), run(getattr(m, f"dil{i}_dw"), cat, ctx),
        ctx), ctx) for i in range(len(m.dilations))]
    return list(inputs[:m.start_level + 1]) + feats[1:-1] + [spatial.cat(outs)]


def _pooled(m: nn.Module, x: Rows, size, ctx) -> torch.Tensor:
    """``m`` (its own forward) on x's global adaptive pool at ``size``."""
    return run(m, spatial.adaptive_avg_pool(x, size, ctx.home), ctx)


@_sharded(UPerHead)
def _uper_head(m: UPerHead, inputs, ctx) -> Rows:
    feats = [inputs[i] for i in m.in_index]
    top = feats[-1]
    ppm = [top] + [_resize_like(_pooled(getattr(m, f"ppm{i}"), top, s, ctx),
                                _hw(top), m.align_corners, top.devices)
                   for i, s in enumerate(m.pool_scales)]
    lat = [run(getattr(m, f"lateral{i}"), f, ctx)
           for i, f in enumerate(feats[:-1])]
    lat.append(run(m.ppm_bottleneck, spatial.cat(ppm), ctx))
    for i in range(len(lat) - 2, -1, -1):
        # the coarser level's rows, wherever they lie, onto this level's
        lat[i] = lat[i] + _resize_like(lat[i + 1], _hw(lat[i]),
                                       m.align_corners, None)
    outs = [run(getattr(m, f"fpn_conv{i}"), lat[i], ctx)
            for i in range(len(lat) - 1)] + [lat[-1]]
    hw0 = _hw(outs[0])
    fused = spatial.cat([_resize_like(f, hw0, m.align_corners, None)
                         for f in outs])
    return _cls_seg(m, run(m.fpn_bottleneck, fused, ctx), ctx)


def _aspp(m, x: Rows, ctx) -> Rows:
    img = _resize_like(_pooled(m.image_pool_conv, x, 1, ctx), _hw(x),
                       m.align_corners, x.devices)
    outs = [img] + [run(getattr(m, f"aspp{i}"), x, ctx)
                    for i in range(m.n_aspp)]
    return run(m.bottleneck, spatial.cat(outs), ctx)


@_sharded(ASPPHead)
def _aspp_head(m: ASPPHead, inputs, ctx) -> Rows:
    return _cls_seg(m, _aspp(m, inputs[m.in_index], ctx), ctx)


@_sharded(DepthwiseSeparableASPPHead)
def _sep_aspp_head(m: DepthwiseSeparableASPPHead, inputs, ctx) -> Rows:
    feats = _aspp(m, inputs[m.in_index], ctx)
    c1 = run(m.c1_bottleneck, inputs[m.c1_index], ctx)
    feats = spatial.cat([_resize_like(feats, _hw(c1), m.align_corners, None),
                         c1])
    return _cls_seg(m, run(m.sep_conv1, run(m.sep_conv0, feats, ctx), ctx),
                    ctx)


@_sharded(FPNHead)
def _fpn_head(m: FPNHead, inputs, ctx) -> Rows:
    feats = [inputs[i] for i in m.in_index]
    h0, w0 = _hw(feats[0])
    out = None
    for i, f in enumerate(feats):
        up = m.feature_strides[i] != m.feature_strides[0]
        y = f
        for j in range(m.n_convs[i]):
            y = run(getattr(m, f"scale{i}_conv{j}"), y, ctx)
            if up:
                y = _resize_like(y, (min(y.height * 2, h0),
                                     min(y.shape[3] * 2, w0)),
                                 m.align_corners, None)
        y = _resize_like(y, (h0, w0), m.align_corners, None)
        out = y if out is None else out + y
    return _cls_seg(m, out, ctx)


@_sharded(SegFormerHead)
def _segformer_head(m: SegFormerHead, inputs, ctx) -> Rows:
    feats = [inputs[i] for i in m.in_index]
    hw0 = _hw(feats[0])
    projected = [_resize_like(_pixelwise(f, functools.partial(
        _dense, getattr(m, f"linear{i}"))), hw0, m.align_corners, None)
        for i, f in enumerate(feats)]
    return _cls_seg(m, run(m.fuse, spatial.cat(projected), ctx), ctx)


# ---- the pooled-context heads: global pools and partial sums --------------

def _untokens_like(t: torch.Tensor, block: torch.Tensor) -> torch.Tensor:
    return untokens(t, block.shape[2], block.shape[3])


@_sharded(APCHead)
def _apc_head(m: APCHead, inputs, ctx) -> Rows:
    x = inputs[m.in_index]
    outs = []
    for i, s in enumerate(m.pool_scales):
        region = tokens(_pooled(getattr(m, f"acm{i}_pooled"), x, s, ctx))

        def affinity(b, region=region):
            r = to(region, b.device)
            aff = torch.softmax(torch.einsum("bnc,bmc->bnm", tokens(b), r),
                                dim=-1)
            return _untokens_like(torch.einsum("bnm,bmc->bnc", aff, r), b)

        z = run(getattr(m, f"acm{i}_input"), x, ctx).map(affinity)
        outs.append(run(getattr(m, f"acm{i}_out"), z, ctx))
    return _cls_seg(m, run(m.bottleneck, spatial.cat(outs + [x]), ctx), ctx)


@_sharded(DMHead)
def _dm_head(m: DMHead, inputs, ctx) -> Rows:
    x = inputs[m.in_index]
    b = x.shape[0]
    outs = []
    for i, k in enumerate(m.filter_sizes):
        filt = _pooled(getattr(m, f"dcm{i}_filter_gen"), x, k, ctx)
        xr = run(getattr(m, f"dcm{i}_input"), x, ctx)
        c = xr.shape[1]
        # the batch folded into the groups, as the unsharded head does:
        # each block's (1, B*C, h, W) view with its halo rows
        y = spatial.conv2d(
            xr.map(lambda t: t.reshape(1, b * c, t.shape[2], t.shape[3])),
            filt.reshape(b * c, 1, k, k), None, 1, (k - 1) // 2, 1, b * c)
        y = y.map(lambda t: t.reshape(b, c, t.shape[2], t.shape[3]))
        outs.append(_relu_of(getattr(m, f"dcm{i}_bn"), y, ctx))
    return _cls_seg(m, run(m.bottleneck, spatial.cat(outs + [x]), ctx), ctx)


@_sharded(EncHead)
def _enc_head(m: EncHead, inputs, ctx) -> Rows:
    feats = [inputs[i] for i in m.in_index]
    x = run(m.bottleneck, feats[-1], ctx)
    if m.add_lateral:
        lats = [_resize_like(run(getattr(m, f"lateral{i}"), f, ctx), _hw(x),
                             m.align_corners, None)
                for i, f in enumerate(feats[:-1])]
        x = run(m.fusion, spatial.cat([x] + lats), ctx)
    # the codewords' aggregation is a sum over the pixels: each shard's
    encoded = _sum_wide((m.encoding(blk) for blk in x.blocks), ctx.home,
                        x.dtype)
    enc = F.relu(_bn_last(m.enc_bn, encoded)).mean(dim=1)
    gamma = torch.sigmoid(m.fc(enc))
    return _cls_seg(m, x.map(
        lambda blk: blk * to(gamma, blk.device)[:, :, None, None]), ctx)


def _ppm_tokens(x: Rows, scales, ctx) -> torch.Tensor:
    """``heads_zoo._ppm_sample`` of a row-sharded map: global (B, M, C)."""
    return torch.cat([tokens(spatial.adaptive_avg_pool(x, s, ctx.home))
                      for s in scales], dim=1)


def _ann_block(m: ANNHead, prefix: str, q_in: Rows, kv_in: Rows,
               ctx) -> Rows:
    k = _ppm_tokens(run(getattr(m, f"{prefix}_key"), kv_in, ctx),
                    m.key_pool_scales, ctx)
    v = _ppm_tokens(run(getattr(m, f"{prefix}_value"), kv_in, ctx),
                    m.key_pool_scales, ctx)
    return run(getattr(m, f"{prefix}_query"), q_in, ctx).map(
        lambda b: _untokens_like(_attend(
            tokens(b), to(k, b.device), to(v, b.device),
            m.project_channels ** -0.5), b))


@_sharded(ANNHead)
def _ann_head(m: ANNHead, inputs, ctx) -> Rows:
    low, high = [inputs[i] for i in m.in_index]
    fused = spatial.cat([_ann_block(m, "afnb", high, low, ctx), high])
    feats = run(m.bottleneck, run(m.afnb_out, fused, ctx), ctx)
    out = spatial.cat([_ann_block(m, "apnb", feats, feats, ctx), feats])
    return _cls_seg(m, run(m.apnb_out, out, ctx), ctx)


def _softmax_pool(logits: Rows, values: Rows, ctx) -> torch.Tensor:
    """For each of K logit maps, the sum over all pixels n of
    softmax_n(logits) * values_n: (B, K, h, W) logits, (B, C, h, W)
    values -> (B, K, C) on the model's device, in the values' type.  The
    softmax over every shard's pixels as a partial log-sum-exp in float32
    or wider: the global max, then each shard's sum of exp(l - max) and
    of its weighted values."""
    dt = values.dtype
    wide = torch.promote_types(dt, torch.float32)
    parts = [(lb.flatten(2).to(wide), vb.flatten(2).to(wide))
             for lb, vb in zip(logits.blocks, values.blocks)
             if lb.shape[2] > 0]
    top = torch.stack([to(lb.amax(dim=2), ctx.home)
                       for lb, _ in parts]).amax(dim=0).detach()
    weights = [torch.exp(lb - to(top, lb.device)[..., None])
               for lb, _ in parts]
    norm = _sum_on([e.sum(dim=2) for e in weights], ctx.home)
    pooled = _sum_on([torch.einsum("bkn,bcn->bkc", e, vb)
                      for e, (_, vb) in zip(weights, parts)], ctx.home)
    return (pooled / norm[..., None]).to(dt)


def _dense(lin: nn.Linear, t: torch.Tensor) -> torch.Tensor:
    """``lin`` on a shard's tokens, its parameters read where they lie."""
    return F.linear(t, to(lin.weight, t.device), to(lin.bias, t.device))


@_sharded(GCHead)
def _gc_head(m: GCHead, inputs, ctx) -> Rows:
    feats = run(m.conv0, inputs[m.in_index], ctx)
    context = _softmax_pool(run(m.mask, feats, ctx), feats, ctx)[:, 0]
    t = m.up(F.relu(m.ln(m.down(context))))
    feats = feats.map(lambda b: b + to(t, b.device)[:, :, None, None])
    return _cls_seg(m, run(m.conv1, feats, ctx), ctx)


@_sharded(EMAHead)
def _ema_head(m: EMAHead, inputs, ctx) -> Rows:
    feats = run(m.ema_in_conv, inputs[m.in_index], ctx)
    pix = [tokens(b) for b in run(m.ema_mid_conv, feats, ctx).blocks]
    dt = feats.dtype
    mu = m.bases.expand(feats.shape[0], -1, -1)
    for _ in range(m.num_stages):
        z = [torch.softmax(torch.einsum("bnc,bkc->bnk", p,
                                        to(mu, p.device)), dim=-1)
             for p in pix]
        # z over its sum over all pixels, then the bases from the sum over
        # all pixels: two partial sums a stage
        norm = 1e-6 + _sum_wide((zi.sum(dim=1, keepdim=True) for zi in z),
                                ctx.home, dt)
        mu = _l2norm(_sum_wide(
            (torch.einsum("bnk,bnc->bkc", zi / to(norm, zi.device), p)
             for zi, p in zip(z, pix)), ctx.home, dt), -1)
    recon = []
    for p, blk in zip(pix, feats.blocks):
        mu_d = to(mu, p.device)
        r = torch.einsum("bnk,bkc->bnc", torch.softmax(
            torch.einsum("bnc,bkc->bnk", p, mu_d), dim=-1), mu_d)
        recon.append(F.relu(_untokens_like(r, blk)))
    recon = run(m.ema_out_conv, Rows(recon, feats.height), ctx)
    feats = (feats + recon).map(F.relu)
    return _cls_seg(m, run(m.bottleneck, feats, ctx), ctx)


@_sharded(CAM)
def _cam(m: CAM, x: Rows, ctx) -> Rows:
    energy = _sum_wide((torch.einsum("bcn,bdn->bcd", b.flatten(2),
                                     b.flatten(2)) for b in x.blocks),
                       ctx.home, x.dtype)
    attn = torch.softmax(energy.amax(dim=-1, keepdim=True) - energy, dim=-1)

    def out(b):
        a = to(attn, b.device)
        y = torch.einsum("bcd,bdn->bcn", a, b.flatten(2)).reshape(b.shape)
        return b + to(m.gamma, b.device) * y
    return x.map(out)


# ---- whole-map attention: each shard's queries, every row's keys ----------

def _all_rows(x: Rows, device, cache: dict) -> torch.Tensor:
    """x's tokens of every row on ``device``, (B, H*W, C) in the global
    row-major order, gathered once a device (shards that share a card
    share them)."""
    if device not in cache:
        cache[device] = tokens(spatial.fetch_rows(x, 0, x.height, device))
    return cache[device]


def _whole_map_attention(q: Rows, k: Rows, v: Rows, scale=None) -> Rows:
    """``heads_zoo._attend`` of each shard's query rows against the keys
    and values of all rows: an (h_i W) x (H W) attention a shard."""
    keys, values = {}, {}
    return q.map(lambda b: _untokens_like(_attend(
        tokens(b), _all_rows(k, b.device, keys),
        _all_rows(v, b.device, values), scale), b))


@_sharded(PAM)
def _pam(m: PAM, x: Rows, ctx) -> Rows:
    out = _whole_map_attention(*(run(c, x, ctx)
                                 for c in (m.query, m.key, m.value)))
    return x + out.map(lambda o: to(m.gamma, o.device) * o)


@_sharded(DAHead)
def _da_head(m: DAHead, inputs, ctx) -> Rows:
    x = inputs[m.in_index]
    pam = run(m.pam_out, run(m.pam, run(m.pam_in, x, ctx), ctx), ctx)
    cam = run(m.cam_out, run(m.cam, run(m.cam_in, x, ctx), ctx), ctx)
    return _cls_seg(m, pam + cam, ctx)


@_sharded(NLHead)
def _nl_head(m: NLHead, inputs, ctx) -> Rows:
    feats = run(m.conv0, inputs[m.in_index], ctx)
    y = _whole_map_attention(*(run(c, feats, ctx)
                               for c in (m.theta, m.phi, m.g)))
    feats = feats + run(m.out_proj, y, ctx)
    return _cls_seg(m, run(m.conv1, feats, ctx), ctx)


def _centred(x: Rows, ctx) -> Rows:
    """x less its mean over all pixels (a partial sum a shard)."""
    n = x.height * x.shape[3]
    mean = _sum_wide((b.sum(dim=(2, 3)) for b in x.blocks), ctx.home,
                     x.dtype) / n
    return x.map(lambda b: b - to(mean, b.device)[:, :, None, None])


@_sharded(DNLHead)
def _dnl_head(m: DNLHead, inputs, ctx) -> Rows:
    feats = run(m.conv0, inputs[m.in_index], ctx)
    theta, phi, g = (run(c, feats, ctx) for c in (m.theta, m.phi, m.g))
    pairwise = _whole_map_attention(_centred(theta, ctx), _centred(phi, ctx),
                                    g, 1.0 / m.temperature)
    unary = _softmax_pool(run(m.unary, feats, ctx), g, ctx)[:, 0]
    y = pairwise.map(lambda b: b + to(unary, b.device)[:, :, None, None])
    y = run(m.conv_out, y, ctx)
    return _cls_seg(m, run(m.conv1, feats + y, ctx), ctx)


@_sharded(CCHead)
def _cc_head(m: CCHead, inputs, ctx) -> Rows:
    x = inputs[m.in_index]
    feats = run(m.conv0, x, ctx)
    h = feats.height
    y = feats
    for _ in range(m.recurrence):
        # NHWC views of each block, the unsharded head's einsum subscripts
        q, k, v = ([t.permute(0, 2, 3, 1) for t in run(c, y, ctx).blocks]
                   for c in (m.cca_query, m.cca_key, m.cca_value))
        columns = {}
        blocks = []
        for qb, kb, vb, yb, (s, e) in zip(q, k, v, y.blocks, y.ranges):
            dev = qb.device
            if dev not in columns:       # every row's keys and values
                columns[dev] = tuple(torch.cat([to(t, dev) for t in r],
                                               dim=1) for r in (k, v))
            k_all, v_all = columns[dev]
            # the pixel itself among its column's keys, at its global row
            diag = (torch.arange(s, e, device=dev)[:, None]
                    == torch.arange(h, device=dev)[None, :])[:, None, :]
            e_h = torch.einsum("bijc,bajc->bija", qb, k_all)
            e_h = e_h.masked_fill(diag[None], -1e9)
            e_w = torch.einsum("bijc,biuc->biju", qb, kb)
            attn = torch.softmax(torch.cat([e_h, e_w], -1), dim=-1)
            out = (torch.einsum("bija,bajc->bijc", attn[..., :h], v_all)
                   + torch.einsum("biju,biuc->bijc", attn[..., h:], vb))
            blocks.append(yb + to(m.cca_gamma, dev) * out.permute(0, 3, 1, 2))
        y = Rows(blocks, h)
    return _cls_seg(m, run(m.conv1, spatial.cat([x, y]), ctx), ctx)


# ---- region and kernel heads: partial sums over the pixels ---------------

@_sharded(OCRHead)
def _ocr_head(m: OCRHead, inputs, ctx, prev: Optional[Rows] = None) -> Rows:
    """``prev``: a cascade's earlier stage's logits, the soft regions."""
    feats = run(m.bottleneck, inputs[m.in_index], ctx)
    regions = run(m.soft_regions, feats, ctx) if prev is None else prev
    # the class centroids: a softmax over all pixels a class
    context = _softmax_pool(regions.map(lambda b: b * m.scale), feats, ctx)
    key, value = m.key(context), m.value(context)
    norm = math.sqrt(float(m.ocr_channels))

    def attend(b):
        pixels = tokens(b)
        sim = torch.einsum("bpc,bkc->bpk", _dense(m.query, pixels),
                           to(key, b.device)) / norm
        ocr = torch.einsum("bpk,bkc->bpc", torch.softmax(sim, dim=-1),
                           to(value, b.device))
        return _untokens_like(torch.cat([pixels, _dense(m.up_proj, ocr)],
                                        dim=-1), b)
    return _cls_seg(m, run(m.fuse, feats.map(attend), ctx), ctx)


@_sharded(IterativeDecodeHead)
def _knet_head(m: IterativeDecodeHead, inputs, ctx) -> Rows:
    feats = run(m.generate_conv, inputs[m.in_index], ctx)
    masks = _cls_seg(m, feats, ctx)
    kernels = m.kernel_seed.expand(feats.shape[0], -1, -1)
    dt, c = feats.dtype, feats.shape[1]
    for i in range(m.num_stages):
        stage = getattr(m, f"kernel_update_head{i}")
        hard = masks.map(lambda b: (torch.sigmoid(b) > stage.mask_thr)
                         .to(dt))
        if ctx.trace is not None:
            ctx.trace.setdefault("knet_hard", []).append(hard)
        # each group's pixel sum and the global count under its hard mask
        denom = torch.clamp(_sum_wide((hb.sum(dim=(2, 3))
                                       for hb in hard.blocks), ctx.home, dt),
                            min=1.0)
        group = _sum_wide((torch.einsum("bkhw,bchw->bkc", hb, fb)
                           for hb, fb in zip(hard.blocks, feats.blocks)),
                          ctx.home, dt) / denom[..., None]
        kernels, mask_feat = stage.update(group, kernels)
        masks = feats.map(lambda b: torch.einsum(
            "bkc,bchw->bkhw", to(mask_feat, b.device), b) / math.sqrt(c))
    return masks


# ---- ISA's and PSA's sparse and pointwise attention ------------------------

@_sharded(ISAHead)
def _isa_head(m: ISAHead, inputs, ctx) -> Rows:
    """The map padded to a multiple of ``down_factor`` (zeros, ``pad_h //
    2`` rows on top), in padded rows R = p qh + r: the global stage
    attends within each row class r (rows r, qh + r, ...: the whole map),
    the local stage within each band p of qh rows.  Each shard attends
    with its queries over the whole bands its rows touch, against the
    global stage's keys and values of every padded row (gathered once a
    device; a padding row's are the projections' biases), so a band that
    straddles a shard's edge is computed by both shards from the halo rows
    of the input, and each keeps its own rows."""
    feats = run(m.in_conv, inputs[m.in_index], ctx)
    b, c, h, w = feats.shape
    ph, pw = m.down_factor
    qh, qw = -(-h // ph), -(-w // pw)
    top, left = (qh * ph - h) // 2, (qw * pw - w) // 2
    bottom, right = qh * ph - h - top, qw * pw - w - left
    scale = m.isa_channels ** -0.5

    def nhwc(t):                     # NCHW rows -> NHWC, columns padded
        return F.pad(t, (left, right)).permute(0, 2, 3, 1)

    def groups(t, bands, a, x):      # (B, bands qh, Wp, C) -> a stage's
        t = t.reshape(b, bands, qh, pw, qw, t.shape[-1])
        return t.permute(0, *a, 5).reshape(b * x[0], x[1], t.shape[-1])

    def all_rows(lin, proj: Rows, dev, cache):
        """``lin``'s projection of every padded row on dev (each shard's
        rows ``proj``), grouped by row class."""
        if dev not in cache:
            pads = [_dense(lin, feats.blocks[0].new_zeros(
                (b, n, qw * pw, c), device=dev)) for n in (top, bottom)]
            full = torch.cat([pads[0], spatial.fetch_rows(
                proj, 0, h, dev).permute(0, 2, 3, 1), pads[1]], dim=1)
            cache[dev] = groups(full, ph, (2, 4, 1, 3), (qh * qw, ph * pw))
        return cache[dev]

    k_rows, v_rows = (Rows([_dense(lin, nhwc(blk)).permute(0, 3, 1, 2)
                            for blk in feats.blocks], h)
                      for lin in (m.global_k, m.global_v))
    keys, values = {}, {}
    blocks = []
    for blk, (s, e) in zip(feats.blocks, feats.ranges):
        dev = blk.device
        if e == s:
            blocks.append(blk)
            continue
        p0, p1 = (s + top) // qh, (e + top - 1) // qh + 1
        nb = p1 - p0
        x = nhwc(spatial.fetch_padded(feats, p0 * qh - top, p1 * qh - top,
                                      dev))
        q = groups(_dense(m.global_q, x), nb, (2, 4, 1, 3), (qh * qw,
                                                            nb * pw))
        g = _attend(q, all_rows(m.global_k, k_rows, dev, keys),
                    all_rows(m.global_v, v_rows, dev, values), scale)
        g = g.reshape(b, qh, qw, nb, pw, c).permute(0, 3, 1, 4, 2, 5)
        t = groups(g.reshape(b, nb * qh, qw * pw, c), nb, (1, 3, 2, 4),
                   (nb * pw, qh * qw))
        t = _attend(*(_dense(getattr(m, f"local_{n}"), t) for n in "qkv"),
                    scale)
        y = t.reshape(b, nb, pw, qh, qw, c).permute(0, 1, 3, 2, 4, 5)
        y = y.reshape(b, nb * qh, qw * pw, c)
        r0 = s + top - p0 * qh
        blocks.append(y[:, r0:r0 + e - s, left:left + w].permute(0, 3, 1, 2))
    out = run(m.out_conv, spatial.cat([feats, Rows(blocks, h)]), ctx)
    return _cls_seg(m, out, ctx)


@_sharded(PSAHead)
def _psa_head(m: PSAHead, inputs, ctx) -> Rows:
    """Each pixel's (2H-1)(2W-1) masks lie at the pixel: the collect
    branch's softmax over the source pixels is a shard's own, against the
    values of every row (gathered once a device); the distribute branch's
    sum over the mask's pixels is each shard's partial (B, N, C), those
    added in float32 or wider on the shard that keeps the output rows.
    The shards' masks are made one shard at a time, each consumed before
    the next."""
    x = inputs[m.in_index]
    h, w = _hw(x)
    n = x.shape[0]

    def affinities(p: str):
        y = run(getattr(m, f"{p}_attn0"), run(getattr(m, f"{p}_reduce"), x,
                                                ctx), ctx)
        # bound by the whole map's size, whatever a block's
        weight = getattr(m, f"{p}_attn1").weight_for(
            h, w, x.blocks[0].new_empty(0, device=ctx.home))
        for blk, (s, e) in zip(y.blocks, y.ranges):
            if e == s:
                yield blk.new_zeros((n, 0, h * w))
                continue
            mask = tokens(F.conv2d(blk, to(weight, blk.device)))
            idx = _psa_index(h, w, blk.device, s * w, e * w)
            aff = torch.gather(mask, -1, idx[None].expand(n, -1, -1))
            del mask, idx
            yield torch.softmax(aff, dim=-1) if m.psa_softmax else aff

    vals = {}
    collect = [torch.einsum("bnm,bmc->bnc", a, _all_rows(x, blk.device,
                                                          vals))
               for a, blk in zip(affinities("collect"), x.blocks)]
    parts = [torch.einsum("bmn,bmc->bnc", a, tokens(blk))
             for a, blk in zip(affinities("distribute"), x.blocks)]
    y = []
    for col, blk, (s, e) in zip(collect, x.blocks, x.ranges):
        dist = _sum_wide((p[:, s * w:e * w] for p in parts), blk.device,
                         x.dtype)
        y.append(_untokens_like(torch.cat([col, dist], dim=-1), blk))
    y = run(m.proj, Rows(y, h), ctx)
    return _cls_seg(m, run(m.bottleneck, spatial.cat([x, y]), ctx), ctx)


# ---- the hierarchical transformers: each shard's tokens ---------------------

def _nhwc(b: torch.Tensor) -> torch.Tensor:
    return b.permute(0, 2, 3, 1)


def _nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2)


def _pixelwise(x: Rows, fn) -> Rows:
    """``fn`` on each shard's (B, h, W, C) pixels: an op of each pixel's
    channels (a dense, a LayerNorm, a GELU)."""
    return x.map(lambda b: _nchw(fn(_nhwc(b))))


def _layer_norm(norm: nn.LayerNorm, t: torch.Tensor) -> torch.Tensor:
    """``norm`` over t's last axis, its parameters read where they lie."""
    return F.layer_norm(t, norm.normalized_shape, to(norm.weight, t.device),
                        to(norm.bias, t.device), norm.eps)


def _ln_rows(norm: nn.LayerNorm, x: Rows) -> Rows:
    """``layers.ln_nchw`` of a row-sharded map."""
    return _pixelwise(x, functools.partial(_layer_norm, norm))


def _mlp(x: Rows, norm, fc1, fc2, approximate: bool) -> Rows:
    """fc2(gelu(fc1(norm(x)))) of each pixel."""
    return _pixelwise(x, lambda t: _dense(fc2, gelu(
        _dense(fc1, _layer_norm(norm, t)), approximate)))


@_sharded(ConvNeXtBlock)
def _convnext_block(m: ConvNeXtBlock, x: Rows, ctx) -> Rows:
    y = _mlp(run(m.depthwise_conv, x, ctx), m.norm, m.pointwise_conv1,
             m.pointwise_conv2, approximate=False)
    if m.gamma is not None:
        y = y.map(lambda b: b * to(m.gamma, b.device)[:, None, None])
    return x + y


@_sharded(ConvNeXt)
def _convnext(m: ConvNeXt, x: Rows, ctx) -> List[Rows]:
    outs = []
    for i in range(4):
        if i == 0:
            x = _ln_rows(m.downsample0_norm, run(m.downsample0_conv, x, ctx))
        else:
            x = run(getattr(m, f"downsample{i}_conv"), _ln_rows(
                getattr(m, f"downsample{i}_norm"), x), ctx)
        for j in range(m.depths[i]):
            x = run(getattr(m, f"stage{i}_block{j}"), x, ctx)
        if i in m.out_indices:
            outs.append(_ln_rows(getattr(m, f"out_norm{i}"), x))
    return outs


@_sharded(EfficientAttention, _SRAttention)
def _reduced_attention(m, x: Rows, ctx) -> Rows:
    """MiT's and Twins' attention over keys and values reduced by a
    strided convolution (``sr``, + LN): each shard reduces and projects
    (``kv``) its own rows, the projections are gathered once a device,
    and each shard's queries attend to all of them."""
    src = x if m.sr is None else _ln_rows(m.sr_norm, run(m.sr, x, ctx))
    kv = _pixelwise(src, functools.partial(_dense, m.kv))
    nh = m.num_heads
    cache = {}

    def attend_block(b):
        k, v = _all_rows(kv, b.device, cache).chunk(2, dim=-1)
        q = heads_split(_dense(m.q, tokens(b)), nh)
        out = attend(q, heads_split(k, nh), heads_split(v, nh),
                     divisor=math.sqrt(q.shape[-1]))
        return _untokens_like(_dense(m.proj, heads_merge(out)), b)
    return x.map(attend_block)


@_sharded(MixFFN)
def _mix_ffn(m: MixFFN, x: Rows, ctx) -> Rows:
    y = run(m.dwconv, _pixelwise(x, functools.partial(_dense, m.fc1)), ctx)
    return _pixelwise(y, lambda t: _dense(m.fc2, gelu(t, approximate=True)))


@_sharded(MiTBlock)
def _mit_block(m: MiTBlock, x: Rows, ctx) -> Rows:
    x = x + run(m.attn, _ln_rows(m.norm1, x), ctx)
    return x + run(m.ffn, _ln_rows(m.norm2, x), ctx)


@_sharded(MixVisionTransformer, MITB0, MITB2)
def _mit(m: MixVisionTransformer, x: Rows, ctx) -> List[Rows]:
    outs = []
    for i, depth in enumerate(m.num_layers):
        x = _ln_rows(getattr(m, f"embed_norm{i + 1}"),
                     run(getattr(m, f"patch_embed{i + 1}"), x, ctx))
        for j in range(depth):
            x = run(getattr(m, f"stage{i + 1}_block{j}"), x, ctx)
        x = _ln_rows(getattr(m, f"out_norm{i + 1}"), x)
        if i in m.out_indices:
            outs.append(x)
    return outs


@functools.lru_cache(maxsize=512)
def _band_plan(hp: int, ws: int, shift: int, s: int, e: int):
    """The window bands (ws rows of a map padded to ``hp`` rows, rolled by
    -``shift``) that output rows [s, e) lie in: their indices, their
    padded rows in rolled order as contiguous runs [a, b) (a band's
    rolled rows are padded rows (p ws + shift + i) mod hp: the last band
    wraps onto the map's first rows), and each output row's place among
    those rows."""
    bands = tuple(sorted({((r - shift) % hp) // ws for r in range(s, e)}))
    rows = [(p * ws + shift + i) % hp for p in bands for i in range(ws)]
    runs, start = [], 0
    for i in range(1, len(rows) + 1):
        if i == len(rows) or rows[i] != rows[i - 1] + 1:
            runs.append((rows[start], rows[i - 1] + 1))
            start = i
    at = {p: i * ws for i, p in enumerate(bands)}
    keep = tuple(at[((r - shift) % hp) // ws] + (r - shift) % hp % ws
                 for r in range(s, e))
    return bands, tuple(runs), keep


def _band_rows(x: Rows, runs, dev) -> torch.Tensor:
    """The (B, C, rows, W) map of x's padded rows ``runs`` on ``dev``,
    zeros below the map."""
    pieces = [spatial.fetch_padded(x, a, b, dev) for a, b in runs]
    return pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=2)


@functools.lru_cache(maxsize=512)
def _keep_index(hp: int, ws: int, shift: int, s: int, e: int,
                device: torch.device) -> torch.Tensor:
    """``_band_plan``'s output rows' places as an index tensor on
    ``device``: uploaded once a geometry, not a block."""
    return upload(list(_band_plan(hp, ws, shift, s, e)[2]), device)


@functools.lru_cache(maxsize=512)
def _window_mask(hp: int, wp: int, ws: int, shift: int, s: int, e: int,
                 device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """The seam mask (``vit._shift_attn_mask`` of the whole padded map) of
    ``_band_plan``'s windows, taken at their global indices p (wp / ws) +
    q: (windows, 1, ws^2, ws^2) on ``device``."""
    per_band = wp // ws
    windows = [p * per_band + q for p in _band_plan(hp, ws, shift, s, e)[0]
               for q in range(per_band)]
    full = upload(_shift_attn_mask(hp, wp, ws, shift), device).to(dtype)
    return full[upload(windows, device), None]


@_sharded(_LocalAttention)
def _local_attention(m: _LocalAttention, x: Rows, ctx) -> Rows:
    """Twins-SVT's windows of ``min(window, h, w)`` cells a side of the
    whole map, padded at its bottom and right with zeros before ``qkv``:
    each shard attends within the bands its rows touch, a band across a
    shard's edge computed by both, and keeps its own rows."""
    n, _, h, w = x.shape
    ws = min(m.window, h, w)
    hp, wp = h + (-h) % ws, w + (-w) % ws
    nh = m.num_heads
    blocks = []
    for blk, (s, e) in zip(x.blocks, x.ranges):
        if e == s:
            blocks.append(blk)
            continue
        bands, runs, _ = _band_plan(hp, ws, 0, s, e)
        g = F.pad(_nhwc(_band_rows(x, runs, blk.device)), (0, 0, 0, wp - w))
        q, k, v = (heads_split(t, nh) for t in _dense(
            m.qkv, _window_partition(g, ws)).chunk(3, dim=-1))
        out = _dense(m.proj, heads_merge(attend(
            q, k, v, divisor=math.sqrt(q.shape[-1]))))
        out = _window_reverse(out, ws, n, g.shape[1], wp)
        r0 = s - bands[0] * ws
        blocks.append(_nchw(out[:, r0:r0 + e - s, :w]))
    return Rows(blocks, h)


@_sharded(_TwinsBlock)
def _twins_block(m: _TwinsBlock, x: Rows, ctx) -> Rows:
    x = x + run(m.attn, _ln_rows(m.norm1, x), ctx)
    return x + _mlp(x, m.norm2, m.fc1, m.fc2, approximate=True)


@_sharded(PCPVT, SVT)
def _twins(m: PCPVT, x: Rows, ctx) -> List[Rows]:
    outs = []
    for s, depth in enumerate(m.depths):
        x = _ln_rows(getattr(m, f"embed_norm{s}"),
                     run(getattr(m, f"patch_embed{s}"), x, ctx))
        for j in range(depth):
            x = run(getattr(m, f"block{s}_{j}"), x, ctx)
            if j == 0:                          # the PEG
                x = x + run(getattr(m, f"peg{s}"), x, ctx)
        x = _ln_rows(getattr(m, f"out_norm{s}"), x)
        if s in m.out_indices:
            outs.append(x)
    return outs


@_sharded(SwinBlock)
def _swin_block(m: SwinBlock, x: Rows, ctx) -> Rows:
    """A Swin block over the map padded to whole windows at its bottom and
    right (zeros after ``norm1``) and rolled by -shift: each shard
    attends within the bands its rows lie in after the roll (the last
    band holds the padded map's last ws - shift rows and its first
    shift rows), with the seam mask of the whole padded map at each
    window's global index, and keeps its own rows."""
    n, _, h, w = x.shape
    ws, sh = m.window, m.shift
    hp, wp = h + (-h) % ws, w + (-w) % ws
    y = _ln_rows(m.norm1, x)
    blocks = []
    for blk, (s, e) in zip(x.blocks, x.ranges):
        if e == s:
            blocks.append(blk)
            continue
        dev = blk.device
        _, runs, _ = _band_plan(hp, ws, sh, s, e)
        keep = _keep_index(hp, ws, sh, s, e, dev)
        g = F.pad(_nhwc(_band_rows(y, runs, dev)), (0, 0, 0, wp - w))
        mask = None
        if sh:
            g = torch.roll(g, -sh, dims=2)
            mask = _window_mask(hp, wp, ws, sh, s, e, dev, x.dtype)
        wins = m.attn(_window_partition(g, ws), mask,
                      param=lambda p: to(p, dev))
        out = _window_reverse(wins, ws, n, g.shape[1], wp)
        if sh:
            out = torch.roll(out, sh, dims=2)
        # row r's output: rolled row (r - shift) mod hp, in its band
        blocks.append(_nchw(out[:, keep, :w]))
    x = x + Rows(blocks, h)
    return x + _mlp(x, m.norm2, m.mlp.fc1, m.mlp.fc2, approximate=False)


def _patch_merge(x: Rows, norm: nn.LayerNorm, lin: nn.Linear) -> Rows:
    """Swin's 2x2 patch merging: the map padded at its bottom and right
    to even sizes, each output row from global input rows 2i and 2i + 1
    ([x00, x10, x01, x11] on the channels), then ``norm`` and ``lin``;
    the output rows split over the shards as ``row_ranges`` splits
    them."""
    h, w = _hw(x)
    h2 = -(-h // 2)
    blocks = []
    for (o0, o1), dev in zip(row_ranges(h2, len(x.blocks)), x.devices):
        t = F.pad(_nhwc(spatial.fetch_padded(x, 2 * o0, 2 * o1, dev)),
                  (0, 0, 0, w % 2))
        t = torch.cat([t[:, 0::2, 0::2], t[:, 1::2, 0::2], t[:, 0::2, 1::2],
                       t[:, 1::2, 1::2]], dim=-1)
        blocks.append(_nchw(_dense(lin, _layer_norm(norm, t))))
    return Rows(blocks, h2)


@_sharded(SwinTransformer)
def _swin(m: SwinTransformer, x: Rows, ctx) -> List[Rows]:
    x = run(m.patch_embed, x, ctx)
    if m.patch_norm_ln is not None:
        x = _ln_rows(m.patch_norm_ln, x)
    outs = []
    for s, depth in enumerate(m.depths):
        for i in range(depth):
            x = run(getattr(m, f"stage{s}_block{i}"), x, ctx)
        outs.append(_ln_rows(getattr(m, f"out_norm{s}"), x))
        if s < len(m.depths) - 1:
            x = _patch_merge(x, getattr(m, f"merge_norm{s}"),
                             getattr(m, f"merge{s}"))
    return outs


# ---- PointRend's cascade: the point head over row-sharded maps -------------

def _point_sample_rows(x: Rows, points: torch.Tensor, align_corners: bool,
                       home) -> torch.Tensor:
    """``heads_zoo.point_sample`` of a row-sharded map at global points
    (B, P, 2) on ``home``: each corner's value from the shard that holds
    its row (every other shard adds an exact zero), then the unsharded
    corner sum -> (B, C, P) on ``home``."""
    n, c, h, w = x.shape

    def gather(yy, xx):
        total = None
        for blk, (s, e) in zip(x.blocks, x.ranges):
            if e == s:
                continue
            dev = blk.device
            yl, xl = to(yy, dev), to(xx, dev)
            idx = ((yl.clamp(s, e - 1) - s) * w + xl).long()
            got = torch.gather(blk.reshape(n, c, (e - s) * w), 2,
                               idx[:, None, :].expand(n, c, -1))
            got = to(torch.where(((yl >= s) & (yl < e))[:, None], got,
                                 torch.zeros_like(got)), home)
            total = got if total is None else total + got
        return total

    return bilinear_points(gather, points, h, w, align_corners).to(x.dtype)


def _most_uncertain(logits: Rows, k: int, ctx):
    """``boxes.top_k`` of PointHead.uncertainty over all shards' cells:
    (B, k) global flat indices on the model's device, most uncertain
    first, ties by the lower index.  Each shard's own top k, by global
    index; in shard order a tie's candidates come in index order, so the
    stable merge keeps it."""
    n, _, h, w = logits.shape
    vals, idx = [], []
    for blk, (s, e) in zip(logits.blocks, logits.ranges):
        if e == s:
            continue
        unc = PointHead.uncertainty(blk).reshape(n, (e - s) * w)
        v, i = top_k(unc, min(k, unc.shape[1]))
        vals.append(to(v, ctx.home))
        idx.append(to(i, ctx.home) + s * w)
    order = top_k(torch.cat(vals, dim=1), k)[1]
    return torch.gather(torch.cat(idx, dim=1), 1, order)


def _point_logits(head: PointHead, feats, coarse: Rows, idx, ctx):
    """The point head at the cells ``idx`` (B, P) of ``coarse``'s grid:
    point logits (B, K, P) and the points (B, P, 2)."""
    h, w = _hw(coarse)
    ys = torch.div(idx, w, rounding_mode="floor").float()
    xs = (idx % w).float()
    pts = torch.stack([(xs + 0.5) / w, (ys + 0.5) / h], dim=-1)
    fine = torch.cat([_point_sample_rows(feats[i], pts, head.align_corners,
                                         ctx.home)
                      for i in head.in_index], dim=1)
    return head.classify(fine, _point_sample_rows(
        coarse, pts, head.align_corners, ctx.home)), pts


def _write_cells(x: Rows, idx: torch.Tensor, values: torch.Tensor) -> Rows:
    """x with the cells ``idx`` (B, P, global flat) set to ``values`` (B,
    K, P), each shard writing those it holds (the others into a slot it
    drops)."""
    n, k, _, w = x.shape
    out = []
    for blk, (s, e) in zip(x.blocks, x.ranges):
        cells = (e - s) * w
        local = to(idx, blk.device) - s * w
        local = torch.where((local >= 0) & (local < cells), local, cells)
        flat = torch.cat([blk.reshape(n, k, cells),
                          blk.new_zeros((n, k, 1))], dim=2)
        flat = flat.scatter(2, local[:, None, :].expand(n, k, -1),
                            to(values, blk.device).to(blk.dtype))
        out.append(flat[..., :cells].reshape(blk.shape))
    return Rows(out, x.height)


def _subdivide(model: CascadeEncoderDecoder, feats, logits: Rows,
               ctx) -> Rows:
    """``CascadeEncoderDecoder.subdivide`` over row-sharded logits: each
    round's x2 resize shard by shard, the most uncertain cells of the
    whole map, the point head's logits written back by the shards that
    hold the cells.  The chosen cells of each round go to ``ctx.trace``
    (``point_cells``)."""
    head = model.heads()[-1]
    cfg = model.test_cfg
    num_points = int(cfg.get("subdivision_num_points", 1024))
    steps = int(cfg.get("subdivision_steps", 2))
    scale = int(cfg.get("scale_factor", 2))
    refined = logits
    for _ in range(steps):
        h2, w2 = refined.height * scale, refined.shape[3] * scale
        refined = _resize_like(refined, (h2, w2), model.align_corners, None)
        idx = _most_uncertain(refined, min(num_points, h2 * w2), ctx)
        point_logits, _ = _point_logits(head, feats, refined, idx, ctx)
        refined = _write_cells(refined, idx, point_logits)
        if ctx.trace is not None:
            ctx.trace.setdefault("point_cells", []).append(idx)
    return refined


def _cascade(model: CascadeEncoderDecoder, feats, hw, with_aux: bool,
             with_points: bool, ctx):
    """``CascadeEncoderDecoder.forward`` from the row-sharded features."""
    stages, prev = [], None
    for head in model.heads():
        if isinstance(head, PointHead):
            break
        if prev is None:
            prev = run(head, feats, ctx)
        elif isinstance(head, OCRHead):
            prev = _ocr_head(head, feats, ctx, prev)
        else:
            raise TypeError(f"{type(head).__name__} takes no prev_logits")
        stages.append(prev)
    pointed = isinstance(model.heads()[-1], PointHead)
    if not model.training:
        logits = stages[-1]
        if pointed:
            logits = _subdivide(model, feats, logits, ctx)
        return spatial.resize(logits, hw, model.align_corners)
    outs = [spatial.resize(o, hw, model.align_corners) for o in stages]
    if with_aux and model.auxiliary_head is not None:
        outs.append(spatial.resize(run(model.auxiliary_head, feats, ctx),
                                   hw, model.align_corners))
    out = tuple(outs) if len(outs) > 1 else outs[0]
    if not with_points:
        return out
    if not pointed:
        raise ValueError("with_points: the last stage is not a PointHead")
    coarse = stages[-1]
    k = min(int(model.train_cfg.get("num_points", 256)),
            coarse.height * coarse.shape[3])
    point_logits, points = _point_logits(
        model.heads()[-1], feats, coarse, _most_uncertain(coarse, k, ctx),
        ctx)
    return out, {"point_logits": point_logits, "points": points}


def forward_rows(model: EncoderDecoder, x: Rows,
                 train: Optional[bool] = None, with_aux: bool = False,
                 generator=None, with_points: bool = False,
                 trace: Optional[dict] = None):
    """``model.forward`` over a row-sharded (B, C, H, W) map: the raw
    logits resized to the input, row-sharded as the input is, and the
    auxiliary head's alike with ``with_aux`` (a pair).  ``train`` and
    ``generator`` as there (a ``layers.BatchRows`` under data
    parallelism).  A ``CascadeEncoderDecoder`` gives what its forward
    gives: in eval mode the last stage's logits (after PointRend's
    subdivision), in train mode every stage's and the auxiliary head's,
    and with ``with_points`` its point pass (global (B, K, P) logits and
    (B, P, 2) points on the model's device).  ``trace``: a dict the heads
    write their decisions into, K-Net's hard masks entering each stage
    (``knet_hard``, row-sharded) and the cells each subdivision round
    chose (``point_cells``, (B, P) global flat indices)."""
    if type(model) not in (EncoderDecoder, CascadeEncoderDecoder):
        raise NotImplementedError(
            f"{type(model).__name__} has no row-sharded forward (every "
            "segmentor type of the port's registries has one)")
    if train is not None:
        model.train(train)
    ctx = _Context(next(model.parameters()).device, generator, trace)
    feats = run(model.backbone, x, ctx)
    if model.neck is not None:
        feats = run(model.neck, feats, ctx)
    hw = (x.height, x.shape[3])
    if isinstance(model, CascadeEncoderDecoder):
        return _cascade(model, feats, hw, with_aux, with_points, ctx)
    logits = spatial.resize(run(model.decode_head, feats, ctx), hw,
                            model.align_corners)
    if with_aux and model.auxiliary_head is not None:
        return logits, spatial.resize(run(model.auxiliary_head, feats, ctx),
                                      hw, model.align_corners)
    return logits


def _slide_sums(model: EncoderDecoder, x: Rows) -> Tuple[Rows, Rows]:
    """``slide_rows``' sums of the windows' logits and their counts,
    row-sharded as ``x``."""
    b, _, h, w = x.shape
    preds = [blk.new_zeros((b, model.num_classes, e - s, w))
             for blk, (s, e) in zip(x.blocks, x.ranges)]
    count = [blk.new_zeros((b, 1, e - s, w))
             for blk, (s, e) in zip(x.blocks, x.ranges)]
    for y1, y2, x1, x2 in model.slide_windows(h, w):
        logits = forward_rows(model, spatial.window(x, y1, y2, x1, x2),
                              train=False)
        for p, c, (s, e) in zip(preds, count, x.ranges):
            a, z = max(s, y1), min(e, y2)
            if a < z:
                p[:, :, a - s:z - s, x1:x2] += spatial.fetch_rows(
                    logits, a - y1, z - y1, p.device)
                c[:, :, a - s:z - s, x1:x2] += 1.0
    return Rows(preds, h), Rows(count, h)


def slide_rows(model: EncoderDecoder, x: Rows) -> Rows:
    """``model.slide_inference`` over a row-sharded (B, C, H, W) map, in
    eval mode: each window of ``model.slide_windows`` taken from the
    shards that hold its rows (``spatial.window``, split again over the
    same devices) and run through ``forward_rows``; each shard adds the
    window's logits over its own rows into its sums and counts, held on
    its device in the input's type, window by window as the unsharded
    loop adds them, so each element rounds as there.  The sums over the
    counts, row-sharded as the input is."""
    preds, count = _slide_sums(model, x)
    return Rows([p / c for p, c in zip(preds.blocks, count.blocks)],
                x.height)


# the plain-ViT families' and the light CNNs' forms, registered through
# ``_sharded``
from . import sharded_light, sharded_vit  # noqa: E402,F401
