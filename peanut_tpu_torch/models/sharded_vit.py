"""The row-sharded forms (``models.sharded``) of the zoo's plain-ViT
families: the backbones ``VisionTransformer``, ``MAE`` and ``BEiT``
(``ViTBlock``, ``_BEiTBlock``), whose taps are resized into a 4x .. 0.5x
pyramid of the patch grid, the necks ``MLANeck``, ``MultiLevelNeck`` and
``Feature2Pyramid``, and the heads ``SETRUPHead``, ``SETRMLAHead``,
``DPTHead`` and ``SegmenterMaskTransformerHead``.  Registered through
``sharded._sharded``; ``models.sharded`` imports this module.

A block's tokens stay row-sharded: a shard's tokens are the patch grid's
rows it holds, in row-major order.  Global attention: each shard projects
its own tokens, the keys and values of every row are gathered once a
device (``sharded._all_rows``), and each shard's queries attend to all of
them.  What the whole grid shapes is taken from the whole grid, never
from a shard: ViT's positional grid is resized once, on the model's
device, to the whole patch grid and each shard adds its rows; MAE's
positional embedding is bound by the grid's h * w patches, BEiT's
relative-position table by its height, and BEiT's bias joins only where
the whole grid is square, a shard's queries taking their rows of it.
Segmenter's class tokens are global: their attention, over every shard's
keys and values and their own, runs once on the model's device, and the
shards read the one result.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from .. import upload
from ..core import spatial
from ..core.spatial import Rows, to
from .backbones_zoo import MAE, BEiT, _BEiTBlock
from .heads import resize_like, tokens, untokens
from .heads_zoo import (DPTHead, SegmenterMaskTransformerHead, SETRMLAHead,
                        SETRUPHead, _l2norm)
from .layers import gelu
from .necks import Feature2Pyramid, MLANeck, MultiLevelNeck
from .sharded import (_all_rows, _cls_seg, _dense, _hw, _layer_norm,
                      _ln_rows, _mlp, _resize_like, _sharded, _untokens_like,
                      run)
from .vit import VisionTransformer, ViTBlock, _rel_pos_index, pyramid_sizes


def _tap_pyramid(taps, gh: int, gw: int, floor: int) -> tuple:
    """``vit.tap_pyramid`` of row-sharded taps: each resized to the whole
    grid's ``vit.pyramid_sizes``."""
    return tuple(_resize_like(t, size, False, None) for t, size in
                 zip(taps, pyramid_sizes(gh, gw, floor=floor)))


def _attend_all(x: Rows, project, attend, extra=()):
    """Global attention over a row-sharded map's tokens: ``project(t,
    device)`` gives each shard's (q, k, v) of its (B, n_i, C) tokens t,
    and ``attend(q, k, v, i)`` shard i's output tokens from its queries
    and every token's keys and values.  The output, row-sharded as x, and
    the function of a device that gives every token's keys and values
    there."""
    qkv = [project(tokens(b), b.device) for b in x.blocks]
    kv = Rows([_untokens_like(torch.cat([k, v], dim=-1), b)
               for (_, k, v), b in zip(qkv, x.blocks)], x.height)
    cache = {}

    def keys_values(device):
        """Gathered once a device: every row's keys and values in the
        grid's row-major order, then ``extra``'s (k, v) tokens."""
        if device not in cache:
            k, v = _all_rows(kv, device, {}).chunk(2, dim=-1)
            if extra:
                k = torch.cat([k, to(extra[0], device)], dim=1)
                v = torch.cat([v, to(extra[1], device)], dim=1)
            cache[device] = (k, v)
        return cache[device]

    out = Rows([_untokens_like(attend(q, *keys_values(b.device), i), b)
                for i, ((q, _, _), b) in enumerate(zip(qkv, x.blocks))],
               x.height)
    return out, keys_values


def _on(device):
    return lambda p: to(p, device)


@_sharded(ViTBlock)
def _vit_block(m: ViTBlock, x: Rows, ctx) -> Rows:
    """ViT's and MAE's block: ``vit.Attention`` of each shard's queries
    against every token, then the per-token MLP (exact GELU)."""
    out, _ = _attend_all(
        x, lambda t, dev: m.attn.project(_layer_norm(m.norm1, t), _on(dev)),
        lambda q, k, v, i: m.attn.attend(q, k, v, param=_on(q.device)))
    x = x + out
    return x + _mlp(x, m.norm2, m.mlp.fc1, m.mlp.fc2, approximate=False)


def _plus_rows(x: Rows, whole: torch.Tensor) -> Rows:
    """x plus the (1, C, H, W) map ``whole`` of x's height, each shard
    adding its rows."""
    return Rows([b + to(whole[:, :, s:e], b.device)
                 for b, (s, e) in zip(x.blocks, x.ranges)], x.height)


@_sharded(VisionTransformer)
def _vit(m: VisionTransformer, x: Rows, ctx) -> tuple:
    x = run(m.patch_embed, x, ctx)
    gh, gw = _hw(x)
    if m.pos_embed is not None:
        # the base grid resized once, on the model's device, to the whole
        # patch grid (never to a shard's rows)
        x = _plus_rows(x, resize_like(m.pos_embed.permute(0, 3, 1, 2),
                                      (gh, gw)))
    taps = []
    for i in range(m.depth):
        x = run(getattr(m, f"block{i}"), x, ctx)
        if i in m.out_indices:
            taps.append(x)
    return _tap_pyramid(taps, gh, gw, 0)


def _home_like(x: Rows, ctx) -> torch.Tensor:
    """An empty tensor of x's type on the model's device: where an
    input-shaped parameter binds (``layers.InputShaped.bind``)."""
    return x.blocks[0].new_empty(0, device=ctx.home)


@_sharded(MAE)
def _mae(m: MAE, x: Rows, ctx) -> tuple:
    x = run(m.patch_embed, x, ctx)
    h, w = _hw(x)
    # bound by the whole grid's h * w patches, as the unsharded first
    # forward binds it
    pos = m.positions(h * w, _home_like(x, ctx))
    x = _plus_rows(x, untokens(pos, h, w))
    taps = []
    for i in range(m.depth):
        x = run(getattr(m, f"block{i}"), x, ctx)
        if i in m.out_indices:
            taps.append(_ln_rows(getattr(m, f"tap_norm{i}"), x))
    return _tap_pyramid(taps, h, w, 1)


@functools.lru_cache(maxsize=512)
def _bias_index(grid: int, a: int, b: int,
                device: torch.device) -> torch.Tensor:
    """Rows [a, b) of ``vit._rel_pos_index(grid)``, flattened, on
    ``device``: uploaded once a geometry, not a block."""
    return upload(np.ascontiguousarray(_rel_pos_index(grid)[a:b]).reshape(
        -1), device)


@_sharded(_BEiTBlock)
def _beit_block(m: _BEiTBlock, x: Rows, ctx) -> Rows:
    """A BEiT block over the patch grid x: its table bound by the whole
    grid's height, the bias joining where the whole grid is square (a
    shard's own count of tokens never decides it), a shard's queries
    taking their rows of the bias; LayerScale, flax's tanh GELU."""
    grid, w = _hw(x)
    table = m.table(grid, _home_like(x, ctx))
    square = w == grid

    def attend(q, k, v, i):
        dev = q.device
        bias = None
        if square:
            s, e = x.ranges[i]
            bias = m.bias(to(table, dev), grid,
                          _bias_index(grid, s * w, e * w, dev))
        return _dense(m.proj, m.mix(q, k, v, bias)) * to(m.gamma1, dev)

    out, _ = _attend_all(
        x, lambda t, dev: _dense(m.qkv, _layer_norm(m.norm1, t)).chunk(
            3, dim=-1), attend)
    x = x + out
    y = _mlp(x, m.norm2, m.fc1, m.fc2, approximate=True)
    return x + y.map(lambda b: b * to(m.gamma2, b.device)[:, None, None])


@_sharded(BEiT)
def _beit(m: BEiT, x: Rows, ctx) -> tuple:
    x = run(m.patch_embed, x, ctx)
    h, w = _hw(x)
    taps = []
    for i in range(m.depth):
        x = run(getattr(m, f"block{i}"), x, ctx)
        if i in m.out_indices:
            taps.append(x)
    return _tap_pyramid(taps, h, w, 1)


# ---- the necks: a pyramid of a plain transformer's taps ---------------------

def _rounded(x: Rows, s: float) -> tuple:
    """The necks' size of x rescaled by s: ``max(int(round(g * s)), 1)``
    of the whole map's sides."""
    return (max(int(round(x.height * s)), 1),
            max(int(round(x.shape[3] * s)), 1))


@_sharded(MLANeck)
def _mla_neck(m: MLANeck, inputs, ctx) -> tuple:
    mids = [run(getattr(m, f"mla_p{i}_1x1"),
                _ln_rows(getattr(m, f"norm{i}"), x), ctx)
            for i, x in enumerate(inputs)]
    for i in range(len(mids) - 2, -1, -1):
        mids[i] = mids[i] + mids[i + 1]      # taps of equal size
    return tuple(run(getattr(m, f"mla_p{i}_3x3"), t, ctx)
                 for i, t in enumerate(mids))


@_sharded(MultiLevelNeck)
def _multi_level_neck(m: MultiLevelNeck, inputs, ctx) -> tuple:
    if len(inputs) == 1:
        inputs = [inputs[0]] * len(m.scales)
    projected = [run(getattr(m, f"lateral{i}"), x, ctx)
                 for i, x in enumerate(inputs)]
    return tuple(run(getattr(m, f"conv{i}"), _resize_like(
        x, _rounded(x, s), False, None), ctx)
        for i, (x, s) in enumerate(zip(projected, m.scales)))


@_sharded(Feature2Pyramid)
def _feature2pyramid(m: Feature2Pyramid, inputs, ctx) -> tuple:
    outs = []
    for i, (x, s) in enumerate(zip(inputs, m.rescales)):
        y = _resize_like(x, _rounded(x, s), False, None)
        outs.append(run(getattr(m, f"rescale{i}"), y, ctx) if s != 1 else y)
    return tuple(outs)


# ---- the heads --------------------------------------------------------------

def _up(m, x: Rows) -> Rows:
    """x resized by the head's ``up_scale`` (bilinear, its corners)."""
    return _resize_like(x, (x.height * m.up_scale, x.shape[3] * m.up_scale),
                        m.align_corners, None)


@_sharded(SETRUPHead)
def _setr_up_head(m: SETRUPHead, inputs, ctx) -> Rows:
    x = _ln_rows(m.norm, inputs[m.in_index])
    for i in range(m.num_convs):
        x = _up(m, run(getattr(m, f"up_conv{i}"), x, ctx))
    return _cls_seg(m, x, ctx)


@_sharded(SETRMLAHead)
def _setr_mla_head(m: SETRMLAHead, inputs, ctx) -> Rows:
    outs = [_up(m, run(getattr(m, f"up{i}_conv1"), run(
        getattr(m, f"up{i}_conv0"), inputs[i], ctx), ctx))
        for i in m.in_index]
    return _cls_seg(m, spatial.cat(outs), ctx)     # taps of equal size


@_sharded(DPTHead)
def _dpt_head(m: DPTHead, inputs, ctx) -> Rows:
    feats = [inputs[i] for i in m.in_index]
    h, w = _hw(feats[0])
    pyramid = []
    for i, (f, size) in enumerate(zip(feats, pyramid_sizes(h, w, floor=1))):
        y = _resize_like(run(getattr(m, f"reassemble{i}_proj"), f, ctx),
                         size, m.align_corners, None)
        pyramid.append(run(getattr(m, f"reassemble{i}_out"), y, ctx))

    def residual(z: Rows, i: int) -> Rows:
        y = run(getattr(m, f"fusion{i}_res_conv0"), z.map(F.relu), ctx)
        return z + run(getattr(m, f"fusion{i}_res_conv1"), y.map(F.relu),
                       ctx)

    out = residual(pyramid[-1], 3)
    for i in range(len(pyramid) - 2, -1, -1):
        out = residual(_resize_like(out, _hw(pyramid[i]), m.align_corners,
                                    None) + pyramid[i], i)
    return _cls_seg(m, run(m.project, out, ctx), ctx)


def _segmenter_layer(m, t: Rows, cls: torch.Tensor, ctx) -> tuple:
    """A ``heads_zoo._TransformerLayer`` over the row-sharded patch tokens
    t and the global class tokens ``cls`` (B, K, C) on the model's device:
    each shard's queries against every patch's keys and values and the
    class tokens'; the class tokens' queries against the same, once, on
    the model's device."""
    attn = m.attn

    def project(tok, dev):
        y = _layer_norm(m.norm1, tok)
        return tuple(_dense(getattr(attn, n), y)
                     for n in ("query", "key", "value"))

    def attend(q, k, v, i):
        return _dense(attn.out, attn.mix(q, k, v))

    qc, kc, vc = project(cls, ctx.home)
    out, keys_values = _attend_all(t, project, attend, extra=(kc, vc))
    t = t + out
    cls = cls + attend(qc, *keys_values(ctx.home), None)
    t = t + _mlp(t, m.norm2, m.fc1, m.fc2, approximate=True)
    cls = cls + _dense(m.fc2, gelu(_dense(m.fc1, _layer_norm(m.norm2, cls)),
                                   approximate=True))
    return t, cls


@_sharded(SegmenterMaskTransformerHead)
def _segmenter_head(m: SegmenterMaskTransformerHead, inputs, ctx) -> Rows:
    x = inputs[m.in_index]
    t = x.map(lambda b: _untokens_like(_dense(m.proj_dec, tokens(b)), b))
    cls = m.cls_emb.expand(x.shape[0], -1, -1)
    for i in range(m.num_layers):
        t, cls = _segmenter_layer(getattr(m, f"layer{i}"), t, cls, ctx)
    t = _ln_rows(m.decoder_norm, t)
    classes = _l2norm(_dense(m.classes_proj,
                             _layer_norm(m.decoder_norm, cls)), -1)

    def masks(b):
        patches = _dense(m.patch_proj, tokens(b)) / (m.channels ** 0.5)
        sim = torch.einsum("bnc,bkc->bnk", _l2norm(patches, -1),
                           to(classes, b.device))
        return _untokens_like(_layer_norm(m.mask_norm, sim), b)
    return t.map(masks)
