"""Pretrained-weight converters for the backbone zoo (the port's copy of
``peanut_tpu.models.zoo_import``).

Official and timm torch checkpoints (and the augreg JAX ViT ``.npz``)
become the JAX package's flax trees, array for array: the eight
converters are numpy only and give the trees and leftovers the JAX
package's give.  ``converted_backbone_state`` then lays such a tree into
a port backbone as its state dict, for ``load_state_dict(strict=True)``.

The converters are permissive: they return ``(variables, leftovers)``
where ``leftovers`` lists source keys with no destination (a
checkpoint's classifier, cls token or final norm), and the caller decides
whether they are acceptable.  The Swin converter consumes every model
key, the relative-position bias tables included.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

_CONV_T = (2, 3, 1, 0)  # torch OIHW -> flax HWIO


def _set(tree, path, value):
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def _dense(params, sd, tkey, fpath, handled):
    _set(params, fpath + ("kernel",), sd[f"{tkey}.weight"].T)
    handled.add(f"{tkey}.weight")
    if f"{tkey}.bias" in sd:
        _set(params, fpath + ("bias",), sd[f"{tkey}.bias"])
        handled.add(f"{tkey}.bias")


def _ln(params, sd, tkey, fpath, handled):
    _set(params, fpath + ("scale",), sd[f"{tkey}.weight"])
    _set(params, fpath + ("bias",), sd[f"{tkey}.bias"])
    handled.update({f"{tkey}.weight", f"{tkey}.bias"})


def _conv(params, sd, tkey, fpath, handled, bias=True):
    _set(params, fpath + ("conv", "kernel"),
         sd[f"{tkey}.weight"].transpose(_CONV_T))
    handled.add(f"{tkey}.weight")
    if bias and f"{tkey}.bias" in sd:
        _set(params, fpath + ("conv", "bias"), sd[f"{tkey}.bias"])
        handled.add(f"{tkey}.bias")


def convert_timm_vit(sd: Dict[str, np.ndarray]
                     ) -> Tuple[Dict[str, Any], List[str]]:
    """timm/DeiT ViT state dict -> VisionTransformer (models/vit.py).

    cls_token is dropped (this backbone is purely spatial, SETR-style);
    pos_embed drops the class token and reshapes to the (1, g, g, D) grid.
    """
    params: Dict[str, Any] = {}
    handled = set()

    _conv(params, sd, "patch_embed.proj", ("patch_embed",), handled)
    if "pos_embed" in sd:
        pe = sd["pos_embed"]
        n = pe.shape[1]
        g = int(np.sqrt(n - 1))
        if g * g == n - 1:
            pe = pe[:, 1:]
        else:
            g = int(np.sqrt(n))
        _set(params, ("pos_embed",),
             pe.reshape(1, g, g, pe.shape[-1]))
        handled.add("pos_embed")

    blk = re.compile(r"blocks\.(\d+)\.")
    n_blocks = 1 + max((int(m.group(1)) for k in sd
                        if (m := blk.match(k))), default=-1)
    for i in range(n_blocks):
        t = f"blocks.{i}"
        f = (f"block{i}",)
        _ln(params, sd, f"{t}.norm1", f + ("norm1",), handled)
        _ln(params, sd, f"{t}.norm2", f + ("norm2",), handled)
        _dense(params, sd, f"{t}.attn.qkv", f + ("attn", "qkv"), handled)
        _dense(params, sd, f"{t}.attn.proj", f + ("attn", "proj"), handled)
        _dense(params, sd, f"{t}.mlp.fc1", f + ("mlp", "fc1"), handled)
        _dense(params, sd, f"{t}.mlp.fc2", f + ("mlp", "fc2"), handled)

    leftovers = [k for k in sd if k not in handled]
    return {"params": params}, leftovers


def convert_augreg_vit(npz: Dict[str, np.ndarray]
                       ) -> Tuple[Dict[str, Any], List[str]]:
    """google-research augreg JAX ViT ``.npz`` -> VisionTransformer.

    The reference ships the inverse direction (vitjax2mmseg.py); the JAX
    package reads the format natively, and so does this copy.  Attention
    kernels are stored per-head (D, H, dh) and fold back to (D, 3D) with
    q,k,v order.
    """
    params: Dict[str, Any] = {}
    handled = set()
    d = npz["embedding/kernel"].shape[-1]

    _set(params, ("patch_embed", "conv", "kernel"), npz["embedding/kernel"])
    _set(params, ("patch_embed", "conv", "bias"), npz["embedding/bias"])
    handled.update({"embedding/kernel", "embedding/bias"})
    pe_key = "Transformer/posembed_input/pos_embedding"
    if pe_key in npz:
        pe = npz[pe_key]
        n = pe.shape[1]
        g = int(np.sqrt(n - 1))
        if g * g == n - 1:
            pe = pe[:, 1:]
        else:
            g = int(np.sqrt(n))
        _set(params, ("pos_embed",), pe.reshape(1, g, g, d))
        handled.add(pe_key)

    blk = re.compile(r"Transformer/encoderblock_(\d+)/")
    n_blocks = 1 + max((int(m.group(1)) for k in npz
                        if (m := blk.match(k))), default=-1)
    for i in range(n_blocks):
        t = f"Transformer/encoderblock_{i}"
        f = (f"block{i}",)
        att = f"{t}/MultiHeadDotProductAttention_1"
        qkv_k, qkv_b = [], []
        for name in ("query", "key", "value"):
            k = npz[f"{att}/{name}/kernel"]          # (D, H, dh)
            b = npz[f"{att}/{name}/bias"]            # (H, dh)
            qkv_k.append(k.reshape(d, -1))
            qkv_b.append(b.reshape(-1))
            handled.update({f"{att}/{name}/kernel", f"{att}/{name}/bias"})
        _set(params, f + ("attn", "qkv", "kernel"),
             np.concatenate(qkv_k, axis=1))
        _set(params, f + ("attn", "qkv", "bias"), np.concatenate(qkv_b))
        ok = npz[f"{att}/out/kernel"]                # (H, dh, D)
        _set(params, f + ("attn", "proj", "kernel"), ok.reshape(-1, d))
        _set(params, f + ("attn", "proj", "bias"), npz[f"{att}/out/bias"])
        handled.update({f"{att}/out/kernel", f"{att}/out/bias"})
        for ln_jax, ln_f in (("LayerNorm_0", "norm1"), ("LayerNorm_2",
                                                        "norm2")):
            _set(params, f + (ln_f, "scale"), npz[f"{t}/{ln_jax}/scale"])
            _set(params, f + (ln_f, "bias"), npz[f"{t}/{ln_jax}/bias"])
            handled.update({f"{t}/{ln_jax}/scale", f"{t}/{ln_jax}/bias"})
        mlp = f"{t}/MlpBlock_3"
        for j, fc in ((0, "fc1"), (1, "fc2")):
            _set(params, f + ("mlp", fc, "kernel"),
                 npz[f"{mlp}/Dense_{j}/kernel"])
            _set(params, f + ("mlp", fc, "bias"),
                 npz[f"{mlp}/Dense_{j}/bias"])
            handled.update({f"{mlp}/Dense_{j}/kernel",
                            f"{mlp}/Dense_{j}/bias"})

    leftovers = [k for k in npz if k not in handled]
    return {"params": params}, leftovers


def convert_official_mit(sd: Dict[str, np.ndarray]
                         ) -> Tuple[Dict[str, Any], List[str]]:
    """Official SegFormer (NVlabs) MiT state dict -> MixVisionTransformer
    (models/mit.py) — mit2mmseg.py twin."""
    params: Dict[str, Any] = {}
    handled = set()

    for i in range(1, 5):
        pe = f"patch_embed{i}"
        if f"{pe}.proj.weight" not in sd:
            continue
        _conv(params, sd, f"{pe}.proj", (f"patch_embed{i}",), handled)
        _ln(params, sd, f"{pe}.norm", (f"embed_norm{i}",), handled)
        if f"norm{i}.weight" in sd:                  # stage-end norm
            _ln(params, sd, f"norm{i}", (f"out_norm{i}",), handled)

        blk = re.compile(rf"block{i}\.(\d+)\.")
        n_blocks = 1 + max((int(m.group(1)) for k in sd
                            if (m := blk.match(k))), default=-1)
        for j in range(n_blocks):
            t = f"block{i}.{j}"
            f = (f"stage{i}_block{j}",)
            _ln(params, sd, f"{t}.norm1", f + ("norm1",), handled)
            _ln(params, sd, f"{t}.norm2", f + ("norm2",), handled)
            _dense(params, sd, f"{t}.attn.q", f + ("attn", "q"), handled)
            _dense(params, sd, f"{t}.attn.kv", f + ("attn", "kv"), handled)
            _dense(params, sd, f"{t}.attn.proj", f + ("attn", "proj"),
                   handled)
            if f"{t}.attn.sr.weight" in sd:
                _conv(params, sd, f"{t}.attn.sr", f + ("attn", "sr"),
                      handled)
                _ln(params, sd, f"{t}.attn.norm", f + ("attn", "sr_norm"),
                    handled)
            _dense(params, sd, f"{t}.mlp.fc1", f + ("ffn", "fc1"), handled)
            _dense(params, sd, f"{t}.mlp.fc2", f + ("ffn", "fc2"), handled)
            dw = f"{t}.mlp.dwconv.dwconv"
            if f"{dw}.weight" in sd:
                # bare nn.Conv (depthwise): kernel sits directly under the
                # module, torch (C,1,kh,kw) -> flax (kh,kw,1,C)
                _set(params, f + ("ffn", "dwconv", "kernel"),
                     sd[f"{dw}.weight"].transpose(_CONV_T))
                _set(params, f + ("ffn", "dwconv", "bias"),
                     sd[f"{dw}.bias"])
                handled.update({f"{dw}.weight", f"{dw}.bias"})

    leftovers = [k for k in sd if k not in handled
                 and not k.startswith("head")]
    return {"params": params}, leftovers


def convert_official_swin(sd: Dict[str, np.ndarray]
                          ) -> Tuple[Dict[str, Any], List[str]]:
    """Official Microsoft Swin state dict -> SwinTransformer
    (models/vit.py) — swin2mmseg.py twin.  Maps the relative-position
    bias tables and the post-patch-embed LayerNorm; the
    relative_position_index / attn_mask buffers are recomputed statically
    (models/vit.py _rel_pos_index / _shift_attn_mask) and marked handled."""
    params: Dict[str, Any] = {}
    handled = set()

    _conv(params, sd, "patch_embed.proj", ("patch_embed",), handled)
    if "patch_embed.norm.weight" in sd:
        _ln(params, sd, "patch_embed.norm", ("patch_norm_ln",), handled)

    lay = re.compile(r"layers\.(\d+)\.blocks\.(\d+)\.")
    stages = {}
    for k in sd:
        m = lay.match(k)
        if m:
            stages.setdefault(int(m.group(1)), set()).add(int(m.group(2)))
    for s, blocks in stages.items():
        for b in sorted(blocks):
            t = f"layers.{s}.blocks.{b}"
            f = (f"stage{s}_block{b}",)
            _ln(params, sd, f"{t}.norm1", f + ("norm1",), handled)
            _ln(params, sd, f"{t}.norm2", f + ("norm2",), handled)
            _dense(params, sd, f"{t}.attn.qkv", f + ("attn", "qkv"), handled)
            _dense(params, sd, f"{t}.attn.proj", f + ("attn", "proj"),
                   handled)
            tbl = f"{t}.attn.relative_position_bias_table"
            if tbl in sd:
                _set(params, f + ("attn", "rel_pos_bias_table"), sd[tbl])
                handled.add(tbl)
            # static in this implementation; nothing to load
            handled.add(f"{t}.attn.relative_position_index")
            handled.add(f"{t}.attn_mask")
            _dense(params, sd, f"{t}.mlp.fc1", f + ("mlp", "fc1"), handled)
            _dense(params, sd, f"{t}.mlp.fc2", f + ("mlp", "fc2"), handled)
        dt = f"layers.{s}.downsample"
        if f"{dt}.reduction.weight" in sd:
            _dense(params, sd, f"{dt}.reduction", (f"merge{s}",), handled)
            _ln(params, sd, f"{dt}.norm", (f"merge_norm{s}",), handled)

    # out_norms: official has a single final `norm`; mmseg adds per-stage
    # norms.  Map what exists.
    for s in range(4):
        if f"norm{s}.weight" in sd:
            _ln(params, sd, f"norm{s}", (f"out_norm{s}",), handled)

    leftovers = [k for k in sd if k not in handled
                 and not k.startswith("head")]
    return {"params": params}, leftovers


def convert_mmcls_convnext(sd: Dict[str, np.ndarray]
                           ) -> Tuple[Dict[str, Any], List[str]]:
    """mmcls ConvNeXt state dict (the reference configs' pretrained source,
    names ``backbone.downsample_layers.i.{0,1}``, ``backbone.stages.i.j.*``)
    -> models/convnext.py ConvNeXt.  Accepts keys with or without the
    ``backbone.`` prefix."""
    params: Dict[str, Any] = {}
    handled = set()
    sd = {k[len("backbone."):] if k.startswith("backbone.") else k: v
          for k, v in sd.items()}

    def ln(tkey, fpath):
        _set(params, fpath + ("scale",), sd[f"{tkey}.weight"])
        _set(params, fpath + ("bias",), sd[f"{tkey}.bias"])
        handled.update({f"{tkey}.weight", f"{tkey}.bias"})

    for i in range(4):
        t = f"downsample_layers.{i}"
        # layer 0 = [conv, LN]; layers 1-3 = [LN, conv]
        conv_idx, norm_idx = (0, 1) if i == 0 else (1, 0)
        if f"{t}.{conv_idx}.weight" not in sd:
            continue
        _set(params, (f"downsample{i}_conv", "conv", "kernel"),
             sd[f"{t}.{conv_idx}.weight"].transpose(_CONV_T))
        _set(params, (f"downsample{i}_conv", "conv", "bias"),
             sd[f"{t}.{conv_idx}.bias"])
        handled.update({f"{t}.{conv_idx}.weight", f"{t}.{conv_idx}.bias"})
        ln(f"{t}.{norm_idx}", (f"downsample{i}_norm",))

        blk = re.compile(rf"stages\.{i}\.(\d+)\.")
        n_blocks = 1 + max((int(m.group(1)) for k in sd
                            if (m := blk.match(k))), default=-1)
        for j in range(n_blocks):
            t2 = f"stages.{i}.{j}"
            f = (f"stage{i}_block{j}",)
            # mmcls depthwise conv weight (C, 1, 7, 7)
            _set(params, f + ("depthwise_conv", "kernel"),
                 sd[f"{t2}.depthwise_conv.weight"].transpose(_CONV_T))
            _set(params, f + ("depthwise_conv", "bias"),
                 sd[f"{t2}.depthwise_conv.bias"])
            handled.update({f"{t2}.depthwise_conv.weight",
                            f"{t2}.depthwise_conv.bias"})
            ln(f"{t2}.norm", f + ("norm",))
            _dense(params, sd, f"{t2}.pointwise_conv1",
                   f + ("pointwise_conv1",), handled)
            _dense(params, sd, f"{t2}.pointwise_conv2",
                   f + ("pointwise_conv2",), handled)
            if f"{t2}.gamma" in sd:
                _set(params, f + ("gamma",), sd[f"{t2}.gamma"])
                handled.add(f"{t2}.gamma")
        if f"norm{i}.weight" in sd:
            ln(f"norm{i}", (f"out_norm{i}",))

    leftovers = [k for k in sd if k not in handled
                 and not k.startswith("head")]
    return {"params": params}, leftovers


def _bn(params, stats, sd, tkey, fpath, handled):
    """torch BatchNorm -> ConvModule's BatchNorm (inner name 'bn')."""
    m = fpath + ("bn",)
    _set(params, m + ("scale",), sd[f"{tkey}.weight"])
    _set(params, m + ("bias",), sd[f"{tkey}.bias"])
    _set(stats, m + ("mean",), sd[f"{tkey}.running_mean"])
    _set(stats, m + ("var",), sd[f"{tkey}.running_var"])
    handled.update({f"{tkey}.{s}" for s in
                    ("weight", "bias", "running_mean", "running_var")})


def convert_official_beit(sd: Dict[str, np.ndarray]
                          ) -> Tuple[Dict[str, Any], List[str]]:
    """Official/unilm BEiT checkpoint -> BEiT (backbones_zoo.py).

    Reference twin: tools/model_converters/beit2mmseg.py.  Deltas handled
    structurally rather than by key renaming: the split q_bias/v_bias pair
    (official BEiT has no k bias) concatenates into the fused qkv bias, and
    each block's relative_position_bias_table drops its 3 cls-token rows
    (this backbone is purely spatial).  relative_position_index buffers are
    recomputed statically.  cls_token / mask_token / final norm surface as
    leftovers for the caller to judge.
    """
    params: Dict[str, Any] = {}
    handled = set()

    _set(params, ("patch_embed", "kernel"),
         sd["patch_embed.proj.weight"].transpose(_CONV_T))
    _set(params, ("patch_embed", "bias"), sd["patch_embed.proj.bias"])
    handled.update({"patch_embed.proj.weight", "patch_embed.proj.bias"})

    blk = re.compile(r"blocks\.(\d+)\.")
    n_blocks = 1 + max((int(m.group(1)) for k in sd
                        if (m := blk.match(k))), default=-1)
    for i in range(n_blocks):
        t = f"blocks.{i}"
        f = (f"block{i}",)
        _ln(params, sd, f"{t}.norm1", f + ("norm1",), handled)
        _ln(params, sd, f"{t}.norm2", f + ("norm2",), handled)
        _set(params, f + ("qkv", "kernel"), sd[f"{t}.attn.qkv.weight"].T)
        handled.add(f"{t}.attn.qkv.weight")
        if f"{t}.attn.q_bias" in sd:
            q_b = sd[f"{t}.attn.q_bias"]
            v_b = sd[f"{t}.attn.v_bias"]
            _set(params, f + ("qkv", "bias"),
                 np.concatenate([q_b, np.zeros_like(q_b), v_b]))
            handled.update({f"{t}.attn.q_bias", f"{t}.attn.v_bias"})
        _dense(params, sd, f"{t}.attn.proj", f + ("proj",), handled)
        _dense(params, sd, f"{t}.mlp.fc1", f + ("fc1",), handled)
        _dense(params, sd, f"{t}.mlp.fc2", f + ("fc2",), handled)
        _set(params, f + ("gamma1",), sd[f"{t}.gamma_1"])
        _set(params, f + ("gamma2",), sd[f"{t}.gamma_2"])
        handled.update({f"{t}.gamma_1", f"{t}.gamma_2"})
        tbl = f"{t}.attn.relative_position_bias_table"
        if tbl in sd:
            # rows: (2g-1)^2 spatial + 3 cls relations — keep spatial only
            _set(params, f + ("rel_pos_bias",), sd[tbl][:-3])
            handled.add(tbl)
        handled.add(f"{t}.attn.relative_position_index")

    leftovers = [k for k in sd if k not in handled]
    return {"params": params}, leftovers


def convert_official_stdc(sd: Dict[str, np.ndarray], stdc_type: str
                          ) -> Tuple[Dict[str, Any], List[str]]:
    """Official STDC-Seg backbone checkpoint -> STDCNet (backbones_zoo.py).

    Reference twin: tools/model_converters/stdc2mmseg.py — the same
    features.N -> stage table ('cp.' prefixes stripped, conv_list -> convM,
    avd_layer -> the stride-2 module's depthwise downsample).  Classifier
    fc/linear keys surface as leftovers.
    """
    assert stdc_type in ("STDCNet1", "STDC1", "STDCNet2", "STDC2")
    if stdc_type in ("STDCNet1", "STDC1"):
        stages = ["stem0", "stem1", "stage2_0", "stage2_1", "stage3_0",
                  "stage3_1", "stage4_0", "stage4_1"]
    else:
        stages = (["stem0", "stem1"]
                  + [f"stage2_{j}" for j in range(4)]
                  + [f"stage3_{j}" for j in range(5)]
                  + [f"stage4_{j}" for j in range(3)])
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}
    handled = set()
    sd = {k[len("cp."):] if k.startswith("cp.") else k: v
          for k, v in sd.items()}
    for k in sd:
        if k.endswith("num_batches_tracked"):
            handled.add(k)

    def convx(tkey, fpath):
        _set(params, fpath + ("conv_unit", "conv", "kernel"),
             sd[f"{tkey}.conv.weight"].transpose(_CONV_T))
        handled.add(f"{tkey}.conv.weight")
        _bn(params, stats, sd, f"{tkey}.bn", fpath + ("norm",), handled)

    for n, dst in enumerate(stages):
        t = f"features.{n}"
        if f"{t}.conv.weight" in sd:                 # stem ConvX
            convx(t, (dst,))
            continue
        m = re.compile(rf"features\.{n}\.conv_list\.(\d+)\.")
        n_convs = 1 + max((int(g.group(1)) for k in sd
                           if (g := m.match(k))), default=-1)
        for j in range(n_convs):
            convx(f"{t}.conv_list.{j}", (dst, f"conv{j}"))
        if f"{t}.avd_layer.0.weight" in sd:          # stride-2 downsample
            _set(params, (dst, "downsample", "conv_unit", "conv", "kernel"),
                 sd[f"{t}.avd_layer.0.weight"].transpose(_CONV_T))
            handled.add(f"{t}.avd_layer.0.weight")
            _bn(params, stats, sd, f"{t}.avd_layer.1",
                (dst, "downsample", "norm"), handled)

    leftovers = [k for k in sd if k not in handled]
    return {"params": params, "batch_stats": stats}, leftovers


def convert_official_twins(sd: Dict[str, np.ndarray]
                           ) -> Tuple[Dict[str, Any], List[str]]:
    """Official Twins (PCPVT/SVT) checkpoint -> PCPVT/SVT (backbones_zoo.py).

    Reference twin: tools/model_converters/twins2mmseg.py.  GSA blocks map
    q/kv/proj/sr/norm onto _SRAttention's q/kv/proj/sr/sr_norm; SVT's LSA
    blocks (even indices) map their fused qkv directly.  pos_block.s.proj.0
    is the stage PEG depthwise conv.  Classifier head / final norm surface
    as leftovers.
    """
    params: Dict[str, Any] = {}
    handled = set()

    n_stages = 1 + max((int(m.group(1)) for k in sd
                        if (m := re.match(r"patch_embeds\.(\d+)\.", k))),
                       default=-1)
    for s in range(n_stages):
        pe = f"patch_embeds.{s}"
        _set(params, (f"patch_embed{s}", "kernel"),
             sd[f"{pe}.proj.weight"].transpose(_CONV_T))
        _set(params, (f"patch_embed{s}", "bias"), sd[f"{pe}.proj.bias"])
        handled.update({f"{pe}.proj.weight", f"{pe}.proj.bias"})
        _ln(params, sd, f"{pe}.norm", (f"embed_norm{s}",), handled)

        peg = f"pos_block.{s}.proj.0"
        _set(params, (f"peg{s}", "kernel"),
             sd[f"{peg}.weight"].transpose(_CONV_T))
        _set(params, (f"peg{s}", "bias"), sd[f"{peg}.bias"])
        handled.update({f"{peg}.weight", f"{peg}.bias"})

        blk = re.compile(rf"blocks\.{s}\.(\d+)\.")
        n_blocks = 1 + max((int(m.group(1)) for k in sd
                            if (m := blk.match(k))), default=-1)
        for j in range(n_blocks):
            t = f"blocks.{s}.{j}"
            f = (f"block{s}_{j}",)
            _ln(params, sd, f"{t}.norm1", f + ("norm1",), handled)
            _ln(params, sd, f"{t}.norm2", f + ("norm2",), handled)
            a = f + ("attn",)
            if f"{t}.attn.qkv.weight" in sd:         # LSA (SVT even blocks)
                _dense(params, sd, f"{t}.attn.qkv", a + ("qkv",), handled)
            else:                                    # GSA
                _dense(params, sd, f"{t}.attn.q", a + ("q",), handled)
                _dense(params, sd, f"{t}.attn.kv", a + ("kv",), handled)
                if f"{t}.attn.sr.weight" in sd:
                    _set(params, a + ("sr", "kernel"),
                         sd[f"{t}.attn.sr.weight"].transpose(_CONV_T))
                    _set(params, a + ("sr", "bias"),
                         sd[f"{t}.attn.sr.bias"])
                    handled.update({f"{t}.attn.sr.weight",
                                    f"{t}.attn.sr.bias"})
                    _ln(params, sd, f"{t}.attn.norm", a + ("sr_norm",),
                        handled)
            _dense(params, sd, f"{t}.attn.proj", a + ("proj",), handled)
            _dense(params, sd, f"{t}.mlp.fc1", f + ("fc1",), handled)
            _dense(params, sd, f"{t}.mlp.fc2", f + ("fc2",), handled)

    leftovers = [k for k in sd if k not in handled
                 and not k.startswith("head")]
    return {"params": params}, leftovers


def converted_backbone_state(variables: Mapping[str, Any],
                             backbone: torch.nn.Module,
                             keep: Sequence[str] = ()
                             ) -> Dict[str, np.ndarray]:
    """A converted tree ({"params"[, "batch_stats"]}, as the converters
    above return it) as the state dict of the port's ``backbone`` (built
    from the same config), for ``backbone.load_state_dict(strict=True)``:
    ``mmseg_import.flax_to_torch_state`` with the backbone as the root,
    so each array goes to the port module named after its flax module, in
    that module's layout (conv kernels OIHW, dense kernels (out, in),
    norms' ``scale`` as ``weight``, batch statistics as the running
    ones).  Raises KeyError on an array it cannot place and on a
    parameter or buffer of ``backbone`` left unset.  ``keep``: regular
    expressions of the port names that a checkpoint lacks by design
    (official Swin's patch merging has no bias, ``merge\\d+\\.bias``;
    official Twins no per-stage output norms, ``out_norm\\d+\\..*``):
    those keep the backbone's own values, as a JAX caller merges the
    tree into its initial variables."""
    from .mmseg_import import flax_to_torch_state
    return flax_to_torch_state(variables, backbone, keep)
