"""The JAX package's Mask R-CNN variables -> a detectron2 state dict.

The inverse, key for key, of ``peanut_tpu.models.d2_import.
convert_d2_maskrcnn_state``: flax conv kernels HWIO -> OIHW, dense kernels
(in, out) -> (out, in), BN ``scale``/``bias`` + ``batch_stats`` -> the
frozen BN's ``weight``/``bias``/``running_mean``/``running_var``, and the
deconv kernel (kh, kw, in, out) -> (in, out, kh, kw) spatially flipped (lax
runs a transposed conv as a regular conv over a dilated input; torch
scatters with the unmirrored kernel).  The result loads into the port's
``MaskRCNN`` with ``load_d2_state``: it is how weights move between the two
packages.  Takes numpy arrays (or anything ``np.asarray`` reads); raises on
any variable it does not convert.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

import numpy as np

_CONV_T = (3, 2, 0, 1)   # HWIO -> OIHW


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def flax_to_d2_state(variables: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    flat = {("params",) + p: v
            for p, v in _flatten(variables.get("params", {}))}
    flat.update({("batch_stats",) + p: v
                 for p, v in _flatten(variables.get("batch_stats", {}))})
    sd: Dict[str, np.ndarray] = {}

    def take(col, path):
        return np.ascontiguousarray(np.asarray(flat.pop((col,) + path),
                                               np.float32))

    def conv(fpath, tkey, bias=False):
        sd[tkey + ".weight"] = np.ascontiguousarray(
            take("params", fpath + ("conv", "kernel")).transpose(_CONV_T))
        if bias:
            sd[tkey + ".bias"] = take("params", fpath + ("conv", "bias"))

    def frozen_bn(fpath, tkey):
        m = fpath + ("bn",)
        sd[tkey + ".weight"] = take("params", m + ("scale",))
        sd[tkey + ".bias"] = take("params", m + ("bias",))
        sd[tkey + ".running_mean"] = take("batch_stats", m + ("mean",))
        sd[tkey + ".running_var"] = take("batch_stats", m + ("var",))

    def dense(fpath, tkey):
        sd[tkey + ".weight"] = np.ascontiguousarray(
            take("params", fpath + ("kernel",)).T)
        sd[tkey + ".bias"] = take("params", fpath + ("bias",))

    conv(("backbone", "conv1"), "backbone.bottom_up.stem.conv1")
    frozen_bn(("backbone", "bn1"), "backbone.bottom_up.stem.conv1.norm")

    block_re = re.compile(r"layer(\d)_(\d+)$")
    blocks = sorted({p[2] for p in flat if p[:2] == ("params", "backbone")
                     and block_re.match(p[2])})
    for blk in blocks:
        m = block_re.match(blk)
        base = f"backbone.bottom_up.res{int(m.group(1)) + 1}.{m.group(2)}"
        fblk = ("backbone", blk)
        for i in (1, 2, 3):
            conv(fblk + (f"conv{i}",), f"{base}.conv{i}")
            frozen_bn(fblk + (f"bn{i}",), f"{base}.conv{i}.norm")
        if ("params",) + fblk + ("downsample_conv", "conv", "kernel") in flat:
            conv(fblk + ("downsample_conv",), f"{base}.shortcut")
            frozen_bn(fblk + ("downsample_bn",), f"{base}.shortcut.norm")

    for lvl in range(2, 6):
        conv(("fpn", f"lateral{lvl}"), f"backbone.fpn_lateral{lvl}", True)
        conv(("fpn", f"output{lvl}"), f"backbone.fpn_output{lvl}", True)

    conv(("rpn_head", "conv"), "proposal_generator.rpn_head.conv", True)
    conv(("rpn_head", "objectness"),
         "proposal_generator.rpn_head.objectness_logits", True)
    conv(("rpn_head", "deltas"),
         "proposal_generator.rpn_head.anchor_deltas", True)

    dense(("box_head", "fc1"), "roi_heads.box_head.fc1")
    dense(("box_head", "fc2"), "roi_heads.box_head.fc2")
    dense(("box_predictor", "cls_score"), "roi_heads.box_predictor.cls_score")
    dense(("box_predictor", "bbox_pred"), "roi_heads.box_predictor.bbox_pred")

    for i in range(1, 5):
        conv(("mask_head", f"mask_fcn{i}"), f"roi_heads.mask_head.mask_fcn{i}",
             True)
    dk = take("params", ("mask_head", "deconv", "kernel"))
    sd["roi_heads.mask_head.deconv.weight"] = np.ascontiguousarray(
        dk.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1])
    sd["roi_heads.mask_head.deconv.bias"] = take(
        "params", ("mask_head", "deconv", "bias"))
    conv(("mask_head", "predictor"), "roi_heads.mask_head.predictor", True)

    if flat:
        left = ["/".join(p) for p in list(flat)[:8]]
        raise KeyError(f"Unconverted flax variables: {left}")
    return sd
