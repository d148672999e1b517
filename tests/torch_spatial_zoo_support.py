"""Shared by the spatial axis's zoo tests (tests/test_torch_spatial_zoo*.py):
the ResNet families whose heads have row-sharded forms, their port models
carried from seeded JAX variables (random batch statistics, non-zero
gates; PSANet's made at each input size, which shapes its masks), and the
checks each file runs on its families."""

import copy
import dataclasses
import functools

import numpy as np
import pytest
import torch
from torch import nn

from peanut_tpu_torch.core import spatial
from peanut_tpu_torch.core.mesh import make_mesh, row_ranges
from peanut_tpu_torch.models.sharded import forward_rows

from torch_zoo_support import carry, family_config, jax_and_port, rel_err

# the families by what crosses the shards, each with the module types of
# models/sharded.py its config builds beyond the backbone's
CONVOLUTIONAL = {"upernet": ("UPerHead",),
                 "sem_fpn": ("FPN", "FPNHead"),
                 "deeplabv3": ("ASPPHead",),
                 "deeplabv3plus": ("DepthwiseSeparableASPPHead",),
                 "fastfcn": ("JPU", "PSPHead")}
POOLED = {"apcnet": ("APCHead",), "dmnet": ("DMHead",),
          "encnet": ("EncHead", "Encoding"), "ann": ("ANNHead",),
          "gcnet": ("GCHead",), "emanet": ("EMAHead",)}
ATTENTION = {"danet": ("DAHead", "PAM", "CAM"), "nonlocal_net": ("NLHead",),
             "dnlnet": ("DNLHead",), "ccnet": ("CCHead",)}
FAMILIES = {**CONVOLUTIONAL, **POOLED, **ATTENTION}
# the families whose config has the auxiliary head the train step needs
TRAINABLE = tuple(f for f in FAMILIES if f not in ("sem_fpn", "fastfcn"))
# the last five ResNet families: region and kernel heads (partial sums
# and softmaxes over all pixels), ISA's and PSA's sparse and pointwise
# attention, PointRend's cascade (the FPN neck, FPNHead, the point head's
# subdivision over every shard's cells)
LAST = {"ocrnet": ("OCRHead",), "knet": ("IterativeDecodeHead",),
        "isanet": ("ISAHead",), "psanet": ("PSAHead", "MaskConv"),
        "point_rend": ("CascadeEncoderDecoder", "FPN", "FPNHead",
                       "PointHead")}
# the hierarchical transformers (ROADMAP A14 part 3b, first half): the
# module types each builds (its heads and necks beyond SegFormerHead had
# sharded forms already); SVT and MiT-B2 have no config of their own and
# are written over the Twins and SegFormer configs (``WRITTEN``)
HIERARCHICAL = {
    "convnext": ("ConvNeXt", "ConvNeXtBlock", "UPerHead", "FCNHead"),
    "swin": ("SwinTransformer", "SwinBlock", "UPerHead"),
    "segformer": ("MixVisionTransformer", "MiTBlock", "EfficientAttention",
                  "MixFFN", "SegFormerHead"),
    "twins": ("PCPVT", "_TwinsBlock", "_SRAttention", "SameConv2d", "FPN",
              "FPNHead"),
    "svt": ("SVT", "_TwinsBlock", "_LocalAttention", "_SRAttention",
            "SameConv2d", "FPN", "FPNHead")}
# the plain-ViT families (part 3b, second half), each with the module
# types it builds; SETRUPHead, MultiLevelNeck and Feature2Pyramid have no
# config of their own and are written over the SETR config (``WRITTEN``),
# SETRMLAHead too, over MultiLevelNeck's taps of equal size; MLANeck,
# which takes taps of equal size and no backbone makes them, is held at
# module level (tests/test_torch_spatial_zoo_22.py), SETRMLAHead there too
PLAIN_VIT = {
    "vit": ("VisionTransformer", "ViTBlock", "UPerHead", "FCNHead"),
    "setr": ("VisionTransformer", "ViTBlock", "FCNHead"),
    "segmenter": ("VisionTransformer", "ViTBlock",
                  "SegmenterMaskTransformerHead"),
    "dpt": ("VisionTransformer", "ViTBlock", "DPTHead"),
    "beit": ("BEiT", "_BEiTBlock", "SameConv2d", "UPerHead"),
    "mae": ("MAE", "ViTBlock", "SameConv2d", "UPerHead"),
    "setr_up": ("VisionTransformer", "ViTBlock", "SETRUPHead"),
    "vit_mln": ("VisionTransformer", "ViTBlock", "MultiLevelNeck",
                "UPerHead"),
    "vit_f2p": ("VisionTransformer", "ViTBlock", "Feature2Pyramid",
                "UPerHead"),
    "setr_mla": ("VisionTransformer", "ViTBlock", "MultiLevelNeck",
                 "SETRMLAHead")}
TRANSFORMERS = {**HIERARCHICAL, **PLAIN_VIT}
# the light CNNs (part 3c), each with the module types of
# models/sharded_light.py its config builds; in the first half, the timm
# adapter, which has no config of its own, is written over the
# MobileNetV2 config (``WRITTEN``: ``timm_mv2``)
LIGHT_FIRST = {"mobilenet_v2": ("MobileNetV2", "InvertedResidual",
                                "PSPHead", "FCNHead"),
         "mobilenet_v3": ("MobileNetV3", "MBV3Block", "SELayer",
                          "LRASPPHead"),
         "resnest": ("ResNeSt", "ResNeStBottleneck", "SplitAttentionConv",
                     "PSPHead"),
         "hrnet": ("HRNet", "HRModule", "FCNHead"),
         "unet": ("UNet", "DoubleConv", "FCNHead"),
         "fastscnn": ("FastSCNN", "_DSConv", "InvertedResidual",
                      "DepthwiseSeparableFCNHead", "SepConvModule",
                      "FCNHead")}
# the light CNNs' second half (part 3c), the two-path real-time nets
TWO_PATH = {"bisenetv1": ("BiSeNetV1", "_ARM", "ZooResNet", "FCNHead"),
            "bisenetv2": ("BiSeNetV2", "_GELayer", "FCNHead"),
            "stdc": ("STDCContextPathNet", "STDCNet", "STDCModule", "_ARM",
                     "FCNHead", "STDCHead"),
            "cgnet": ("CGNet", "ContextGuidedBlock", "PReLU", "FCNHead"),
            "erfnet": ("ERFNet", "_Downsampler", "_NonBottleneck1d",
                       "FCNHead"),
            "icnet": ("ICNet", "ZooBottleneck", "ICNeck", "FCNHead")}
LIGHT = {**LIGHT_FIRST, **TWO_PATH}
# family: (the family whose config it is written over, its backbone (None:
# the config's), its decode head (a whole one where it names its type,
# else overrides of the config's), and its neck, if any); SVT at the
# Twins config's widths, two blocks a stage (a local and a global one),
# its windows of 7; over the SETR config's ViT (192 wide, 4 blocks, a
# tap after each): SETR's naive head on the 1x level, two convs each up
# 2x, UPerHead over MultiLevelNeck and over Feature2Pyramid, each
# rescaling the 4x .. 0.5x taps to 2x (downsampling 4x, upsampling 1x
# and 0.5x, the rounding where the grid is odd), and SETR's MLA head over
# MultiLevelNeck's (where the grid is even, taps of equal size);
# TIMMBackbone's MobileNetV2 under the MobileNetV2-d8 config's strides,
# dilations and taps (its variables under ``backbone/model/...``);
# HRNet-W18 with one module a stage and two blocks a branch (all four
# branches and every fusion path; the config's 4 and 3 modules in stages
# 3 and 4 make a GSPMD program that XLA compiles in ~140 s on one core,
# and, with the tests' random variables, logits of ~1.5e4, whose float32
# rounding alone moves a probability by ~1e-3: JAX's own GSPMD
# prediction is 1.1e-3 from its unsharded one at 256 x 128), for the
# comparison with JAX and the no-gathered-map checks
_UPER_32 = dict(type="UPerHead", in_channels=(32, 32, 32, 32),
                in_index=(0, 1, 2, 3), channels=32, num_classes=19,
                dropout_ratio=0.1, align_corners=False)
WRITTEN = {
    "svt": ("twins", dict(type="SVT", embed_dims=(16, 32, 64, 128),
                          num_heads=(1, 2, 4, 8), depths=(2, 2, 2, 2),
                          mlp_ratios=(2, 2, 2, 2)), {}),
    "mitb2": ("segformer", dict(type="MITB2"),
              dict(in_channels=(64, 128, 320, 512))),
    "setr_up": ("setr", None, dict(
        type="SETRUPHead", in_channels=192, channels=32, num_convs=2,
        up_scale=2, kernel_size=3, in_index=2, num_classes=19,
        dropout_ratio=0.1, align_corners=False)),
    "vit_mln": ("setr", None, _UPER_32, dict(
        type="MultiLevelNeck", out_channels=32, scales=(0.5, 1, 2, 4))),
    "vit_f2p": ("setr", None, dict(_UPER_32, in_channels=(192,) * 4), dict(
        type="Feature2Pyramid", embed_dim=192, rescales=(0.5, 1, 2, 4))),
    "setr_mla": ("setr", None, dict(
        type="SETRMLAHead", in_channels=(32, 32, 32, 32), channels=32,
        mla_channels=16, up_scale=2, in_index=(0, 1, 2, 3),
        num_classes=19, dropout_ratio=0.1, align_corners=False), dict(
        type="MultiLevelNeck", out_channels=32, scales=(0.5, 1, 2, 4))),
    "timm_mv2": ("mobilenet_v2", dict(
        type="TIMMBackbone", model_name="mobilenetv2_100", extra=dict(
            strides=(1, 2, 2, 2, 1, 1, 1), dilations=(1, 1, 1, 1, 1, 2, 4),
            out_indices=(1, 2, 4, 6))), {}),
    "hrnet_cut": ("hrnet", dict(type="HRNet", base_channels=18,
                                stage_modules=(1, 1, 1, 1),
                                stage_blocks=2), {})}
# the families whose variables are shaped by the input (PSAHead's masks,
# BEiT's relative-position table, MAE's positional embedding): their JAX
# variables are made at each input size
SIZED = ("psanet", "beit", "mae")
SHARDS = range(1, 9)
TOL = 1e-12
# (H, W) inputs: 128^2 leaves 16 rows at 1/8 (uneven over 3, 5, 6 and 7
# shards) and 4 at UPerNet's 1/32; 40 x 64 leaves 5 rows at 1/8 and 2 at
# 1/32, so 6 to 8 shards hold shards of no rows
SHAPES = {"128x128": (128, 128), "40x64": (40, 64)}


def cpus(k):
    return ["cpu"] * k


def port_model(family: str, hw=None):
    """The family's first config at the shrunk widths, the JAX model's
    seeded float64 variables carried into the port's model (eval mode):
    (config, JAX variables, port model).  Made at 64^2, or at ``hw`` for
    a family in ``SIZED``."""
    return _port_model(family, tuple(hw) if hw and family in SIZED
                       else (64, 64))


def zoo_config(family: str) -> dict:
    """``family_config`` of the family, or of the one a ``WRITTEN`` family
    is written over, with its backbone and decode head."""
    if family not in WRITTEN:
        return family_config(family)
    base, backbone, head, *neck = WRITTEN[family]
    cfg = family_config(base)
    if backbone is not None:
        cfg["backbone"] = dict(backbone)
    cfg["decode_head"] = (dict(head) if "type" in head
                          else dict(cfg["decode_head"], **head))
    if neck:
        cfg["neck"] = dict(neck[0])
    return cfg


@functools.lru_cache(maxsize=None)
def _port_model(family: str, hw):
    cfg = zoo_config(family)
    _, variables, model, _ = jax_and_port(cfg, hw)
    return cfg, variables, model


def image(hw):
    """A seeded (1, 3, H, W) float64 image."""
    g = torch.Generator().manual_seed(0)
    return torch.rand((1, 3) + tuple(hw), generator=g, dtype=torch.float64)


def check_forward_rows(family: str, hw) -> None:
    """The port's ``forward_rows`` over ``["cpu"] * k`` for k = 1 ... 8
    against its unsharded ``model(x)`` in float64, eval mode: within
    ``TOL`` of the largest |logit|, the logits split as the input is."""
    _, _, model = port_model(family, hw)
    x = image(hw)
    with torch.no_grad():
        want = model(x, train=False)
        for k in SHARDS:
            got = forward_rows(model, spatial.shard(x, cpus(k)), train=False)
            assert [b.shape[2] for b in got.blocks] == \
                [e - s for s, e in row_ranges(hw[0], k)]
            assert rel_err(spatial.gather(got).numpy(),
                           want.numpy()) <= TOL, k


@functools.lru_cache(maxsize=None)
def train_variables(family: str):
    """The family's config for the train step (PEANUT's 14 channels in, 6
    classes, the heads' dropout 0) and the JAX model's seeded float64
    variables: (config, variables)."""
    cfg, _, _ = port_model(family)
    cfg = dict(cfg, backbone=dict(cfg["backbone"], in_channels=14))
    for head in ("decode_head", "auxiliary_head"):
        cfg[head] = dict(cfg[head], num_classes=6, dropout_ratio=0.0)
    _, variables, _, _ = jax_and_port(cfg, (64, 64),
                                      jax_cfg=jax_config(family, cfg))
    return cfg, variables


def jax_config(family: str, cfg: dict) -> dict:
    """``cfg`` as the JAX package builds it: a backbone without
    ``in_channels`` where flax infers it from the input (the
    transformers', MobileNetV2's, Fast-SCNN's)."""
    import peanut_tpu.models  # noqa: F401  (registers the backbones)
    from peanut_tpu.registry import BACKBONES as JBACKBONES
    fields = JBACKBONES.get(cfg["backbone"]["type"]).__dataclass_fields__
    if family not in TRANSFORMERS and "in_channels" in fields:
        return cfg
    return dict(cfg, backbone={k: v for k, v in cfg["backbone"].items()
                               if k != "in_channels"})


def train_model(family: str, dropout: float = 0.0) -> nn.Module:
    """A fresh port model carrying ``train_variables``, its heads'
    dropout at ``dropout``."""
    from peanut_tpu_torch.models.builder import build_segmentor
    cfg, variables = train_variables(family)
    model = carry(variables, build_segmentor(cfg))
    for head in (model.decode_head, model.auxiliary_head):
        head.dropout_ratio = dropout
    return model


def train_batch(b=2, hw=(64, 64), seed=5):
    rng = np.random.RandomState(seed)
    return {"img": rng.rand(b, *hw, 14),
            "gt": (rng.rand(b, *hw, 6) > 0.9) * 255.0}


def nchw(batch):
    return {k: torch.as_tensor(np.ascontiguousarray(v.transpose(0, 3, 1, 2)))
            for k, v in batch.items()}


def check_train_grads(family: str, k: int) -> None:
    """One ``loss_and_grads`` in train mode (batch statistics, the heads'
    dropout 0.1 from one generator), float64, batch 2 at 64^2 with
    PEANUT's 14 channels and 6 classes, sharded over ``["cpu"] * k``
    against unsharded: losses within 1e-12 relative, every gradient
    within 1e-9 of its tensor's largest |value| plus 1e-12 of the model's
    largest (a bias before a softmax has a gradient of rounding alone),
    the running statistics within 1e-12 of the largest."""
    from peanut_tpu_torch.prediction.train import (TrainConfig,
                                                   create_train_state,
                                                   loss_and_grads)
    batch = nchw(train_batch())
    tcfg = TrainConfig(lr=1e-3, max_iters=50, seed=3)
    runs = []
    for devices in (None, cpus(k)):
        state = create_train_state(train_model(family, 0.1), tcfg,
                                   device="cpu")
        state.step = 2
        losses = loss_and_grads(state, batch, tcfg, devices)
        runs.append(({n: float(v) for n, v in losses.items()},
                     {n: p.grad for n, p in state.model.named_parameters()},
                     {n: v for n, v in state.model.state_dict().items()
                      if "running" in n}))
    (want_l, want_g, want_s), (got_l, got_g, got_s) = runs
    for name, v in want_l.items():
        assert got_l[name] == pytest.approx(v, rel=1e-12), name
    assert_grads_close(got_g, want_g)
    top = max(float(s.abs().max()) for s in want_s.values())
    for name, w in want_s.items():
        assert float((got_s[name] - w).abs().max()) <= 1e-12 * top, name


# where the JAX package's GSPMD prediction over the 8 virtual CPU devices
# is not its own unsharded prediction (the transformers' levels of fewer
# rows than devices: apart by 0.04 to 0.15 in probability; ROADMAP queue
# C's reference-side differences, read with the jax below, cause not
# isolated): there the port's sharded prediction is held to JAX's
# unsharded one
JAX_GSPMD_APART = {("convnext", (128, 128)), ("segformer", (128, 128)),
                   ("segformer", (120, 96)), ("svt", (128, 128)),
                   ("svt", (120, 96)), ("twins", (128, 128)),
                   ("twins", (120, 96))}
JAX_GSPMD_APART_READ_ON = "0.9.0"


def assert_grads_close(got_g: dict, want_g: dict) -> None:
    """``check_train_grads``' bounds: the same parameters without a
    gradient (EncHead's SE-loss classifier is in no output), every other
    gradient within 1e-9 of its tensor's largest |value| plus 1e-12 of
    the model's largest (a bias before a softmax has a gradient of
    rounding alone)."""
    assert {n for n, g in got_g.items() if g is None} == \
        {n for n, g in want_g.items() if g is None}
    want_g = {n: g for n, g in want_g.items() if g is not None}
    top = max(float(g.abs().max()) for g in want_g.values())
    for name, w in want_g.items():
        err = float((got_g[name] - w).abs().max())
        assert err <= 1e-9 * float(w.abs().max()) + 1e-12 * top, name


def check_train_mode_grads(family: str, k: int, batch: int = 2,
                           tol: float = TOL) -> None:
    """``forward_rows(train=True)`` of the family's model (batch
    statistics, its heads' dropout 0.1 from one seeded generator),
    float64, ``batch`` (2) at 64^2, over ``["cpu"] * k`` against the
    unsharded ``model(x, train=True)``: the logits within ``tol``
    (``TOL``) of their largest, and the gradients of one seeded weighted
    sum of them within ``assert_grads_close``' bounds."""
    _, _, model = port_model(family)
    x = torch.rand((batch, 3, 64, 64),
                   generator=torch.Generator().manual_seed(4),
                   dtype=torch.float64)
    runs = []
    for devices in (None, cpus(k)):
        m = copy.deepcopy(model)
        gen = torch.Generator().manual_seed(6)
        if devices is None:
            logits = m(x, train=True, generator=gen)
        else:
            logits = spatial.gather(forward_rows(
                m, spatial.shard(x, devices), train=True, generator=gen))
        if not runs:
            weights = torch.randn(logits.shape, dtype=logits.dtype,
                                  generator=torch.Generator().manual_seed(5))
        (logits * weights).sum().backward()
        runs.append((logits.detach(),
                     {n: p.grad for n, p in m.named_parameters()}))
    (want, want_g), (got, got_g) = runs
    assert rel_err(got.numpy(), want.numpy()) <= tol
    assert_grads_close(got_g, want_g)


def backbone_rows_seen(family: str, k: int, hw) -> tuple:
    """The pixels (``F.conv2d``) or tokens (``F.linear``) each
    ``nn.Conv2d`` and ``nn.Linear`` of the family's backbone, and of a
    SegFormerHead, receives in each call, however it is called: in the
    unsharded forward and in the forward over ``["cpu"] * k`` (the
    backbone alone, ``sharded.run``, or the whole ``forward_rows`` with a
    SegFormerHead).  Two dicts, module name -> counts."""
    import torch.nn.functional as F

    from peanut_tpu_torch.models import sharded
    from peanut_tpu_torch.models.heads import SegFormerHead
    _, _, model = port_model(family, hw)
    whole = isinstance(model.decode_head, SegFormerHead)
    parts = {"backbone": model.backbone}
    if whole:
        parts["decode_head"] = model.decode_head
    names = {id(m.weight): f"{p}.{n}" for p, part in parts.items()
             for n, m in part.named_modules()
             if isinstance(m, (nn.Conv2d, nn.Linear))}
    x = image(hw)
    runs = []
    for k_run in (None, k):
        seen = {}

        def counting(fn, channels):
            def call(inp, weight, *args, **kw):
                if id(weight) in names:
                    seen.setdefault(names[id(weight)], []).append(
                        inp.numel() // inp.shape[channels])
                return fn(inp, weight, *args, **kw)
            return call

        conv2d, linear = F.conv2d, F.linear
        F.conv2d, F.linear = counting(conv2d, 1), counting(linear, -1)
        try:
            with torch.no_grad():
                if k_run is None:
                    model(x) if whole else model.backbone(x)
                elif whole:
                    forward_rows(model, spatial.shard(x, cpus(k)),
                                 train=False)
                else:
                    sharded.run(model.backbone, spatial.shard(x, cpus(k)),
                                sharded._Context(torch.device("cpu"), None))
        finally:
            F.conv2d, F.linear = conv2d, linear
        runs.append(seen)
    assert set(runs[0]) == set(runs[1]) == set(names.values())
    return runs[0], runs[1]


def global_modules(backbone: nn.Module) -> set:
    """The names (as ``backbone_rows_seen`` gives them) of the backbone's
    convolutions and dense layers that take a global pooled map: the
    squeeze-excitation gates' and split attention's ``fc1`` / ``fc2``
    (the global mean), Fast-SCNN's pyramid pool (``ppm{i}``), the
    attention refinement's ``gate`` and the context fusion's ``gap_conv``,
    ``ffm_fc1`` and ``ffm_fc2`` (BiSeNetV1, STDC), BiSeNetV2's context
    embedding ``ce_conv`` and CGNet's global-context ``fc1`` / ``fc2``."""
    from peanut_tpu_torch.models.backbones_zoo import (
        BiSeNetV2, ContextGuidedBlock, FastSCNN, SELayer, SplitAttentionConv,
        _ARM, _ContextFusion)
    names = set()
    for prefix, m in backbone.named_modules():
        if isinstance(m, (SELayer, SplitAttentionConv, ContextGuidedBlock)):
            subs = ("fc1", "fc2")
        elif isinstance(m, FastSCNN):
            subs = tuple(f"ppm{i}" for i in range(len(m.pool_scales)))
        elif isinstance(m, _ARM):
            subs = ("gate",)
        elif isinstance(m, _ContextFusion):
            subs = ("gap_conv", "ffm_fc1", "ffm_fc2")
        elif isinstance(m, BiSeNetV2):
            subs = ("ce_conv",)
        else:
            continue
        for sub in subs:
            names |= {".".join(p for p in ("backbone", prefix, sub, n) if p)
                      for n, c in getattr(m, sub).named_modules()
                      if isinstance(c, (nn.Conv2d, nn.Linear))}
    return names


def check_no_gathered_backbone(family: str, k: int = 8,
                               hw=(896, 32)) -> None:
    """No ``nn.Conv2d`` or ``nn.Linear`` of the backbone (or of a
    SegFormerHead) receives a whole level's map in ``forward_rows`` over
    k shards: each of its calls gets fewer pixels or tokens than its call
    in the unsharded forward.  At 896 x 32 over 8 shards a shard's rows
    with their halo or window bands (Swin's wrapped band included) are
    fewer than every level's rows, down to the 28 of 1/32, so a shard
    that gathered a map (the rows before a reduction, the keys' or
    values' projections, a band of the whole height) would show.  A
    convolution of a global pooled map (``global_modules``) gets the same
    pooled map, once, as in the unsharded forward: at most 6 x 6
    pixels."""
    full, parts = backbone_rows_seen(family, k, hw)
    pooled = global_modules(port_model(family, hw)[2].backbone)
    for name, counts in full.items():
        if name in pooled:
            assert parts[name] == counts and max(counts) <= 36, (
                name, parts[name], counts)
        else:
            assert max(parts[name]) < min(counts), (name, parts[name],
                                                    counts)


def check_against_jax(family: str,
                      sizes=((128, 128), (120, 96))) -> None:
    """JAX's ``PredictionModel(model_cfg=...).get_prediction_sharded`` over
    the 8 virtual CPU devices (GSPMD's exchanges) against the port's
    ``get_prediction_sharded`` over ``["cpu"] * 8``, float32, from the same
    variables, at 128^2 and 120 x 96 (uneven rows): within 1e-4
    (tests/test_torch_spatial_2.py's bar; the port's float32 sharded
    prediction is up to ~1.3e-5 from its unsharded one, the float64
    checks hold the port to 1e-12).  At the sizes of
    ``JAX_GSPMD_APART`` the port is held to JAX's unsharded
    ``get_prediction``; with the jax the gap was read on, JAX's GSPMD
    prediction must still lie more than 1e-4 from that one (else the
    list is stale), with another it is only reported.  ``sizes``: the
    (H, W) inputs."""
    import jax

    from peanut_tpu.config import NavConfig as JNavConfig
    from peanut_tpu.core.mesh import make_mesh as jmake_mesh
    from peanut_tpu.prediction import PredictionModel as JPrediction
    from peanut_tpu_torch.config import NavConfig
    from peanut_tpu_torch.prediction import PredictionModel

    assert len(jax.devices()) == 8
    jcfg = JNavConfig()
    for hw in sizes:
        cfg, variables, model = port_model(family, hw)
        jpm = JPrediction(jcfg, variables=variables, model_cfg=cfg)
        pm = PredictionModel(NavConfig(**dataclasses.asdict(jcfg)),
                             model=copy.deepcopy(model), device="cpu")
        classes = model.num_classes
        full_map = np.random.RandomState(1).rand(3, *hw).astype(np.float32)
        want = jpm.get_prediction_sharded(full_map,
                                          jmake_mesh({"spatial": 8}))
        got = pm.get_prediction_sharded(full_map,
                                        make_mesh({"spatial": 8}, cpus(8)))
        assert got.shape == want.shape == (classes,) + hw
        assert got.dtype == np.float32
        if (family, hw) in JAX_GSPMD_APART:
            plain = jpm.get_prediction(full_map)
            gap = float(np.abs(want - plain).max())
            print(f"{family} {hw}: JAX's GSPMD prediction {gap:.3g} from "
                  f"its unsharded one (jax {jax.__version__})")
            assert gap > 1e-4 or jax.__version__ != JAX_GSPMD_APART_READ_ON, (
                f"{family} {hw}: JAX's GSPMD prediction now agrees with its "
                f"unsharded one; take it from JAX_GSPMD_APART and ROADMAP C")
            want = plain
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
        if family == "point_rend":
            check_point_cells(jpm, pm, full_map)


def jax_gspmd_levels(family: str, hw) -> list:
    """Of each backbone level of the family's JAX model (the CPU tests'
    widths, float32), the largest gap between its GSPMD program over the
    8 virtual CPU devices, the input's height sharded as
    ``get_prediction_sharded`` shards it, and its unsharded program, over
    the level's largest |value|: where ``JAX_GSPMD_APART``'s gaps begin
    (ROADMAP C).  Not a test: a reading, e.g.
    ``python -c "import sys; sys.path[:0] = ['tests']; import conftest,
    torch_spatial_zoo_support as s; print(s.jax_gspmd_levels('convnext',
    (128, 128)))"``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from peanut_tpu.config import NavConfig as JNavConfig
    from peanut_tpu.core.mesh import make_mesh as jmake_mesh
    from peanut_tpu.prediction import PredictionModel as JPrediction

    cfg, variables, _ = port_model(family, hw)
    jpm = JPrediction(JNavConfig(), variables=variables, model_cfg=cfg)
    x = np.random.RandomState(1).rand(3, *hw).astype(np.float32)
    x = np.transpose(x[None], (0, 2, 3, 1))     # check_against_jax's map
    v = jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), variables)
    f = jax.jit(lambda v, x: jpm.model.apply(
        v, x, method=lambda m, x: m.extract_feat(x)))
    mesh = jmake_mesh({"spatial": 8})
    want = f(v, x)
    with mesh:
        got = f(v, jax.device_put(x, NamedSharding(
            mesh, P(None, "spatial", None, None))))
    return [float(jnp.abs(a - b).max() / jnp.abs(a).max())
            for a, b in zip(want, got)]


# PointRend's float32 near-ties: two cells whose uncertainties lie this
# close (of the round's largest |uncertainty|) may come in either order,
# or one for the other at the last place, as the two sides round them
POINT_TIE = 1e-5


def check_point_cells(jpm, pm, full_map) -> None:
    """PointRend's cells chosen in each subdivision round, in order: the
    port's over ``["cpu"] * 8`` (``forward_rows``'s trace) against those
    of the JAX package's inference under jit over the 8 virtual devices,
    its input sharded as ``get_prediction_sharded`` shards it (read back
    from the points its point head is given).  In float32 the two sides
    round each uncertainty apart (and the JAX package's sharded and
    unsharded runs do so between themselves), so where the cells differ
    at a place their uncertainties, as the JAX side computed them, must
    be within ``POINT_TIE`` of the largest: a near-tie in either order
    (ROADMAP queue C), never another cell."""
    import jax
    import jax.numpy as jnp
    from flax import linen as jnn
    from jax.sharding import NamedSharding, PartitionSpec as P

    from peanut_tpu.core.mesh import make_mesh as jmake_mesh
    from peanut_tpu.models.heads_zoo import PointHead as JPointHead

    def cells(variables, x):
        rounds = []

        def catch(call, args, kwargs, context):
            if (isinstance(context.module, JPointHead)
                    and context.method_name == "__call__"):
                rounds.append((args[2], JPointHead.uncertainty(args[1])))
            return call(*args, **kwargs)

        with jnn.intercept_methods(catch):
            jpm.model.apply(variables, jnp.transpose(x, (0, 2, 3, 1)),
                            method=jpm.model.inference)
        return rounds

    mesh = jmake_mesh({"spatial": 8})
    x = jax.device_put(jnp.asarray(full_map)[None],
                       NamedSharding(mesh, P(None, None, "spatial", None)))
    with mesh:
        rounds = jax.jit(cells)(jpm.variables, x)
    trace = {}
    with torch.no_grad():
        forward_rows(pm.model, spatial.shard(torch.as_tensor(
            full_map[None]).to(pm.dtype), cpus(8)), train=False,
            trace=trace)
    assert len(rounds) == len(trace["point_cells"]) > 0
    for (pts, unc), got in zip(rounds, trace["point_cells"]):
        h2, w2 = unc.shape[1:]
        pts = np.asarray(pts, np.float64)
        want = (np.rint(pts[..., 1] * h2 - 0.5) * w2
                + np.rint(pts[..., 0] * w2 - 0.5)).astype(np.int64)
        got = got.numpy()
        unc = np.asarray(unc, np.float64).reshape(unc.shape[0], -1)
        apart = got != want
        gaps = np.abs(np.take_along_axis(unc, got, 1)
                      - np.take_along_axis(unc, want, 1))
        assert gaps[apart].max(initial=0.0) <= POINT_TIE * np.abs(unc).max(), (
            int(apart.sum()), gaps[apart])


def gathered_inputs(model: nn.Module, run, hw) -> list:
    """The inputs of full-map size that the ``nn.Conv2d`` and ``nn.Linear``
    modules of ``model``'s neck and heads receive through their own
    forward while ``run()`` runs: a (B, C, h, w) map of a level's full
    height and width, or (B, h * w, C) tokens of one.  A pooled map, a
    global vector and a shard's block are none; a sharded convolution
    calls no module's forward."""
    from peanut_tpu_torch.models.heads_zoo import ISAHead, MaskConv
    with torch.no_grad():
        levels = model.backbone(image(hw))
        if model.neck is not None:
            levels = list(levels) + list(model.neck(levels))
    sizes = {tuple(f.shape[-2:]) for f in levels}
    # a level's tokens, also as ISAHead pads them to its down factor,
    # whether in one batch or in groups of tokens
    pads = {m.down_factor for m in model.modules()
            if isinstance(m, ISAHead)}
    tokens = {h * w for h, w in sizes} | {
        -(-h // ph) * ph * -(-w // pw) * pw
        for h, w in sizes for ph, pw in pads}
    seen = []

    def hook(mod, args):
        t = args[0]
        full = (t.dim() == 4 and tuple(t.shape[-2:]) in sizes) or (
            t.dim() == 3 and t.shape[0] * t.shape[1] in tokens)
        if full:
            seen.append((type(mod).__name__, tuple(t.shape)))

    heads = (model.heads() if hasattr(model, "heads")
             else [model.decode_head])
    parts = [m for m in (model.neck, *heads, model.auxiliary_head)
             if m is not None]
    handles = [m.register_forward_pre_hook(hook) for part in parts
               for m in part.modules()
               if isinstance(m, (nn.Conv2d, nn.Linear, MaskConv))]
    try:
        with torch.no_grad():
            run()
    finally:
        for h in handles:
            h.remove()
    return seen


def check_no_gathered_head(family: str, k: int = 2, model=None) -> None:
    """No module of the neck or the heads gets a full-height map in
    ``forward_rows`` over k shards; the unsharded forward, where every
    one does, shows that the hooks see such maps.  ``model``: another
    than the family's."""
    hw = (96, 128)
    if model is None:
        _, _, model = port_model(family, hw)
    x = image(hw)
    assert gathered_inputs(model, lambda: model(x), hw)
    assert gathered_inputs(model, lambda: forward_rows(
        model, spatial.shard(x, cpus(k)), train=False), hw) == []


def check_train_step_against_jax(family: str, k: int, hw=(64, 64)) -> None:
    """One train step of the family (``train_variables``: 14 channels in,
    6 classes, dropout 0, the auxiliary FCNHead) in float64 on both sides,
    batch 2 at ``hw`` (64^2), its height over k shards: JAX's GSPMD step
    (``make_train_step(mesh={"data": 1, "spatial": k}, spatial_axis=
    "spatial")`` over k of the virtual CPU devices) against the port's
    ``make_train_step(spatial_axis="spatial", mesh=make_mesh({"spatial":
    k}, ["cpu"] * k))``, both with plain SGD at rate 1 (the update is the
    gradient; Adam's first update is lr x sign(g), which a rounding flips
    where g is near 0): the losses within 1e-9 relative, every gradient
    within 1e-9 of the largest |gradient|, the batch statistics after the
    step within 1e-9 of the largest statistic."""
    import jax
    import jax.numpy as jnp
    import optax

    from peanut_tpu.core.mesh import make_mesh as jmake_mesh
    from peanut_tpu.models import build_segmentor as jbuild
    from peanut_tpu.prediction.train import TrainConfig as JTrainConfig
    from peanut_tpu.prediction.train import create_train_state as jcreate
    from peanut_tpu.prediction.train import make_train_step as jmake_step
    from peanut_tpu_torch.models.mmseg_import import flax_to_torch_state
    from peanut_tpu_torch.prediction.train import (TrainConfig,
                                                   create_train_state,
                                                   make_train_step)
    cfg, variables = train_variables(family)
    data = train_batch(hw=hw)
    mesh = jmake_mesh({"data": 1, "spatial": k}, devices=jax.devices()[:k])
    with jax.enable_x64(True):
        jmodel = jbuild(jax_config(family, cfg))
        state, tx = jcreate(jmodel, jax.tree.map(jnp.asarray, variables),
                            JTrainConfig(batch_size=2), tx=optax.sgd(1.0))
        with mesh:
            step, _ = jmake_step(jmodel, JTrainConfig(batch_size=2), tx,
                                 mesh=mesh, spatial_axis="spatial")
            state, metrics = step(state, {n: jnp.asarray(v)
                                          for n, v in data.items()})
        want_l = {n: float(v) for n, v in metrics.items()}
        grads = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b),
                             variables["params"], state.params)
        stats = jax.tree.map(np.asarray, state.batch_stats)

    model = train_model(family)
    tcfg = TrainConfig(lr=1.0, min_lr=1.0, max_iters=50)
    port = create_train_state(model, tcfg, device="cpu")
    port.optimizer = torch.optim.SGD(model.parameters(), lr=1.0)
    got_l = make_train_step(tcfg, spatial_axis="spatial",
                            mesh=make_mesh({"spatial": k}, cpus(k)))(
        port, nchw(data))
    for name, v in want_l.items():
        assert float(got_l[name]) == pytest.approx(v, rel=1e-9), name
    want = flax_to_torch_state({"params": grads, "batch_stats": stats},
                               model)
    params = dict(model.named_parameters())
    top = max(np.abs(want[n]).max() for n in params)
    for name, p in params.items():
        np.testing.assert_allclose(p.grad.numpy(), want[name], rtol=0,
                                   atol=1e-9 * top, err_msg=name)
    sd = model.state_dict()
    running = [n for n in want if n.endswith(("running_mean",
                                              "running_var"))]
    top = max(np.abs(want[n]).max() for n in running)
    for name in running:
        np.testing.assert_allclose(sd[name].numpy(), want[name], rtol=0,
                                   atol=1e-9 * top, err_msg=name)


def ocr_cascade_config() -> dict:
    """mmseg's OCRNet at the shrunk widths: a ``CascadeEncoderDecoder`` of
    an FCNHead on the 1/8 level before the last, whose logits are the
    OCRHead's soft regions."""
    cfg = family_config("ocrnet")
    ocr = cfg["decode_head"]
    fcn = dict(type="FCNHead", in_channels=ocr["in_channels"] // 2,
               in_index=2, channels=ocr["channels"] // 2, num_convs=1,
               concat_input=False, num_classes=ocr["num_classes"],
               dropout_ratio=0.1, align_corners=False)
    cfg.update(type="CascadeEncoderDecoder", num_stages=2,
               decode_head=[fcn, ocr])
    cfg.pop("auxiliary_head", None)
    return cfg


def check_point_rend_train(k: int) -> None:
    """PointRend in train mode (batch statistics), float64, batch 2 at
    64^2, over ``["cpu"] * k`` against unsharded: the stage's logits and
    the point pass's logits within ``TOL`` of their largest, its points
    equal, and the gradients of a seeded sum of both within 1e-9 of each
    tensor's largest |value| plus 1e-12 of the model's largest."""
    _, _, model = port_model("point_rend")
    g = torch.Generator().manual_seed(4)
    x = torch.rand((2, 3, 64, 64), generator=g, dtype=torch.float64)
    runs = []
    for devices in (None, cpus(k)):
        m = copy.deepcopy(model)
        if devices is None:
            logits, points = m(x, train=True, with_points=True)
        else:
            logits, points = forward_rows(m, spatial.shard(x, devices),
                                          train=True, with_points=True)
            logits = spatial.gather(logits)
        if not runs:
            gl = torch.Generator().manual_seed(5)
            weights = [torch.randn(t.shape, generator=gl, dtype=t.dtype)
                       for t in (logits, points["point_logits"])]
        ((logits * weights[0]).sum()
         + (points["point_logits"] * weights[1]).sum()).backward()
        runs.append((logits.detach(), points,
                     {n: p.grad for n, p in m.named_parameters()}))
    (want, want_p, want_g), (got, got_p, got_g) = runs
    assert rel_err(got.numpy(), want.numpy()) <= TOL
    assert torch.equal(got_p["points"], want_p["points"])
    assert rel_err(got_p["point_logits"].detach().numpy(),
                   want_p["point_logits"].detach().numpy()) <= TOL
    assert_grads_close(got_g, want_g)
