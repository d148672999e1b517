"""The zoo's ResNet backbones of the port (``models/resnet.py``: the
registered ``ResNet``, ``ResNetV1c`` and ``ResNeXt``) against the JAX
package's, on the CPU, in float64 on both sides: every stage within 1e-9
of its largest |value|.

* ``ResNet`` at depths 18 and 34 (BasicBlock), with the 7x7 stem and the
  deep one, at depth 50 in the caffe style (the stride on the first
  1x1), ``ResNetV1c`` at depth 18 with dilated stages, and ``ResNeXt``
  (groups 32, base width 4) at narrow widths; each through
  ``flax_to_torch_state``'s mmseg rule, as a segmentor's ``backbone``.
* ``norm_eval``: in a train-mode forward the batch norms keep their
  running statistics and use them, as the JAX package's; without it they
  take the batch's and update them, as the JAX package's.
* BiSeNetV1, whose nested ResNet-18 (``context_backbone``) takes its
  variables through ``flax_to_torch_state``.
* PEANUT's prediction net (``peanut_prediction_config()``) keeps its
  state dict's names and shapes and its forward bit for bit: the former
  against their digest before the zoo's ResNet took these keys, the
  latter against that ResNetV1c's code, kept below.
"""

import hashlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

import jax

import peanut_tpu.models  # noqa: F401  (registers the JAX zoo)
from peanut_tpu.models import backbones_zoo as jbz
from peanut_tpu.registry import BACKBONES as JBACKBONES
import peanut_tpu_torch.models.builder  # noqa: F401  (registers the zoo)
from peanut_tpu_torch.models.builder import (build_segmentor,
                                             peanut_prediction_config)
from peanut_tpu_torch.models.layers import BatchNorm
from peanut_tpu_torch.registry import BACKBONES

from torch_zoo_support import (carried_module, carry, jax64,
                               random_variables, randomize, rel_err)
from torch_zoo_support import one_thread  # noqa: F401  (autouse)

TOL = 1e-9


def _nchw(a):
    return torch.as_tensor(a).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def _close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float64
        assert rel_err(g, w) <= TOL


def _backbone_pair(kind, kw, x, seed=2):
    """The JAX backbone ``kind`` and the port's, the port's carrying the
    former's seeded float64 variables as a segmentor's ``backbone`` (the
    mmseg names)."""
    jmod = JBACKBONES.get(kind)(**kw)
    tmod = BACKBONES.build(dict(kw, type=kind))
    v = random_variables(lambda: jmod.init(
        {"params": jax.random.PRNGKey(0)}, np.float32(x)))
    v = randomize(v, np.random.RandomState(seed), np.float64)
    holder = nn.Module()
    holder.add_module("backbone", tmod)
    carry({c: {"backbone": t} for c, t in v.items()}, holder)
    return jmod, tmod, v


RESNETS = {
    "resnet18": ("ResNet", dict(depth=18, stem_channels=8,
                                base_channels=8)),
    "resnet18_deep_stem": ("ResNet", dict(depth=18, stem_channels=8,
                                          base_channels=8, deep_stem=True)),
    "resnet34": ("ResNet", dict(depth=34, stem_channels=8, base_channels=4,
                                out_indices=(1, 3))),
    "resnet50_caffe": ("ResNet", dict(depth=50, stem_channels=8,
                                      base_channels=4, style="caffe")),
    "resnetv1c18_dilated": ("ResNetV1c", dict(
        depth=18, stem_channels=8, base_channels=8, strides=(1, 2, 1, 1),
        dilations=(1, 1, 2, 4), contract_dilation=True, avg_down=True,
        pretrained="unused")),
    "resnext50_32x4d": ("ResNeXt", dict(depth=50, stem_channels=16,
                                        base_channels=16)),
}


@pytest.mark.parametrize("name", sorted(RESNETS))
def test_zoo_resnet_matches_jax(name):
    kind, kw = RESNETS[name]
    x = np.random.RandomState(3).rand(2, 40, 56, 3)
    jmod, tmod, v = _backbone_pair(kind, kw, x)
    with torch.no_grad():
        got = [_nhwc(t) for t in tmod(_nchw(x))]
    _close(got, jax64(jmod, v, x))
    assert [g.shape[-1] for g in got] == list(tmod.out_channels)
    if kind == "ResNeXt":      # int(planes * 4 / 64) * 32 wide 3x3s
        assert tmod.layer1[0].conv2.groups == 32
        assert tmod.layer1[0].conv2.weight.shape == (32, 1, 3, 3)


@pytest.mark.parametrize("norm_eval", [True, False])
def test_norm_eval_keeps_batch_norms_in_eval_mode(norm_eval):
    kw = dict(depth=18, stem_channels=8, base_channels=8,
              norm_eval=norm_eval)
    x = np.random.RandomState(4).rand(2, 32, 40, 3)
    jmod, tmod, v = _backbone_pair("ResNet", kw, x)
    with jax.enable_x64(True):
        want, new = jax.jit(lambda v, x: jmod.apply(
            v, x, train=True, mutable=["batch_stats"]))(v, x)
    want = [np.asarray(w) for w in want]
    before = {k: b.clone() for k, b in tmod.named_buffers()}
    tmod.train()
    assert tmod.training
    assert all(not m.training for m in tmod.modules()
               if isinstance(m, BatchNorm)) == norm_eval
    with torch.no_grad():
        got = [_nhwc(t) for t in tmod(_nchw(x))]
    _close(got, want)
    after = dict(tmod.named_buffers())
    moved = [k for k in before if not torch.equal(before[k], after[k])]
    assert (moved == []) == norm_eval
    want_var = np.asarray(new["batch_stats"]["layer1_0"]["bn1"]["bn"]["var"])
    np.testing.assert_allclose(after["layer1.0.bn1.running_var"].numpy(),
                               want_var, rtol=1e-12)


def test_bisenetv1_nested_resnet18_carries():
    kw = dict(backbone_cfg=dict(type="ResNet", depth=18, base_channels=8,
                                stem_channels=8),
              spatial_channels=(8, 8, 8, 16), context_channels=(16, 32, 64),
              out_channels=32)
    jmod = jbz.BiSeNetV1(**kw)
    tmod = BACKBONES.build(dict(kw, type="BiSeNetV1"))
    x = np.random.RandomState(5).rand(1, 64, 96, 3)
    v = carried_module(jmod, tmod, x)
    # the flax path runs through the nested ResNet's blocks ...
    block = v["params"]["context_backbone"]["layer2_0"]
    assert set(block) >= {"conv1", "bn1", "downsample_conv", "downsample_bn"}
    # ... into the port's mmseg names under context_backbone
    w = tmod.context_backbone.layer2[0].downsample[0].weight
    np.testing.assert_array_equal(
        w.detach().numpy(),
        block["downsample_conv"]["conv"]["kernel"].transpose(3, 2, 0, 1))
    with torch.no_grad():
        got = [_nhwc(t) for t in tmod(_nchw(x))]
    _close(got, jax64(jmod, v, x))


# ---- PEANUT's prediction net, as before the zoo's ResNet --------------

# sha256 of "name (shape)" lines of peanut_prediction_config()'s state
# dict, in order, before this ResNet took the zoo's keys (309 entries)
PEANUT_KEYS_SHA256 = ("4268b3e6854cd3a2324bae009395581156aa34e6ce1c7635ed"
                      "49045dcc728591")


class _V1cBottleneck(nn.Module):
    def __init__(self, in_channels, planes, stride=1, dilation=1,
                 downsample=False):
        super().__init__()
        out = planes * 4
        self.conv1 = nn.Conv2d(in_channels, planes, 1, bias=False)
        self.bn1 = BatchNorm(planes)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride=stride,
                               padding=dilation, dilation=dilation,
                               bias=False)
        self.bn2 = BatchNorm(planes)
        self.conv3 = nn.Conv2d(planes, out, 1, bias=False)
        self.bn3 = BatchNorm(out)
        self.downsample = (nn.Sequential(
            nn.Conv2d(in_channels, out, 1, stride=stride, bias=False),
            BatchNorm(out)) if downsample else None)

    def forward(self, x):
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = self.downsample(x) if self.downsample is not None else x
        return F.relu(out + identity)


class _ResNetV1cBefore(nn.Module):
    """The ResNetV1c of the port before the zoo's ResNet (bottleneck
    depths only), kept as the bit-for-bit reference."""

    def __init__(self, depth=50, in_channels=3, stem_channels=64,
                 base_channels=64, num_stages=4, strides=(1, 2, 2, 2),
                 dilations=(1, 1, 1, 1), out_indices=(0, 1, 2, 3),
                 contract_dilation=False, remat=False):
        super().__init__()
        half = stem_channels // 2
        self.stem = nn.Sequential(
            nn.Conv2d(in_channels, half, 3, stride=2, padding=1, bias=False),
            BatchNorm(half), nn.ReLU(),
            nn.Conv2d(half, half, 3, padding=1, bias=False),
            BatchNorm(half), nn.ReLU(),
            nn.Conv2d(half, stem_channels, 3, padding=1, bias=False),
            BatchNorm(stem_channels), nn.ReLU())
        self.out_indices = tuple(out_indices)
        self.num_stages = num_stages
        ch = stem_channels
        for i in range(num_stages):
            planes = base_channels * 2 ** i
            stride, dilation = strides[i], dilations[i]
            blocks = []
            for j in range({50: (3, 4, 6, 3)}[depth][i]):
                first = j == 0
                d = (dilation // 2 if first and dilation > 1
                     and contract_dilation else dilation)
                blocks.append(_V1cBottleneck(
                    ch, planes, stride if first else 1, d,
                    downsample=first and (stride != 1 or ch != planes * 4)))
                ch = planes * 4
            self.add_module(f"layer{i + 1}", nn.Sequential(*blocks))

    def forward(self, x):
        x = F.max_pool2d(self.stem(x), 3, 2, 1)
        outs = []
        for i in range(self.num_stages):
            for block in getattr(self, f"layer{i + 1}"):
                x = block(x)
            if i in self.out_indices:
                outs.append(x)
        return outs


def test_peanut_prediction_net_keeps_its_keys_and_forward():
    model = build_segmentor(peanut_prediction_config(), seed=0)
    sd = model.state_dict()
    lines = "\n".join(f"{k} {tuple(v.shape)}" for k, v in sd.items())
    assert len(sd) == 309
    assert hashlib.sha256(lines.encode()).hexdigest() == PEANUT_KEYS_SHA256
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                m.running_mean.normal_(0.0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
    cfg = {k: v for k, v in peanut_prediction_config()["backbone"].items()
           if k != "type"}
    before = _ResNetV1cBefore(**cfg)
    before.load_state_dict(model.backbone.state_dict(), strict=True)
    assert list(before.state_dict()) == list(model.backbone.state_dict())
    x = torch.rand(1, 14, 72, 88, generator=g)
    with torch.no_grad():
        for a, b in zip(model.backbone(x), before(x)):
            assert torch.equal(a, b)
