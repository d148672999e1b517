"""The model zoo's light-CNN modules of the port (ROADMAP A13 part 4)
against their flax modules, on the CPU, in float64 on both sides: every
output within 1e-9 of its largest |value|.

* The shared pieces: ``layers.PReLU`` is flax's (a 0-D slope, 0.01 at
  init; carried from a seeded value), a ConvModule holds its PReLU as
  flax's ``PReLU_0``, and ``hswish`` / ``hsigmoid`` / ``relu6`` are the
  JAX package's.
* The backbones and their blocks at narrow widths: MobileNetV2 (d8
  strides and dilations), the SE layer with both gates, ResNeSt's split
  attention, bottleneck (stride 2, the avg-down shortcut) and net,
  MobileNetV3 (``dilate_last`` on and off), Fast-SCNN, CGNet's CG block
  (both forms) and net, ERFNet (and its ValueError on an odd side, where
  the JAX package's concatenation fails), BiSeNetV2 and its GE layers,
  STDC's modules (both strides), net and context path, ICNet (a 2x2
  coarsest map under 3- and 6-bin pools), HRNet's module on odd sizes and
  net, UNet.  (BiSeNetV1 over its nested ResNet-18:
  ``test_torch_zoo_resnet.py``.)
* The heads LRASPP, DepthwiseSeparableFCN (with ``concat_input``) and
  STDC, ``SepConvModule`` (its bare flax ``dw_bn``, with no inner
  ``bn`` level, placed by ``flax_to_torch_state``), and ICNeck.

The variables are seeded normals (``torch_zoo_support.random_variables``),
the PReLU slopes too; each family's whole model:
``test_torch_zoo_models_4.py`` and ``_5.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as fnn

import peanut_tpu.models  # noqa: F401  (registers the JAX zoo)
from peanut_tpu.models import backbones_zoo as jbz, hrnet as jhr
from peanut_tpu.models import heads_zoo as jhz, layers as jlayers
from peanut_tpu.models import mobilenet as jmb
from peanut_tpu.registry import (BACKBONES as JBACKBONES, HEADS as JHEADS,
                                 NECKS as JNECKS)
import peanut_tpu_torch.models.builder  # noqa: F401  (registers the zoo)
from peanut_tpu_torch.models import backbones_zoo, heads_zoo, hrnet
from peanut_tpu_torch.models.layers import (ConvModule, PReLU, hsigmoid,
                                            hswish, relu6)
from peanut_tpu_torch.models.mmseg_import import flax_to_torch_state
from peanut_tpu_torch.registry import BACKBONES, HEADS, NECKS

from torch_zoo_support import carried_module, jax64, rel_err
from torch_zoo_support import one_thread  # noqa: F401  (autouse)

TOL = 1e-9


def _nchw(a):
    if isinstance(a, (tuple, list)):
        return [_nchw(e) for e in a]
    return torch.as_tensor(a).permute(0, 3, 1, 2)


def _nhwc(t):
    if isinstance(t, (tuple, list)):
        return [_nhwc(e) for e in t]
    return t.permute(0, 2, 3, 1).numpy()


def _close(got, want):
    got = got if isinstance(got, (tuple, list)) else [got]
    want = want if isinstance(want, (tuple, list)) else [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float64
        assert rel_err(g, w) <= TOL


def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape)


def _check(jmod, tmod, *args):
    """The flax module's seeded variables carried into the port's; both
    applied in float64 to ``args`` (NHWC arrays, or lists of them)."""
    v = carried_module(jmod, tmod, *args)
    with torch.no_grad():
        got = _nhwc(tmod(*_nchw(list(args))))
    _close(got, jax64(jmod, v, *args))
    return v


def test_prelu_and_activations_are_the_jax_package_s():
    x = _rand(0, 4000) * 5
    with jax.enable_x64(True):
        want = [np.asarray(f(jnp.asarray(x))) for f in
                (jbz.hswish, jbz.hsigmoid, jmb.relu6)]
    for f, w in zip((hswish, hsigmoid, relu6), want):
        assert rel_err(f(torch.as_tensor(x)).numpy(), w) <= 1e-15
    assert PReLU().negative_slope.shape == ()
    assert PReLU().negative_slope.item() == pytest.approx(0.01)
    xs = _rand(1, 2, 5, 6, 3)
    tmod = PReLU()
    v = carried_module(fnn.PReLU(), tmod, xs)
    assert abs(float(v["params"]["negative_slope"]) - 0.01) > 1e-3
    with torch.no_grad():
        got = tmod(torch.as_tensor(xs)).numpy()
    _close(got, jax64(fnn.PReLU(), v, xs))


def test_conv_module_holds_its_prelu_as_flax_names_it():
    jmod = jlayers.ConvModule(6, 3, padding=1, act=lambda t: fnn.PReLU()(t))
    tmod = ConvModule(4, 6, 3, padding=1, act=PReLU())
    v = _check(jmod, tmod, _rand(2, 2, 7, 9, 4))
    assert "PReLU_0" in v["params"]
    assert "PReLU_0.negative_slope" in dict(tmod.named_parameters())


# (JAX module, port module, input shapes): the blocks and backbones
MODULES = {
    "se_hsigmoid": (lambda: jbz.SELayer(),
                    lambda: backbones_zoo.SELayer(8), [(2, 5, 6, 8)]),
    "se_sigmoid": (lambda: jbz.SELayer(ratio=16, gate="sigmoid"),
                   lambda: backbones_zoo.SELayer(8, 16, "sigmoid"),
                   [(1, 4, 3, 8)]),
    "split_attention": (
        lambda: jbz.SplitAttentionConv(8, radix=2, stride=2),
        lambda: backbones_zoo.SplitAttentionConv(8, 8, radix=2, stride=2),
        [(2, 9, 10, 8)]),
    "resnest_bottleneck": (
        lambda: jbz.ResNeStBottleneck(4, stride=2, downsample=True),
        lambda: backbones_zoo.ResNeStBottleneck(8, 4, stride=2,
                                                downsample=True),
        [(1, 8, 10, 8)]),
    "resnest": (
        lambda: jbz.ResNeSt(stem_channels=8, base_channels=4,
                            strides=(1, 2, 1, 1), dilations=(1, 1, 2, 4),
                            contract_dilation=True),
        lambda: BACKBONES.build(dict(
            type="ResNeSt", stem_channels=8, base_channels=4,
            strides=(1, 2, 1, 1), dilations=(1, 1, 2, 4),
            contract_dilation=True)),
        [(1, 32, 32, 3)]),
    "mobilenet_v2_d8": (
        lambda: jmb.MobileNetV2(widen_factor=0.25,
                                strides=(1, 2, 2, 2, 1, 1, 1),
                                dilations=(1, 1, 1, 1, 1, 2, 4)),
        lambda: BACKBONES.build(dict(
            type="MobileNetV2", widen_factor=0.25,
            strides=(1, 2, 2, 2, 1, 1, 1),
            dilations=(1, 1, 1, 1, 1, 2, 4))),
        [(1, 32, 32, 3)]),
    "mbv3_block": (
        lambda: jbz.MBV3Block(5, 12, 8, True, "hswish", 2),
        lambda: backbones_zoo.MBV3Block(6, 5, 12, 8, True, "hswish", 2),
        [(1, 9, 11, 6)]),
    "mobilenet_v3_dilated": (
        lambda: jbz.MobileNetV3(arch="small", out_indices=(0, 1, 3, 12)),
        lambda: BACKBONES.build(dict(type="MobileNetV3", arch="small",
                                     out_indices=(0, 1, 3, 12))),
        [(1, 64, 64, 3)]),
    "mobilenet_v3_strided": (
        lambda: jbz.MobileNetV3(arch="small", out_indices=(2, 11),
                                dilate_last=False),
        lambda: BACKBONES.build(dict(type="MobileNetV3", arch="small",
                                     out_indices=(2, 11),
                                     dilate_last=False)),
        [(1, 64, 64, 3)]),
    "fast_scnn": (
        lambda: jbz.FastSCNN(downsample_dw_channels=(8, 12),
                             global_in_channels=16,
                             global_block_channels=(16, 24, 32),
                             global_out_channels=32,
                             fusion_out_channels=24),
        lambda: BACKBONES.build(dict(
            type="FastSCNN", downsample_dw_channels=(8, 12),
            global_in_channels=16, global_block_channels=(16, 24, 32),
            global_out_channels=32, fusion_out_channels=24)),
        [(1, 64, 96, 3)]),
    "cg_block_down": (
        lambda: jbz.ContextGuidedBlock(16, dilation=2, reduction=4,
                                       downsample=True),
        lambda: backbones_zoo.ContextGuidedBlock(11, 16, 2, 4, True),
        [(1, 10, 12, 11)]),
    "cg_block": (
        lambda: jbz.ContextGuidedBlock(16, dilation=4, reduction=8),
        lambda: backbones_zoo.ContextGuidedBlock(16, 16, 4, 8),
        [(2, 7, 9, 16)]),
    "cgnet": (
        lambda: jbz.CGNet(num_channels=(8, 16, 32), num_blocks=(2, 3)),
        lambda: BACKBONES.build(dict(type="CGNet", num_channels=(8, 16, 32),
                                     num_blocks=(2, 3))),
        [(1, 32, 48, 3)]),
    "erfnet": (
        lambda: jbz.ERFNet(enc_downsample_channels=(8, 16, 32),
                           enc_stage_non_bottlenecks=(1, 5),
                           dec_upsample_channels=(16, 8),
                           dec_stages_non_bottleneck=(1, 1)),
        lambda: BACKBONES.build(dict(
            type="ERFNet", enc_downsample_channels=(8, 16, 32),
            enc_stage_non_bottlenecks=(1, 5), dec_upsample_channels=(16, 8),
            dec_stages_non_bottleneck=(1, 1))),
        [(1, 32, 48, 3)]),
    "ge_layer": (lambda: jbz._GELayer(8, stride=1, expand=3),
                 lambda: backbones_zoo._GELayer(8, 8, 1, 3),
                 [(1, 6, 7, 8)]),
    "ge_layer_stride2": (lambda: jbz._GELayer(12, stride=2, expand=2),
                         lambda: backbones_zoo._GELayer(8, 12, 2, 2),
                         [(1, 7, 9, 8)]),
    "bisenetv2": (
        lambda: jbz.BiSeNetV2(detail_channels=(8, 8, 16),
                              semantic_channels=(4, 8, 16, 32),
                              bga_channels=16),
        lambda: BACKBONES.build(dict(
            type="BiSeNetV2", detail_channels=(8, 8, 16),
            semantic_channels=(4, 8, 16, 32), bga_channels=16)),
        [(1, 64, 64, 3)]),
    "stdc_module": (lambda: jbz.STDCModule(32),
                    lambda: backbones_zoo.STDCModule(12, 32),
                    [(1, 6, 7, 12)]),
    "stdc_module_stride2": (
        lambda: jbz.STDCModule(32, stride=2, num_convs=3),
        lambda: backbones_zoo.STDCModule(12, 32, 2, 3), [(1, 7, 9, 12)]),
    "stdc_net2": (
        lambda: jbz.STDCNet(stdc_type="STDCNet2",
                            channels=(8, 8, 16, 32, 64),
                            out_indices=(1, 3, 4)),
        lambda: BACKBONES.build(dict(type="STDCNet", stdc_type="STDCNet2",
                                     channels=(8, 8, 16, 32, 64),
                                     out_indices=(1, 3, 4))),
        [(1, 64, 64, 3)]),
    "stdc_context_path": (
        lambda: jbz.STDCContextPathNet(
            backbone_cfg=dict(type="STDCNet", channels=(8, 8, 16, 32, 64)),
            out_channels=16, ffm_channels=24),
        lambda: BACKBONES.build(dict(
            type="STDCContextPathNet",
            backbone_cfg=dict(type="STDCNet", channels=(8, 8, 16, 32, 64)),
            out_channels=16, ffm_channels=24)),
        [(1, 64, 64, 3)]),
    "icnet_bins_beyond_the_map": (
        lambda: jbz.ICNet(light_branch_mid_channels=8, psp_out_channels=16,
                          out_channels=(8, 16, 16),
                          depth_blocks=(1, 1, 1, 1)),
        lambda: BACKBONES.build(dict(
            type="ICNet", light_branch_mid_channels=8, psp_out_channels=16,
            out_channels=(8, 16, 16), depth_blocks=(1, 1, 1, 1))),
        [(1, 64, 64, 3)]),
    "hr_module_odd": (
        lambda: jhr.HRModule(3, 2, (4, 8, 16)),
        lambda: hrnet.HRModule(3, 2, (4, 8, 16)),
        [[(1, 15, 17, 4), (1, 8, 9, 8), (1, 4, 5, 16)]]),
    "hrnet": (
        lambda: jhr.HRNet(base_channels=4, stage_modules=(1, 1, 2, 1),
                          stage_blocks=2),
        lambda: BACKBONES.build(dict(type="HRNet", base_channels=4,
                                     stage_modules=(1, 1, 2, 1),
                                     stage_blocks=2)),
        [(1, 64, 64, 3)]),
    "unet": (
        lambda: JBACKBONES.get("UNet")(base_channels=4, num_stages=4),
        lambda: BACKBONES.build(dict(type="UNet", base_channels=4,
                                     num_stages=4)),
        [(1, 32, 48, 3)]),
}


def _inputs(shapes, seed):
    out = []
    for i, s in enumerate(shapes):
        out.append(_inputs(s, seed + 10 * i) if isinstance(s, list)
                   else _rand(seed + i, *s))
    return out


@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_matches_flax(name):
    jmk, tmk, shapes = MODULES[name]
    tmod = tmk()
    _check(jmk(), tmod, *_inputs(shapes, 3))
    if hasattr(tmod, "out_channels"):
        with torch.no_grad():
            outs = tmod(torch.zeros(1, 3, 64, 64, dtype=torch.float64))
        assert [o.shape[1] for o in outs] == list(tmod.out_channels)


def test_erfnet_raises_on_an_odd_side():
    kw = dict(enc_downsample_channels=(8, 16, 32),
              enc_stage_non_bottlenecks=(1, 1), dec_upsample_channels=(8, 8),
              dec_stages_non_bottleneck=(1, 1))
    tmod = BACKBONES.build(dict(type="ERFNet", **kw))
    with torch.no_grad():
        assert tmod(torch.zeros(1, 3, 32, 48))[0].shape == (1, 8, 16, 24)
        with pytest.raises(ValueError, match="even"):
            tmod(torch.zeros(1, 3, 30, 48))       # 15 rows at down1
    with pytest.raises(Exception):               # the concatenation fails
        jax.eval_shape(lambda: jbz.ERFNet(**kw).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 30, 48, 3))))


def test_sep_conv_module_places_its_bare_batch_norm():
    jmod, tmod = jhz.SepConvModule(8), heads_zoo.SepConvModule(6, 8)
    v = _check(jmod, tmod, _rand(4, 2, 7, 9, 6))
    # flax's dw_bn holds its variables directly, not under a "bn" level
    assert set(v["params"]["dw_bn"]) == {"scale", "bias"}
    sd = flax_to_torch_state({c: {"m": t} for c, t in v.items()},
                             _holder(tmod))
    np.testing.assert_array_equal(sd["m.dw_bn.running_var"],
                                  v["batch_stats"]["dw_bn"]["var"])


def _holder(tmod):
    holder = torch.nn.Module()
    holder.add_module("m", tmod)
    return holder


HEAD_CASES = {
    "LRASPPHead": (dict(in_channels=(4, 6, 12), channels=8, num_classes=5,
                        in_index=(0, 1, 2)),
                   [(1, 16, 20, 4), (1, 8, 10, 6), (1, 4, 5, 12)]),
    "DepthwiseSeparableFCNHead": (
        dict(in_channels=12, channels=8, num_classes=5, num_convs=2,
             concat_input=True, in_index=-1),
        [(1, 4, 4, 6), (2, 9, 11, 12)]),
    "STDCHead": (dict(in_channels=6, channels=8, num_classes=2,
                      in_index=0), [(2, 9, 11, 6)]),
}


@pytest.mark.parametrize("kind", sorted(HEAD_CASES))
def test_head_matches_flax(kind):
    kw, shapes = HEAD_CASES[kind]
    jmod = JHEADS.get(kind)(**kw)
    tmod = HEADS.build(dict(kw, type=kind))
    _check(jmod, tmod, _inputs(shapes, 5))


def test_icneck_matches_flax():
    kw = dict(in_channels=(4, 8, 8), out_channels=8)
    jmod, tmod = JNECKS.get("ICNeck")(**kw), NECKS.build(dict(kw,
                                                               type="ICNeck"))
    _check(jmod, tmod, _inputs([(1, 16, 18, 4), (1, 8, 9, 8),
                                (1, 4, 5, 8)], 6))
