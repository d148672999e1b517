"""The traps of the hierarchical transformers over the spatial axis, one
module at a time, on the CPU in float64 (the port against its unsharded
module), and the types still without a sharded form:

* ``layers.SameConv2d`` (flax's "SAME" padding, also dilated) over 1
  ... 8 shards at heights whose ``(-H) % s`` is 0 ... s - 1: the padding
  split from the whole map's height, its top rows above shard 0 only
  (Twins' reductions pad 3 rows on top of 10), its bottom rows below the
  last shard only; the values and the input's gradient within 1e-12;
* ``spatial.fetch_padded`` of rows wholly above or below the map (a
  window band of padding rows only);
* a shifted ``SwinBlock`` over 2 and 3 shards: the last window band,
  which holds the padded map's last ws - shift rows and its first shift
  rows, is computed by the shards that output its rows, shard 0's rows
  fetched by the last shard, with the seam mask at each window's global
  index; the output and the input's gradient within 1e-12 of the
  unsharded block's, and the last shard's output rows in that band
  depend on shard 0's rows as the unsharded block's do;
* Twins-SVT's ``_LocalAttention`` on maps lower or narrower than its
  window (its windows ``min(window, h, w)`` of the whole map) over 1 ...
  8 shards;
* every type of the port's registries has a sharded form (none is
  left); each light-CNN type, of both halves of ROADMAP A14 part 3c
  (the two-path real-time nets, their neck and head among them), runs a
  small instance over 2 shards of a float64 map as its unsharded forward
  does; and a plain-ViT model (UPerNet-ViT, SETR) whose head's
  convolution pads in reflect mode, or ERFNet with a convolution padded
  "same" or in reflect, replicate or circular mode, runs through
  ``forward_rows`` over 2 shards as its unsharded forward does, within
  1e-12 in float64.
"""

import pytest
import torch

from peanut_tpu_torch.core import spatial
from peanut_tpu_torch.core.mesh import row_ranges
from peanut_tpu_torch.models import sharded
from peanut_tpu_torch.models.backbones_zoo import _LocalAttention
from peanut_tpu_torch.models.layers import SameConv2d, same_pads
from peanut_tpu_torch.models.sharded import forward_rows
from peanut_tpu_torch.models.vit import SwinBlock

from torch_spatial_zoo_support import SHARDS, cpus
from torch_zoo_support import family_config, one_thread  # noqa: F401


def _context():
    return sharded._Context(torch.device("cpu"), None)


def _check_rows(module, x, shards, nchw=True, tol=1e-12):
    """``sharded.run(module)`` over each k of ``shards`` against
    ``module``'s forward (on NCHW maps, or NHWC ones for ``nchw=False``):
    the values and the input's gradient under a seeded weighting."""
    g = torch.Generator().manual_seed(9)
    xd = x.clone().requires_grad_(True)
    want = module(xd if nchw else xd.permute(0, 2, 3, 1))
    if not nchw:
        want = want.permute(0, 3, 1, 2)
    weights = torch.randn(want.shape, generator=g, dtype=want.dtype)
    (want * weights).sum().backward()
    for k in shards:
        xr = x.clone().requires_grad_(True)
        got = spatial.gather(sharded.run(module, spatial.shard(xr, cpus(k)),
                                         _context()))
        assert got.shape == want.shape, k
        top = float(want.detach().abs().max())
        assert float((got - want).detach().abs().max()) <= tol * top, k
        (got * weights).sum().backward()
        gtop = float(xd.grad.abs().max())
        assert float((xr.grad - xd.grad).abs().max()) <= tol * gtop, k
    return want


@pytest.mark.parametrize("ks", [(8, 8, 1), (4, 4, 1), (2, 2, 1), (3, 2, 1),
                                (3, 1, 1), (3, 1, 2)])
def test_same_conv_pads_from_the_global_height(ks):
    kernel, stride, dilation = ks
    torch.manual_seed(0)
    conv = SameConv2d(3, 5, kernel, stride=stride,
                      dilation=dilation).double()
    tops = set()
    for rest in range(stride):
        h = 5 * stride - rest                   # (-h) % stride == rest
        assert (-h) % stride == rest
        tops.add(same_pads(h, kernel, stride)[0])
        x = torch.rand(2, 3, h, 13, dtype=torch.float64,
                       generator=torch.Generator().manual_seed(h))
        _check_rows(conv, x, SHARDS)
    if kernel == stride == 8:
        assert same_pads(10, 8, 8) == (3, 3) and max(tops) >= 3


@pytest.mark.parametrize("k", [2, 3])
def test_shifted_swin_block_wraps_onto_shard_0(k):
    torch.manual_seed(0)
    block = SwinBlock(8, 2, window=7, shift=3).double()
    with torch.no_grad():
        block.attn.rel_pos_bias_table.normal_(0.0, 0.5)
    h, w = 20, 11                      # padded 21 x 14: three bands
    x = torch.rand(1, 8, h, w, dtype=torch.float64,
                   generator=torch.Generator().manual_seed(1))
    _check_rows(block, x, [k], nchw=False)
    # the last band (padded rows 17 ... 20, then 0 ... 2): the last
    # shard's rows 17 ... 19 read shard 0's rows 0 ... 2, and only
    # through the seam mask's -100 (a weight of exp(-100), kept)
    s_last, e0 = row_ranges(h, k)[-1][0], row_ranges(h, k)[0][1]
    assert s_last <= 17 and e0 >= 3
    xr = x.clone().requires_grad_(True)
    out = sharded.run(block, spatial.shard(xr, cpus(k)), _context())
    out.blocks[-1][:, :, 17 - s_last:20 - s_last].sum().backward()
    reach = xr.grad[:, :, 0:3].abs().max()
    assert 0.0 < float(reach) < 1e-30
    xd = x.clone().requires_grad_(True)
    block(xd.permute(0, 2, 3, 1))[:, 17:20].sum().backward()
    assert float((xr.grad - xd.grad).abs().max()) <= 1e-12 * float(
        xd.grad.abs().max())


@pytest.mark.parametrize("hw", [(5, 12), (9, 4), (3, 3)])
def test_local_attention_below_its_window(hw):
    torch.manual_seed(0)
    attn = _LocalAttention(8, 2, window=7).double()
    h, w = hw
    x = torch.rand(1, 8, h, w, dtype=torch.float64,
                   generator=torch.Generator().manual_seed(2))

    class Tokens(torch.nn.Module):      # the module on (B, h*w, C) tokens
        def forward(self, t):
            b, hh, ww, c = t.shape
            return attn(t.reshape(b, hh * ww, c), (hh, ww)).reshape(t.shape)

    with torch.no_grad():
        want = Tokens()(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        for k in SHARDS:
            got = spatial.gather(sharded.run(attn, spatial.shard(
                x, cpus(k)), _context()))
            assert float((got - want).abs().max()) <= 1e-12 * float(
                want.abs().max()), k


# the port's registered types without a sharded form: none since the
# light CNNs' two-path real-time nets, their neck and head got theirs
LEFT = {"backbones": (), "necks": (), "heads": ()}
# the light CNNs' types, which got forms (models/sharded_light.py): each a
# small instance, and the levels a head or a neck takes (channels,
# stride)
GOT_A_FORM = {
    "MobileNetV2": dict(widen_factor=0.25),
    "MobileNetV3": dict(arch="small", out_indices=(0, 1, 12)),
    "ResNeSt": dict(depth=50, stem_channels=8, base_channels=4,
                    dilations=(1, 1, 2, 4), strides=(1, 2, 1, 1),
                    contract_dilation=True),
    "HRNet": dict(base_channels=4, stage_modules=(1, 1, 1, 1),
                  stage_blocks=1),
    "UNet": dict(base_channels=4, num_stages=4),
    "FastSCNN": dict(downsample_dw_channels=(8, 8), global_in_channels=8,
                     global_block_channels=(8, 8, 8), global_out_channels=8,
                     fusion_out_channels=8),
    "TIMMBackbone": dict(model_name="mobilenetv3_small_100",
                         extra=dict(out_indices=(0, 1, 12))),
    "LRASPPHead": dict(in_channels=(4, 6, 8), channels=8, num_classes=3,
                       levels=((4, 2), (6, 4), (8, 8))),
    "DepthwiseSeparableFCNHead": dict(in_channels=8, channels=8,
                                      num_classes=3, in_index=0,
                                      concat_input=True,
                                      levels=((8, 8),)),
    "BiSeNetV1": dict(backbone_cfg=dict(type="ResNet", depth=18,
                                        base_channels=4, stem_channels=4),
                      spatial_channels=(4, 4, 4, 8),
                      context_channels=(8, 16, 32), out_channels=8),
    "BiSeNetV2": dict(detail_channels=(4, 4, 8),
                      semantic_channels=(4, 8, 8, 16), bga_channels=8,
                      semantic_expansion=2),
    "CGNet": dict(num_channels=(8, 16, 32), num_blocks=(2, 2),
                  reductions=(4, 8)),
    "ERFNet": dict(enc_downsample_channels=(4, 8, 16),
                   enc_stage_non_bottlenecks=(1, 4),
                   dec_upsample_channels=(8, 4),
                   dec_stages_non_bottleneck=(1, 1)),
    "ICNet": dict(layer_channels=(8, 16), light_branch_mid_channels=4,
                  psp_out_channels=16, out_channels=(4, 8, 8),
                  depth_blocks=(1, 1, 1, 1)),
    "STDCNet": dict(channels=(4, 4, 16, 32, 64)),
    "STDCContextPathNet": dict(backbone_cfg=dict(
        type="STDCNet", channels=(4, 4, 16, 32, 64)), out_channels=8,
        ffm_channels=16),
    "ICNeck": dict(in_channels=(4, 8, 8), out_channels=8,
                   levels=((4, 8), (8, 16), (8, 32))),
    "STDCHead": dict(in_channels=8, channels=4, num_classes=2, in_index=0,
                     levels=((8, 8),))}


def _registries():
    import peanut_tpu_torch.models.builder  # noqa: F401  (registers)
    from peanut_tpu_torch.registry import BACKBONES, HEADS, NECKS
    return {"backbones": BACKBONES, "necks": NECKS, "heads": HEADS}


def test_the_types_left_are_those_without_a_form():
    from peanut_tpu_torch.models.heads_zoo import PointHead
    for kind, reg in _registries().items():
        left = {n for n, c in reg._modules.items()
                if c not in sharded._FORWARDS and c is not PointHead}
        assert left == set(LEFT[kind]), kind


@pytest.mark.parametrize("name", list(GOT_A_FORM))
def test_a_light_cnn_type_has_a_form_that_runs_sharded(name):
    reg = next(r for r in _registries().values() if name in r._modules)
    cls = reg.get(name)
    assert cls in sharded._FORWARDS
    kw = dict(GOT_A_FORM[name])
    levels = kw.pop("levels", None)
    torch.manual_seed(0)
    module = cls(**kw).double().eval()
    g = torch.Generator().manual_seed(1)
    if levels is None:                         # a backbone, on an image
        x = torch.rand(1, 3, 64, 48, generator=g, dtype=torch.float64)
        with torch.no_grad():
            want = list(module(x))
            got = sharded.run(module, spatial.shard(x, cpus(2)), _context())
    else:                              # a head or a neck, on its levels
        xs = [torch.rand(1, c, 64 // s, 48 // s, generator=g,
                         dtype=torch.float64) for c, s in levels]
        with torch.no_grad():
            want = module(xs)
            got = sharded.run(module, [spatial.shard(t, cpus(2))
                                       for t in xs], _context())
        if isinstance(want, torch.Tensor):
            want, got = [want], [got]
    assert len(got) == len(want) > 0
    for r, w in zip(got, want):
        assert [b.shape[2] for b in r.blocks] == [
            e - s for s, e in row_ranges(w.shape[2], 2)]
        got_w = spatial.gather(r)
        assert got_w.shape == w.shape
        assert float((got_w - w).abs().max()) <= 1e-12 * float(
            w.abs().max())


def _check_model_rows(model, x):
    with torch.no_grad():
        want = model(x, train=False)
        got = spatial.gather(forward_rows(model, spatial.shard(x, cpus(2)),
                                          train=False))
    assert got.shape == want.shape == x.shape[:1] + want.shape[1:2] + \
        x.shape[2:]
    assert float((got - want).abs().max()) <= 1e-12 * float(
        want.abs().max())


@pytest.mark.parametrize("family", ["vit", "setr"])
def test_a_plain_vit_model_with_a_reflect_conv_runs_sharded(family):
    from peanut_tpu_torch.models.builder import build_segmentor
    model = build_segmentor(family_config(family), seed=0).double()
    conv = next(m for m in model.decode_head.modules()
                if isinstance(m, torch.nn.Conv2d) and m.kernel_size == (3, 3))
    conv.padding_mode = "reflect"
    _check_model_rows(model, torch.rand(
        1, 3, 64, 64, dtype=torch.float64,
        generator=torch.Generator().manual_seed(3)))


@pytest.mark.parametrize("padding", ["reflect", "replicate", "circular",
                                     "same"])
def test_a_conv_padded_otherwise_runs_sharded(padding):
    from peanut_tpu_torch.models.builder import build_segmentor
    model = build_segmentor(family_config("erfnet"), seed=0).double()
    block = model.backbone.enc1_0
    if padding == "same":
        conv = block.conv3x1_1
        block.conv3x1_1 = torch.nn.Conv2d(conv.in_channels,
                                          conv.out_channels, (3, 1),
                                          padding="same").double()
    else:
        block.conv3x1_1.padding_mode = padding
    _check_model_rows(model, torch.rand(
        1, 3, 64, 64, dtype=torch.float64,
        generator=torch.Generator().manual_seed(3)))


@pytest.mark.parametrize("rows", [(13, 16), (12, 12), (-5, -2), (-2, 3),
                                  (10, 14)])
def test_fetch_padded_past_the_map_edges(rows):
    a, b = rows
    x = torch.arange(12.0).reshape(1, 1, 12, 1)
    want = torch.nn.functional.pad(x, (0, 0, 20, 20), value=-7.0)[
        :, :, a + 20:b + 20]
    for k in SHARDS:
        got = spatial.fetch_padded(spatial.shard(x, cpus(k)), a, b, "cpu",
                                   value=-7.0)
        assert torch.equal(got, want), k
