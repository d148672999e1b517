"""The mesh's spatial axis over the zoo's last five ResNet families, on
the CPU, the port against itself in float64
(tests/test_torch_spatial_zoo.py's construction and bars):

* ``forward_rows`` of OCRNet (the class centroids a softmax over all
  pixels, as a partial log-sum-exp a class), K-Net (each stage's group
  features and counts partial sums), ISANet (the global stage over the
  row classes of the padded map, the local one over bands that straddle
  a shard's edge), PSANet (its masks bound by the whole map's size; the
  distribute branch's partial sums) and PointRend (the FPN neck, FPNHead
  and the point head's subdivision over every shard's cells) over
  ``["cpu"] * k`` for k = 1 ... 8 against the unsharded ``model(x)``, at
  128^2 and at 40 x 64 (shards of no rows), within 1e-12 of the largest
  |logit|; PointRend's chosen cells of each round equal the unsharded
  ``subdivide``'s, in order;
* mmseg's OCRNet, a ``CascadeEncoderDecoder`` of an FCNHead and an
  OCRHead that takes its logits as the soft regions, the same way;
* ISANet where the 1/8 level's bands of 8 rows fall on the shards' edges
  (64 rows over 4 shards) and across them (over 3), at 512 x 64;
* the FPN neck's P6 (the stride-2 1x1 max pool of P5) over 1 ... 8
  shards: every level, P6 included, bit-equal to the unsharded module's;
* ``PSAHead``'s mask convolutions bound by a sharded forward take the
  whole map's (2H-1)(2W-1) channels, the weights an unsharded forward
  binds;
* the merge of each shard's most uncertain cells equals ``boxes.top_k``
  of the whole map on logits full of ties.
"""

import pytest
import torch

from peanut_tpu_torch.core import spatial
from peanut_tpu_torch.models import sharded
from peanut_tpu_torch.models.boxes import top_k
from peanut_tpu_torch.models.heads_zoo import PointHead
from peanut_tpu_torch.models.sharded import forward_rows

from torch_spatial_zoo_support import (LAST, SHAPES, SHARDS, TOL,
                                       check_forward_rows, cpus, image,
                                       ocr_cascade_config, port_model)
from torch_zoo_support import (family_config, jax_and_port,  # noqa: F401
                               one_thread, rel_err)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("family", sorted(LAST))
def test_forward_rows_matches_the_model(family, shape):
    check_forward_rows(family, SHAPES[shape])


def test_isanet_bands_along_and_across_shard_edges():
    _, _, model = port_model("isanet")
    x = image((512, 64))              # 64 rows at 1/8: bands of 8
    with torch.no_grad():
        want = model(x, train=False)
        for k in (3, 4):
            got = forward_rows(model, spatial.shard(x, cpus(k)), train=False)
            assert rel_err(spatial.gather(got).numpy(),
                           want.numpy()) <= TOL, k


def test_subdivision_chooses_the_unsharded_cells():
    _, _, model = port_model("point_rend")
    for hw in SHAPES.values():
        x = image(hw)
        with torch.no_grad():
            feats = model.extract_feat(x)
            _, want = model.subdivide(feats, model._stage_outputs(feats)[-1])
            for k in SHARDS:
                trace = {}
                forward_rows(model, spatial.shard(x, cpus(k)), train=False,
                             trace=trace)
                assert len(trace["point_cells"]) == len(want) == 2
                for got, w in zip(trace["point_cells"], want):
                    assert torch.equal(got, w), (hw, k)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_fcn_ocr_cascade_matches_the_model(shape):
    _, _, model, _ = jax_and_port(ocr_cascade_config(), (64, 64))
    hw = SHAPES[shape]
    x = image(hw)
    with torch.no_grad():
        want = model(x, train=False)
        for k in SHARDS:
            got = forward_rows(model, spatial.shard(x, cpus(k)), train=False)
            assert rel_err(spatial.gather(got).numpy(),
                           want.numpy()) <= TOL, k


@pytest.mark.parametrize("sizes", [((32, 20), (16, 10), (8, 5), (4, 3)),
                                   ((41, 26), (21, 13), (11, 7), (6, 4))])
def test_fpn_p6_rows_equal_the_module(sizes):
    from peanut_tpu_torch.models.fpn import FPN
    torch.manual_seed(0)
    fpn = FPN(out_channels=8, in_channels=(4, 6, 8, 10),
              add_p6_pool=True).double().eval()
    g = torch.Generator().manual_seed(1)
    levels = [torch.randn(2, c, *hw, generator=g, dtype=torch.float64)
              for c, hw in zip((4, 6, 8, 10), sizes)]
    with torch.no_grad():
        want = fpn(levels)
        assert len(want) == 5
        assert want[4].shape[-2:] == ((sizes[3][0] + 1) // 2,
                                      (sizes[3][1] + 1) // 2)
        for k in SHARDS:
            got = sharded.run(fpn, [spatial.shard(f, cpus(k))
                                    for f in levels],
                              sharded._Context(torch.device("cpu"), None))
            assert len(got) == 5
            for g_, w in zip(got, want):
                assert torch.equal(spatial.gather(g_), w), k


def test_mask_conv_binds_the_whole_map_over_shards():
    from peanut_tpu_torch.models.builder import build_segmentor
    from peanut_tpu_torch.models.heads_zoo import MaskConv
    hw = (64, 96)                     # 8 x 12 at 1/8: 15 x 23 positions
    x = image(hw).float()
    cfg = family_config("psanet")
    masks = lambda m: [mod for mod in m.modules()  # noqa: E731
                       if isinstance(mod, MaskConv)]
    sharded_model = build_segmentor(cfg, seed=0)
    with torch.no_grad():
        got = forward_rows(sharded_model, spatial.shard(x, cpus(3)),
                           train=False)
    assert [tuple(mc.weight.shape) for mc in masks(sharded_model)] == \
        [(15 * 23, mc.in_channels, 1, 1) for mc in masks(sharded_model)]
    unsharded = build_segmentor(cfg, seed=0)
    with torch.no_grad():
        want = unsharded(x, train=False)
        # another split binds nothing anew
        again = forward_rows(sharded_model, spatial.shard(x, cpus(5)),
                             train=False)
    for a, b in zip(masks(sharded_model), masks(unsharded)):
        assert torch.equal(a.weight, b.weight)
    assert rel_err(spatial.gather(got).numpy(), want.numpy()) <= 1e-5
    assert rel_err(spatial.gather(again).numpy(), want.numpy()) <= 1e-5
    with pytest.raises(ValueError, match="masks were shaped"):
        with torch.no_grad():
            forward_rows(sharded_model, spatial.shard(image((32, 96)).float(),
                                                      cpus(2)), train=False)


@pytest.mark.parametrize("k_points", [1, 7, 40, 63])
def test_most_uncertain_merge_is_the_whole_maps_top_k(k_points):
    g = torch.Generator().manual_seed(3)
    # three levels of logits: few distinct uncertainties, many ties
    logits = torch.randint(0, 3, (2, 4, 9, 7), generator=g).double()
    want = top_k(PointHead.uncertainty(logits).reshape(2, -1), k_points)[1]
    ctx = sharded._Context(torch.device("cpu"), None)
    for k in SHARDS:
        got = sharded._most_uncertain(spatial.shard(logits, cpus(k)),
                                      k_points, ctx)
        assert torch.equal(got, want), k
