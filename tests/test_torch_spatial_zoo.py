"""The mesh's spatial axis over the model zoo's convolutional ResNet heads,
on the CPU, the port against itself in float64:

* ``spatial.upsample_nearest2`` (the FPN neck's top-down path) against
  ``F.interpolate(scale_factor=2, mode="nearest")`` cropped over k = 1
  ... 8 shards: the values bit-equal, the input gradients within 1e-12;
* ``forward_rows`` of UPerNet (UPerHead), Semantic FPN (the FPN neck and
  FPNHead), DeepLabV3 (ASPPHead: dilations 12 / 24 / 36 whose halos reach
  several shards away), DeepLabV3+ (DepthwiseSeparableASPPHead's c1 skip)
  and FastFCN (the JPU neck) over ``["cpu"] * k`` for k = 1 ... 8
  against the unsharded ``model(x)``: the family's first config at
  tests/test_zoo_forward.py's widths with the JAX model's seeded
  variables carried in (random batch statistics, non-zero gates), at
  128^2 and at 40 x 64 (shards of no rows), within 1e-12 of the largest
  |logit|;
* the configs of BiSeNetV1, BiSeNetV2, STDC's context path, ERFNet and
  CGNet (whose types got their sharded forms in A14 part 3c's second
  half) given a ``test_cfg`` of ``mode="slide"``: ``PredictionModel.
  get_prediction_sharded`` raises NotImplementedError naming ROADMAP A14
  part 3d (slide over a sharded map), where a whole forward would not be
  the prediction the unsharded path gives; and the refusal names only
  what part 3d leaves.
"""

import pytest
import torch
import torch.nn.functional as F

from peanut_tpu_torch.core import spatial

from torch_spatial_zoo_support import (CONVOLUTIONAL, SHAPES, SHARDS,
                                       check_forward_rows, cpus)
from torch_zoo_support import family_config, one_thread  # noqa: F401


@pytest.mark.parametrize("sizes", [((5, 7), (10, 14)), ((5, 7), (9, 13)),
                                   ((3, 4), (5, 8)), ((8, 4), (16, 8))])
def test_upsample_nearest2_matches_interpolate(sizes):
    (h, w), out = sizes
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, h, w, generator=g, dtype=torch.float64)
    xd = x.clone().requires_grad_(True)
    want = F.interpolate(xd, scale_factor=2, mode="nearest")[
        ..., :out[0], :out[1]]
    out_grad = torch.randn(want.shape, generator=g, dtype=torch.float64)
    want.backward(out_grad)
    for k in SHARDS:
        xr = x.clone().requires_grad_(True)
        got = spatial.gather(spatial.upsample_nearest2(
            spatial.shard(xr, cpus(k)), out))
        assert torch.equal(got, want.detach())
        got.backward(out_grad)        # the four copies' sum, reordered
        torch.testing.assert_close(xr.grad, xd.grad, rtol=0, atol=1e-12)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("family", sorted(CONVOLUTIONAL))
def test_forward_rows_matches_the_model(family, shape):
    check_forward_rows(family, SHAPES[shape])


# the configs of the types that part 3c's second half gave a form
SLIDING = {"BiSeNetV1": "bisenetv1", "ERFNet": "erfnet",
           "BiSeNetV2": "bisenetv2", "STDCContextPathNet": "stdc",
           "CGNet": "cgnet"}


@pytest.mark.parametrize("what", list(SLIDING))
def test_a_sliding_config_raises_naming_3d(what):
    from peanut_tpu_torch.config import NavConfig
    from peanut_tpu_torch.core.mesh import make_mesh
    from peanut_tpu_torch.models.builder import build_segmentor
    from peanut_tpu_torch.prediction import PredictionModel
    cfg = dict(family_config(SLIDING[what]), test_cfg=dict(
        mode="slide", crop_size=(32, 32), stride=(24, 24)))
    model = build_segmentor(cfg, seed=0)
    assert type(model.backbone).__name__ == what
    pm = PredictionModel(NavConfig(), model=model, device="cpu")
    full_map = torch.rand(3, 64, 64).numpy()
    assert pm.get_prediction(full_map).shape == (19, 64, 64)
    with pytest.raises(NotImplementedError,
                       match=r"EncoderDecoder with test_cfg mode 'slide' has "
                             r"no row-sharded.*ROADMAP A14 part 3d"):
        pm.get_prediction_sharded(full_map, make_mesh({"spatial": 2},
                                                      cpus(2)))


def test_the_refusal_names_what_is_left():
    from peanut_tpu_torch.models import sharded
    for name in ("slide", "padding mode", "3d"):
        assert name in sharded._LEFT
    for name in ("3c", "light-CNN", "plain-ViT"):
        assert name not in sharded._LEFT
