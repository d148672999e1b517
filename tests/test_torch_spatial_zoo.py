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
  CGNet given a ``test_cfg`` of ``mode="slide"`` (32^2 windows every 24
  rows and columns of a 64^2 map): ``PredictionModel.
  get_prediction_sharded`` over 2 shards slides as the unsharded
  ``get_prediction`` does, within 1e-5 in float32;
* no source file of the port names a ROADMAP part still to do, and a
  module type outside the port's registries is refused by name.
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


# light-CNN configs that mmseg's users may slide
SLIDING = {"BiSeNetV1": "bisenetv1", "ERFNet": "erfnet",
           "BiSeNetV2": "bisenetv2", "STDCContextPathNet": "stdc",
           "CGNet": "cgnet"}


@pytest.mark.parametrize("what", list(SLIDING))
def test_a_sliding_config_slides_over_shards(what):
    import numpy as np

    from peanut_tpu_torch.config import NavConfig
    from peanut_tpu_torch.core.mesh import make_mesh
    from peanut_tpu_torch.models.builder import build_segmentor
    from peanut_tpu_torch.prediction import PredictionModel
    cfg = dict(family_config(SLIDING[what]), test_cfg=dict(
        mode="slide", crop_size=(32, 32), stride=(24, 24)))
    model = build_segmentor(cfg, seed=0)
    assert type(model.backbone).__name__ == what
    pm = PredictionModel(NavConfig(), model=model, device="cpu")
    full_map = torch.rand(3, 64, 64,
                          generator=torch.Generator().manual_seed(4)).numpy()
    want = pm.get_prediction(full_map)
    assert want.shape == (19, 64, 64)
    got = pm.get_prediction_sharded(full_map, make_mesh({"spatial": 2},
                                                        cpus(2)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_no_refusal_names_a_roadmap_part():
    import pathlib

    import peanut_tpu_torch
    from peanut_tpu_torch.models import sharded
    root = pathlib.Path(peanut_tpu_torch.__file__).parent
    sources = sorted(root.rglob("*.py"))
    assert len(sources) > 50
    for path in sources:
        assert "part 3d" not in path.read_text(), path

    class Unregistered(torch.nn.Module):
        def forward(self, x):
            return x

    x = spatial.shard(torch.rand(1, 2, 6, 4), cpus(2))
    with pytest.raises(NotImplementedError,
                       match=r"^Unregistered has no row-sharded forward"):
        sharded.run(Unregistered(), x, sharded._Context(
            torch.device("cpu"), None))
