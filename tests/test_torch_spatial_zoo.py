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
* the types still without a sharded form (the light-CNN backbones of
  A14 part 3c's second half: BiSeNetV1, BiSeNetV2, STDC's context path,
  ERFNet, CGNet) raise NotImplementedError naming themselves and ROADMAP
  A14 part 3.
"""

import pytest
import torch
import torch.nn.functional as F

from peanut_tpu_torch.core import spatial
from peanut_tpu_torch.models.sharded import forward_rows

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


# each type still without a sharded form, in the config that builds it
UNPORTED = {"BiSeNetV1": "bisenetv1", "ERFNet": "erfnet",
            "BiSeNetV2": "bisenetv2", "STDCContextPathNet": "stdc",
            "CGNet": "cgnet"}


@pytest.mark.parametrize("what", list(UNPORTED))
def test_a_type_without_a_sharded_form_raises(what):
    from peanut_tpu_torch.models.builder import build_segmentor
    model = build_segmentor(family_config(UNPORTED[what]), seed=0)
    x = spatial.shard(torch.rand(1, 3, 64, 64), cpus(2))
    with pytest.raises(NotImplementedError,
                       match=rf"{what}\b.*has no row-sharded.*A14 part 3"):
        with torch.no_grad():
            forward_rows(model, x)


def test_the_refusal_names_what_is_left():
    from peanut_tpu_torch.models import sharded
    for name in ("3c", "light-CNN", "slide", "padding mode", "3d"):
        assert name in sharded._LEFT
    assert "plain-ViT" not in sharded._LEFT
