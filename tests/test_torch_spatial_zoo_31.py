"""The light CNNs' first half sees no gathered map over the spatial axis,
on the CPU (tests/test_torch_spatial_zoo_19.py's checks):

* no gathered map in the backbones: every ``nn.Conv2d`` of MobileNetV2,
  MobileNetV3, ResNeSt, HRNet (W18 with one module a stage and two
  blocks a branch: ``torch_spatial_zoo_support.WRITTEN``'s
  ``hrnet_cut``), UNet and Fast-SCNN gets fewer pixels in each call over
  8 shards at 896 x 32
  than in the unsharded forward (``F.conv2d`` counted), but the gates'
  and Fast-SCNN's pyramid pool's, which take the global pooled map, the
  same (B, C, <= 6, <= 6) map once, as unsharded;
* no gathered head: over 2 shards no ``nn.Conv2d`` of the heads over
  these backbones (LRASPPHead, DepthwiseSeparableFCNHead with
  SepConvModule, PSPHead, FCNHead) receives a level's full map through
  its own forward, which the unsharded forward shows they would.
"""

import pytest

from torch_spatial_zoo_support import (LIGHT_FIRST,
                                       check_no_gathered_backbone,
                                       check_no_gathered_head)
from torch_zoo_support import one_thread  # noqa: F401

FAMILIES = sorted(set(LIGHT_FIRST) - {"hrnet"}) + ["hrnet_cut"]


@pytest.mark.parametrize("family", FAMILIES)
def test_no_backbone_module_receives_a_gathered_map(family):
    check_no_gathered_backbone(family)


@pytest.mark.parametrize("family", FAMILIES)
def test_no_head_receives_a_gathered_map(family):
    check_no_gathered_head(family)
