"""The plain-ViT families' modules see no gathered map over the spatial
axis, on the CPU (tests/test_torch_spatial_zoo_19.py's checks):

* no gathered map in the backbones: every ``nn.Conv2d`` and
  ``nn.Linear`` of VisionTransformer, BEiT and MAE (each family's, also
  under the written configs) gets fewer pixels or tokens in each call
  over 8 shards at 896 x 32 than in the unsharded forward, however it is
  called (``F.conv2d`` and ``F.linear`` counted): each shard projects its
  own tokens, the keys and values of every row are gathered, not the
  tokens before their projection;
* no gathered head: over 2 shards no ``nn.Conv2d`` or ``nn.Linear`` of
  the necks and heads over these backbones (UPerHead, FCNHead,
  SETRUPHead, DPTHead, Segmenter's mask transformer, MultiLevelNeck,
  Feature2Pyramid) receives a level's full map or tokens through its own
  forward, which the unsharded forward shows they would.

UPerNet-ViT's train step against JAX's GSPMD step is in
tests/test_torch_spatial_zoo_25.py.
"""

import pytest

from torch_spatial_zoo_support import (PLAIN_VIT, check_no_gathered_backbone,
                                       check_no_gathered_head)
from torch_zoo_support import one_thread  # noqa: F401


@pytest.mark.parametrize("family", sorted(PLAIN_VIT))
def test_no_backbone_module_receives_a_gathered_map(family):
    check_no_gathered_backbone(family)


@pytest.mark.parametrize("family", sorted(PLAIN_VIT))
def test_no_head_receives_a_gathered_map(family):
    check_no_gathered_head(family)
