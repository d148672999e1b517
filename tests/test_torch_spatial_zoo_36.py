"""The two-path real-time nets in train mode over the spatial axis, and
the inputs of their modules, on the CPU, the port against itself in
float64 (tests/test_torch_spatial_zoo_30.py's and _31.py's checks):

* ``forward_rows(train=True)`` of each family (the heads' dropout 0.1
  from one seeded generator, every batch norm's statistics from all
  shards' sums; the gates' batch norms, BiSeNetV2's ``ce_bn`` among
  them, over the (B, C, 1, 1) global mean on the model's device) over 3
  uneven shards, batch 2 at 64^2: the logits within 1e-12 of their
  largest, and the gradients of one seeded weighted sum within
  ``check_train_grads``' bounds;
* no gathered map in the backbones: every ``nn.Conv2d`` and
  ``nn.Linear`` of BiSeNetV1, BiSeNetV2, STDC's context path, CGNet,
  ERFNet and ICNet gets fewer pixels in each call over 8 shards at 896 x
  32 than in the unsharded forward, but the gates' (``global_modules``:
  the refinements' ``gate``, the fusion's ``gap_conv`` / ``ffm_fc1`` /
  ``ffm_fc2``, ``ce_conv``, CGNet's ``fc1`` / ``fc2``), which take the
  global mean, the same (B, C, 1, 1) map once, as unsharded;
* no gathered head or neck: over 2 shards no ``nn.Conv2d`` of FCNHead,
  STDCHead or ICNeck receives a level's full map through its own
  forward, which the unsharded forward shows they would.
"""

import pytest

from torch_spatial_zoo_support import (TWO_PATH, check_no_gathered_backbone,
                                       check_no_gathered_head,
                                       check_train_mode_grads)
from torch_zoo_support import one_thread  # noqa: F401


@pytest.mark.parametrize("family", sorted(TWO_PATH))
def test_train_mode_gradients_over_3_shards_equal_unsharded(family):
    check_train_mode_grads(family, 3)


@pytest.mark.parametrize("family", sorted(TWO_PATH))
def test_no_backbone_module_receives_a_gathered_map(family):
    check_no_gathered_backbone(family)


@pytest.mark.parametrize("family", sorted(TWO_PATH))
def test_no_head_receives_a_gathered_map(family):
    check_no_gathered_head(family)
