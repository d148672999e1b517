"""The hierarchical transformers in train mode over the spatial axis and
the inputs of their modules, on the CPU, the port against itself in
float64:

* ``forward_rows(train=True)`` of UPerNet-Swin-T, SegFormer and the two
  Twins (configs without the auxiliary head the train step takes, which
  ``check_heads`` refuses as it does unsharded) over 3 uneven shards,
  batch 2 at 64^2 (the 1/32 level's 2 rows leave a shard without any):
  the logits within 1e-12 of their largest, and the gradients of one
  seeded weighted sum within ``check_train_grads``' bounds (1e-9 of each
  tensor's largest |value| plus 1e-12 of the model's largest);
* ``create_train_state`` refuses those four for the train step,
  sharded or not, naming their heads (``check_heads``);
* no gathered map in the backbones: every ``nn.Conv2d`` and
  ``nn.Linear`` of the five backbones, and SegFormerHead's, gets fewer
  pixels or tokens in each call over 8 shards at 896 x 32 than in the
  unsharded forward, however it is called (``F.conv2d`` and
  ``F.linear`` counted); that covers the reductions (``sr``) and the
  keys' and values' projections (``kv``), and Swin's and SVT's window
  bands;
* no gathered head: over 2 shards no ``nn.Conv2d`` or ``nn.Linear`` of
  the necks and heads over these backbones (UPerHead, FPN, FPNHead,
  SegFormerHead) receives a level's full map through its own forward,
  which the unsharded forward shows they would.
"""

import copy

import pytest

from torch_spatial_zoo_support import (HIERARCHICAL,
                                       check_no_gathered_backbone,
                                       check_no_gathered_head,
                                       check_train_mode_grads, port_model)
from torch_zoo_support import one_thread  # noqa: F401


@pytest.mark.parametrize("family", ["segformer", "svt", "swin", "twins"])
def test_train_mode_gradients_over_3_shards_equal_unsharded(family):
    check_train_mode_grads(family, 3)


@pytest.mark.parametrize("family", ["segformer", "svt", "swin", "twins"])
def test_the_train_step_refuses_a_config_without_an_auxiliary_head(family):
    from peanut_tpu_torch.prediction.train import (TrainConfig,
                                                   create_train_state)
    _, _, model = port_model(family)
    with pytest.raises(ValueError, match="auxiliary head None"):
        create_train_state(copy.deepcopy(model), TrainConfig(), device="cpu")


@pytest.mark.parametrize("family", sorted(HIERARCHICAL))
def test_no_backbone_module_receives_a_gathered_map(family):
    check_no_gathered_backbone(family)


@pytest.mark.parametrize("family", sorted(HIERARCHICAL))
def test_no_head_receives_a_gathered_map(family):
    check_no_gathered_head(family)
