"""The plain-ViT families in train mode over the spatial axis, on the
CPU, the port against itself in float64
(tests/test_torch_spatial_zoo_19.py's construction and bars):

* ``forward_rows(train=True)`` of each family (the heads' dropout 0.1
  from one seeded generator, the batch norms' statistics of every shard)
  over 3 uneven shards, batch 2 at 64^2 (a 4 x 4 patch grid: 2 / 1 / 1
  rows): the logits within 1e-12 of their largest, and the gradients of
  one seeded weighted sum within ``check_train_grads``' bounds, those of
  ViT's positional grid, MAE's positional embedding, BEiT's
  relative-position tables and LayerScales (``gamma1``, ``gamma2``) and
  Segmenter's class tokens (``cls_emb``, read once, on the model's
  device) included;
* ``create_train_state`` refuses the configs without the auxiliary head
  the train step takes (all but UPerNet-ViT's), sharded or not, naming
  their heads (``check_heads``).
"""

import copy

import pytest

from torch_spatial_zoo_support import (PLAIN_VIT, check_train_mode_grads,
                                       port_model)
from torch_zoo_support import one_thread  # noqa: F401


@pytest.mark.parametrize("family", sorted(PLAIN_VIT))
def test_train_mode_gradients_over_3_shards_equal_unsharded(family):
    check_train_mode_grads(family, 3)


@pytest.mark.parametrize("family", sorted(set(PLAIN_VIT) - {"vit"}))
def test_the_train_step_refuses_a_config_without_an_auxiliary_head(family):
    from peanut_tpu_torch.prediction.train import (TrainConfig,
                                                   create_train_state)
    _, _, model = port_model(family)
    with pytest.raises(ValueError, match="auxiliary head None"):
        create_train_state(copy.deepcopy(model), TrainConfig(), device="cpu")
