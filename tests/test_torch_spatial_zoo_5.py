"""The zoo's attention ResNet families over the spatial axis, on the CPU:

* whole-map prediction of DANet, NonLocal, DNL and CCNet sharded over 8
  shards against the JAX package's GSPMD one over 8 virtual CPU devices,
  float32, within 1e-4 (tests/test_torch_spatial_zoo_3.py's construction
  and bars);
* their train mode, the port against itself in float64: one
  ``loss_and_grads`` (batch statistics over every shard, the heads'
  dropout 0.1 drawn for the whole map, the keys and values gathered with
  their gradients carried home) over 3 uneven shards against unsharded:
  losses within 1e-12 relative, each gradient within 1e-9 of its
  tensor's largest |value| plus 1e-12 of the model's largest, the
  running statistics within 1e-12 of the largest.
"""

import pytest

from torch_spatial_zoo_support import (ATTENTION, check_against_jax,
                                       check_train_grads)
from torch_zoo_support import one_thread  # noqa: F401


@pytest.mark.parametrize("family", sorted(ATTENTION))
def test_sharded_prediction_matches_jax_on_8_devices(family):
    check_against_jax(family)


@pytest.mark.parametrize("family", sorted(ATTENTION))
def test_train_mode_gradients_over_3_shards_equal_unsharded(family):
    check_train_grads(family, 3)
