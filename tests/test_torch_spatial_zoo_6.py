"""The zoo's convolutional and pooled-context ResNet families in train
mode over the spatial axis, the port against itself in float64 on the
CPU (tests/test_torch_spatial_zoo_5.py's check and bars): one
``loss_and_grads`` over 3 uneven shards and over 8 (shards of one row and
of none at 64^2) against unsharded, for every family whose config has
the auxiliary head the train step takes (Semantic FPN and FastFCN have
none).  The pooled-context heads' global norms (EncHead's ``enc_bn`` on
the codebook's global output, DMHead's ``dcm{i}_bn`` on a sharded map)
move their running statistics once.
"""

import pytest

from torch_spatial_zoo_support import (ATTENTION, TRAINABLE,
                                       check_train_grads)
from torch_zoo_support import one_thread  # noqa: F401


@pytest.mark.parametrize("k", [3, 8])
@pytest.mark.parametrize("family", [f for f in TRAINABLE
                                    if f not in ATTENTION])
def test_train_mode_gradients_equal_unsharded(family, k):
    check_train_grads(family, k)
