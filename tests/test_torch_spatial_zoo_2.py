"""The mesh's spatial axis over the model zoo's pooled-context and
attention ResNet heads, on the CPU, the port against itself in float64
(tests/test_torch_spatial_zoo.py's construction and bars):

* ``forward_rows`` of APCNet, DMNet, EncNet, ANN, GCNet, EMANet (global
  pools and partial sums over the pixels: region tokens, dynamic filters,
  the codebook's aggregation, GC's softmax over all pixels as a partial
  log-sum-exp, EMA's bases), DANet (CAM's energy as a partial sum, PAM's
  whole-map attention), NonLocal, DNL (whitening means and a global
  softmax) and CCNet (each column's keys from every shard, the self-mask
  at the global row) over ``["cpu"] * k`` for k = 1 ... 8 against the
  unsharded ``model(x)``, at 128^2 and at 40 x 64, within 1e-12 of the
  largest |logit|;
* no gathered head: over 2 shards no ``nn.Conv2d`` or ``nn.Linear`` of
  the neck or the heads of any of the fifteen families receives a map
  (or tokens) of a level's full size through its own forward, which the
  unsharded forward, run under the same hooks, shows they would see.
"""

import pytest

from torch_spatial_zoo_support import (ATTENTION, FAMILIES, POOLED, SHAPES,
                                       check_forward_rows,
                                       check_no_gathered_head)
from torch_zoo_support import one_thread  # noqa: F401


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("family", sorted(POOLED) + sorted(ATTENTION))
def test_forward_rows_matches_the_model(family, shape):
    check_forward_rows(family, SHAPES[shape])


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_no_head_receives_a_gathered_map(family):
    check_no_gathered_head(family)
