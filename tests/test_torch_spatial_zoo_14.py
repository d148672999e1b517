"""UPerNet over ConvNeXt-T and Swin-T (Swin cut to two blocks a stage,
``tests/torch_zoo_support.py``'s CUTS) over the spatial axis, on the
CPU, the port against itself in float64
(tests/test_torch_spatial_zoo.py's construction and bars):

* ``forward_rows`` over ``["cpu"] * k`` for k = 1 ... 8 against the
  unsharded ``model(x)``, within 1e-12 of the largest |logit|.
  ConvNeXt: the 4x4 stem and 2x2 downsamplings that drop the rows left
  over, counted from global row 0, and the 7x7 depthwise halos, which
  reach several shards away at 1/32.  Swin: the windows' bands across
  the shards' edges, the shifted blocks' last band, which wraps onto
  shard 0's rows, the seam mask at each window's global index, and the
  patch merging's row pairs.  At 40 x 64 only in this file: the
  published widths (UPerHead's 512 channels) at 128^2 take ~32 s for
  ConvNeXt and ~21 s for Swin on one core; Swin's 128^2 sweep is in
  tests/test_torch_spatial_zoo_18.py, ConvNeXt's is left out;
* one ``loss_and_grads`` of UPerNet-ConvNeXt-T (its config's auxiliary
  FCNHead, the one of the five families the train step takes) over 3
  uneven shards against unsharded (tests/test_torch_spatial_zoo_5.py's
  bars: losses within 1e-12 relative, each gradient within 1e-9 of its
  tensor's largest |value| plus 1e-12 of the model's largest, the
  running statistics within 1e-12 of the largest).
"""

import pytest

from torch_spatial_zoo_support import (SHAPES, check_forward_rows,
                                       check_train_grads)
from torch_zoo_support import one_thread  # noqa: F401


@pytest.mark.parametrize("family", ["convnext", "swin"])
def test_forward_rows_matches_the_model(family):
    check_forward_rows(family, SHAPES["40x64"])


def test_convnext_train_step_gradients_over_3_shards_equal_unsharded():
    check_train_grads("convnext", 3)
