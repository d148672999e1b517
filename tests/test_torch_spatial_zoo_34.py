"""The mesh's spatial axis over the zoo's two-path real-time nets (ROADMAP
A14 part 3c, second half), on the CPU, the port against itself in
float64 (tests/test_torch_spatial_zoo.py's construction and bars):
``forward_rows`` over ``["cpu"] * k`` for k = 1 ... 8 against the
unsharded ``model(x)``, within 1e-12 of the largest |logit|, at 128^2
and 40 x 64 (shards of no rows at the coarsest levels), of

* FCN over BiSeNetV1 (the spatial path's 7x7 / 2 and 3x3 / 2 convs, the
  ResNet-18 context path, the attention refinements' and the fusion's
  gates from global means, the context maps resized onto the finer
  map's shards);
* FCN over BiSeNetV2 (the stem's max pool beside its strided conv, the
  stride-2 gather-and-expand layers with their shortcuts, the context
  embedding added to every shard, the guided aggregation's average pool,
  sigmoid gates between 1/8 and 1/32 and its resizes);
* FCN over STDC1's context path with STDCHead as the auxiliary head
  (the stride-2 modules' average pool concatenated with their depthwise
  strided conv: 1/4's 32 rows at 128^2 split 11 / 11 / 10 over 3
  shards, so a shard starts on an odd row);
* FCN over CGNet (PReLU, the dilated depthwise surrounding convs, the
  global-context gate of two dense layers, the input injection's average
  pool resized to 1/4);
* FCN over ERFNet (the downsamplers, the (3, 1) convs dilated up to 16
  rows at 1/8, past the neighbouring shard, the decoder's 2x resizes);
* FCN over ICNet with ICNeck (the input resized to half its height, the
  dilated bottlenecks on the map halved again, the pyramid pool's global
  bins, the neck's resizes and dilated fusion convs).
"""

import pytest

from torch_spatial_zoo_support import SHAPES, TWO_PATH, check_forward_rows
from torch_zoo_support import one_thread  # noqa: F401


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("family", sorted(TWO_PATH))
def test_forward_rows_matches_the_model(family, shape):
    check_forward_rows(family, SHAPES[shape])
