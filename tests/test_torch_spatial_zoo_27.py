"""The mesh's spatial axis over the zoo's light CNNs (ROADMAP A14 part
3c, first half), on the CPU, the port against itself in float64
(tests/test_torch_spatial_zoo.py's construction and bars):
``forward_rows`` over ``["cpu"] * k`` for k = 1 ... 8 against the
unsharded ``model(x)``, within 1e-12 of the largest |logit|, at 128^2
and 40 x 64 (shards of no rows at the coarsest levels), of

* PSPNet over ResNeSt-50-d8 (its config's widths): the deep stem's max
  pool, the 3x3 average pools before the split attention, whose global
  mean and radix softmax are computed once, and the average-pooled
  shortcuts, whose 2x2 windows straddle two shards where a shard starts
  on an odd row (the 32 rows at 1/4 of 128^2 over 3, 5, 6, 7 shards);
* FCN over HRNet-W18: four branches of their own heights, each fused
  branch resized onto a finer branch's shards or brought down by a chain
  of strided convolutions, the head concatenating all four;
* FCN over UNet: 2x2 max pools whose windows straddle shards, the
  decoder's resize to the skip's rows and the skip concatenated first;
* Fast-SCNN: learning to downsample, the pyramid pool at 1/32 (a global
  map, as PSPHead's), the fusion's resize onto the 1/8 map and
  DepthwiseSeparableFCNHead.
"""

import pytest

from torch_spatial_zoo_support import SHAPES, check_forward_rows
from torch_zoo_support import one_thread  # noqa: F401


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("family", ["fastscnn", "hrnet", "resnest", "unet"])
def test_forward_rows_matches_the_model(family, shape):
    check_forward_rows(family, SHAPES[shape])
