"""The mesh's spatial axis over the zoo's plain-ViT families, on the CPU,
the port against itself in float64 (tests/test_torch_spatial_zoo.py's
construction and bars): ``forward_rows`` over ``["cpu"] * k`` for k = 1
... 8 against the unsharded ``model(x)``, within 1e-12 of the largest
|logit|, at 128^2 (a patch grid of 8 rows: 32 / 16 / 8 / 4 rows in the
4x .. 0.5x taps, uneven over 3, 5, 6 and 7 shards) and at 40 x 64 (a
grid of 2 rows, the input's 40 rows split unevenly: a shard's patch rows
come from the global 16-row windows; shards of no rows):

* UPerNet-ViT-B/16 (its config's widths, cut to four blocks: the
  stride-16 patch embedding, the positional grid resized once to the
  whole patch grid, the global attention over every shard's keys and
  values), SETR (ViT + FCNHead), Segmenter (ViT + the mask transformer:
  the class tokens' attention once over every shard's keys and values
  and their own), DPT (the
  reassemble resizes, the residual fusion), BEiT (the relative-position
  bias over the 8 x 8 grid: square at 128^2, so it joins every block)
  and MAE (its positional embedding per patch), at their configs' narrow
  widths;
* the written configs over the SETR config's ViT: SETR's naive head
  (SETRUPHead), UPerHead over MultiLevelNeck and over Feature2Pyramid,
  and SETR's MLA head over MultiLevelNeck's taps, of equal size at 128^2
  (``torch_spatial_zoo_support.WRITTEN``).
"""

import pytest

from torch_spatial_zoo_support import SHAPES, check_forward_rows
from torch_zoo_support import one_thread  # noqa: F401

FAMILIES = ["beit", "dpt", "mae", "segmenter", "setr", "setr_mla",
            "setr_up", "vit", "vit_f2p", "vit_mln"]


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("family", FAMILIES)
def test_forward_rows_matches_the_model(family, shape):
    check_forward_rows(family, SHAPES[shape])
