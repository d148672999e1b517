"""Spatially sharded whole-map prediction of K-Net and PointRend against
the JAX package's GSPMD one over the 8 virtual CPU devices, float32, at
128^2 and 120 x 96, within 1e-4 (tests/test_torch_spatial_zoo_3.py's
construction and bars).  PointRend's subdivision chooses the same cells
in each round on both sides: the port's from ``forward_rows``'s trace
over 8 shards, the JAX package's read back from the points its point
head is given under jit over the 8 devices; where a place differs, the
two cells are a float32 near-tie (within 1e-5 of the largest
uncertainty, ``torch_spatial_zoo_support.POINT_TIE``), as the JAX
package's own sharded and unsharded runs also order them apart.
"""

import pytest

from torch_spatial_zoo_support import check_against_jax
from torch_zoo_support import one_thread  # noqa: F401


@pytest.mark.parametrize("family", ["knet", "point_rend"])
def test_sharded_prediction_matches_jax_on_8_devices(family):
    check_against_jax(family)
