"""Spatially sharded whole-map prediction of the two-path real-time nets
against the JAX package's GSPMD one over the 8 virtual CPU devices,
float32, within 1e-4 (``torch_spatial_zoo_support.check_against_jax``),
at 256 x 128, where every level has at least 8 rows (1/32: 8): FCN over
BiSeNetV1, BiSeNetV2, STDC1's context path, CGNet, ERFNet and ICNet with
ICNeck, each at its first config's widths and depths.  All six agree with
JAX's GSPMD prediction within the bar, so none is in
``JAX_GSPMD_APART``.
"""

import pytest

from torch_spatial_zoo_support import TWO_PATH, check_against_jax
from torch_zoo_support import one_thread  # noqa: F401


@pytest.mark.parametrize("family", sorted(TWO_PATH))
def test_sharded_prediction_matches_jax_on_8_devices(family):
    check_against_jax(family, sizes=((256, 128),))
