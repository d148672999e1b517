"""Spatially sharded whole-map prediction of ISANet, OCRNet and PSANet
against the JAX package's GSPMD one over the 8 virtual CPU devices,
float32, at 128^2 and 120 x 96, within 1e-4
(tests/test_torch_spatial_zoo_3.py's construction and bars).  PSANet's
variables are made at each size, which shapes its masks on both sides.
K-Net and PointRend are in tests/test_torch_spatial_zoo_11.py.
"""

import pytest

from torch_spatial_zoo_support import check_against_jax
from torch_zoo_support import one_thread  # noqa: F401


@pytest.mark.parametrize("family", ["isanet", "ocrnet", "psanet"])
def test_sharded_prediction_matches_jax_on_8_devices(family):
    check_against_jax(family)
