"""Spatially sharded whole-map prediction of the zoo's pooled-context
ResNet families (APCNet, DMNet, EncNet, ANN, GCNet, EMANet) against the
JAX package's GSPMD one over 8 virtual CPU devices, float32, within
1e-4 (tests/test_torch_spatial_zoo_3.py's construction and bars).
"""

import pytest

from torch_spatial_zoo_support import POOLED, check_against_jax
from torch_zoo_support import one_thread  # noqa: F401


@pytest.mark.parametrize("family", sorted(POOLED))
def test_sharded_prediction_matches_jax_on_8_devices(family):
    check_against_jax(family)
