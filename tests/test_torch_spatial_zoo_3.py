"""Spatially sharded whole-map prediction of the zoo's convolutional ResNet
families against the JAX package's, on the CPU: JAX's
``PredictionModel(model_cfg=<the family's first config>)
.get_prediction_sharded`` over the 8 virtual CPU devices of
tests/conftest.py (GSPMD inserts every exchange) against the port's
``PredictionModel(model=<the variables carried>).get_prediction_sharded``
over ``make_mesh({"spatial": 8}, ["cpu"] * 8)``, float32, at 128^2 and
120 x 96: within 1e-4 (tests/test_torch_spatial_2.py's bar).  UPerNet, Semantic FPN,
DeepLabV3, DeepLabV3+ and FastFCN (tests/test_torch_spatial_zoo_4.py and
_5.py hold the others).
"""

import pytest

from torch_spatial_zoo_support import CONVOLUTIONAL, check_against_jax
from torch_zoo_support import one_thread  # noqa: F401


@pytest.mark.parametrize("family", sorted(CONVOLUTIONAL))
def test_sharded_prediction_matches_jax_on_8_devices(family):
    check_against_jax(family)
