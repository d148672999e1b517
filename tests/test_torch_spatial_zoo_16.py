"""Spatially sharded whole-map prediction of UPerNet over ConvNeXt-T and
Swin-T (Swin cut to two blocks a stage) against the JAX package's GSPMD
one over the 8 virtual CPU devices, float32, at 128^2 and 120 x 96,
within 1e-4 (tests/test_torch_spatial_zoo_3.py's construction and
bars).  At 128^2 JAX's GSPMD prediction of ConvNeXt is apart from its
own unsharded one (``torch_spatial_zoo_support.JAX_GSPMD_APART``): there
the port is held to the unsharded one, and ConvNeXt is also held to
JAX's GSPMD prediction at 256 x 128, where that agrees with it.
SegFormer and the two Twins are in tests/test_torch_spatial_zoo_17.py
and tests/test_torch_spatial_zoo_18.py.
"""

import pytest

from torch_spatial_zoo_support import check_against_jax
from torch_zoo_support import one_thread  # noqa: F401


@pytest.mark.parametrize("family", ["convnext", "swin"])
def test_sharded_prediction_matches_jax_on_8_devices(family):
    check_against_jax(family)


def test_convnext_matches_jax_gspmd_at_256x128():
    check_against_jax("convnext", sizes=((256, 128),))
