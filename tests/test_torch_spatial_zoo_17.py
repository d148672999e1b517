"""Spatially sharded whole-map prediction of SegFormer (MiT-B0) and
Twins-PCPVT against the JAX package's GSPMD one over the 8 virtual CPU
devices, float32, at 128^2 and 120 x 96, within 1e-4
(tests/test_torch_spatial_zoo_3.py's construction and bars).  At both
sizes JAX's GSPMD prediction of these two is apart from its own
unsharded one (``torch_spatial_zoo_support.JAX_GSPMD_APART``, ROADMAP
queue C): there the port is held to the unsharded one, and to the GSPMD
one at 256 x 128, where the two agree.
"""

import pytest

from torch_spatial_zoo_support import check_against_jax
from torch_zoo_support import one_thread  # noqa: F401


@pytest.mark.parametrize("family", ["segformer", "twins"])
def test_sharded_prediction_matches_jax_on_8_devices(family):
    check_against_jax(family)


@pytest.mark.parametrize("family", ["segformer", "twins"])
def test_matches_jax_gspmd_at_256x128(family):
    check_against_jax(family, sizes=((256, 128),))
