"""Spatially sharded whole-map prediction of the plain-ViT families
against the JAX package's GSPMD one over the 8 virtual CPU devices,
float32, within 1e-4 (tests/test_torch_spatial_zoo_3.py's construction
and bars): at 256 x 128, where each of the 4x .. 0.5x taps has at least
8 rows (64 / 32 / 16 / 8), and at 128^2 (a patch grid of 8 rows: the
0.5x tap's 4 rows leave half the devices without one).  JAX's GSPMD
prediction of these families equals its unsharded one at 128^2
(``torch_spatial_zoo_support.jax_gspmd_levels``: 0 at every level), so
none is in ``JAX_GSPMD_APART``.  UPerNet-ViT-B/16 (cut to four blocks),
SETR, Segmenter, DPT, BEiT (its relative-position table made at each
size: at 128^2 its bias joins) and MAE; the configs written over the
SETR config's ViT in tests/test_torch_spatial_zoo_22.py.
"""

import pytest

from torch_spatial_zoo_support import check_against_jax
from torch_zoo_support import one_thread  # noqa: F401

SIZES = ((256, 128), (128, 128))


@pytest.mark.parametrize("family", ["beit", "dpt", "mae", "segmenter", "setr",
                                    "vit"])
def test_sharded_prediction_matches_jax_on_8_devices(family):
    check_against_jax(family, sizes=SIZES)
