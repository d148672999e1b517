"""Spatially sharded whole-map prediction of Twins-SVT (written over the
Twins config, ``torch_spatial_zoo_support.WRITTEN``) against the JAX
package's GSPMD one over the 8 virtual CPU devices, float32, at 128^2
and 120 x 96, within 1e-4 (tests/test_torch_spatial_zoo_3.py's
construction and bars); at both sizes JAX's GSPMD prediction of SVT is
apart from its own unsharded one (``JAX_GSPMD_APART``, ROADMAP queue
C), so there the port is held to the unsharded one, and to the GSPMD one
at 256 x 128, where the two agree.  And UPerNet-Swin-T's ``forward_rows``
at 128^2 over 1 ... 8 shards against the unsharded ``model(x)`` in
float64, within 1e-12 of the largest |logit| (its 40 x 64 sweep is in
tests/test_torch_spatial_zoo_14.py).
"""

from torch_spatial_zoo_support import (SHAPES, check_against_jax,
                                       check_forward_rows)
from torch_zoo_support import one_thread  # noqa: F401


def test_svt_sharded_prediction_matches_jax_on_8_devices():
    check_against_jax("svt")


def test_svt_matches_jax_gspmd_at_256x128():
    check_against_jax("svt", sizes=((256, 128),))


def test_swin_forward_rows_matches_the_model_at_128x128():
    check_forward_rows("swin", SHAPES["128x128"])
