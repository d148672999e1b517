"""Spatially sharded whole-map prediction of the light CNNs' MobileNet
families, Fast-SCNN and UNet against the JAX package's GSPMD one over
the 8 virtual CPU devices, float32, within 1e-4
(``torch_spatial_zoo_support.check_against_jax``), at 256 x 128, where
every level has at least 8 rows (1/8: 32, 1/32: 8): PSPNet over
MobileNetV2-d8, LR-ASPP over MobileNetV3-large, Fast-SCNN, FCN over
UNet, and PSPNet over TIMMBackbone's MobileNetV2 (its variables under
``backbone/model/...``).  ResNeSt and HRNet in
tests/test_torch_spatial_zoo_29.py.
"""

import pytest

from torch_spatial_zoo_support import check_against_jax
from torch_zoo_support import one_thread  # noqa: F401


@pytest.mark.parametrize("family", ["fastscnn", "mobilenet_v2",
                                    "mobilenet_v3", "timm_mv2", "unet"])
def test_sharded_prediction_matches_jax_on_8_devices(family):
    check_against_jax(family, sizes=((256, 128),))
