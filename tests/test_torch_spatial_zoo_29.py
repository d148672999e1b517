"""Spatially sharded whole-map prediction of ResNeSt and HRNet against
the JAX package's GSPMD one over the 8 virtual CPU devices, float32,
within 1e-4 (``torch_spatial_zoo_support.check_against_jax``), at 256 x
128, where every level has at least 8 rows (ResNeSt's 1/8 and HRNet's
1/32: 8): PSPNet over ResNeSt-50-d8 (its average pools and the split
attention's global mean as GSPMD computes them) and FCN over HRNet-W18
with one module a stage and two blocks a branch
(``torch_spatial_zoo_support.WRITTEN``: ``hrnet_cut``; the four
branches and every fusion path, the config's
depth held against the unsharded forward in
tests/test_torch_spatial_zoo_27.py).  Both agree with JAX's GSPMD
prediction within the bar, so neither is in ``JAX_GSPMD_APART``.
"""

import pytest

from torch_spatial_zoo_support import check_against_jax
from torch_zoo_support import one_thread  # noqa: F401


@pytest.mark.parametrize("family", ["hrnet_cut", "resnest"])
def test_sharded_prediction_matches_jax_on_8_devices(family):
    check_against_jax(family, sizes=((256, 128),))
