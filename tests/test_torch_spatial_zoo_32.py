"""One train step of PSPNet over MobileNetV2-d8 (its config: the PSPHead
and the auxiliary FCNHead on the 1/8 level of 96 channels) with the
map's height over 2 shards, on the CPU in float64: the port's
``make_train_step(spatial_axis="spatial")`` against the JAX package's
GSPMD step over 2 of the virtual CPU devices
(``torch_spatial_zoo_support.check_train_step_against_jax``: SGD at
rate 1, the losses within 1e-9 relative, each gradient within 1e-9 of
the largest |gradient|, the batch statistics after the step within 1e-9
of the largest).  Batch 2 at 32^2: the 1/8 level has 2 rows a shard,
whose dilation-4 halos reach past the other shard into the padding.
Most of its time is XLA's float64 compile of the JAX step (~26 s on one
core; at 64^2 XLA's CPU float64 step takes ~35 s more to run).
Fast-SCNN's step in tests/test_torch_spatial_zoo_33.py.
"""

from torch_spatial_zoo_support import check_train_step_against_jax
from torch_zoo_support import one_thread  # noqa: F401


def test_mobilenet_v2_train_step_matches_jax_gspmd_over_2_shards():
    check_train_step_against_jax("mobilenet_v2", 2, hw=(32, 32))
