"""One train step of Fast-SCNN (its config: DepthwiseSeparableFCNHead on
the fusion and the auxiliary FCNHead on the 1/8 higher-resolution map)
with the map's height over 2 shards, on the CPU in float64, against the
JAX package's GSPMD step over 2 of the virtual CPU devices
(tests/test_torch_spatial_zoo_32.py's check and bars), batch 2 at 32^2:
its 1/32 level has 1 row, so one shard holds none of it.  Most of its
time is XLA's float64 compile of the JAX step.
"""

from torch_spatial_zoo_support import check_train_step_against_jax
from torch_zoo_support import one_thread  # noqa: F401


def test_fast_scnn_train_step_matches_jax_gspmd_over_2_shards():
    check_train_step_against_jax("fastscnn", 2, hw=(32, 32))
