"""The spatially sharded train step of DNLNet (its config at
tests/test_zoo_forward.py's widths, with its auxiliary FCNHead) against
the JAX package's GSPMD step, on the CPU, in float64, batch 2 at 64^2
over 3 uneven shards (8 rows at 1/8 as 3 / 3 / 2): the whitening means of
theta and phi and the unary softmax over all pixels in the backward pass
as in the forward (tests/test_torch_spatial_zoo_7.py's bars).
"""

from torch_spatial_zoo_support import check_train_step_against_jax
from torch_zoo_support import one_thread  # noqa: F401


def test_dnl_spatial_train_step_matches_jax_over_3_shards():
    check_train_step_against_jax("dnlnet", 3)
