"""The spatially sharded train step of UPerNet-R50 (its config at
tests/test_zoo_forward.py's widths, with its auxiliary FCNHead) against
the JAX package's GSPMD step, on the CPU, in float64 on both sides
(``jax.enable_x64``), batch 2 at 64^2 over 4 shards: the 1/32 level's 2
rows leave two shards empty, and the lateral top-down sum resizes between
levels whose row splits differ.  Plain SGD at rate 1 on both sides (the
update is the gradient): losses within 1e-9 relative, every gradient
within 1e-9 of the largest |gradient|, the batch statistics within 1e-9
of the largest (``torch_spatial_zoo_support.check_train_step_against_jax``).
"""

from torch_spatial_zoo_support import check_train_step_against_jax
from torch_zoo_support import one_thread  # noqa: F401


def test_upernet_spatial_train_step_matches_jax_over_4_shards():
    check_train_step_against_jax("upernet", 4)
