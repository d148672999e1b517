"""One train step of UPerNet-ViT-B/16 (its config's widths cut to four
blocks, ``tests/torch_zoo_support.py``'s CUTS; its config's auxiliary
FCNHead, the one of the plain-ViT configs the train step takes) with
the map's height over 2 shards, on the CPU in float64: the port's
``make_train_step(spatial_axis="spatial")`` against the JAX package's
GSPMD step over 2 of the virtual CPU devices
(``torch_spatial_zoo_support.check_train_step_against_jax``: SGD at
rate 1, the losses within 1e-9 relative, each gradient within 1e-9 of
the largest |gradient|, the batch statistics after the step within 1e-9
of the largest).  ~80 s on one core, most of it XLA's float64 compile
of the JAX step.
"""

from torch_spatial_zoo_support import check_train_step_against_jax
from torch_zoo_support import one_thread  # noqa: F401


def test_upernet_vit_train_step_matches_jax_gspmd_over_2_shards():
    check_train_step_against_jax("vit", 2)
