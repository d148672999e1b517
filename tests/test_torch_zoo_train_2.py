"""The zoo's train step on the light-CNN families, in the port against the
JAX package, on the CPU (``test_torch_zoo_train.py`` has the
transformers, the cascade and the entry points).

One train step of PEANUT's recipe in float64 on both sides, dropout 0,
batch 2 at 32x32, 14 input channels and 6 classes, from the JAX model's
seeded variables (``torch_zoo_support.check_train_step``): PSPNet over
MobileNetV2-d8 (widen factor 0.5, narrow heads), Fast-SCNN (its published
backbone, narrow heads), BiSeNetV1 (its nested ResNet-18) and STDC1
(``STDCHead`` the auxiliary head) as their configs size them.  Bars: the
loss within 1e-5 relative, every gradient within 1e-4 of its tensor's
largest |value| (plus 1e-10 of the model's largest), the running
statistics within 1e-8 relative, the parameters after Adam within 1e-4
of the learning rate.
"""

import pytest

import jax  # noqa: F401  (kept on the CPU by conftest)

from torch_zoo_support import check_train_step
from torch_zoo_support import one_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("family", ["pspnet_m-v2-d8", "fast_scnn",
                                    "bisenetv1_r18", "stdc1"])
def test_train_step_matches_jax(family):
    check_train_step(family)
