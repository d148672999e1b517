"""The other six of the model zoo's twelve light-CNN families (ROADMAP
A13 part 4), whole, in the port against the JAX package, on the CPU:
ICNet (with ICNeck), PSPNet over MobileNetV2-d8, LR-ASPP over
MobileNetV3-large, PSPNet over ResNeSt-50, STDC1 (with its detail head as
the auxiliary head) and FCN over U-Net (the first six:
``test_torch_zoo_models_4.py``).

The family's first config as written (MobileNetV2-d8 and
MobileNetV3-large at their published widths), with no depth cut, on a
seeded 64x128 input, in float64 on both sides: logits within 1e-9 of the
largest |logit| and ``predict_labels`` equal
(``torch_zoo_support.check_family``).  ICNet's pyramid pooling meets a
2x4 map there, so its 3- and 6-bin pools are finer than the map.
"""

import pytest

import jax  # noqa: F401  (kept on the CPU by conftest)

from torch_zoo_support import LIGHT_FAMILIES, check_family
from torch_zoo_support import one_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("family", LIGHT_FAMILIES[6:])
def test_family_logits_and_labels_match_jax(family):
    check_family(family)
