"""The first six of the model zoo's twelve light-CNN families (ROADMAP
A13 part 4), whole, in the port against the JAX package, on the CPU:
BiSeNetV1 (over its ResNet-18 context path), BiSeNetV2, CGNet, ERFNet,
Fast-SCNN and FCN over HRNet-W18 (the other six:
``test_torch_zoo_models_5.py``).

The family's first config as written (their backbones size themselves,
so ``test_zoo_forward.py``'s ``SHRINK`` leaves them; Fast-SCNN and
HRNet-W18 are at their published widths), with no depth cut, on a
seeded 64x128 input: the JAX model's variables (seeded normals, CGNet's
PReLU slopes among them, random batch statistics, norms and biases)
carried by ``flax_to_torch_state``; in float64 on both sides the logits
agree within 1e-9 of the largest |logit| and ``predict_labels`` is equal
(``torch_zoo_support.check_family``).  HRNet-W18's 4 + 3 stage-3 and
stage-4 modules take about half of this file's time.
"""

import pytest

import jax  # noqa: F401  (kept on the CPU by conftest)

from torch_zoo_support import LIGHT_FAMILIES, check_family
from torch_zoo_support import one_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("family", LIGHT_FAMILIES[:6])
def test_family_logits_and_labels_match_jax(family):
    check_family(family)
