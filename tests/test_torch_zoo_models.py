"""The first ten of the twenty ResNetV1c EncoderDecoder families of the
model zoo, whole, in the port against the JAX package, on the CPU (the
other ten: ``test_torch_zoo_models_2.py``; a file each keeps each near a
minute, the JAX package's compiles dominating).

The family's first config at ``tests/test_zoo_forward.py``'s ``SHRINK``
widths (base and stem 16, the heads scaled to match), on a seeded 64x128
input: the JAX model's variables (every one, the auxiliary head's too:
seeded normals, random batch statistics, norms and biases, non-zero
attention gates) carried by ``flax_to_torch_state``; in float64 on both
sides the logits agree within 1e-9 of the largest |logit| and
``predict_labels`` is equal (``torch_zoo_support.check_family``).
"""

import pytest

import jax  # noqa: F401  (kept on the CPU by conftest)

from torch_zoo_support import FAMILIES, check_family
from torch_zoo_support import one_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("family", FAMILIES[:10])
def test_family_logits_and_labels_match_jax(family):
    check_family(family)
