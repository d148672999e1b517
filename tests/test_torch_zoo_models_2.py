"""The last ten of the twenty ResNetV1c EncoderDecoder families of the
model zoo, whole, in the port against the JAX package, on the CPU: the
check of ``test_torch_zoo_models.py`` (``torch_zoo_support.
check_family``), in a file of its own to keep each near a minute."""

import pytest

import jax  # noqa: F401  (kept on the CPU by conftest)

from torch_zoo_support import FAMILIES, check_family
from torch_zoo_support import one_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("family", FAMILIES[10:])
def test_family_logits_and_labels_match_jax(family):
    check_family(family)
