"""Train mode of the model zoo's families in the port against the JAX
package, on the CPU: the other ten ResNetV1c EncoderDecoder families
(fastfcn ... upernet) and K-Net (the rest:
``test_torch_zoo_train_modes.py``, ``test_torch_zoo_train_modes_3.py``,
``test_torch_zoo_train_modes_4.py``).

Each family's first config at ``test_zoo_forward.py``'s ``SHRINK``
widths with ``CUTS``' depths and the heads' dropout 0, in float64 on both
sides on a seeded (2, 32, 64, C) input (BEiT's 32x32, a square patch
grid), from the JAX model's seeded variables carried by
``flax_to_torch_state`` (``torch_zoo_support.check_train_forward``): the
train forward's outputs (stage logits, the auxiliary head's, PointRend's
point logits and points) within 1e-9 of the largest |value| of the JAX
``apply(train=True, mutable=["batch_stats"])``'s, the running statistics
after it within 1e-8 relative; then the backward of the outputs' means
gives every parameter a finite gradient, non-zero but for
``ZERO_GRAD``'s, which match the JAX package's gradients (1e-4 of each
tensor's largest |value|).
"""

import pytest

import jax  # noqa: F401  (kept on the CPU by conftest)

from torch_zoo_support import FAMILIES, check_train_forward
from torch_zoo_support import one_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("family", FAMILIES[10:] + ("knet",))
def test_train_forward_matches_jax(family):
    check_train_forward(family)
