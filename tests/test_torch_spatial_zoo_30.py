"""The light CNNs' first half in train mode over the spatial axis, on the
CPU, the port against itself in float64
(tests/test_torch_spatial_zoo_19.py's construction and bars):
``forward_rows(train=True)`` of each family (the heads' dropout 0.1 from
one seeded generator, every batch norm's statistics from all shards'
sums, the squeeze-excitation and split-attention gates from the global
mean, their own batch norms over the (B, C, 1, 1) mean) over 3 uneven
shards, batch 2 at 64^2 (HRNet's and Fast-SCNN's 1/32: 2 rows, a shard of
none): the logits within 1e-12 of their largest, and the gradients of
one seeded weighted sum within ``check_train_grads``' bounds.

ResNeSt's split attention normalises its global mean over the batch
(``fc1``'s batch norm over (B, C, 1, 1), flax's E[x^2] - E[x]^2): over 2
images of one distribution some channels' two values agree to ~1e-4
(var / mean^2 down to 9e-9), so a shard's rounding of 1e-16 moves the
logits by 4.3e-10 and the gradients (up to 6.6e6) by 4.4e-8 of a
tensor's largest, and the unsharded forward is as sensitive to the
rounding of its input.  Its check takes 4 images (var / mean^2 at least
1.7e-4): the logits within 1e-11 (3.1e-12 measured), the gradients
within the bounds of the others.
"""

import pytest

from torch_spatial_zoo_support import LIGHT_FIRST, check_train_mode_grads
from torch_zoo_support import one_thread  # noqa: F401

CONDITIONED = {"resnest": dict(batch=4, tol=1e-11)}


@pytest.mark.parametrize("family", sorted(LIGHT_FIRST))
def test_train_mode_gradients_over_3_shards_equal_unsharded(family):
    check_train_mode_grads(family, 3, **CONDITIONED.get(family, {}))
