"""The ten transformer families of the model zoo (ROADMAP A13 part 3),
whole, in the port against the JAX package, on the CPU: the first config
of each family (``torch_zoo_support.check_family``) in float64 on both
sides, logits within 1e-9 of the largest |logit| on a 64x128 input (32x64
for the three UPerNets of 512 channels: ConvNeXt-T, Swin-T, ViT-B) and
``predict_labels`` equal.

BEiT, ConvNeXt-T, DPT, MAE, SegFormer (MiT-B0), Segmenter, SETR and
Twins-PCPVT run at their configs' widths and depths.  Two are cut in
depth, not in width (``torch_zoo_support.CUTS``), to keep this file near a
minute on one core: ViT-B/16 (UPerNet, 150 classes) keeps four of its
twelve blocks, a tap after each; Swin-T keeps two blocks a stage (the
second shifted).  The card runs the published widths and depths
(chip_smoke.py's zoo phase).
"""

import pytest

import jax  # noqa: F401  (kept on the CPU by conftest)

from torch_zoo_support import TRANSFORMER_FAMILIES, check_family
from torch_zoo_support import one_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("family", TRANSFORMER_FAMILIES)
def test_family_logits_and_labels_match_jax(family):
    check_family(family)
