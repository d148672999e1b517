"""The zoo's last five ResNet families in train mode over the spatial
axis and their heads' inputs, on the CPU, the port against itself in
float64 (tests/test_torch_spatial_zoo_5.py's check and bars):

* one ``loss_and_grads`` of ISANet, PSANet, OCRNet and K-Net (their
  configs' auxiliary FCNHead, batch statistics over every shard, the
  heads' dropout 0.1 drawn for the whole map) over 3 uneven shards
  against unsharded: losses within 1e-12 relative, each gradient within
  1e-9 of its tensor's largest |value| plus 1e-12 of the model's largest,
  the running statistics within 1e-12 of the largest;
* PointRend, which the train step refuses (no auxiliary head), in train
  mode over 3 shards: its stage's logits, the point pass's logits and
  points, and the gradients of both;
* no gathered head: over 2 shards no ``nn.Conv2d``, ``nn.Linear`` or
  PSAHead ``MaskConv`` of the neck or the heads of the five families, or
  of mmseg's FCN -> OCR cascade, receives a map (or tokens, ISAHead's
  padded groups among them) of a level's full size through its own
  forward, which the unsharded forward shows they would see.
"""

import pytest

from torch_spatial_zoo_support import (LAST, check_no_gathered_head,
                                       check_point_rend_train,
                                       check_train_grads,
                                       ocr_cascade_config)
from torch_zoo_support import one_thread  # noqa: F401


@pytest.mark.parametrize("family", ["isanet", "knet", "ocrnet", "psanet"])
def test_train_mode_gradients_over_3_shards_equal_unsharded(family):
    check_train_grads(family, 3)


def test_point_rend_train_mode_over_3_shards_equals_unsharded():
    check_point_rend_train(3)


@pytest.mark.parametrize("family", sorted(LAST) + ["ocr_cascade"])
def test_no_head_receives_a_gathered_map(family):
    if family == "ocr_cascade":
        from peanut_tpu_torch.models.builder import build_segmentor
        check_no_gathered_head(family, model=build_segmentor(
            ocr_cascade_config(), seed=0).double())
    else:
        check_no_gathered_head(family)
