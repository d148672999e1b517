"""The mesh's spatial axis over the zoo's hierarchical transformers, on
the CPU, the port against itself in float64
(tests/test_torch_spatial_zoo.py's construction and bars):

* ``forward_rows`` of SegFormer (MiT-B0: overlapping patch embeddings,
  keys and values of a map reduced by a strided convolution, each
  shard's reduced rows projected by it and gathered once a device, the
  Mix-FFN's depthwise 3x3; SegFormerHead), Twins-PCPVT (flax's "SAME"
  patch embeddings and reductions split from the whole map's height,
  the PEG; the FPN neck and FPNHead) and Twins-SVT (written over the
  Twins config: its windows of 7 over the map padded at its bottom,
  bands across a shard's edge computed by both shards) over ``["cpu"] *
  k`` for k = 1 ... 8 against the unsharded ``model(x)``, at 128^2 and
  at 40 x 64 (uneven shards, shards of no rows, a top pad of the
  reductions on shard 0, bands across every edge), within 1e-12 of the
  largest |logit|;
* ``MITB2`` (registered beside ``MixVisionTransformer``) over the
  SegFormer config at 2 and 3 shards, 40 x 64 only: its published
  widths are the heaviest of the file.
"""

import pytest
import torch

from peanut_tpu_torch.core import spatial
from peanut_tpu_torch.models.sharded import forward_rows

from torch_spatial_zoo_support import (SHAPES, TOL, check_forward_rows,
                                       cpus, image, port_model)
from torch_zoo_support import one_thread, rel_err  # noqa: F401


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("family", ["segformer", "svt", "twins"])
def test_forward_rows_matches_the_model(family, shape):
    check_forward_rows(family, SHAPES[shape])


@pytest.mark.parametrize("k", [2, 3])
def test_mitb2_forward_rows_matches_the_model(k):
    _, _, model = port_model("mitb2")
    assert type(model.backbone).__name__ == "MITB2"
    x = image(SHAPES["40x64"])
    with torch.no_grad():
        want = model(x, train=False)
        got = forward_rows(model, spatial.shard(x, cpus(k)), train=False)
    assert rel_err(spatial.gather(got).numpy(), want.numpy()) <= TOL
