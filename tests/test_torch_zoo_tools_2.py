"""``cli.export`` of the port (ROADMAP A13 part 6) on the CPU, for a
reduced-width config of each kind of inference code (tests/
test_torch_zoo_tools.py holds two models against the JAX package): a
transformer (Swin, SegFormer), the two cascades (K-Net, PointRend),
slide inference, and a family whose parameters take their shape from
the input (``layers.InputShaped``: BEiT) at its bound size.  The
``torch.export`` program, saved and reloaded, is bit-equal to the eager
port."""

import numpy as np
import pytest
import torch

from peanut_tpu_torch import apis
from peanut_tpu_torch.cli import export

from torch_zoo_support import family_config, one_thread  # noqa: F401


def _kind_config(kind):
    if kind == "slide":
        cfg = family_config("fcn")
        cfg["test_cfg"] = dict(mode="slide", crop_size=(48, 48),
                               stride=(32, 32))
        return cfg, (1, 48, 80, 3)        # two windows, overlapping
    return family_config(kind), (1, 64, 64, 3)


@pytest.mark.parametrize("kind", ["swin", "segformer", "knet", "point_rend",
                                  "slide", "beit"])
def test_export_equals_eager_for_each_kind_of_inference(kind, tmp_path):
    cfg, shape = _kind_config(kind)
    out = str(tmp_path / "m.pt2")
    export.export_segmentor(cfg, out, shape, device="cpu")
    bundle = apis.init_segmentor(cfg, input_size=shape[1], device="cpu")
    x = torch.as_tensor(np.random.RandomState(4).rand(*shape)
                        .astype(np.float32))
    with torch.no_grad():
        got = torch.export.load(out).module()(x)
        eager = bundle.model.inference(x)
    assert got.shape == eager.shape
    assert torch.equal(got, eager)
