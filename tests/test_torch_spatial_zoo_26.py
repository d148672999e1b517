"""The mesh's spatial axis over the zoo's light CNNs (ROADMAP A14 part
3c, first half), on the CPU, the port against itself in float64:

* ``spatial.avg_pool2d`` (flax's ``nn.avg_pool``, the padding counted in
  the mean) against ``F.avg_pool2d(count_include_pad=True)`` over 1 ... 8
  shards, even and uneven, at even and odd heights: ResNeSt's 3x3 / 2
  padded 1 before its split attention, its unpadded 2x2 / 2 shortcut
  (a window straddles two shards where a shard starts on an odd row),
  and a 3x3 / 1; the values and the input's gradient within 1e-12;
* the global-mean gates (MobileNetV3's squeeze-excitation, ResNeSt's
  split attention): the mean each shard's partial sum gives equals the
  unsharded mean within 1e-12, the gated rows equal the unsharded
  module's, and the gate's convolutions read the (B, C, 1, 1) mean, no
  gathered map (``spatial.fetch_rows`` is never called);
* ``forward_rows`` of PSPNet over MobileNetV2-d8 (depthwise convolutions
  dilated 2 and 4 at 1/8), LR-ASPP over MobileNetV3-large (SE gates and
  the head's image-pool gate) and PSPNet over TIMMBackbone's MobileNetV2
  (``torch_spatial_zoo_support.WRITTEN``: ``timm_mv2``) over ``["cpu"] *
  k`` for k = 1 ... 8 against the unsharded ``model(x)``, within 1e-12
  of the largest |logit|, at 128^2 and 40 x 64 (1/32's 2 rows: shards of
  none).
"""

import pytest
import torch
import torch.nn.functional as F

from peanut_tpu_torch.core import spatial
from peanut_tpu_torch.models import sharded
from peanut_tpu_torch.models.backbones_zoo import SELayer, SplitAttentionConv

from torch_spatial_zoo_support import SHAPES, SHARDS, check_forward_rows, cpus
from torch_zoo_support import one_thread  # noqa: F401


@pytest.mark.parametrize("hw", [(12, 10), (13, 9), (7, 8)])
@pytest.mark.parametrize("pool", [(3, 2, 1), (2, 2, 0), (3, 1, 1)])
def test_avg_pool2d_matches_avg_pool2d(pool, hw):
    kernel, stride, padding = pool
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, *hw, generator=g, dtype=torch.float64)
    xd = x.clone().requires_grad_(True)
    want = F.avg_pool2d(xd, kernel, stride, padding, count_include_pad=True)
    out_grad = torch.randn(want.shape, generator=g, dtype=torch.float64)
    want.backward(out_grad)
    top = float(want.detach().abs().max())
    for k in SHARDS:
        xr = x.clone().requires_grad_(True)
        got = spatial.avg_pool2d(spatial.shard(xr, cpus(k)), kernel, stride,
                                 padding)
        assert got.height == want.shape[2], k
        got = spatial.gather(got)
        assert float((got - want).detach().abs().max()) <= 1e-12 * top, k
        got.backward(out_grad)
        torch.testing.assert_close(xr.grad, xd.grad, rtol=0, atol=1e-12)


def _gate_module(kind: str):
    torch.manual_seed(0)
    if kind == "se":
        return SELayer(16).double().eval(), 16
    return SplitAttentionConv(8, 8, radix=2).double().eval(), 8


@pytest.mark.parametrize("kind", ["se", "split_attention"])
def test_the_global_mean_gate_reads_partial_sums(kind, monkeypatch):
    from peanut_tpu_torch.models import sharded_light
    module, c = _gate_module(kind)
    h = 13
    x = torch.rand(2, c, h, 9, dtype=torch.float64,
                   generator=torch.Generator().manual_seed(1))
    ctx = sharded._Context(torch.device("cpu"), None)
    fc1_inputs, fetched = [], []
    module.fc1.register_forward_pre_hook(
        lambda m, a: fc1_inputs.append(tuple(a[0].shape)))
    fetch_rows = spatial.fetch_rows

    def recording(x, a, b, device):
        fetched.append(b - a)
        return fetch_rows(x, a, b, device)

    monkeypatch.setattr(spatial, "fetch_rows", recording)
    with torch.no_grad():
        want = module(x)
        fc1_inputs.clear()
        for k in SHARDS:
            rows = spatial.shard(x, cpus(k))
            mean = sharded_light._global_mean(rows, ctx)
            assert float((mean - x.mean(dim=(2, 3), keepdim=True))
                         .abs().max()) <= 1e-12 * float(x.abs().max()), k
            fetched.clear()
            got = spatial.gather(sharded.run(module, rows, ctx))
            assert float((got - want).abs().max()) <= 1e-12 * float(
                want.abs().max()), k
            # SE fetches no rows; the split attention's 3x3 conv its halo
            assert (not fetched) if kind == "se" else (
                k == 1 or max(fetched) < h), (k, fetched)
    assert set(fc1_inputs) == {(2, c, 1, 1)}


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("family", ["mobilenet_v2", "mobilenet_v3",
                                    "timm_mv2"])
def test_forward_rows_matches_the_model(family, shape):
    check_forward_rows(family, SHAPES[shape])
