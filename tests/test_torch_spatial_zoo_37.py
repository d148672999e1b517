"""The traps of the two-path real-time nets over the spatial axis, one
module at a time, on the CPU in float64 (the port against its unsharded
module, tests/test_torch_spatial_zoo_15.py's construction):

* the strided concatenations (STDC's stride-2 module: its 3x3 / 2
  average pool beside its depthwise stride-2 conv; BiSeNetV2's stride-2
  gather-and-expand layer and its shortcut; ERFNet's downsampler: a 3x3
  / 2 conv beside a 2x2 / 2 max pool; CGNet's downsampling block with its
  PReLUs), ERFNet's non-bottleneck block dilated 16 rows, CGNet's block
  dilated 4 and BiSeNet's attention refinement over 1 ... 8 shards of
  maps whose shards start on odd rows: the values and the input's
  gradient within 1e-12, in eval mode with random batch statistics;
* ERFNet's downsampler reads the whole map's sides: ``forward_rows`` of
  an ERFNet over a map with an odd side (41 x 64, 40 x 63, and 44 x 64,
  whose 1/4 level has 11 rows) raises the unsharded model's ValueError,
  over 1 and 3 shards, and a map of even sides runs over every k though
  its shards hold odd numbers of rows (40 rows over 3: 14 / 13 / 13);
* ICNet halves the whole map's height and width (``h // 2``, ``max(h //
  2, 1)``): ``forward_rows`` over 1 ... 8 shards of maps of odd sides
  (42 x 66, 45 x 70) equals the unsharded forward within 1e-12.
"""

import pytest
import torch

from peanut_tpu_torch.core import spatial
from peanut_tpu_torch.core.mesh import row_ranges
from peanut_tpu_torch.models import sharded
from peanut_tpu_torch.models.backbones_zoo import (ContextGuidedBlock,
                                                   STDCModule, _ARM,
                                                   _Downsampler, _GELayer,
                                                   _NonBottleneck1d)
from peanut_tpu_torch.models.layers import PReLU
from peanut_tpu_torch.models.sharded import forward_rows

from test_torch_spatial import _random_stats
from torch_spatial_zoo_support import SHARDS, TOL, cpus
from torch_zoo_support import family_config, one_thread  # noqa: F401

MODULES = {
    "stdc_module_stride_2": (lambda: STDCModule(8, 16, stride=2), 8),
    "ge_layer_stride_2": (lambda: _GELayer(4, 8, stride=2, expand=2), 4),
    "downsampler": (lambda: _Downsampler(4, 12), 4),
    "cg_block_downsample": (lambda: ContextGuidedBlock(
        8, 16, dilation=2, reduction=4, downsample=True), 8),
    "cg_block_dilated_4": (lambda: ContextGuidedBlock(
        16, 16, dilation=4, reduction=4), 16),
    "non_bottleneck_dilated_16": (lambda: _NonBottleneck1d(4, 16), 4),
    "arm": (lambda: _ARM(8, 8), 8)}
STRIDED = ("stdc_module_stride_2", "ge_layer_stride_2", "downsampler",
           "cg_block_downsample")


def _context():
    return sharded._Context(torch.device("cpu"), None)


def _module(name):
    make, channels = MODULES[name]
    torch.manual_seed(0)
    module = _random_stats(make()).double().eval()
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, PReLU):
                m.negative_slope.fill_(0.3)
    return module, channels


@pytest.mark.parametrize("name", list(MODULES))
def test_a_module_over_shards_that_start_on_odd_rows(name):
    module, c = _module(name)
    h = 22                            # over 3 shards rows 0, 8, 15 on
    if name in STRIDED:
        assert any(s % 2 for k in SHARDS for s, _ in row_ranges(h, k))
    x = torch.rand(2, c, h, 10, dtype=torch.float64,
                   generator=torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(9)
    xd = x.clone().requires_grad_(True)
    want = module(xd)
    weights = torch.randn(want.shape, generator=g, dtype=want.dtype)
    (want * weights).sum().backward()
    top, gtop = float(want.detach().abs().max()), float(xd.grad.abs().max())
    for k in SHARDS:
        xr = x.clone().requires_grad_(True)
        got = spatial.gather(sharded.run(module, spatial.shard(xr, cpus(k)),
                                         _context()))
        assert got.shape == want.shape, k
        assert float((got - want).detach().abs().max()) <= TOL * top, k
        (got * weights).sum().backward()
        assert float((xr.grad - xd.grad).abs().max()) <= TOL * gtop, k


def _model(family):
    from peanut_tpu_torch.models.builder import build_segmentor
    return _random_stats(build_segmentor(family_config(family),
                                         seed=0)).double()


@pytest.mark.parametrize("hw", [(41, 64), (40, 63), (44, 64)])
def test_erfnet_raises_on_an_odd_side_of_the_whole_map(hw):
    model = _model("erfnet")
    x = torch.rand((1, 3) + hw, dtype=torch.float64)
    with pytest.raises(ValueError, match="needs even sides") as whole:
        with torch.no_grad():
            model(x)
    for k in (1, 3):
        with pytest.raises(ValueError) as rows:
            with torch.no_grad():
                forward_rows(model, spatial.shard(x, cpus(k)))
        assert str(rows.value) == str(whole.value), k


def test_erfnet_runs_over_shards_of_odd_row_counts():
    model = _model("erfnet")
    x = torch.rand(1, 3, 40, 64, dtype=torch.float64,
                   generator=torch.Generator().manual_seed(2))
    assert [e - s for s, e in row_ranges(40, 3)] == [14, 13, 13]
    with torch.no_grad():
        want = model(x)
        for k in SHARDS:
            got = spatial.gather(forward_rows(model, spatial.shard(
                x, cpus(k))))
            assert float((got - want).abs().max()) <= TOL * float(
                want.abs().max()), k


@pytest.mark.parametrize("hw", [(42, 66), (45, 70)])
def test_icnet_halves_the_whole_map(hw):
    model = _model("icnet")
    x = torch.rand((1, 3) + hw, dtype=torch.float64,
                   generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want = model(x)
        for k in SHARDS:
            got = spatial.gather(forward_rows(model, spatial.shard(
                x, cpus(k))))
            assert float((got - want).abs().max()) <= TOL * float(
                want.abs().max()), k
