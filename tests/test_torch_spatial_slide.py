"""Slide inference over a row-sharded map and convolutions padded by a
string or in another mode than zeros, on the CPU, the port against itself
in float64 (``core.spatial``, ``models.sharded.slide_rows``):

* ``spatial.window`` over k = 1 ... 8 shards: the window's rows and
  columns split again over the same devices (empty blocks where it has
  fewer rows than shards), its input gradients those of the slice;
* ``slide_rows`` of the dry run's PSPNet and of BiSeNetV2 over k = 1 ...
  8 shards against ``model.slide_inference`` at 128^2 (nine 64^2
  windows every 48 rows, which straddle shards, the last ones clamped
  to the border), 120 x 96 (clamped rows and columns) and 40 x 64 (a map
  lower than the crop; the windows' 1/8 maps have 5 rows, fewer than 6
  to 8 shards): within 1e-12 of the largest |logit|; the counts of
  windows over each pixel equal a count made from mmseg's windows bit for
  bit; in bfloat16 the sharded slide's probabilities (the sigmoid in
  float32, as ``get_prediction_sharded`` takes it) within 1e-2 of the
  unsharded one's, its sums and counts in the input's type;
* ``spatial.conv2d`` (``nn.Conv2d``'s sharded form) padded "same"
  (kernels 3 and 4, dilation 1 and 2), "valid", and in reflect,
  replicate and circular mode (padding 1 - 3 and a pair, stride 1 and 2,
  dilation 1 and 2) over k = 1 ... 8 at heights 5, 12 and 40 against the
  module: values and input gradients within 1e-12;
* ``spatial.fetch_padded``'s modes against ``F.pad`` of the whole map,
  for every window of rows in the padded range;
* where torch raises (a reflect or circular padding past the map's
  height, "same" with a stride, a kernel past the padded map), the
  sharded form raises the same type with torch's message, from the whole
  map's height whatever the shards' rows.
"""

import copy

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from peanut_tpu_torch.core import spatial
from peanut_tpu_torch.core.mesh import row_ranges
from peanut_tpu_torch.models.builder import build_segmentor
from peanut_tpu_torch.models.sharded import _slide_sums, slide_rows
from peanut_tpu_torch.multichip import DRYRUN_MODEL

from test_torch_spatial import _random_stats
from torch_zoo_support import family_config, one_thread  # noqa: F401

SHARDS = range(1, 9)
TOL = 1e-12
SLIDE = dict(mode="slide", crop_size=(64, 64), stride=(48, 48))
SHAPES = {"128x128": (128, 128), "120x96": (120, 96), "40x64": (40, 64)}


def cpus(k):
    return ["cpu"] * k


def rand(*shape, seed=0):
    return torch.rand(shape, generator=torch.Generator().manual_seed(seed),
                      dtype=torch.float64)


def err_of_largest(got, want) -> float:
    assert got.shape == want.shape
    return float((got - want).detach().abs().max()) / float(
        want.detach().abs().max())


@pytest.mark.parametrize("win", [(0, 40, 0, 9), (3, 6, 2, 7), (17, 39, 5, 6),
                                 (20, 21, 4, 9), (38, 40, 0, 9)])
def test_window_of_a_sharded_map(win):
    y1, y2, x1, x2 = win
    x = rand(2, 3, 40, 9, seed=1)
    weights = rand(2, 3, y2 - y1, x2 - x1, seed=2)
    xd = x.clone().requires_grad_(True)
    (xd[:, :, y1:y2, x1:x2] * weights).sum().backward()
    for k in SHARDS:
        xr = x.clone().requires_grad_(True)
        got = spatial.window(spatial.shard(xr, cpus(k)), y1, y2, x1, x2)
        assert got.height == y2 - y1
        assert [b.shape[2] for b in got.blocks] == [
            e - s for s, e in row_ranges(y2 - y1, k)]
        assert all(b.shape[3] == x2 - x1 for b in got.blocks)
        assert torch.equal(spatial.gather(got), x[:, :, y1:y2, x1:x2])
        (spatial.gather(got) * weights).sum().backward()
        assert torch.equal(xr.grad, xd.grad), k
    with pytest.raises(ValueError):
        spatial.window(spatial.shard(x, cpus(2)), 0, 41, 0, 9)


@pytest.fixture(scope="module")
def slide_models():
    psp = _random_stats(build_segmentor(dict(copy.deepcopy(DRYRUN_MODEL),
                                             test_cfg=dict(SLIDE)), seed=0))
    light = build_segmentor(dict(family_config("bisenetv2"),
                                 test_cfg=dict(SLIDE)), seed=0)
    return {"pspnet": (psp.double().eval(), 14),
            "bisenetv2": (light.double().eval(), 3)}


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("model", ["pspnet", "bisenetv2"])
def test_slide_rows_matches_slide_inference(slide_models, model, shape):
    m, channels = slide_models[model]
    x = rand(1, channels, *SHAPES[shape], seed=3)
    with torch.no_grad():
        want = m.slide_inference(x)
        for k in SHARDS:
            got = slide_rows(m, spatial.shard(x, cpus(k)))
            assert [b.shape[2] for b in got.blocks] == [
                e - s for s, e in row_ranges(x.shape[2], k)]
            assert err_of_largest(spatial.gather(got), want) <= TOL, k


def _mmseg_count(h, w, crop, stride):
    """mmseg's windows over an h x w map, counted over each pixel."""
    count = torch.zeros(1, 1, h, w, dtype=torch.float64)
    for hi in range(max(h - crop[0] + stride[0] - 1, 0) // stride[0] + 1):
        for wi in range(max(w - crop[1] + stride[1] - 1, 0) // stride[1] + 1):
            y1 = min(hi * stride[0], max(h - crop[0], 0))
            x1 = min(wi * stride[1], max(w - crop[1], 0))
            count[:, :, y1:y1 + crop[0], x1:x1 + crop[1]] += 1.0
    return count


@pytest.mark.parametrize("shape", list(SHAPES))
def test_slide_counts_equal_the_unsharded_ones(slide_models, shape):
    m, channels = slide_models["bisenetv2"]
    x = rand(1, channels, *SHAPES[shape], seed=3)
    want = _mmseg_count(*SHAPES[shape], SLIDE["crop_size"], SLIDE["stride"])
    assert float(want.max()) > 1.0 or shape == "40x64"
    with torch.no_grad():
        for k in (1, 3, 8):
            preds, count = _slide_sums(m, spatial.shard(x, cpus(k)))
            assert preds.dtype == count.dtype == torch.float64
            assert torch.equal(spatial.gather(count), want), k


def test_bf16_sharded_slide_near_the_unsharded_one(slide_models):
    m = copy.deepcopy(slide_models["pspnet"][0]).to(torch.bfloat16)
    x = rand(1, 14, 120, 96, seed=5).to(torch.bfloat16)
    with torch.no_grad():
        want = m.slide_inference(x)
        assert want.dtype == torch.bfloat16
        for k in (2, 3, 5):
            rows = spatial.shard(x, cpus(k))
            preds, count = _slide_sums(m, rows)
            assert preds.dtype == count.dtype == torch.bfloat16
            got = slide_rows(m, rows)
            assert got.dtype == torch.bfloat16
            gap = float((torch.sigmoid(spatial.gather(got).float())
                         - torch.sigmoid(want.float())).abs().max())
            assert gap <= 1e-2, (k, gap)


# nn.Conv2d's keyword arguments past the channels
CONVS = {
    "same_k3": dict(kernel_size=3, padding="same"),
    "same_k4": dict(kernel_size=4, padding="same"),
    "same_k3_d2": dict(kernel_size=3, padding="same", dilation=2),
    "same_k4_d2_reflect": dict(kernel_size=(4, 3), padding="same",
                               dilation=2, padding_mode="reflect"),
    "valid": dict(kernel_size=3, padding="valid"),
    "valid_s2": dict(kernel_size=2, padding="valid", stride=2),
    **{f"{mode}_p{p}_s{s}": dict(kernel_size=3, padding=p, stride=s,
                                 padding_mode=mode)
       for mode in ("reflect", "replicate", "circular")
       for p in (1, 2, 3) for s in (1, 2)},
    "reflect_pair_d2": dict(kernel_size=3, padding=(2, 1), dilation=2,
                            padding_mode="reflect"),
    "circular_pair_s2": dict(kernel_size=(2, 3), padding=(3, 2), stride=2,
                             padding_mode="circular"),
    "replicate_d2_k1": dict(kernel_size=1, padding=2, dilation=2,
                            padding_mode="replicate"),
}


@pytest.mark.parametrize("name", list(CONVS))
def test_padded_conv_matches_the_module(name):
    torch.manual_seed(0)
    conv = nn.Conv2d(3, 4, **CONVS[name]).double()
    for h in (5, 12, 40):
        x = rand(2, 3, h, 7, seed=h)
        xd = x.clone().requires_grad_(True)
        want = conv(xd)
        weights = rand(*want.shape, seed=h + 1)
        (want * weights).sum().backward()
        for k in SHARDS:
            xr = x.clone().requires_grad_(True)
            got = spatial.gather(spatial.conv2d(
                spatial.shard(xr, cpus(k)), conv.weight, conv.bias,
                conv.stride, conv.padding, conv.dilation, conv.groups,
                conv.padding_mode))
            assert err_of_largest(got, want) <= TOL, (h, k)
            (got * weights).sum().backward()
            assert err_of_largest(xr.grad, xd.grad) <= TOL, (h, k)


@pytest.mark.parametrize("mode", ["reflect", "replicate", "circular",
                                  "constant"])
def test_fetch_padded_modes_match_pad(mode):
    for h in (4, 9):
        x = rand(1, 2, h, 3, seed=h)
        pad = h - 1 if mode == "reflect" else h
        kw = {"value": -3.0} if mode == "constant" else {}
        whole = F.pad(x, (0, 0, pad, pad), mode=mode, **kw)
        for k in SHARDS:
            rows = spatial.shard(x, cpus(k))
            for a in range(-pad, h + pad):
                for b in range(a, h + pad + 1):
                    got = spatial.fetch_padded(rows, a, b, "cpu", mode=mode,
                                               **kw)
                    assert torch.equal(got, whole[:, :, a + pad:b + pad]), (
                        h, k, a, b)


# (conv keyword arguments, input height): where torch raises
RAISES = {
    "reflect_past_the_height": (dict(kernel_size=3, padding=3,
                                     padding_mode="reflect"), 3),
    "circular_past_the_height": (dict(kernel_size=3, padding=4,
                                      padding_mode="circular"), 3),
    "valid_kernel_past_the_map": (dict(kernel_size=5, padding="valid"), 4),
    "reflect_kernel_past_the_map": (dict(kernel_size=7, padding=1,
                                         padding_mode="reflect"), 4),
}


@pytest.mark.parametrize("name", list(RAISES) + ["same_with_a_stride"])
def test_the_sharded_form_raises_what_torch_raises(name):
    if name == "same_with_a_stride":
        x = rand(1, 3, 9, 6)
        weight = rand(4, 3, 3, 3)
        with pytest.raises(RuntimeError) as want:
            F.conv2d(x, weight, None, 2, "same")
        call = lambda rows: spatial.conv2d(  # noqa: E731
            rows, weight, None, 2, "same")
    else:
        kw, h = RAISES[name]
        conv = nn.Conv2d(3, 4, **kw).double()
        x = rand(1, 3, h, 6)
        with pytest.raises(RuntimeError) as want:
            conv(x)
        call = lambda rows: spatial.conv2d(  # noqa: E731
            rows, conv.weight, conv.bias, conv.stride, conv.padding,
            conv.dilation, conv.groups, conv.padding_mode)
    message = str(want.value).split("[")[0].split("torch.Size")[0]
    for k in (1, 2, 3):
        with pytest.raises(type(want.value)) as got:
            call(spatial.shard(x, cpus(k)))
        assert str(got.value).startswith(message), (str(got.value), message)
