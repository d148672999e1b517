"""The mesh's spatial axis on the CPU: row-sharded maps
(``peanut_tpu_torch.core.spatial``) and the segmentor's sharded forward
(``models.sharded``) against the unsharded ops and model, in float64.

* Every sharded op over k = 1 ... 8 shards of ``["cpu"] * k``, on heights
  that split evenly and unevenly and on maps so short that a dilated
  convolution's halo reaches past the neighbouring shard: values and
  input gradients within 1e-12 of the largest |value| of the unsharded
  op (convolutions, the stem's max pool, the pyramid's adaptive pools,
  bilinear resizes of sharded and of global maps, train-mode batch
  norms with their running statistics, the heads' dropout, the BCE
  mean).
* The dry run's narrow PSPNet (base 16, ``multichip.DRYRUN_MODEL``) in
  eval mode with random batch statistics, sharded against unsharded
  within 1e-12; ``PredictionModel.get_prediction_sharded`` against
  ``get_prediction`` within 1e-9 in float64 and 1e-6 in float32.
* A module without a sharded form (torch's own ``nn.PReLU``) raises
  NotImplementedError naming it, though the unsharded forward runs; a
  convolution padded in reflect mode in STDCHead, or "same" and dilated
  in ICNeck's fusion, runs sharded as unsharded within 1e-12 in
  float64.
"""

import copy

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from peanut_tpu_torch.config import NavConfig
from peanut_tpu_torch.core import spatial
from peanut_tpu_torch.core.mesh import axis_devices, make_mesh, row_ranges
from peanut_tpu_torch.models import ops
from peanut_tpu_torch.models.layers import BatchNorm, BatchRows, dropout_draw
from peanut_tpu_torch.models.losses import bce_with_logits
from peanut_tpu_torch.models.pspnet import build_segmentor
from peanut_tpu_torch.models.sharded import forward_rows
from peanut_tpu_torch.multichip import DRYRUN_MODEL
from peanut_tpu_torch.prediction import PredictionModel

torch.set_num_threads(1)
SHARDS = range(1, 9)
TOL = 1e-12


def cpus(k):
    return ["cpu"] * k


def rand(*shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g, dtype=torch.float64)


def close(got, want, tol=TOL):
    top = float(want.detach().abs().max())
    err = float((got - want).detach().abs().max())
    assert got.shape == want.shape
    assert err <= tol * top, (err, top)


# ---- rows, meshes --------------------------------------------------------

def test_row_ranges_and_axis_devices():
    assert row_ranges(90, 4) == [(0, 23), (23, 46), (46, 68), (68, 90)]
    assert row_ranges(2, 4) == [(0, 1), (1, 2), (2, 2), (2, 2)]
    for h in range(0, 20):
        for k in SHARDS:
            r = row_ranges(h, k)
            assert r[0][0] == 0 and r[-1][1] == h
            assert all(a[1] == b[0] for a, b in zip(r, r[1:]))
            assert max(e - s for s, e in r) - min(e - s for s, e in r) <= 1
    mesh = make_mesh({"data": 2, "spatial": 3}, devices=cpus(6))
    assert axis_devices(mesh, "data") == [torch.device("cpu")] * 2
    assert axis_devices(mesh, "spatial", {"data": 1}) == \
        [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match="no axis"):
        axis_devices(mesh, "model")


@pytest.mark.parametrize("k", SHARDS)
def test_fetch_rows_from_any_shards(k):
    x = rand(2, 3, 13, 5)
    rows = spatial.shard(x, cpus(k))
    assert [b.shape[2] for b in rows.blocks] == \
        [e - s for s, e in row_ranges(13, k)]
    assert torch.equal(spatial.gather(rows), x)
    for a in range(14):
        for b in range(a, 14):
            assert torch.equal(spatial.fetch_rows(rows, a, b, "cpu"),
                               x[:, :, a:b])
    got = spatial.fetch_padded(rows, -3, 16, "cpu", value=-7.0)
    assert torch.equal(got, F.pad(x, (0, 0, 3, 3), value=-7.0))
    with pytest.raises(ValueError):
        spatial.fetch_rows(rows, 2, 14, "cpu")


# ---- convolutions and the max pool ---------------------------------------

CONVS = {  # (kernel, stride, padding, dilation, groups)
    "3x3": (3, 1, 1, 1, 1),
    "3x3_stride2": (3, 2, 1, 1, 1),
    "1x1": (1, 1, 0, 1, 1),
    "1x1_stride2": (1, 2, 0, 1, 1),
    "3x3_dilation2": (3, 1, 2, 2, 1),
    "3x3_dilation4": (3, 1, 4, 4, 1),
    "7x7_stride2": (7, 2, 3, 1, 1),
    "5x5_unpadded": (5, 1, 0, 1, 1),
    "3x3_grouped": (3, 1, 1, 1, 2),
}
# 16 rows split evenly over 1, 2, 4 and 8 shards, 13 and 9 unevenly; 9
# rows over 8 shards of 1-2 rows against a dilation-4 reach of 4 rows
HEIGHTS = (16, 13, 9)


@pytest.mark.parametrize("conv", sorted(CONVS))
@pytest.mark.parametrize("h", HEIGHTS)
def test_conv2d_matches_dense(conv, h):
    kern, stride, pad, dil, groups = CONVS[conv]
    w = rand(6, 4 // groups, kern, kern, seed=1)
    bias = rand(6, seed=2)
    x = rand(2, 4, h, 11, seed=3)
    out_grad = None
    for k in SHARDS:
        xs = x.clone().requires_grad_(True)
        ws = w.clone().requires_grad_(True)
        want = F.conv2d(xs, ws, bias, stride, pad, dil, groups)
        if out_grad is None:
            out_grad = rand(*want.shape, seed=4)
        want.backward(out_grad)
        xr = x.clone().requires_grad_(True)
        wr = w.clone().requires_grad_(True)
        got = spatial.conv2d(spatial.shard(xr, cpus(k)), wr, bias, stride,
                             pad, dil, groups)
        got = spatial.gather(got)
        close(got, want.detach())
        got.backward(out_grad)
        close(xr.grad, xs.grad)       # halo rows' gradients come home
        close(wr.grad, ws.grad)


@pytest.mark.parametrize("h", (16, 15, 5))
def test_max_pool_pads_minus_infinity_only_at_the_edges(h):
    x = rand(2, 3, h, 9) - 3.0        # all-negative rows near the edges
    want = F.max_pool2d(x, 3, 2, 1)
    for k in SHARDS:
        close(spatial.gather(spatial.max_pool2d(spatial.shard(x, cpus(k)),
                                                3, 2, 1)), want)


# ---- pools, resizes, dropout, the loss -----------------------------------

@pytest.mark.parametrize("h", (16, 9, 7))
def test_adaptive_pool_matches_dense(h):
    x = rand(2, 5, h, 10)
    for scale in (1, 2, 3, 6):
        want = ops.adaptive_avg_pool(x, scale)   # float32 bin weights
        for k in SHARDS:
            got = spatial.adaptive_avg_pool(spatial.shard(x, cpus(k)),
                                            scale, "cpu")
            assert got.dtype == torch.float64
            close(got, want)


@pytest.mark.parametrize("sizes", [(9, 72), (8, 64), (13, 100), (16, 16),
                                   (12, 5)])
@pytest.mark.parametrize("align_corners", [False, True])
def test_resize_of_sharded_maps_matches_dense(sizes, align_corners):
    h_in, h_out = sizes
    x = rand(1, 3, h_in, 7)
    want = ops.resize_nchw(x, (h_out, 11), align_corners)
    for k in SHARDS:
        xr = x.clone().requires_grad_(True)
        got = spatial.gather(spatial.resize(spatial.shard(xr, cpus(k)),
                                            (h_out, 11), align_corners))
        close(got, want)
        got.sum().backward()
        xd = x.clone().requires_grad_(True)
        ops.resize_nchw(xd, (h_out, 11), align_corners).sum().backward()
        close(xr.grad, xd.grad)


@pytest.mark.parametrize("scale", [1, 2, 3, 6])
def test_resize_of_a_global_map_matches_dense(scale):
    x = rand(2, 4, scale, scale)
    for h in (9, 16):
        want = ops.resize_nchw(x, (h, 10))
        for k in SHARDS:
            close(spatial.gather(spatial.resize(x, (h, 10), False,
                                                cpus(k))), want)


@pytest.mark.parametrize("k", SHARDS)
def test_dropout_keeps_the_global_mask(k):
    x = rand(4, 3, 11, 6)
    for gen in (lambda: torch.Generator().manual_seed(3),
                lambda: BatchRows(torch.Generator().manual_seed(3), 4, 12)):
        mask = dropout_draw(x.shape, gen(), "cpu") < 0.9
        want = torch.where(mask, x / 0.9, torch.zeros_like(x))
        got = spatial.dropout(spatial.shard(x, cpus(k)), 0.1, gen(), "cpu")
        assert torch.equal(spatial.gather(got), want)


@pytest.mark.parametrize("k", SHARDS)
def test_bce_mean_over_the_global_count(k):
    logits, target = rand(2, 6, 10, 4), (rand(2, 6, 10, 4, seed=1) > 1)
    want = bce_with_logits(logits, target.double()).mean()
    got = spatial.bce_mean(spatial.shard(logits, cpus(k)),
                           spatial.shard(target.double(), cpus(k)), "cpu")
    assert float(got) == pytest.approx(float(want), rel=TOL)


@pytest.mark.parametrize("k", SHARDS)
def test_train_mode_batch_norm_matches_dense(k):
    from peanut_tpu_torch.models.sharded import _Context, run
    x = rand(3, 5, 11, 4) * 2 + 1
    dense, shd = BatchNorm(5).double().train(), BatchNorm(5).double().train()
    for m in (dense, shd):
        m.requires_grad_(True)
        with torch.no_grad():
            m.weight.copy_(rand(5, seed=1))
            m.bias.copy_(rand(5, seed=2))
    xd, xs = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    want = dense(xd)
    got = spatial.gather(run(shd, spatial.shard(xs, cpus(k)),
                             _Context(torch.device("cpu"), None)))
    close(got, want.detach())
    g = rand(*x.shape, seed=5)
    want.backward(g)
    got.backward(g)
    close(xs.grad, xd.grad)
    close(shd.weight.grad, dense.weight.grad)
    for name in ("running_mean", "running_var"):   # moved once
        close(getattr(shd, name), getattr(dense, name))


# ---- the segmentor --------------------------------------------------------

def _random_stats(model, seed=1):
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, BatchNorm):
            with torch.no_grad():
                m.running_mean.copy_(0.1 * torch.randn(
                    m.running_mean.shape, generator=g))
                m.running_var.copy_(0.5 + torch.rand(m.running_var.shape,
                                                     generator=g))
                m.weight.copy_(1 + 0.1 * torch.randn(m.weight.shape,
                                                     generator=g))
                m.bias.copy_(0.1 * torch.randn(m.bias.shape, generator=g))
    return model


@pytest.fixture(scope="module")
def dryrun_model():
    return _random_stats(build_segmentor(DRYRUN_MODEL, seed=0)).double()


@pytest.mark.parametrize("h", (64, 72))
def test_forward_rows_matches_the_model(dryrun_model, h):
    """72 rows leave 9 stride-8 rows: 1-2 a shard at k = 8 against the
    decode head's dilation-4 convolutions, and uneven splits."""
    x = rand(1, 14, h, 64, seed=2).abs()
    with torch.no_grad():
        want = dryrun_model(x, train=False)
        for k in SHARDS:
            got = forward_rows(dryrun_model, spatial.shard(x, cpus(k)),
                               train=False)
            assert [b.shape[2] for b in got.blocks] == \
                [e - s for s, e in row_ranges(h, k)]
            close(spatial.gather(got), want)


def test_get_prediction_sharded_matches_unsharded(dryrun_model):
    full_map = np.random.RandomState(3).rand(14, 72, 64).astype(np.float32)
    pm = PredictionModel(NavConfig(), model=copy.deepcopy(dryrun_model),
                         device="cpu")
    pm.model, pm.dtype = pm.model.double(), torch.float64
    want = pm.get_prediction(full_map)
    for k in (2, 3, 8):
        got = pm.get_prediction_sharded(
            full_map, make_mesh({"spatial": k}, devices=cpus(k)))
        assert got.shape == (6, 72, 64) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    pm32 = PredictionModel(NavConfig(), model=copy.deepcopy(
        dryrun_model).float(), device="cpu")
    want = pm32.get_prediction(full_map)
    got = pm32.get_prediction_sharded(
        full_map, make_mesh({"data": 1, "spatial": 4}, devices=cpus(4)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def _small_model(what: str):
    """The dry run's PSPNet with STDCHead for its decode head, or ICNeck
    for its neck, or its auxiliary head's first convolution followed by
    torch's own ``nn.PReLU``."""
    cfg = copy.deepcopy(DRYRUN_MODEL)
    if what == "STDCHead":
        cfg["decode_head"] = dict(type="STDCHead", in_channels=512,
                                  in_index=3, channels=32, num_classes=6)
    elif what == "neck":
        cfg["neck"] = dict(type="ICNeck", in_channels=[128, 256, 512],
                           out_channels=32)
        cfg["decode_head"].update(in_channels=32, in_index=2)
        cfg["auxiliary_head"].update(in_channels=32, in_index=1)
    return build_segmentor(cfg, seed=0)


@pytest.mark.parametrize("what", ["STDCHead", "neck"])
def test_a_conv_padded_otherwise_runs_sharded(what):
    """A reflect-padded conv in STDCHead, a conv padded "same" and
    dilated in ICNeck's fusion: sharded as unsharded, both heads."""
    model = _small_model(what)
    if what == "STDCHead":
        model.decode_head.conv0.conv.padding_mode = "reflect"
    else:
        model.neck.cff42.conv_low.conv = torch.nn.Conv2d(
            512, 32, 3, padding="same", dilation=2, bias=False)
    model = _random_stats(model).double()
    x = rand(1, 14, 32, 32, seed=4)
    with torch.no_grad():
        want = model(x, train=False, with_aux=True)
        for k in (2, 3):
            got = forward_rows(model, spatial.shard(x, cpus(k)),
                               train=False, with_aux=True)
            for g, w in zip(got, want):
                close(spatial.gather(g), w)


@pytest.mark.parametrize("what", ["PReLU"])
def test_a_module_without_a_sharded_form_raises(what):
    model = _small_model(what)
    from peanut_tpu_torch.models.layers import ConvModule
    model.auxiliary_head.convs[0] = ConvModule(
        256, 64, 3, padding=1, act=torch.nn.PReLU())
    x = torch.rand(1, 14, 32, 32)
    with torch.no_grad():
        model(x, with_aux=True)
        with pytest.raises(NotImplementedError,
                           match=r"^PReLU has no row-sharded forward"):
            forward_rows(model, spatial.shard(x, cpus(2)), with_aux=True)
