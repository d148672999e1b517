"""The model zoo's cascade families of the port (ROADMAP A13 part 2)
against the JAX package, on the CPU, in float64 on both sides: within
1e-9 of the largest |output|.

* K-Net (``IterativeDecodeHead`` over ResNetV1c) and PointRend
  (``CascadeEncoderDecoder``: FPNHead, then PointHead) whole, the first
  config of each (``torch_zoo_support.check_family``): logits and
  ``predict_labels``.
* PointRend's subdivision: on a 64x128 input the FPN head's 16x32 logits
  are refined twice to 64x128; the refined logits agree and the cells
  each round re-classifies are the JAX package's ``jax.lax.top_k``
  indices, in its order.  On logits with many equal uncertainties the
  port's stable ``boxes.top_k`` picks the cells ``jax.lax.top_k`` picks.
* ``point_sample`` with both ``align_corners``, on points that reach the
  map's edges; PointHead's 1-D convs carry from flax's (1, in, out)
  kernels.
* K-Net's head at two stages, one class's mask empty (its group feature
  divides by the floor of 1).
* A cascade of FCNHead then OCRHead, which takes the first stage's logits
  as its soft regions (and has no ``soft_regions`` conv of its own).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import peanut_tpu.models  # noqa: F401  (registers the JAX zoo)
from peanut_tpu.models import heads_zoo as jhz
from peanut_tpu.models.ops import resize_bilinear as jresize
from peanut_tpu.registry import HEADS as JHEADS
import peanut_tpu_torch.models.builder  # noqa: F401  (registers the zoo)
from peanut_tpu_torch.models import heads_zoo
from peanut_tpu_torch.models.boxes import top_k
from peanut_tpu_torch.registry import HEADS

from torch_zoo_support import (CASCADE_FAMILIES, carried_module,
                               check_family, family_config, jax64,
                               jax_and_port, rel_err)
from torch_zoo_support import one_thread  # noqa: F401  (autouse)

TOL = 1e-9
PYRAMID = [np.random.RandomState(i).randn(2, h, w, c)
           for i, (c, h, w) in enumerate(((8, 16, 24), (12, 8, 12),
                                          (16, 4, 6), (16, 4, 6)))]


def _nchw(a):
    return torch.as_tensor(a).permute(0, 3, 1, 2)


@pytest.mark.parametrize("family", CASCADE_FAMILIES)
def test_family_logits_and_labels_match_jax(family):
    check_family(family)


def _jax_subdivision(m, x):
    """The JAX cascade's encode_decode, step by step: the refined logits
    and each round's top_k indices."""
    cfg = m.test_cfg
    feats = m.extract_feat(x)
    refined = m._run_stages(feats)[-1]
    chosen = []
    for _ in range(cfg["subdivision_steps"]):
        b, h, w, k = refined.shape
        h2, w2 = h * cfg["scale_factor"], w * cfg["scale_factor"]
        refined = jresize(refined, (h2, w2))
        unc = jhz.PointHead.uncertainty(refined).reshape(b, h2 * w2)
        _, idx = jax.lax.top_k(unc, min(cfg["subdivision_num_points"],
                                        h2 * w2))
        pts = jnp.stack([((idx % w2).astype(jnp.float32) + 0.5) / w2,
                         ((idx // w2).astype(jnp.float32) + 0.5) / h2], -1)
        point_logits = m._heads[-1](feats, refined, pts)
        flat = jax.vmap(lambda f, i, p: f.at[i].set(p))(
            refined.reshape(b, h2 * w2, k), idx, point_logits)
        refined = flat.reshape(b, h2, w2, k)
        chosen.append(idx)
    return refined, chosen, m.encode_decode(x)


def test_pointrend_refines_the_cells_jax_refines():
    jm, v, pm, x = jax_and_port(family_config("point_rend"), (64, 128))
    want, want_idx, want_out = jax64(jm, v, x, method=_jax_subdivision)
    assert want.shape == (1, 64, 128, 19)
    np.testing.assert_array_equal(want, want_out)
    with torch.no_grad():
        img = _nchw(x)
        feats = pm.extract_feat(img)
        got, got_idx = pm.subdivide(feats, pm._run_stages(feats))
    assert len(got_idx) == len(want_idx) == 2
    for g, w in zip(got_idx, want_idx):
        assert g.shape == (1, 256)
        np.testing.assert_array_equal(g.numpy(), w)
    assert rel_err(got.permute(0, 2, 3, 1).numpy(), want) <= TOL


def test_point_choice_orders_ties_as_jax():
    """Logits of few distinct values: the uncertainties tie in runs, and
    the k chosen cells are jax.lax.top_k's."""
    logits = np.random.RandomState(3).randint(0, 3, (2, 12, 16, 4)) * 1.0
    with jax.enable_x64(True):
        unc = jhz.PointHead.uncertainty(jnp.asarray(logits))
        want = np.asarray(jax.lax.top_k(unc.reshape(2, -1), 50)[1])
    unc_t = heads_zoo.PointHead.uncertainty(_nchw(logits)).reshape(2, -1)
    np.testing.assert_array_equal(top_k(unc_t, 50)[1].numpy(), want)
    np.testing.assert_array_equal(unc_t.numpy(), np.asarray(unc).reshape(
        2, -1))


@pytest.mark.parametrize("align_corners", [False, True])
def test_point_sample_matches_jax(align_corners):
    feats = PYRAMID[0]
    pts = np.random.RandomState(4).rand(2, 40, 2).astype(np.float32)
    pts[:, :4] = [[0, 0], [1, 1], [0, 1], [1, 0]]       # the corners
    with jax.enable_x64(True):      # jitted, as the JAX package serves
        want = np.asarray(jax.jit(lambda f, p: jhz.point_sample(
            f, p, align_corners))(feats, pts))
    got = heads_zoo.point_sample(_nchw(feats), torch.as_tensor(pts),
                                 align_corners)
    assert got.dtype == torch.float64
    assert rel_err(got.transpose(1, 2).numpy(), want) <= TOL


@pytest.mark.parametrize("align_corners", [False, True])
def test_point_head_matches_jax(align_corners):
    kw = dict(in_channels=(8, 16), in_index=(0, 2), channels=8,
              num_classes=5, num_fcs=2, align_corners=align_corners)
    jkw = {k: v for k, v in kw.items() if k != "in_channels"}
    coarse = np.random.RandomState(5).randn(2, 8, 12, 5)
    pts = np.random.RandomState(6).rand(2, 30, 2).astype(np.float32)
    feats = tuple(PYRAMID)
    jmod, tmod = JHEADS.get("PointHead")(**jkw), HEADS.build(
        dict(kw, type="PointHead"))
    v = carried_module(jmod, tmod, feats, coarse, pts)
    kernel = v["params"]["fc0"]["kernel"]
    assert kernel.shape == (1, 8 + 16 + 5, 8)
    np.testing.assert_array_equal(tmod.fc0.weight.detach().numpy(),
                                  kernel.transpose(2, 1, 0))
    want = jax64(jmod, v, feats, coarse, pts)
    with torch.no_grad():
        got = tmod([_nchw(f) for f in feats], _nchw(coarse),
                   torch.as_tensor(pts))
    assert rel_err(got.transpose(1, 2).numpy(), want) <= TOL


def test_knet_head_two_stages_with_an_empty_mask():
    kw = dict(in_channels=16, channels=8, num_classes=5, num_stages=2,
              num_heads=2, feedforward_channels=16, in_index=3)
    feats = tuple(PYRAMID)
    jmod, tmod = JHEADS.get("IterativeDecodeHead")(**kw), HEADS.build(
        dict(kw, type="IterativeDecodeHead"))
    v = carried_module(jmod, tmod, feats, train=False)
    # class 0's initial mask is empty everywhere
    v["params"]["conv_seg"]["conv"]["bias"][0] = -1e3
    with torch.no_grad():
        tmod.conv_seg.bias[0] = -1e3
        masks = tmod.conv_seg(tmod.generate_conv(_nchw(feats[3])))
        assert bool((torch.sigmoid(masks[:, 0]) <= 0.5).all())
        got = tmod([_nchw(f) for f in feats]).permute(0, 2, 3, 1).numpy()
    want = jax64(jmod, v, feats, train=False)
    assert rel_err(got, want) <= TOL


def test_cascade_ocr_stage_takes_the_prior_logits():
    cfg = family_config("fcn")
    base = dict(cfg["decode_head"])
    cfg = dict(type="CascadeEncoderDecoder", num_stages=2,
               backbone=cfg["backbone"],
               decode_head=[base, dict(type="OCRHead", in_channels=512,
                                       channels=16, ocr_channels=8,
                                       num_classes=base["num_classes"],
                                       align_corners=False)],
               test_cfg=dict(mode="whole"))
    jm, v, pm, x = jax_and_port(cfg, (64, 96))
    assert "soft_regions" not in v["params"]["decode_head1"]
    assert pm.decode_head1.soft_regions is None
    want = jax64(jm, v, x, method=lambda m, x: m.inference(x))
    with torch.no_grad():
        got = pm.inference(torch.as_tensor(x)).numpy()
    assert rel_err(got, want) <= TOL
