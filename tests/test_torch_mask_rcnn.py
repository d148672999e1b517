"""Mask R-CNN in the port against the JAX package, on the CPU in float32.

The JAX model is initialised as ``tests/test_mask_rcnn.py``'s golden test
does (ResNet-50, PRNGKey(0), the 128x160 synthetic scene); its variables
move to the port through ``flax_to_d2_state`` + ``load_d2_state``.  Each
stage then gets the JAX stage's own inputs, so a difference points at the
stage that makes it.  Tolerances (float32; the two frameworks sum
convolutions in other orders):
  * pyramid levels: |diff| <= 1e-4 * max|level|;
  * proposals, detections: the same boxes within 5e-3 px (box deltas go
    through exp and anchors up to 512 px) and scores within 1e-4 where
    JAX's are finite, the same -inf slots;
  * mask probabilities: within 1e-4;
  * the whole detect against ``tests/data/mask_rcnn_golden.npz`` with that
    test's bar (finite count and classes equal, scores within 1e-3, boxes
    within 1.0, mask IoU >= 0.97).
Box utilities (NMS with tied scores, IoU, clipping, anchors) are bit-equal;
box deltas within 4 ulps (XLA's CPU exp is not correctly rounded).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from peanut_tpu.models import boxes as jboxes
from peanut_tpu.models.d2_import import convert_d2_maskrcnn_state
from peanut_tpu.models.mask_rcnn import FPN_STRIDES, MaskRCNN as JMaskRCNN
from peanut_tpu_torch.models import boxes as tboxes
from peanut_tpu_torch.models import MaskRCNN, flax_to_d2_state, load_d2_state
from peanut_tpu_torch.models.mask_rcnn import nchw

from test_mask_rcnn import _synthetic_scene

torch.set_num_threads(1)
H, W = 128, 160


@pytest.fixture(scope="module")
def models():
    jm = JMaskRCNN(num_classes=9, depth=50, score_thresh=0.05)
    img = jnp.asarray(_synthetic_scene(H, W))
    variables = jax.jit(lambda r, x: jm.init(r, x, method=jm.detect))(
        jax.random.PRNGKey(0), img)
    tm = load_d2_state(MaskRCNN(num_classes=9, depth=50),
                       flax_to_d2_state(variables)).eval()
    return jm, variables, tm


@pytest.fixture(scope="module")
def jax_stages(models):
    jm, v, _ = models
    imgs = jnp.asarray(_synthetic_scene(H, W))[None]
    pyr = jax.jit(lambda v, x: jm.apply(v, x, method=jm.features))(v, imgs)
    props, pscores = jax.jit(lambda v, p: jm.apply(
        v, p, H, W, method=jm.proposals))(v, pyr)
    dets = jax.jit(lambda v, p, b, s: jm.apply(
        v, p, b, s, H, W, method=jm.box_inference))(v, pyr, props, pscores)
    masks = jax.jit(lambda v, p, b, c: jm.apply(
        v, p, b, c, method=jm.mask_inference))(v, pyr, dets[0], dets[2])
    to_np = lambda t: jax.tree.map(np.asarray, t)   # noqa: E731
    return dict(imgs=np.asarray(imgs), pyr=to_np(pyr),
                props=to_np((props, pscores)), dets=to_np(dets),
                masks=np.asarray(masks))


def _t(x):
    return torch.tensor(np.asarray(x))


def _pyr(js):
    return [nchw(_t(p)) for p in js["pyr"]]


def test_state_dict_round_trip(models):
    """flax -> d2 -> flax gives the variables back, and every d2 key the
    port's model has is filled."""
    _, variables, tm = models
    sd = flax_to_d2_state(variables)
    back = convert_d2_maskrcnn_state(sd)
    got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            jax.tree.map(np.asarray, dict(variables)))[0]:
        np.testing.assert_array_equal(got[path], leaf, err_msg=str(path))
    assert set(sd) == set(tm.state_dict())
    with pytest.raises(KeyError, match="Unconverted"):
        extra = jax.tree.map(np.asarray, dict(variables))
        extra["params"] = dict(extra["params"], stray={"kernel": np.ones(2)})
        flax_to_d2_state(extra)


def test_batchnorm_terms_follow_their_buffers():
    """The frozen BN keeps its (mean, scale, bias) terms between calls; a
    buffer written in place, loaded or cast gives fresh terms, bit-equal to
    computing them in the call."""
    from peanut_tpu_torch.models.layers import BN_EPS, BatchNorm

    def fresh(bn, x):
        mul = torch.rsqrt(bn.running_var + BN_EPS) * bn.weight
        return ((x - bn.running_mean[:, None, None]) * mul[:, None, None]
                + bn.bias[:, None, None])

    rng = np.random.RandomState(8)
    bn = BatchNorm(4)
    x = _t(rng.randn(2, 4, 3, 3).astype(np.float32))
    assert torch.equal(bn(x), fresh(bn, x))
    bn.running_var.fill_(2.5)
    bn.weight.mul_(3.0)
    assert torch.equal(bn(x), fresh(bn, x))
    bn.load_state_dict({k: _t(rng.rand(4).astype(np.float32)) for k in
                        ("weight", "bias", "running_mean", "running_var")})
    assert torch.equal(bn(x), fresh(bn, x))
    bn = bn.to(torch.bfloat16)
    assert torch.equal(bn(x.bfloat16()), fresh(bn, x.bfloat16()))


def test_features_match(models, jax_stages):
    _, _, tm = models
    with torch.no_grad():
        got = tm.features(_t(jax_stages["imgs"]))
    assert len(got) == 5
    for g, w in zip(got, jax_stages["pyr"]):
        g = g.permute(0, 2, 3, 1).numpy()
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())


def _assert_scored_boxes(got_b, got_s, want_b, want_s, box_tol, score_tol):
    fin = np.isfinite(want_s)
    np.testing.assert_array_equal(np.isfinite(got_s), fin)
    np.testing.assert_allclose(got_s[fin], want_s[fin], rtol=0,
                               atol=score_tol)
    np.testing.assert_allclose(got_b[fin], want_b[fin], rtol=0, atol=box_tol)


def test_proposals_match(models, jax_stages):
    _, _, tm = models
    with torch.no_grad():
        b, s = tm.proposals(_pyr(jax_stages), H, W)
    wb, ws = jax_stages["props"]
    assert np.isfinite(ws).sum() > 100
    _assert_scored_boxes(b.numpy(), s.numpy(), wb, ws, 5e-3, 1e-4)


def test_box_and_mask_inference_match(models, jax_stages):
    _, _, tm = models
    pyr = _pyr(jax_stages)
    wp, wps = jax_stages["props"]
    with torch.no_grad():
        ctx = tm.roi_context(pyr)
        b, s, c = tm.box_inference(pyr, _t(wp), _t(wps), H, W, roi_ctx=ctx)
        wb, ws, wc = jax_stages["dets"]
        assert np.isfinite(ws).sum() > 0
        _assert_scored_boxes(b.numpy(), s.numpy(), wb, ws, 5e-3, 1e-4)
        fin = np.isfinite(ws)
        np.testing.assert_array_equal(c.numpy()[fin], wc[fin])
        m = tm.mask_inference(pyr, _t(wb), _t(wc), roi_ctx=ctx)
    np.testing.assert_allclose(m.numpy(), jax_stages["masks"], rtol=0,
                               atol=1e-4)


def test_detect_matches_golden(models):
    """The whole detect on weights moved by flax_to_d2_state against the
    JAX package's committed fixture, with its bar."""
    _, _, tm = models
    golden = np.load(os.path.join(os.path.dirname(__file__), "data",
                                  "mask_rcnn_golden.npz"))
    with torch.no_grad():
        out = tm.detect_batch(_t(_synthetic_scene(H, W))[None])
    out = {k: v[0].numpy() for k, v in out.items()}
    want_finite = np.isfinite(golden["scores"])
    np.testing.assert_array_equal(np.isfinite(out["scores"]), want_finite)
    k = int(want_finite.sum())
    assert k > 0
    np.testing.assert_allclose(out["scores"][:k], golden["scores"][:k],
                               atol=1e-3)
    np.testing.assert_array_equal(out["classes"][:k], golden["classes"][:k])
    np.testing.assert_allclose(out["boxes"][:k], golden["boxes"][:k],
                               atol=1.0)
    gm = golden["masks"][:k] > 0.5
    om = out["masks"][:k] > 0.5
    inter = (gm & om).sum(axis=(1, 2))
    union = np.maximum((gm | om).sum(axis=(1, 2)), 1)
    assert (inter / union >= 0.97).all()


# ---------------------------------------------------------------------------
# box utilities: bit-equal, ties included

def _tied_boxes(rng, n):
    xy = rng.rand(n, 2).astype(np.float32) * 100
    wh = rng.rand(n, 2).astype(np.float32) * 40 + 2
    boxes = np.concatenate([xy, xy + wh], axis=1)
    boxes[n // 2:n // 2 + 8] = boxes[:8]                 # duplicate boxes
    scores = np.round(rng.rand(n).astype(np.float32) * 8) / 8   # many ties
    scores[-5:] = -np.inf                                # padding slots
    return boxes, scores


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_nms_fixed_and_batched_nms_bit_equal(seed):
    rng = np.random.RandomState(seed)
    boxes, scores = _tied_boxes(rng, 300)
    want = np.asarray(jboxes.nms_fixed(jnp.asarray(boxes),
                                       jnp.asarray(scores), 0.5))
    got = tboxes.nms_fixed(_t(boxes), _t(scores), 0.5).numpy()
    np.testing.assert_array_equal(got, want)
    cls = rng.randint(0, 4, 300).astype(np.int32)
    want = np.asarray(jboxes.batched_nms(jnp.asarray(boxes),
                                         jnp.asarray(scores),
                                         jnp.asarray(cls), 0.5))
    got = tboxes.batched_nms(_t(boxes), _t(scores), _t(cls), 0.5).numpy()
    np.testing.assert_array_equal(got, want)
    # batched over a leading axis, as the RPN runs it
    b2, s2 = _tied_boxes(rng, 300)
    got = tboxes.nms_fixed(_t(np.stack([boxes, b2])),
                           _t(np.stack([scores, s2])), 0.7).numpy()
    for i, (bb, ss) in enumerate(((boxes, scores), (b2, s2))):
        np.testing.assert_array_equal(got[i], np.asarray(jboxes.nms_fixed(
            jnp.asarray(bb), jnp.asarray(ss), 0.7)))


def _greedy_keep(sup, valid):
    """Sequential greedy NMS over a suppression matrix: the walk the CUDA
    kernel csrc/nms_greedy.cu makes."""
    n = valid.shape[-1]
    keep = np.zeros_like(valid)
    for p in np.ndindex(valid.shape[:-1]):
        removed = np.zeros(n, bool)
        for j in range(n):
            keep[p + (j,)] = valid[p + (j,)] and not removed[j]
            if keep[p + (j,)]:
                removed |= sup[p + (j,)] & (np.arange(n) > j)
    return keep


@pytest.mark.parametrize("case", ["random", "chain", "boxes"])
def test_nms_keep_plain_version_is_the_greedy_walk(case):
    """The JAX package's bounding rounds (the plain version, on the CPU)
    and the kernel's in-order walk give the same keep set, bit for bit:
    random overlaps, a suppression chain (n/2 rounds to converge) and tied
    boxes."""
    from peanut_tpu_torch.kernels.nms import nms_keep, nms_keep_reference
    rng = np.random.RandomState(5)
    if case == "random":
        sup = np.triu(rng.rand(3, 200, 200) > 0.97, 1)
        valid = rng.rand(3, 200) > 0.1
    elif case == "chain":
        sup = np.eye(64, k=1, dtype=bool)
        valid = np.ones(64, bool)
    else:
        boxes, scores = _tied_boxes(rng, 300)
        order = np.argsort(-scores, kind="stable")
        iou = tboxes.pairwise_iou(_t(boxes[order]), _t(boxes[order])).numpy()
        sup = np.triu(iou > 0.5, 1)
        valid = np.isfinite(scores[order])
    got = nms_keep_reference(torch.as_tensor(sup), torch.as_tensor(valid))
    np.testing.assert_array_equal(got.numpy(), _greedy_keep(sup, valid))
    assert torch.equal(nms_keep(torch.as_tensor(sup), torch.as_tensor(valid)),
                       got)


def test_top_k_keeps_index_order_of_ties():
    scores = np.array([[0.5, 1.0, 0.5, -np.inf, 1.0, 0.5]], np.float32)
    wv, wi = jax.lax.top_k(jnp.asarray(scores), 5)
    gv, gi = tboxes.top_k(_t(scores), 5)
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def test_apply_deltas_clip_and_anchors_bit_equal():
    rng = np.random.RandomState(3)
    boxes, _ = _tied_boxes(rng, 64)
    deltas = rng.randn(64, 4).astype(np.float32) * 2
    deltas[:4, 2:] = 9.0                                 # past the clamp
    for w in ((1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)):
        want = np.asarray(jboxes.apply_deltas(jnp.asarray(deltas),
                                              jnp.asarray(boxes), weights=w))
        got = tboxes.apply_deltas(_t(deltas), _t(boxes), weights=w).numpy()
        # XLA's CPU exp is a polynomial that is not correctly rounded, and
        # XLA contracts the centre update into an FMA: a few ulps apart
        ulp = np.spacing(np.abs(want).max().astype(np.float32))
        np.testing.assert_allclose(got, want, rtol=0, atol=4 * ulp)
        np.testing.assert_array_equal(
            tboxes.clip_boxes(_t(want), 90, 120).numpy(),
            np.asarray(jboxes.clip_boxes(jnp.asarray(want), 90, 120)))
    np.testing.assert_array_equal(
        tboxes.pairwise_iou(_t(boxes), _t(boxes[::-1].copy())).numpy(),
        np.asarray(jboxes.pairwise_iou(jnp.asarray(boxes),
                                       jnp.asarray(boxes[::-1]))))
    for lvl, stride in enumerate(FPN_STRIDES):
        cell_t = tboxes.generate_cell_anchors((32 * 2 ** lvl,),
                                              (0.5, 1.0, 2.0))
        cell_j = jboxes.generate_cell_anchors((32 * 2 ** lvl,),
                                              (0.5, 1.0, 2.0))
        np.testing.assert_array_equal(cell_t, cell_j)
        np.testing.assert_array_equal(
            tboxes.anchors_for_level(7, 9, stride, cell_t),
            jboxes.anchors_for_level(7, 9, stride, cell_j))
