"""ROIAlign in the port against the JAX package, on the CPU.

* ``roi_window_pool_reference`` (kernel B3's plain version) against the JAX
  Pallas kernel run with ``interpret=True``, square and rectangular windows:
  rtol/atol 2e-5 in float32, 2e-2 in bfloat16 (the bars of
  tests/test_roi_window.py; the sums run in another order).
* ``multilevel_roi_align`` against JAX's on a batched pyramid whose finest
  level is wider than the square window, with x- and y-elongated ROIs, and
  more overflowing ROIs than the JAX tail budget (256 of 600) gives the
  exact passes: the others keep the square result in both packages.
  The sample coordinates are bit-equal (one rounding per multiply-add, as
  XLA contracts them); the sums over up to 40x40-cell windows with hat
  weights up to g run in other orders: rtol/atol 5e-5 in float32, 2e-2 in
  bfloat16.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from peanut_tpu.kernels.roi_window import roi_window_pool as j_pool
from peanut_tpu.models.roi_align import (
    assign_fpn_levels as j_levels, multilevel_roi_align as j_align)
from peanut_tpu_torch.kernels.roi_window import (roi_window_pool,
                                                 roi_window_pool_reference)
from peanut_tpu_torch.models.roi_align import (
    assign_fpn_levels, build_roi_stack, multilevel_roi_align,
    overflow_budget)

torch.set_num_threads(1)
STRIDES = (4, 8, 16, 32)
IMG_H, IMG_W = 256, 320          # levels 64x80 .. 8x10; the window is 32


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("win_y,win_x", [(16, 16), (8, 40), (40, 8)])
def test_window_pool_plain_version_matches_pallas(dtype, tol, win_y, win_x):
    rng = np.random.RandomState(win_y * 7 + win_x)
    n, p, c, hp, wp = 9, 7, 128, 96, 64
    flat = rng.standard_normal((hp, wp, c)).astype(np.float32)
    ay = rng.standard_normal((n, p, win_y)).astype(np.float32)
    ax = rng.standard_normal((n, p, win_x)).astype(np.float32)
    row0 = rng.randint(0, hp - win_y, n).astype(np.int32)
    col0 = (rng.randint(0, (wp - win_x) // 8 + 1, n) * 8).astype(np.int32)
    jflat = jnp.asarray(flat, dtype)
    want = np.asarray(j_pool(jflat, jnp.asarray(ay), jnp.asarray(ax),
                             jnp.asarray(row0), jnp.asarray(col0),
                             win_y=win_y, win_x=win_x, interpret=True))
    tflat = _t(np.asarray(jflat.astype(jnp.float32))).to(getattr(torch,
                                                                 dtype))
    got = roi_window_pool(tflat, _t(ay), _t(ax), _t(row0), _t(col0), win_y,
                          win_x)
    assert got.dtype == torch.float32 and got.shape == (n, p, p, c)
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def test_window_pool_reads_outside_the_buffer_as_zero():
    rng = np.random.RandomState(5)
    flat = _t(rng.standard_normal((20, 24, 8)).astype(np.float32))
    ay = torch.ones((3, 4, 16))
    ax = torch.ones((3, 4, 16))
    row0 = torch.tensor([-8, 12, -30])
    col0 = torch.tensor([-8, 16, 0])
    got = roi_window_pool_reference(flat, ay, ax, row0, col0, 16, 16)
    padded = torch.nn.functional.pad(flat, (0, 0, 16, 16, 16, 16))
    want = roi_window_pool_reference(padded, ay, ax, row0 + 16, col0 + 16,
                                     16, 16)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert float(got[2].abs().sum()) == 0.0
    np.testing.assert_allclose(got[0, 0, 0].numpy(),
                               flat[:8, :8].sum((0, 1)).numpy(), rtol=1e-5)


def test_overflow_budget_is_the_jax_tail():
    # at most one 256-chunk tail below 16 chunks; all ROIs below 257
    assert [overflow_budget(n) for n in (100, 256, 600, 800, 8000)] == \
        [100, 256, 256, 256, 1024]


def _boxes(rng, bsz, n):
    """Ordinary boxes, x-elongated (300x30 px) and y-elongated (35x240 px)
    slivers on the finest level, and boxes past the image edge."""
    out = np.zeros((bsz, n, 4), np.float32)
    for b in range(bsz):
        kind = rng.randint(0, 3, n)
        for i in range(n):
            if kind[i] == 0:
                w, h = rng.uniform(8, 200, 2)
            elif kind[i] == 1:
                w, h = rng.uniform(250, 310), rng.uniform(22, 36)
            else:
                w, h = rng.uniform(28, 40), rng.uniform(200, 250)
            x0 = rng.uniform(-10, IMG_W - min(w, IMG_W - 1) + 10)
            y0 = rng.uniform(-10, IMG_H - min(h, IMG_H - 1) + 10)
            out[b, i] = [x0, y0, x0 + w, y0 + h]
    return np.clip(out, 0, [IMG_W, IMG_H, IMG_W, IMG_H]).astype(np.float32)


@pytest.fixture(scope="module")
def pyramid():
    rng = np.random.RandomState(0)
    feats = [rng.standard_normal((2, IMG_H // s, IMG_W // s, 16)).astype(
        np.float32) for s in STRIDES]
    return feats, _boxes(rng, 2, 300)


@pytest.mark.parametrize("dtype,tol", [("float32", 5e-5),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("p", [7, 14])
def test_multilevel_roi_align_matches_jax(pyramid, dtype, tol, p):
    feats, boxes = pyramid
    jfeats = [jnp.asarray(f, dtype) for f in feats]
    want = np.asarray(jax.jit(lambda fs, b: j_align(fs, b, STRIDES, p))(
        jfeats, jnp.asarray(boxes)).astype(jnp.float32))
    tfeats = [_t(np.asarray(f.astype(jnp.float32))).to(getattr(torch, dtype))
              for f in jfeats]
    ctx = build_roi_stack(tfeats, STRIDES)
    assert not ctx["square_covers_all"] and ctx["win"] == 32
    got = multilevel_roi_align(tfeats, _t(boxes), STRIDES, p, ctx=ctx)
    assert got.dtype == getattr(torch, dtype)
    assert got.shape == (2, 300, p, p, 16)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def test_one_image_below_one_chunk_and_levels(pyramid):
    """40 ROIs of one image (all get the exact passes) against JAX's
    single-image form; FPN level assignment equal."""
    feats, boxes = pyramid
    jf = [jnp.asarray(f[1]) for f in feats]
    want = np.asarray(j_align(jf, jnp.asarray(boxes[1, :40]), STRIDES, 7))
    got = multilevel_roi_align([_t(f[1:2]) for f in feats],
                               _t(boxes[1:2, :40]), STRIDES, 7)[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-5, atol=5e-5)
    np.testing.assert_array_equal(
        assign_fpn_levels(_t(boxes)).numpy(),
        np.asarray(j_levels(jnp.asarray(boxes))))


def test_tail_budget_leaves_the_excess_overflow_square(pyramid, monkeypatch):
    """This pyramid has more overflowing ROIs than the budget: given every
    one the exact passes, some results change (those the JAX rule leaves
    square), and the rest stay as they were."""
    import peanut_tpu_torch.models.roi_align as ra

    feats, boxes = pyramid
    tfeats = [_t(f) for f in feats]
    got = multilevel_roi_align(tfeats, _t(boxes), STRIDES, 7)
    monkeypatch.setattr(ra, "overflow_budget", lambda n: n)
    exact = multilevel_roi_align(tfeats, _t(boxes), STRIDES, 7)
    changed = (got - exact).abs().amax(dim=(2, 3, 4)) > 1e-3
    assert 0 < int(changed.sum()) < changed.numel() - 256
