"""The model zoo's transformer modules of the port against their flax
modules, on the CPU, in float64 on both sides: within 1e-9 of the largest
|output|.

* The shared pieces: ``layers.LayerNorm`` has flax's epsilon, ``gelu``
  both of flax's forms, and ``MultiHeadAttention`` is flax's
  ``MultiHeadDotProductAttention``.
* Swin blocks with shift 0 and shift 2 on a 9x11 map that pads to
  whole 4x4 windows; ViT with its positional grid resized (6x6 to 5x7)
  and a 4x .. 1x tap pyramid; Twins-SVT, whose local windows are smaller
  than 7 on the coarse stages (5x6, 3x3: the window becomes the grid);
  BEiT on a square grid (the relative-position bias joins the product)
  and a non-square one (it does not, as in the JAX package); MiT's
  aliases carry (MITB2's widths).
* SETR's UP and MLA heads, the MLA, MultiLevel (one input and four) and
  Feature2Pyramid necks.
* ``flax_to_torch_state`` follows the receiving module: a 4-D parameter
  that is not a conv kernel (ViT's positional grid) keeps its layout,
  flax's (C, heads, head_dim) and (heads, head_dim, C) attention kernels
  land in the port's dense weights, and a variable left over or a
  parameter left unset still raises KeyError.  (PointHead's 1-D convs:
  ``test_torch_zoo_cascade.py``.)

The variables are seeded normals (``torch_zoo_support.random_variables``):
the layer scales ``gamma`` / ``gamma1`` / ``gamma2`` and the relative-
position tables are drawn too, not flax's constants, so a dropped branch
shows.  Each family's whole model: ``test_torch_zoo_models_3.py``.
"""

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp
from flax import linen as fnn

import peanut_tpu.models  # noqa: F401  (registers the JAX zoo)
from peanut_tpu.models import backbones_zoo as jbz, heads_zoo as jhz
from peanut_tpu.models import vit as jvit
from peanut_tpu.registry import (BACKBONES as JBACKBONES, HEADS as JHEADS,
                                 NECKS as JNECKS)
import peanut_tpu_torch.models.builder  # noqa: F401  (registers the zoo)
from peanut_tpu_torch.models import backbones_zoo, heads_zoo, vit
from peanut_tpu_torch.models.layers import (LN_EPS, LayerNorm,
                                            MultiHeadAttention, gelu)
from peanut_tpu_torch.models.mmseg_import import flax_to_torch_state
from peanut_tpu_torch.registry import BACKBONES, HEADS, NECKS

from torch_zoo_support import (carried_module, carry, jax64,
                               random_variables, rel_err)
from torch_zoo_support import one_thread  # noqa: F401  (autouse)

TOL = 1e-9


def _nchw(a):
    return torch.as_tensor(a).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _close(got, want):
    got = got if isinstance(got, (tuple, list)) else [got]
    want = want if isinstance(want, (tuple, list)) else [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float64
        assert rel_err(g, w) <= TOL


def test_layer_norm_and_gelu_are_flax_s():
    assert LayerNorm(4).eps == LN_EPS == fnn.LayerNorm().epsilon == 1e-6
    x = np.random.RandomState(0).randn(1000) * 3
    with jax.enable_x64(True):
        tanh = np.asarray(jax.nn.gelu(x))            # flax's default
        erf = np.asarray(jax.nn.gelu(x, approximate=False))
    t = torch.as_tensor(x)
    assert rel_err(gelu(t, approximate=True).numpy(), tanh) <= 1e-15
    assert rel_err(gelu(t, approximate=False).numpy(), erf) <= 1e-15
    # the two forms differ by far more than the bar
    assert rel_err(tanh, erf) > 1e-5


def test_multi_head_attention_is_flax_s():
    jmod = fnn.MultiHeadDotProductAttention(num_heads=3)
    q = np.random.RandomState(1).randn(2, 5, 12)
    kv = np.random.RandomState(2).randn(2, 7, 12)
    tmod = MultiHeadAttention(12, 3)
    v = carried_module(jmod, tmod, q, kv)
    with torch.no_grad():
        got = tmod(torch.as_tensor(q), torch.as_tensor(kv)).numpy()
    _close(got, jax64(jmod, v, q, kv))


@pytest.mark.parametrize("shift", [0, 2])
def test_swin_block_pads_rolls_and_masks(shift):
    x = np.random.RandomState(3).randn(2, 9, 11, 8)
    jmod = jvit.SwinBlock(8, 2, window=4, shift=shift)
    tmod = vit.SwinBlock(8, 2, window=4, shift=shift)
    v = carried_module(jmod, tmod, x)
    with torch.no_grad():
        got = tmod(torch.as_tensor(x)).numpy()
    _close(got, jax64(jmod, v, x))


def test_swin_shift_mask_has_seams():
    mask = vit._shift_attn_mask(12, 12, 4, 2)
    np.testing.assert_array_equal(mask, jvit._shift_attn_mask(12, 12, 4, 2))
    assert mask.shape == (9, 16, 16)
    assert (mask[0] == 0).all() and (mask[-1] == -100).any()


def test_swin_transformer_merges_patches():
    x = np.random.RandomState(4).randn(1, 52, 60, 3)
    kw = dict(embed_dim=8, depths=(2, 1, 2), num_heads=(1, 2, 2), window=3)
    jmod = jvit.SwinTransformer(**kw)
    tmod = vit.SwinTransformer(**kw)
    v = carried_module(jmod, tmod, x)
    assert tmod.out_channels == [8, 16, 32]
    with torch.no_grad():
        got = [_nhwc(t) for t in tmod(_nchw(x))]
    _close(got, jax64(jmod, v, x))


def test_vit_resizes_its_positional_grid():
    x = np.random.RandomState(5).randn(2, 20, 28, 3)
    kw = dict(embed_dim=16, depth=3, num_heads=2, patch_size=4,
              out_indices=(0, 1, 2), img_size=24)
    jmod, tmod = jvit.VisionTransformer(**kw), vit.VisionTransformer(**kw)
    v = carried_module(jmod, tmod, x)
    with torch.no_grad():
        got = [_nhwc(t) for t in tmod(_nchw(x))]
    assert [g.shape[1:3] for g in got] == [(20, 28), (10, 14), (5, 7)]
    _close(got, jax64(jmod, v, x))


def test_svt_local_windows_smaller_than_the_window():
    """Stage grids 10x12 (7x7 windows, padded), 5x6 and 3x3 (the window
    shrinks to the grid) and 2x2 (global attention only)."""
    x = np.random.RandomState(6).randn(1, 40, 48, 3)
    kw = dict(embed_dims=(8, 16, 16, 16), num_heads=(1, 2, 2, 2),
              depths=(2, 2, 2, 1), mlp_ratios=(2, 2, 2, 2))
    jmod, tmod = jbz.SVT(**kw), BACKBONES.build(dict(kw, type="SVT"))
    v = carried_module(jmod, tmod, x)
    with torch.no_grad():
        got = [_nhwc(t) for t in tmod(_nchw(x))]
    assert [g.shape[1:3] for g in got] == [(10, 12), (5, 6), (3, 3), (2, 2)]
    _close(got, jax64(jmod, v, x))


@pytest.mark.parametrize("hw,bias", [((16, 16), True), ((16, 24), False)])
def test_beit_bias_only_on_a_square_grid(hw, bias):
    x = np.random.RandomState(7).randn(1, *hw, 3)
    kw = dict(embed_dim=16, depth=2, num_heads=2, patch_size=4,
              out_indices=(0, 1))
    jmod, tmod = jbz.BEiT(**kw), backbones_zoo.BEiT(**kw)
    v = carried_module(jmod, tmod, x)
    # the table spans the grid's height (4), whatever its width
    assert tmod.block0.rel_pos_bias.shape == (49, 2)
    with torch.no_grad():
        got = [_nhwc(t) for t in tmod(_nchw(x))]
        _close(got, jax64(jmod, v, x))
        for i in range(2):
            getattr(tmod, f"block{i}").rel_pos_bias.zero_()
        unbiased = [_nhwc(t) for t in tmod(_nchw(x))]
    assert (max(rel_err(u, g) for u, g in zip(unbiased, got)) > 1e-6) == bias


def test_beit_and_mae_raise_on_another_grid():
    for kind in ("BEiT", "MAE"):
        tmod = BACKBONES.build(dict(type=kind, embed_dim=16, depth=1,
                                    num_heads=2, patch_size=4,
                                    out_indices=(0,)))
        with torch.no_grad():
            tmod(torch.rand(1, 3, 16, 16))
            with pytest.raises(ValueError, match="shape"):
                tmod(torch.rand(1, 3, 24, 24))


@pytest.mark.parametrize("kind", ["MITB0", "MITB2"])
def test_mit_aliases_carry(kind):
    x = np.zeros((1, 32, 32, 3))
    jmod, tmod = JBACKBONES.get(kind)(), BACKBONES.build(dict(type=kind))
    carried_module(jmod, tmod, x)
    assert tmod.out_channels == list(jmod.embed_dims)


SETR_TAPS = [np.random.RandomState(8 + i).randn(2, 6, 10, 12)
             for i in range(4)]


@pytest.mark.parametrize("kind,kw", [
    ("SETRUPHead", dict(in_channels=12, channels=8, num_convs=2,
                        up_scale=2)),
    ("SETRMLAHead", dict(in_channels=(12, 12, 12, 12), channels=8,
                         mla_channels=4, up_scale=2)),
    ("SETRMLAHead", dict(in_channels=(12, 12), channels=8, mla_channels=4,
                         up_scale=2, in_index=(1, 3), align_corners=True)),
])
def test_setr_heads(kind, kw):
    kw = dict(kw, num_classes=5)
    jkw = {k: v for k, v in kw.items() if k != "in_channels"}
    jmod, tmod = JHEADS.get(kind)(**jkw), HEADS.build(dict(kw, type=kind))
    taps = tuple(SETR_TAPS)
    v = carried_module(jmod, tmod, taps, train=False)
    with torch.no_grad():
        got = _nhwc(tmod([_nchw(t) for t in taps]))
    _close(got, jax64(jmod, v, taps, train=False))


@pytest.mark.parametrize("kind,kw,n", [
    ("MLANeck", dict(in_channels=(12,) * 4, out_channels=8), 4),
    ("MultiLevelNeck", dict(in_channels=(12,), out_channels=8,
                            scales=(0.5, 1, 2, 3)), 1),
    ("MultiLevelNeck", dict(in_channels=(12,) * 4, out_channels=8), 4),
    ("Feature2Pyramid", dict(embed_dim=12), 4),
])
def test_transformer_necks(kind, kw, n):
    taps = tuple(SETR_TAPS[:n])
    jkw = {k: v for k, v in kw.items() if k != "in_channels"} \
        if kind == "MultiLevelNeck" else kw
    jmod, tmod = JNECKS.get(kind)(**jkw), NECKS.build(dict(kw, type=kind))
    v = carried_module(jmod, tmod, taps, train=False)
    with torch.no_grad():
        got = [_nhwc(t) for t in tmod([_nchw(t) for t in taps])]
    _close(got, jax64(jmod, v, taps, train=False))


def test_flax_to_torch_state_follows_the_module():
    """ViT's (1, base, base, C) positional grid is no conv kernel and
    keeps its layout; the attention kernels of flax's
    MultiHeadDotProductAttention reshape into the dense weights."""
    x = np.zeros((1, 16, 16, 3))
    kw = dict(embed_dim=8, depth=1, num_heads=2, patch_size=4,
              out_indices=(0,), img_size=24)
    vt = vit.VisionTransformer(**kw)
    v = carried_module(jvit.VisionTransformer(**kw), vt, x)
    pos = v["params"]["pos_embed"]
    assert pos.shape == (1, 6, 6, 8)
    np.testing.assert_array_equal(vt.pos_embed.detach().numpy(), pos)

    layer = heads_zoo._TransformerLayer(12, 3)
    v = carried_module(jhz._TransformerLayer(12, 3), layer,
                       np.zeros((1, 5, 12)))["params"]["attn"]
    for name in ("query", "key", "value"):
        kernel, b = v[name]["kernel"], v[name]["bias"]
        assert kernel.shape == (12, 3, 4) and b.shape == (3, 4)
        lin = getattr(layer.attn, name)
        np.testing.assert_array_equal(lin.weight.detach().numpy(),
                                      kernel.reshape(12, 12).T)
        np.testing.assert_array_equal(lin.bias.detach().numpy(),
                                      b.reshape(12))
    assert v["out"]["kernel"].shape == (3, 4, 12)
    np.testing.assert_array_equal(layer.attn.out.weight.detach().numpy(),
                                  v["out"]["kernel"].reshape(12, 12).T)


def test_flax_to_torch_state_still_raises_on_leftovers():
    x = jnp.zeros((1, 16, 16, 3))
    kw = dict(embed_dim=8, depth=1, num_heads=2, patch_size=4,
              out_indices=(0,), img_size=24)
    v = random_variables(lambda: jvit.VisionTransformer(**kw).init(
        {"params": jax.random.PRNGKey(0)}, x))
    holder = nn.Module()
    holder.backbone = vit.VisionTransformer(**kw)
    extra = {"params": {"backbone": dict(v["params"])}}
    extra["params"]["backbone"]["stray"] = np.zeros((2, 2, 2, 2))
    with pytest.raises(KeyError, match="stray"):
        carry(extra, holder)
    short = {"params": {"backbone": dict(v["params"])}}
    del short["params"]["backbone"]["pos_embed"]
    with pytest.raises(KeyError, match="pos_embed"):
        flax_to_torch_state(jax.tree_util.tree_map(np.asarray, short),
                            holder)
