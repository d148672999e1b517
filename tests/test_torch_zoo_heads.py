"""The model zoo's decode heads and necks of the port against their flax
modules, on the CPU.

Each of the 17 zoo heads over ResNetV1c (and PSPHead and FCNHead, and the
JPU and FPN necks) at small widths, batch 2, on seeded feature pyramids:
the JAX package's variables (seeded normals; random batch statistics with
a positive variance, random norm scales and biases, and the attention
gates ``gamma`` / ``cca_gamma`` non-zero, since at their initial 0 the
attention branch would contribute nothing) carried into the port by
``flax_to_torch_state``, which must place every variable and set every
parameter.  In float64 on both sides (``jax.enable_x64``) the outputs agree
within 1e-9 of the largest |value|; in float32 within 1e-4 (the two
frameworks' CPU products sum in other orders).  The pyramids' top levels
are 6x10, so ISAHead pads to its down-factor 4 and crops back, and DMHead
folds batch 2 into its depthwise groups.  Then ``slide_inference`` with
overlapping windows (crop 64x96, stride 40x56 on 100x200: 2 x 3 windows,
the last of each row and column clamped to the border) against the JAX
package's, in float64.  (Each family's whole model:
``test_torch_zoo_models.py`` and ``_2``.)
"""

import numpy as np
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

import peanut_tpu.models  # noqa: F401  (registers the JAX zoo)
from peanut_tpu.models import layers as jlayers, ops as jops
from peanut_tpu.registry import HEADS as JHEADS, NECKS as JNECKS
from peanut_tpu_torch.models import ops
from peanut_tpu_torch.models.layers import ConvModule
import peanut_tpu_torch.models.builder  # noqa: F401  (registers the zoo)
from peanut_tpu_torch.models.layers import init_flax_random
from peanut_tpu_torch.registry import HEADS, NECKS

from torch_zoo_support import (carry, family_config, jax_and_port,
                               random_variables, randomize, rel_err)
from torch_zoo_support import one_thread  # noqa: F401  (autouse)

# (channels, height, width) of the levels: "d8" as a dilated ResNetV1c
# gives them (strides 4, 8, 8, 8), "d32" as a plain one (4, 8, 16, 32)
PYRAMIDS = {"d8": ((8, 12, 20), (16, 6, 10), (24, 6, 10), (32, 6, 10)),
            "d32": ((8, 16, 24), (16, 8, 12), (24, 4, 6), (32, 2, 3))}
HEAD_CASES = {
    "PSPHead": ("d8", dict(in_channels=32, channels=8)),
    "FCNHead": ("d8", dict(in_channels=32, channels=8, num_convs=2,
                           concat_input=True, in_index=3)),
    "UPerHead": ("d32", dict(in_channels=(8, 16, 24, 32), channels=8)),
    "ASPPHead": ("d8", dict(in_channels=32, channels=8,
                            dilations=(1, 2, 3, 4))),
    "DepthwiseSeparableASPPHead": ("d8", dict(
        in_channels=32, channels=8, dilations=(1, 2, 3, 4),
        c1_in_channels=8, c1_channels=4)),
    "OCRHead": ("d8", dict(in_channels=32, channels=8, ocr_channels=4)),
    "DAHead": ("d8", dict(in_channels=32, channels=16)),
    "NLHead": ("d8", dict(in_channels=32, channels=8)),
    "GCHead": ("d8", dict(in_channels=32, channels=16)),
    "ANNHead": ("d8", dict(in_channels=(24, 32), channels=8,
                           project_channels=4)),
    "APCHead": ("d8", dict(in_channels=32, channels=8)),
    "DMHead": ("d8", dict(in_channels=32, channels=8)),
    "EMAHead": ("d8", dict(in_channels=32, channels=8, ema_channels=8,
                           num_bases=4)),
    "EncHead": ("d8", dict(in_channels=(16, 24, 32), channels=8,
                           num_codes=4, add_lateral=True)),
    "DNLHead": ("d8", dict(in_channels=32, channels=8)),
    "ISAHead": ("d8", dict(in_channels=32, channels=8, isa_channels=4,
                           down_factor=(4, 4))),
    "FPNHead": ("d32", dict(in_channels=(8, 16, 24, 32), channels=8)),
    "PSAHead": ("d8", dict(in_channels=32, channels=8, mask_channels=8)),
    "CCHead": ("d8", dict(in_channels=32, channels=16)),
}
# align_corners=True through a head's resizes (the configs all use False)
HEAD_CASES["UPerHead_align_corners"] = ("d32", dict(
    HEAD_CASES["UPerHead"][1], align_corners=True))
NECK_CASES = {
    "JPU": ("d32", dict(in_channels=(16, 24, 32), mid_channels=8,
                        start_level=1)),
    "FPN": ("d32", dict(out_channels=8, num_levels=4, add_p6_pool=False)),
    "FPN_p6": ("d32", dict(out_channels=8, num_levels=4, add_p6_pool=True)),
}
DTYPES = {"float64": (np.float64, torch.float64, 1e-9),
          "float32": (np.float32, torch.float32, 1e-4)}


def _pyramid(name, dtype):
    rng = np.random.RandomState(0)
    return [rng.randn(2, h, w, c).astype(dtype)
            for c, h, w in PYRAMIDS[name]]


def _compare(jmod, tmod, role, feats, dtype_name):
    """jmod's output on feats (NHWC) against tmod's, the variables carried
    under ``role`` (decode_head or neck)."""
    np_dt, t_dt, tol = DTYPES[dtype_name]
    with jax.enable_x64(np_dt == np.float64):
        jfeats = tuple(jnp.asarray(f) for f in feats)
        v = random_variables(lambda: jmod.init(
            {"params": jax.random.PRNGKey(0)}, jfeats, train=False))
        v = randomize(v, np.random.RandomState(2), np_dt)
        want = jax.jit(lambda v, f: jmod.apply(v, f, train=False))(v, jfeats)
        want = [np.asarray(w) for w in (
            want if isinstance(want, (tuple, list)) else [want])]
    holder = nn.Module()
    holder.add_module(role, tmod)
    carry({c: {role: t} for c, t in v.items()}, holder, t_dt)
    with torch.no_grad():
        got = tmod([torch.as_tensor(f).permute(0, 3, 1, 2) for f in feats])
    got = [g.permute(0, 2, 3, 1).numpy() for g in (
        got if isinstance(got, (tuple, list)) else [got])]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np_dt
        err = rel_err(g, w)
        assert err <= tol, err


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("head", list(HEAD_CASES))
def test_head_matches_its_flax_module(head, dtype_name):
    pyr, kw = HEAD_CASES[head]
    kind = head.split("_")[0]
    kw = dict(kw, num_classes=5, dropout_ratio=0.1)
    feats = _pyramid(pyr, DTYPES[dtype_name][0])
    jkw = {k: v for k, v in kw.items() if k != "in_channels"} \
        if kind == "FPNHead" else dict(kw)
    _compare(JHEADS.get(kind)(**jkw), HEADS.build(dict(kw, type=kind)),
             "decode_head", feats, dtype_name)


@pytest.mark.parametrize("dtype_name", list(DTYPES))
@pytest.mark.parametrize("neck", list(NECK_CASES))
def test_neck_matches_its_flax_module(neck, dtype_name):
    pyr, kw = NECK_CASES[neck]
    kind = neck.split("_")[0]
    tkw = dict(kw)
    if kind == "FPN":
        tkw["in_channels"] = tuple(c for c, _, _ in PYRAMIDS[pyr])
    feats = _pyramid(pyr, DTYPES[dtype_name][0])
    _compare(JNECKS.get(kind)(**kw), NECKS.build(dict(tkw, type=kind)),
             "neck", feats, dtype_name)


def test_zero_gates_would_hide_the_attention_branch():
    """At flax's initial gates (0) DAHead's and CCHead's attention adds
    nothing; the carried, non-zero gates above are what exercise it."""
    feats = [torch.as_tensor(f).permute(0, 3, 1, 2)
             for f in _pyramid("d8", np.float64)]
    for head in ("DAHead", "CCHead"):
        _, kw = HEAD_CASES[head]
        tmod = HEADS.build(dict(kw, type=head, num_classes=5)).double()
        init_flax_random(tmod, torch.Generator().manual_seed(0))
        with torch.no_grad():
            base = tmod(feats)
            gates = [p for n, p in tmod.named_parameters()
                     if n.endswith("gamma")]
            assert gates and all(float(g) == 0.0 for g in gates)
            for g in gates:
                g.fill_(0.7)
            assert (tmod(feats) - base).abs().max() > 1e-3


def test_flax_to_torch_state_raises_on_leftovers():
    """A flax variable the port does not have, or a port parameter no
    variable sets, raises KeyError."""
    pyr, kw = HEAD_CASES["UPerHead"]
    feats = tuple(jnp.asarray(f) for f in _pyramid(pyr, np.float32))
    jmod = JHEADS.get("UPerHead")(**kw, num_classes=5)
    v = random_variables(lambda: jmod.init(
        {"params": jax.random.PRNGKey(0)}, feats, train=False))
    holder = nn.Module()
    holder.decode_head = HEADS.build(dict(kw, type="UPerHead",
                                          num_classes=5))
    extra = {c: {"decode_head": dict(t)} for c, t in v.items()}
    extra["params"]["decode_head"]["stray"] = {"kernel": np.zeros((1, 1))}
    with pytest.raises(KeyError, match="stray"):
        carry(extra, holder)
    short = {c: {"decode_head": dict(t)} for c, t in v.items()}
    del short["params"]["decode_head"]["fpn_bottleneck"]
    del short["batch_stats"]["decode_head"]["fpn_bottleneck"]
    with pytest.raises(KeyError, match="fpn_bottleneck"):
        carry(short, holder)


def test_slide_inference_matches_jax():
    cfg = family_config("upernet")
    cfg["test_cfg"] = dict(mode="slide", crop_size=(64, 96), stride=(40, 56))
    jm, v, pm, x = jax_and_port(cfg, (100, 200), seed=3)
    with jax.enable_x64(True):
        want = np.asarray(jax.jit(lambda v, x: jm.apply(
            v, x, method=jm.inference))(v, jnp.asarray(x)))
    with torch.no_grad():
        got = pm.inference(torch.as_tensor(x)).numpy()
        whole = pm.whole_inference(torch.as_tensor(x).permute(0, 3, 1, 2))
    assert rel_err(got, want) <= 1e-9
    # the overlap normalisation is doing something: not the whole image's
    assert rel_err(whole.permute(0, 2, 3, 1).numpy(), got) > 1e-3


@pytest.mark.parametrize("align_corners", [False, True])
def test_resize_and_pool_match_jax_and_torch(align_corners):
    """``ops.resize_nchw`` (and ``resize_bilinear``, its NHWC wrapper)
    within 1e-15 of the JAX package's resize (the same float32 matrices,
    float64 maps; products summed in other orders) and within 1e-6 of
    ``F.interpolate``; ``ops.adaptive_avg_pool`` to the JAX package's and
    ``F.adaptive_avg_pool2d`` alike, down to one cell, within 1e-15 in
    float64 and 1e-6 in float32."""
    x = np.random.RandomState(4).randn(2, 7, 11, 3)
    xt = torch.as_tensor(x)
    for size in ((1, 1), (3, 5), (7, 11), (14, 9), (29, 40)):
        with jax.enable_x64(True):
            want = np.asarray(jops.resize_bilinear(jnp.asarray(x), size,
                                                   align_corners))
        got = ops.resize_nchw(xt.permute(0, 3, 1, 2), size, align_corners)
        assert rel_err(got.permute(0, 2, 3, 1).numpy(), want) <= 1e-15
        if not align_corners:
            assert rel_err(ops.resize_bilinear(xt, size).numpy(),
                           want) <= 1e-15
        ref = torch.nn.functional.interpolate(
            xt.permute(0, 3, 1, 2), size, mode="bilinear",
            align_corners=align_corners).permute(0, 2, 3, 1).numpy()
        assert rel_err(want, ref) <= 1e-6
    for size in (1, 2, 3, 6, (4, 5)):
        with jax.enable_x64(True):
            want = np.asarray(jops.adaptive_avg_pool(jnp.asarray(x), size))
        got = ops.adaptive_avg_pool(xt.permute(0, 3, 1, 2), size)
        assert rel_err(got.permute(0, 2, 3, 1).numpy(), want) <= 1e-15
        got = ops.adaptive_avg_pool(xt.float().permute(0, 3, 1, 2), size)
        assert got.dtype == torch.float32
        assert rel_err(got.permute(0, 2, 3, 1).numpy(), want) <= 1e-6
        ref = torch.nn.functional.adaptive_avg_pool2d(
            xt.permute(0, 3, 1, 2), size).permute(0, 2, 3, 1).numpy()
        assert rel_err(want, ref) <= 1e-6


@pytest.mark.parametrize("with_norm,with_act,groups", [
    (True, True, 1), (False, False, 1), (True, False, 2), (False, True, 4)])
def test_conv_module_matches_flax(with_norm, with_act, groups):
    """``ConvModule``'s options as the flax one's: no BN means a bias, no
    act means no ReLU, and grouped convolutions."""
    x = np.random.RandomState(5).randn(2, 6, 9, 8)
    jmod = jlayers.ConvModule(12, 3, padding=1, with_norm=with_norm,
                              with_act=with_act, groups=groups)
    with jax.enable_x64(True):
        v = random_variables(lambda: jmod.init(
            {"params": jax.random.PRNGKey(0)}, jnp.asarray(x)))
        v = randomize(v, np.random.RandomState(6), np.float64)
        want = np.asarray(jmod.apply(v, jnp.asarray(x)))
    tmod = ConvModule(8, 12, 3, padding=1, with_norm=with_norm,
                      with_act=with_act, groups=groups)
    assert (tmod.conv.bias is None) == with_norm
    holder = nn.Module()
    holder.neck = tmod
    carry({c: {"neck": t} for c, t in v.items()}, holder)
    with torch.no_grad():
        got = tmod(torch.as_tensor(x).permute(0, 3, 1, 2))
    assert rel_err(got.permute(0, 2, 3, 1).numpy(), want) <= 1e-12
