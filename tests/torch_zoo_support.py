"""Shared by the zoo's parity tests (tests/test_torch_zoo_*.py): seeded
variables for a flax zoo module, carried into the port's module built from
the same config."""

import glob
import os

import numpy as np
import pytest
import torch

import jax

from peanut_tpu_torch.models.mmseg_import import (flax_to_torch_state,
                                                  load_mmseg_state)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the ResNetV1c EncoderDecoder families of the model zoo that the port
# builds (ROADMAP A13, part 1)
FAMILIES = ("ann", "apcnet", "ccnet", "danet", "deeplabv3", "deeplabv3plus",
            "dmnet", "dnlnet", "emanet", "encnet", "fastfcn", "fcn", "gcnet",
            "isanet", "nonlocal_net", "ocrnet", "psanet", "pspnet",
            "sem_fpn", "upernet")
# the transformer families (ROADMAP A13 part 3) and the cascade ones
# (part 2: K-Net's head over ResNetV1c, PointRend's CascadeEncoderDecoder)
TRANSFORMER_FAMILIES = ("beit", "convnext", "dpt", "mae", "segformer",
                        "segmenter", "setr", "swin", "twins", "vit")
CASCADE_FAMILIES = ("knet", "point_rend")
# the light-CNN families (ROADMAP A13 part 4)
LIGHT_FAMILIES = ("bisenetv1", "bisenetv2", "cgnet", "erfnet", "fastscnn",
                  "hrnet", "icnet", "mobilenet_v2", "mobilenet_v3",
                  "resnest", "stdc", "unet")
PORTED = FAMILIES + TRANSFORMER_FAMILIES + CASCADE_FAMILIES + LIGHT_FAMILIES
# depth cuts of the published widths in the CPU parity tests, which keep a
# file near a minute on one core (the card runs the configs as they are):
# ViT-B/16 keeps its width and four of its twelve blocks, a tap after
# each; Swin-T keeps its widths and two blocks a stage (one shifted)
CUTS = {"vit": dict(depth=4, out_indices=(0, 1, 2, 3)),
        "swin": dict(depths=(2, 2, 2, 2))}
# the whole-model check's input: 64x128, but 32x64 for the three UPerNets
# of 512 channels (float64 convolutions in XLA's CPU backend take most of
# their time); Swin's grids still pad to its 7x7 windows
CHECK_HW = {"convnext": (32, 64), "swin": (32, 64), "vit": (32, 64)}
# the attention gates that start at 0: set non-zero, or a parity test
# would pass with the attention branch wrong
GATES = ("gamma", "cca_gamma")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The zoo files' tests on one torch thread (each file near a minute
    on the CPU), the session's thread count restored after the file."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def randomize(tree, rng, dtype=np.float32):
    """Every variable as a numpy array of ``dtype`` (numpy, so that no
    jnp conversion outside ``jax.enable_x64`` rounds float64 to float32),
    and random batch statistics (a positive
    variance), norm scales and biases, and non-zero gates: initial ones
    (unit statistics, zero biases, zero gates) would hide a swapped or
    dropped term."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = randomize(v, rng, dtype)
            continue
        v = np.asarray(v)
        if k in ("var", "scale") or k in GATES:
            v = 0.5 + rng.rand(*v.shape)
        elif k in ("mean", "bias"):
            v = 0.2 * rng.randn(*v.shape)
        out[k] = np.asarray(v, dtype)
    return out


def carry(variables, model: torch.nn.Module, dtype=torch.float64):
    """The flax ``variables`` loaded into the port's ``model`` (in
    ``dtype``) through ``flax_to_torch_state``."""
    host = jax.tree_util.tree_map(np.asarray, dict(variables))
    model = model.to(dtype)
    return load_mmseg_state(model, flax_to_torch_state(host, model)).eval()


def rel_err(got, want) -> float:
    """max |got - want| over the largest |want|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def random_variables(init_fn, seed: int = 1):
    """Variables of the shapes ``init_fn`` (a flax ``init`` call) makes,
    drawn from a seeded normal (kernels scaled by 1 / sqrt(fan-in)) without
    running it: ``jax.eval_shape`` traces the init, so no XLA program is
    compiled or run for it.  ``randomize`` then gives the statistics,
    norms, biases and gates their values."""
    shapes = jax.eval_shape(init_fn)
    rng = np.random.RandomState(seed)
    return {col: jax.tree_util.tree_map(
        lambda s: rng.randn(*s.shape) / np.sqrt(
            max(int(np.prod(s.shape[:-1])), 1)), shapes[col])
        for col in ("params", "batch_stats") if col in shapes}


def family_config(family: str) -> dict:
    """The first config of ``configs/<family>/`` at
    ``tests/test_zoo_forward.py``'s ``SHRINK`` widths, with the family's
    depth cut (``CUTS``)."""
    from peanut_tpu.core.config_file import load_config
    from test_zoo_forward import shrink_cfg
    path = sorted(glob.glob(os.path.join(REPO, "configs", family, "*.py")))[0]
    cfg = shrink_cfg(load_config(path)["model"])
    cfg["backbone"].update(CUTS.get(family, {}))
    return cfg


def jax_and_port(cfg, hw, seed=0, jax_cfg=None):
    """The JAX model of ``cfg`` (or of ``jax_cfg``, where the JAX
    package's config differs: a backbone whose input channels flax
    infers), its float64 variables (every one, the auxiliary head's too),
    the port's model carrying them, and a seeded float64 (1, H, W, C)
    input."""
    from peanut_tpu.models import build_segmentor as jbuild
    from peanut_tpu_torch.models.builder import build_segmentor
    in_ch = cfg["backbone"].get("in_channels", 3)
    x = np.random.RandomState(seed).rand(1, *hw, in_ch)
    jm = jbuild(cfg if jax_cfg is None else jax_cfg)
    v = random_variables(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, jax.numpy.zeros((1, *hw, in_ch)),
        train=False, with_aux=True))
    v = randomize(v, np.random.RandomState(seed + 1), np.float64)
    return jm, v, carry(v, build_segmentor(cfg)), x


def check_family(family: str) -> None:
    """The family's whole model at SHRINK widths on a 64x128 input (or
    ``CHECK_HW``'s), in float64 on both sides: logits within 1e-9 of the
    largest |logit|, and ``predict_labels`` equal."""
    jm, v, pm, x = jax_and_port(family_config(family),
                                CHECK_HW.get(family, (64, 128)))
    with jax.enable_x64(True):
        fn = jax.jit(lambda v, x: jm.apply(v, x, method=lambda m, x: (
            m.inference(x), m.predict_labels(x))))
        want, want_labels = (np.asarray(a) for a in fn(v, x))
    with torch.no_grad():
        got = pm.inference(torch.as_tensor(x)).numpy()
        labels = pm.predict_labels(torch.as_tensor(x)).numpy()
    assert want.dtype == got.dtype == np.float64
    assert rel_err(got, want) <= 1e-9
    np.testing.assert_array_equal(labels, want_labels)


def carried_module(jmod, tmod, *init_args, seed: int = 2, **init_kw):
    """Seeded float64 variables of the flax module ``jmod`` (shaped by an
    init on ``init_args``), carried into the port's ``tmod`` by
    ``flax_to_torch_state`` (under a holder's child ``m``, so every
    variable and parameter must be placed).  Returns the variables."""
    from torch import nn
    shapes = jax.tree_util.tree_map(        # the init traces in float32
        lambda a: np.asarray(a, np.float32), init_args)
    v = random_variables(lambda: jmod.init(
        {"params": jax.random.PRNGKey(0)}, *shapes, **init_kw))
    v = randomize(v, np.random.RandomState(seed), np.float64)
    holder = nn.Module()
    holder.add_module("m", tmod)
    carry({c: {"m": t} for c, t in v.items()}, holder)
    return v


def jax64(jmod, v, *args, **kw):
    """``jmod.apply(v, *args, **kw)`` in float64 (``args`` numpy arrays,
    ``kw`` static), the outputs as numpy."""
    with jax.enable_x64(True):
        out = jax.jit(lambda v, *a: jmod.apply(v, *a, **kw))(v, *args)
    return jax.tree_util.tree_map(np.asarray, out)


# ---- the zoo's train step (tests/test_torch_zoo_train*.py) ---------------

TRAIN_CHANNELS = 14    # PEANUT's map channels
TRAIN_CLASSES = 6      # PEANUT's targets
TRAIN_HW = (32, 32)
TRAIN_LR = 1e-3
# a ConvNeXt narrow enough for a float64 train step on one core, put in
# both packages' arch tables by ``narrow_convnext``
NARROW_CONVNEXT = ((1, 1, 2, 1), (16, 32, 48, 64))
# family: (config under configs/, backbone, decode head, auxiliary head
# overrides); narrow heads over the configs' backbones, the transformers
# and MobileNetV2 narrowed too
TRAIN_CASES = {
    "upernet_convnext": (
        "convnext/upernet_convnext_512x512_160k_ade20k.py",
        dict(arch="narrow"), dict(in_channels=(16, 32, 48, 64), channels=16),
        dict(in_channels=48, channels=8)),
    "upernet_vit": (
        "vit/upernet_vit-b16_512x512_80k_ade20k.py",
        dict(embed_dim=32, depth=4, num_heads=2, out_indices=(0, 1, 2, 3)),
        dict(in_channels=(32, 32, 32, 32), channels=16),
        dict(in_channels=32, channels=8)),
    # no auxiliary head in its config: an FCN one over the third tap
    "mae_upernet": (
        "mae/mae_upernet_512x512_160k_ade20k.py", {}, dict(channels=32),
        dict(type="FCNHead", in_channels=96, in_index=2, channels=16,
             num_convs=1, concat_input=False, align_corners=False)),
    "pspnet_m-v2-d8": (
        "mobilenet_v2/pspnet_m-v2-d8_512x1024_80k_cityscapes.py",
        dict(widen_factor=0.5), dict(in_channels=160, channels=32),
        dict(in_channels=48, channels=16)),
    "fast_scnn": ("fastscnn/fast_scnn_512x1024_80k_cityscapes.py", {},
                  dict(channels=32), dict(channels=16)),
    "bisenetv1_r18": ("bisenetv1/bisenetv1_r18_512x1024_80k_cityscapes.py",
                      {}, {}, {}),
    "stdc1": ("stdc/stdc1_512x1024_80k_cityscapes.py", {}, {}, {}),
}


@pytest.fixture
def narrow_convnext(monkeypatch):
    """The "narrow" ConvNeXt arch in both packages' tables."""
    from peanut_tpu.models import convnext as jconvnext
    from peanut_tpu_torch.models import convnext
    for mod in (jconvnext, convnext):
        monkeypatch.setitem(mod.ARCHS, "narrow", NARROW_CONVNEXT)


def train_case_configs(family: str):
    """(the JAX package's config, the port's) of a ``TRAIN_CASES`` family:
    the overrides, 6 classes and dropout 0 in both heads; the port's
    backbone also names the 14 input channels flax infers."""
    from peanut_tpu_torch.core.config_file import load_config
    path, bb, dec, aux = TRAIN_CASES[family]
    cfg = load_config(os.path.join(REPO, "configs", path))["model"]
    cfg["backbone"].update(bb)
    cfg["decode_head"].update(dec)
    cfg["auxiliary_head"] = dict(cfg.get("auxiliary_head") or {}, **aux)
    for k in ("decode_head", "auxiliary_head"):
        cfg[k].update(num_classes=TRAIN_CLASSES, dropout_ratio=0.0)
    port = dict(cfg, backbone=dict(cfg["backbone"],
                                   in_channels=TRAIN_CHANNELS))
    return cfg, port


def jax_train_step(jm, variables, img, gt, tcfg):
    """The JAX package's step (prediction/train.py:80-99) in float64:
    loss, gradients, batch statistics and the parameters after optax's
    Adam at the poly schedule, as numpy."""
    import jax.numpy as jnp
    import optax
    from peanut_tpu.models import losses as jlosses
    from peanut_tpu.prediction.train import poly_schedule as jpoly

    def loss_fn(params, stats):
        (logits, aux), mut = jm.apply(
            {"params": params, "batch_stats": stats}, img, train=True,
            with_aux=True, mutable=["batch_stats"],
            rngs={"dropout": jax.random.PRNGKey(0)})
        t = gt / 255.0
        main = jnp.mean(jlosses.bce_with_logits(logits, t))
        aux_l = jnp.mean(jlosses.bce_with_logits(aux, t))
        return main + tcfg.aux_weight * aux_l, mut["batch_stats"]

    with jax.enable_x64(True):
        params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
        stats = jax.tree_util.tree_map(jnp.asarray,
                                       variables["batch_stats"])
        (loss, new_stats), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params, stats)
        tx = optax.adam(learning_rate=jpoly(tcfg))
        updates, _ = tx.update(grads, tx.init(params), params)
        new_params = optax.apply_updates(params, updates)
        return jax.tree_util.tree_map(np.asarray, (
            loss, grads, new_stats, new_params))


def check_train_step(family: str) -> None:
    """One train step of a ``TRAIN_CASES`` family in float64 on both
    sides, batch 2 at 32x32, from the JAX model's seeded variables: the
    loss within 1e-5 relative, every gradient within 1e-4 of its tensor's
    largest |value| (plus 1e-10 of the model's largest, for tensors whose
    gradients cancel), the running statistics within 1e-8 relative, the
    parameters after Adam within 1e-4 of the learning rate; every
    parameter, input-shaped ones included, in the optimizer."""
    import jax.numpy as jnp
    from peanut_tpu.models import build_segmentor as jbuild
    from peanut_tpu.prediction.train import TrainConfig as JTrainConfig
    from peanut_tpu_torch.models.builder import build_segmentor
    from peanut_tpu_torch.prediction.train import (TrainConfig,
                                                   create_train_state,
                                                   make_train_step)
    jcfg, pcfg = train_case_configs(family)
    rng = np.random.RandomState(0)
    img = rng.rand(2, *TRAIN_HW, TRAIN_CHANNELS)
    gt = (rng.rand(2, *TRAIN_HW, TRAIN_CLASSES) > 0.8) * 255.0
    jm = jbuild(jcfg)
    v = random_variables(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)},
        jnp.zeros((1, *TRAIN_HW, TRAIN_CHANNELS)), train=False,
        with_aux=True))
    v = randomize(v, np.random.RandomState(1), np.float64)
    loss, grads, stats, new_params = jax_train_step(
        jm, v, img, gt, JTrainConfig(lr=TRAIN_LR, max_iters=50,
                                     batch_size=2))

    tcfg = TrainConfig(lr=TRAIN_LR, max_iters=50)
    model = carry(v, build_segmentor(pcfg))
    state = create_train_state(model, tcfg, device="cpu")
    held = {id(p) for g in state.optimizer.param_groups for p in g["params"]}
    assert all(id(p) in held for p in model.parameters())
    metrics = make_train_step(tcfg)(state, {
        "img": torch.as_tensor(img.transpose(0, 3, 1, 2)),
        "gt": torch.as_tensor(gt.transpose(0, 3, 1, 2))})
    assert float(metrics["loss"]) == pytest.approx(float(loss), rel=1e-5)

    want_g = flax_to_torch_state({"params": grads, "batch_stats": stats},
                                 model)
    top = max(np.abs(want_g[n]).max() for n, _ in model.named_parameters())
    for name, p in model.named_parameters():
        w = want_g[name]
        np.testing.assert_allclose(
            p.grad.numpy(), w, rtol=0,
            atol=1e-4 * np.abs(w).max() + 1e-10 * top, err_msg=name)
        assert np.abs(w).max() > 0 or "bias" in name, name
    want = flax_to_torch_state({"params": new_params, "batch_stats": stats},
                               model)
    sd = model.state_dict()
    for name, w in want.items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[name].numpy(), w, rtol=1e-8,
                                       atol=1e-12, err_msg=name)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=0,
                                   atol=1e-4 * TRAIN_LR, err_msg=name)


# the parameters whose gradient is zero in train mode in both packages
# (checked against the JAX package's gradients in check_train_forward):
# APCNet's adaptive context at pool scale 1 (one region: a softmax over
# one cell), ISANet's local attention over one cell at the test size,
# EncNet's SE-loss classifier (sown, in no output), K-Net's first masks
# and the mask branches of its first two of three stages (each stage's
# masks reach the next only through a hard threshold)
ZERO_GRAD = {
    "apcnet": ("decode_head.acm0_input.conv.weight",
               "decode_head.acm0_input.bn.weight",
               "decode_head.acm0_input.bn.bias"),
    "isanet": ("decode_head.local_q.weight", "decode_head.local_q.bias",
               "decode_head.local_k.weight", "decode_head.local_k.bias"),
    "encnet": ("decode_head.se_layer.weight", "decode_head.se_layer.bias"),
    "knet": ("decode_head.conv_seg.weight", "decode_head.conv_seg.bias")
    + tuple(f"decode_head.kernel_update_head{i}.{m}.{w}" for i in (0, 1)
            for m in ("mask_fc", "mask_fc_norm") for w in ("weight", "bias")),
}
# BEiT's relative-position tables join on a square patch grid alone
TRAIN_FORWARD_HW = {"beit": (32, 32)}


def check_train_forward(family: str) -> None:
    """The family's whole model (``family_config``, heads' dropout 0) in
    train mode, in float64 on both sides on a seeded (2, H, W, C) input
    (32x64, ``TRAIN_FORWARD_HW``): every output of the JAX package's
    ``apply(train=True, with_aux=True, mutable=["batch_stats"])`` (stage
    logits, the auxiliary head's; the point head's sown ones for
    PointRend) within 1e-9 of its largest |value|, and the running
    statistics after it within 1e-8 relative (1e-10 absolute).  Then the
    port's backward of the outputs' means: every parameter gets a finite
    gradient, non-zero but for ``ZERO_GRAD``'s; for those families the
    JAX package's gradients of the same sum too (within 1e-4 of each
    tensor's largest |value|, plus 1e-10 of the model's largest)."""
    import jax.numpy as jnp
    from peanut_tpu.models import build_segmentor as jbuild
    from peanut_tpu_torch.models.builder import build_segmentor
    hw = TRAIN_FORWARD_HW.get(family, (32, 64))
    cfg = family_config(family)
    heads = cfg["decode_head"]
    for h in (heads if isinstance(heads, list) else [heads]) + (
            [cfg["auxiliary_head"]] if cfg.get("auxiliary_head") else []):
        h["dropout_ratio"] = 0.0
    in_ch = cfg["backbone"].get("in_channels", 3)
    x = np.random.RandomState(0).rand(2, *hw, in_ch)
    jm = jbuild(cfg)
    v = random_variables(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, *hw, in_ch)),
        train=False, with_aux=True))
    v = randomize(v, np.random.RandomState(1), np.float64)
    points = cfg["type"] == "CascadeEncoderDecoder" and any(
        h["type"] == "PointHead" for h in heads)

    def apply(params, x):
        out, mut = jm.apply(dict(v, params=params), x, train=True,
                            with_aux=True,
                            mutable=["batch_stats", "intermediates"])
        outs = list(out) if isinstance(out, tuple) else [out]
        if points:
            outs.append(mut["intermediates"]["point_logits"][0])
        return sum(jnp.mean(o) for o in outs), (out, mut)

    with jax.enable_x64(True):
        params = jax.tree_util.tree_map(jnp.asarray, v["params"])
        if family in ZERO_GRAD:
            (_, (out, mut)), jgrads = jax.jit(jax.value_and_grad(
                apply, has_aux=True))(params, x)
        else:
            _, (out, mut) = jax.jit(apply)(params, x)
            jgrads = None
        out, mut, jgrads = jax.tree_util.tree_map(np.asarray,
                                                  (out, mut, jgrads))
    pm = carry(v, build_segmentor(cfg)).requires_grad_(True)
    got = pm(torch.as_tensor(x.transpose(0, 3, 1, 2)), train=True,
             with_aux=True, **({"with_points": True} if points else {}))
    got, extra = got if points else (got, None)
    outs = list(got) if isinstance(got, tuple) else [got]
    want = list(out) if isinstance(out, tuple) else [out]
    assert len(outs) == len(want)
    for g, w in zip(outs, want):
        assert rel_err(g.detach().numpy().transpose(0, 2, 3, 1), w) <= 1e-9
    if points:
        inter = mut["intermediates"]
        np.testing.assert_array_equal(extra["points"].numpy(),
                                      inter["points"][0])
        assert rel_err(extra["point_logits"].detach().numpy().transpose(
            0, 2, 1), inter["point_logits"][0]) <= 1e-9
        outs.append(extra["point_logits"])
    stats = mut.get("batch_stats", {})
    want_sd = flax_to_torch_state({"params": v["params"],
                                   "batch_stats": stats}, pm)
    sd = pm.state_dict()
    for name, w in want_sd.items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[name].numpy(), w, rtol=1e-8,
                                       atol=1e-10, err_msg=name)
    sum(o.mean() for o in outs).backward()
    zero = set()
    for name, p in pm.named_parameters():
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        assert torch.isfinite(g).all(), name
        if not g.any():
            zero.add(name)
    assert zero == set(ZERO_GRAD.get(family, ())), sorted(zero)
    if jgrads is not None:
        want_g = flax_to_torch_state({"params": jgrads,
                                      "batch_stats": stats}, pm)
        top = max(np.abs(want_g[n]).max() for n, _ in pm.named_parameters())
        for name, p in pm.named_parameters():
            g = (p.grad if p.grad is not None
                 else torch.zeros_like(p)).numpy()
            w = want_g[name]
            np.testing.assert_allclose(
                g, w, rtol=0, atol=1e-4 * np.abs(w).max() + 1e-10 * top,
                err_msg=name)
