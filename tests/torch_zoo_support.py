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
PORTED = FAMILIES + TRANSFORMER_FAMILIES + CASCADE_FAMILIES
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


def jax_and_port(cfg, hw, seed=0):
    """The JAX model of ``cfg``, its float64 variables (every one, the
    auxiliary head's too), the port's model carrying them, and a seeded
    float64 (1, H, W, C) input."""
    from peanut_tpu.models import build_segmentor as jbuild
    from peanut_tpu_torch.models.builder import build_segmentor
    in_ch = cfg["backbone"].get("in_channels", 3)
    x = np.random.RandomState(seed).rand(1, *hw, in_ch)
    jm = jbuild(cfg)
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
