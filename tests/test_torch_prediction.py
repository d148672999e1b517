"""The port's target prediction (PSPNet-R50-v1c, PredictionModel) and goal
selection against the JAX package's, on the CPU.

* ``flax_to_mmseg_state`` equals the JAX package's
  ``export_encoder_decoder_to_torch`` key for key and bit for bit.
* PSPNet logits on weights moved from JAX (base width 16, 14 x 80 x 72
  inputs, float32, random BN statistics): within 1e-4 of the largest
  |logit| of JAX's, since the two frameworks' CPU convolutions sum in other
  orders; PredictionModel's probabilities within the same bound.
* ``NavAgentState.update_global_goal`` in the temperature modes -1, 0 and
  500 and the serving profile (``dd_downscale=2``, ``dd_order=1``): equal
  goals, ``dd_wt`` and ``value`` within 1e-5 (the geodesic fields are
  bit-equal; ``np.exp`` sees the same numbers).
* No silent random weights: a missing ``pred_model_wts`` raises.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from peanut_tpu.agent.state import NavAgentState as JState
from peanut_tpu.core.checkpoint import export_encoder_decoder_to_torch
from peanut_tpu.models import build_segmentor as jbuild
from peanut_tpu.models import init_segmentor_params
from peanut_tpu.prediction import PredictionModel as JPrediction
from peanut_tpu_torch.agent import NavAgentState, PeanutAgent
from peanut_tpu_torch.config import NavConfig
from peanut_tpu_torch.models.pspnet import (build_segmentor,
                                             peanut_prediction_config)
from peanut_tpu_torch.models.mmseg_import import (flax_to_mmseg_state,
                                                  load_mmseg_checkpoint,
                                                  load_mmseg_state)
from peanut_tpu_torch.prediction import PredictionModel

from test_agent_e2e import small_cfg
from test_torch_agent import StubPrediction

torch.set_num_threads(1)
BASE = 16


def tiny_config():
    """peanut_prediction_config at base width 16 (the aux head included,
    so its keys are carried and load strictly)."""
    cfg = peanut_prediction_config(in_channels=14, num_classes=6)
    cfg["backbone"].update(base_channels=BASE, stem_channels=BASE)
    cfg["decode_head"].update(in_channels=BASE * 32, channels=BASE * 8)
    cfg["auxiliary_head"].update(in_channels=BASE * 16, channels=BASE * 4)
    return cfg


def _randomize(tree, rng, parent=""):
    """Random BN statistics and affine terms (identity ones would hide a
    swapped mean/var or scale/bias)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rng, k)
        elif k in ("var", "scale"):
            out[k] = jnp.asarray(0.5 + rng.rand(*v.shape).astype(np.float32))
        elif k == "mean" or (k == "bias" and parent == "bn"):
            out[k] = jnp.asarray(rng.randn(*v.shape).astype(np.float32)
                                 * 0.2)
        else:
            out[k] = v
    return out


@pytest.fixture(scope="module")
def jax_net():
    """The JAX PSPNet with random variables, and its logits on a seeded
    input."""
    model = jbuild(tiny_config())
    variables = init_segmentor_params(model, (1, 64, 64, 14), seed=0)
    rng = np.random.RandomState(0)
    variables = {"params": _randomize(variables["params"], rng),
                 "batch_stats": _randomize(variables["batch_stats"], rng)}
    x = np.random.RandomState(1).rand(2, 80, 72, 14).astype(np.float32)
    logits = np.asarray(jax.jit(lambda v, i: model.apply(
        v, i, method=model.inference))(variables, jnp.asarray(x)))
    return variables, x, logits


def test_flax_to_mmseg_state_equals_jax_export(jax_net, tmp_path):
    variables = jax_net[0]
    path = str(tmp_path / "pspnet.pth")
    names = export_encoder_decoder_to_torch(variables, path)
    want = load_mmseg_checkpoint(path)
    got = flax_to_mmseg_state(variables)
    assert sorted(got) == sorted(want) == names
    for k in want:
        assert got[k].dtype == np.float32
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # every parameter of the port's model, the aux head's too, is covered
    model = load_mmseg_state(build_segmentor(tiny_config()), got)
    assert set(model.state_dict()) == set(got)
    with pytest.raises(KeyError, match="Unconverted"):
        flax_to_mmseg_state({"params": {"neck": {"w": np.zeros(3)}}})


def test_pspnet_logits_match_jax(jax_net):
    variables, x, want = jax_net
    model = load_mmseg_state(build_segmentor(tiny_config()),
                             flax_to_mmseg_state(variables)).eval()
    with torch.no_grad():
        got = model.inference(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 80, 72, 6)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)


def test_prediction_model_matches_jax(jax_net):
    variables = jax_net[0]
    jcfg = small_cfg()
    cfg = NavConfig(**dataclasses.asdict(jcfg))
    full_map = np.random.RandomState(2).rand(14, 64, 80).astype(np.float32)
    want = JPrediction(jcfg, variables=variables,
                       model_cfg=tiny_config()).get_prediction(full_map)
    model = build_segmentor(tiny_config())
    pm = PredictionModel(cfg, model=load_mmseg_state(
        model, flax_to_mmseg_state(variables)), device="cpu")
    got = pm.get_prediction(full_map)
    assert got.shape == (6, 64, 80) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # a batch of two convolves in another summation order on the CPU
    np.testing.assert_allclose(
        pm.get_prediction_batch(np.stack([full_map, full_map]))[1], got,
        rtol=0, atol=1e-6)


def test_missing_prediction_weights_raise():
    cfg = NavConfig(**dataclasses.asdict(small_cfg(
        pred_model_wts="no/such/pspnet.pth")))
    for make in (lambda: PredictionModel(cfg, device="cpu"),
                 lambda: NavAgentState(cfg, device="cpu"),
                 lambda: PeanutAgent(cfg, device="cpu")):
        with pytest.raises(FileNotFoundError, match="no/such/pspnet.pth"):
            make()


def test_random_init_is_seeded():
    a = build_segmentor(tiny_config(), seed=3).state_dict()
    b = build_segmentor(tiny_config(), seed=3).state_dict()
    c = build_segmentor(tiny_config(), seed=4).state_dict()
    w = "backbone.layer1.0.conv1.weight"
    assert torch.equal(a[w], b[w]) and not torch.equal(a[w], c[w])
    assert float(a["backbone.stem.1.running_var"].min()) == 1.0


class _Helper:
    def __init__(self, n, rng):
        self.collision_map = (rng.rand(n, n) > 0.995).astype(float)
        self.visited_vis = (rng.rand(n, n) > 0.99).astype(float)


@pytest.mark.parametrize("mode", [
    dict(dist_weight_temperature=-1), dict(dist_weight_temperature=0),
    dict(dist_weight_temperature=500),
    dict(dist_weight_temperature=500, dd_downscale=2, dd_order=1)])
def test_update_global_goal_matches_jax(mode):
    jcfg = small_cfg(map_size_cm=640, prediction_window=128, **mode)
    cfg = NavConfig(**dataclasses.asdict(jcfg))
    rng = np.random.RandomState(3)
    n = jcfg.map_size
    full_map = np.zeros((14, n, n), np.float32)
    full_map[0, 30:32, 10:100] = full_map[0, 60:110, 90:92] = 1.0   # walls
    full_map[0] += rng.rand(n, n) > 0.998                     # clutter
    full_map[1, 50:80, 40:75] = 1.0                            # explored
    helper = _Helper(n, rng)
    stub = StubPrediction(n)
    states = []
    for cls, kw in ((JState, {}), (NavAgentState, dict(device="cpu"))):
        st = cls(jcfg if cls is JState else cfg, prediction_model=stub, **kw)
        st.reset()
        st.full_map[:] = full_map
        st.local_map = full_map[:, st.lmb[0]:st.lmb[1],
                                st.lmb[2]:st.lmb[3]].copy()
        st.helper = helper
        st.loc_r, st.loc_c = 30, 25
        st.goal_cat = 2
        st.global_goals = [[5, 5]]
        st.update_prediction()
        st.update_global_goal()
        states.append(st)
    js, ts = states
    assert ts.global_goals == js.global_goals
    assert ts.last_global_goal == js.last_global_goal
    np.testing.assert_allclose(ts.dd_wt, js.dd_wt, rtol=0, atol=1e-5)
    np.testing.assert_allclose(ts.value, js.value, rtol=0, atol=1e-5)
    assert np.isfinite(ts.value).all() and ts.value.max() > 0
