"""The batched runtime's prediction hook (``only_explore=0``) against the JAX
package's, on the CPU: the exact and the serving profiles of
``bench.py::bench_env_steps``, the ``dist_weight_temperature`` modes, the
``pred_async`` serving mode.

Both runtimes run the same PSPNet: the JAX ``tiny_prediction_model`` of
tests/test_agent_e2e.py (base width 16, random weights), carried into the
port through ``flax_to_mmseg_state`` (key for key and bit for bit
``export_encoder_decoder_to_torch``'s, tests/test_torch_prediction.py).
Both are fed the same FakeNavEnv seeds.  Bars: actions equal tick for tick
and ``cur_goal`` exactly; ``target_pred`` within 1e-4 (the two frameworks'
CPU convolutions sum in other orders) and ``dd_wt`` within 1e-5 (the
geodesic fields are bit-equal; XLA's CPU exp is not correctly rounded),
the bars of tests/test_torch_prediction.py.  The ``pred_async`` program,
the checkpoint handover and the half-batch pipeline are in
tests/test_torch_pipeline.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from peanut_tpu.agent.batched_runtime import BatchedNavRuntime as JRuntime
from peanut_tpu.envs import FakeNavEnv as JEnv
from peanut_tpu_torch.agent.batched_runtime import BatchedNavRuntime
from peanut_tpu_torch.config import NavConfig
from peanut_tpu_torch.envs import FakeNavEnv
from peanut_tpu_torch.models.mmseg_import import (flax_to_mmseg_state,
                                                  load_mmseg_state)
from peanut_tpu_torch.models.pspnet import build_segmentor
from peanut_tpu_torch.prediction import PredictionModel

from test_agent_e2e import small_cfg, tiny_prediction_model

torch.set_num_threads(1)
SEEDS = (3, 11)
TICKS = 10
# the prediction geometry of tests/test_torch_agent.py: 128^2 full maps,
# the whole map as the prediction crop, 64^2 local windows; triggers every
# update_goal_freq (5) steps, not at every step near the goal
GEOMETRY = dict(map_size_cm=640, prediction_window=128, vision_range=32,
                use_gt_seg=1, goal_reached_dist=0)
SERVING = dict(dd_downscale=2, dd_order=1, dd_block=8, dd_inner=24,
               plan_block=8, plan_inner=24)


@pytest.fixture(scope="module")
def models():
    """The JAX tiny PSPNet and its variables, shared by every config (the
    network does not depend on the fields these tests vary)."""
    jpm = tiny_prediction_model(small_cfg(**GEOMETRY))
    return jpm.model_cfg, jpm.variables


def _jax_pm(models, jcfg):
    from peanut_tpu.prediction import PredictionModel as JPrediction

    model_cfg, variables = models
    return JPrediction(jcfg, variables=variables, model_cfg=model_cfg)


def _port_pm(models, cfg):
    model_cfg, variables = models
    model = load_mmseg_state(build_segmentor(model_cfg),
                             flax_to_mmseg_state(variables))
    return PredictionModel(cfg, model=model, device="cpu")


def _port(jcfg):
    return NavConfig(**dataclasses.asdict(jcfg))


def _start(rt, cls, cfg):
    envs = [cls(cfg, size_m=8.0, seed=s, max_steps=TICKS + 8) for s in SEEDS]
    obs = [e.reset() for e in envs]
    for i in range(len(SEEDS)):
        rt.reset_env(i)
    return envs, obs


def _fields(rt):
    return {k: np.asarray(getattr(rt.state, k))
            for k in ("cur_goal", "target_pred", "dd_wt")}


def _drive(rt, envs, obs, ticks):
    """Actions and the prediction fields after each tick."""
    acts, fields = [], []
    for _ in range(ticks):
        out = rt.act_batch(obs)
        acts.append([a["action"] for a in out])
        fields.append(_fields(rt))
        obs = [e.step(a) for e, a in zip(envs, out)]
    return acts, fields, obs


def _assert_same(got, want, first_tick=0, dd_rtol=0.0):
    g_acts, g_fields = got
    w_acts, w_fields = want
    for t, (g, w) in enumerate(zip(g_acts, w_acts)):
        tick = first_tick + t
        assert g == w, f"tick {tick}: port actions {g} != JAX {w}"
        gf, wf = g_fields[t], w_fields[t]
        np.testing.assert_array_equal(gf["cur_goal"], wf["cur_goal"],
                                      err_msg=f"cur_goal, tick {tick}")
        np.testing.assert_allclose(gf["target_pred"], wf["target_pred"],
                                   rtol=0, atol=1e-4,
                                   err_msg=f"target_pred, tick {tick}")
        np.testing.assert_allclose(gf["dd_wt"], wf["dd_wt"], rtol=dd_rtol,
                                   atol=1e-5, err_msg=f"dd_wt, tick {tick}")


def _both(models, jcfg, ticks):
    cfg = _port(jcfg)
    runs = []
    for rt_cls, env_cls, pm, c in (
            (JRuntime, JEnv, _jax_pm(models, jcfg), jcfg),
            (BatchedNavRuntime, FakeNavEnv, _port_pm(models, cfg), cfg)):
        kw = {} if rt_cls is JRuntime else dict(device="cpu")
        rt = rt_cls(c, len(SEEDS), prediction_model=pm, **kw)
        envs, obs = _start(rt, env_cls, c)
        acts, fields, _ = _drive(rt, envs, obs, ticks)
        runs.append((acts, fields))
    return runs


@pytest.mark.parametrize("profile", ["exact", "serving"])
def test_profiles_match_jax(models, profile):
    """bench.py's exact profile (synchronous prediction in the tick, the
    order-2 goal field at full resolution) and its serving profile (the
    OR-pooled first-order field, 8-row tiling, ``pred_async``)."""
    kw = dict(GEOMETRY)
    if profile == "serving":
        kw.update(SERVING, pred_async=1)
    want, got = _both(models, small_cfg(**kw),
                      ticks=TICKS if profile == "serving" else 8)
    _assert_same(got, want)
    acts, fields = got
    assert len({a for tick in acts for a in tick}) > 1
    # prediction ran: the goal moved off its reset cell and dd_wt is set
    assert fields[-1]["dd_wt"].max() > 0
    assert fields[-1]["target_pred"].max() > 0


@pytest.mark.parametrize("mode", [
    dict(dist_weight_temperature=-1), dict(dist_weight_temperature=0),
    dict(dist_weight_temperature=0, dd_downscale=2)])
def test_temperature_modes_match_jax(models, mode):
    """-1: no distance weighting; 0: frontier exploration, which also
    forces the full-resolution order-2 field (the dd_downscale guard).
    At T = -1, dd_wt = exp(dd / 0.2) grows to ~1e37 (unused: the goal is
    the prediction's argmax), so it is held to 1e-5 relative as well."""
    want, got = _both(models, small_cfg(**GEOMETRY, **mode), ticks=5)
    _assert_same(got, want, dd_rtol=1e-5)
