"""The port's single-env agent against the JAX package's, on the CPU.

Both agents drive FakeNavEnvs that emit the same bytes
(tests/test_torch_package.py) from the same seed, in two configurations:

* ``explore``: map collection's (GT semantics, ``only_explore=1``,
  ``switch_step=999``, ``global_downscaling=4``; cli/collect_maps.py:35);
* ``predict``: ``only_explore=0``, goal weighting every
  ``update_goal_freq`` steps (``goal_reached_dist=0`` keeps it from running
  every step near the goal, which would only repeat it), both agents given
  the same numpy stub prediction model, so that the conv rounding of a real
  net cannot flip an argmax.

Tolerances: the action sequences are equal (no tolerance); the full and
local maps lie within 1e-4 of JAX's, the exact mapper's bound of
tests/test_torch_mapping.py (F.grid_sample rounds its weights differently).
The Mask R-CNN segmenter's host call equals its device path bit for bit.
"""

import dataclasses

import numpy as np
import pytest
import torch

from peanut_tpu.agent import PeanutAgent as JAgent
from peanut_tpu.envs import FakeNavEnv as JEnv
from peanut_tpu_torch.agent import PeanutAgent
from peanut_tpu_torch.config import NavConfig
from peanut_tpu_torch.envs import FakeNavEnv

from test_agent_e2e import small_cfg
from test_torch_seg import Synth, _cfg as seg_cfg, _frames, _port

torch.set_num_threads(1)


class StubPrediction:
    """Fixed per-category probabilities, masked to unexplored cells: the
    same numpy function of the map for both agents."""

    def __init__(self, n):
        self.p = np.random.RandomState(7).rand(6, n, n).astype(np.float32)

    def get_prediction(self, full_map):
        return self.p * (1.0 - full_map[1])


# name -> (config, steps, env size in metres, env seed)
CONFIGS = {
    "explore": (small_cfg(only_explore=1, switch_step=999,
                          global_downscaling=4, map_size_cm=960,
                          vision_range=24), 20, 8.0, 5),
    "predict": (small_cfg(map_size_cm=640, prediction_window=128,
                          vision_range=32, goal_reached_dist=0), 16, 8.0, 5),
}


def _rollout(agent, env):
    obs = env.reset()
    agent.reset()
    actions = []
    while not env.episode_over:
        actions.append(agent.act(obs)["action"])
        obs = env.step(actions[-1])
    st = agent.agent_state
    return actions, st.full_map.copy(), st.local_map.copy()


@pytest.fixture(scope="module", params=list(CONFIGS))
def rollouts(request):
    """(JAX rollout, port rollout) of one configuration."""
    jcfg, steps, size_m, seed = CONFIGS[request.param]
    tcfg = NavConfig(**dataclasses.asdict(jcfg))
    kw = {}
    if not jcfg.only_explore:
        kw["prediction_model"] = StubPrediction(jcfg.map_size)
    want = _rollout(JAgent(jcfg, **kw),
                    JEnv(jcfg, size_m=size_m, seed=seed, max_steps=steps))
    got = _rollout(PeanutAgent(tcfg, device="cpu", **kw),
                   FakeNavEnv(tcfg, size_m=size_m, seed=seed,
                              max_steps=steps))
    return want, got


def test_actions_equal_jax(rollouts):
    (want, _, _), (got, _, _) = rollouts
    assert got == want
    assert len(set(got)) > 1


def test_maps_within_mapper_bound(rollouts):
    (_, jfull, jlocal), (_, full, local) = rollouts
    assert full.dtype == np.float32 and full.shape == jfull.shape
    np.testing.assert_allclose(full, jfull, rtol=0, atol=1e-4)
    np.testing.assert_allclose(local, jlocal, rtol=0, atol=1e-4)
    assert full[1].sum() > 0                   # exploration was mapped


def test_segmenter_host_call_equals_device_path():
    """``__call__`` (full env resolution, host array) subsampled as the
    agent subsamples it equals ``batch_device`` (strided pixel centres),
    bit for bit; ``batch`` equals ``__call__`` frame by frame."""
    cfg = seg_cfg(env_frame_width=128, env_frame_height=96)
    rgbs, cats = _frames(cfg)
    seg = Synth(_port(cfg))
    ds = cfg.env_frame_width // cfg.frame_width
    want = seg.batch_device(rgbs[:1], cats[:1])[0].numpy()
    got = seg(rgbs[0], goal_cat=cats[0])
    assert got.shape == (cfg.env_frame_height, cfg.env_frame_width,
                         cfg.num_sem_categories)
    assert got.dtype == np.float32 and got[..., :9].sum() > 0
    np.testing.assert_array_equal(
        got[ds // 2::ds, ds // 2::ds].transpose(2, 0, 1), want)
    for a, b in zip(seg.batch(list(rgbs), cats),
                    [seg(r, goal_cat=c) for r, c in zip(rgbs, cats)]):
        np.testing.assert_array_equal(a, b)


def test_visualize_raises_naming_its_roadmap_item(tmp_path):
    """visualize=2 was ROADMAP A11's and raised; ported, an episode dumps
    one dashboard frame a step (tests/test_torch_env_and_vis.py holds the
    frames against the JAX package's)."""
    import glob

    cfg = NavConfig(**dataclasses.asdict(small_cfg(
        visualize=2, only_explore=1, switch_step=999,
        dump_location=str(tmp_path))))
    agent = PeanutAgent(cfg, device="cpu")
    env = FakeNavEnv(cfg, seed=0, max_steps=3)
    obs = env.reset()
    agent.reset()
    while not env.episode_over:
        obs = env.step(agent.act(obs)["action"])
    frames = glob.glob(str(tmp_path / "dump" / "**" / "*.jpg"),
                       recursive=True)
    assert len(frames) == 3
