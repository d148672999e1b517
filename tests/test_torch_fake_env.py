"""``FakeNavEnv.reset`` with its placement loop bounded (ROADMAP fault C5).

* Where no free cell lies ``goal_min_dist`` (3 m) from the start, as in
  a 6 m square (the geometry of tests/test_batched_runtime.py::
  test_mesh_sharded_runtime_matches_unsharded), the reset raises
  RuntimeError naming the size, the seed and goal_min_dist, within a
  second; the JAX package's reset loops forever there.
* Wherever the JAX package's reset returns, the port's draws the same
  candidates: objects, goal and pose bit for bit, 50 seeds at each of
  8, 12 and 14 m, and at 6.5 m, whose goal region is four thin corners
  (the most draws a reset took, 843, over seeds 0-299).
"""

import time

import numpy as np
import pytest

from peanut_tpu.config import NavConfig as JNavConfig
from peanut_tpu.envs import FakeNavEnv as JEnv
from peanut_tpu_torch.config import NavConfig
from peanut_tpu_torch.envs import FakeNavEnv

GEOMETRY = dict(map_size_cm=640, prediction_window=64, vision_range=24)


@pytest.mark.parametrize("seed", range(100, 108))
def test_reset_without_a_goal_cell_raises(seed):
    env = FakeNavEnv(NavConfig(**GEOMETRY), size_m=6.0, seed=seed)
    t0 = time.perf_counter()
    with pytest.raises(RuntimeError) as e:
        env.reset()
    assert time.perf_counter() - t0 < 1.0
    msg = str(e.value)
    assert "size 6.0 m" in msg and f"seed {seed}" in msg
    assert "goal_min_dist 3.0 m" in msg
    assert f"{FakeNavEnv.MAX_DRAWS} candidate draws" in msg


@pytest.mark.parametrize("size_m", [6.5, 8.0, 12.0, 14.0])
def test_reset_equals_reference_wherever_it_returns(size_m):
    for seed in range(50):
        mine = FakeNavEnv(NavConfig(**GEOMETRY), size_m=size_m, seed=seed)
        ref = JEnv(JNavConfig(**GEOMETRY), size_m=size_m, seed=seed)
        obs, want = mine.reset(), ref.reset()
        assert mine.objects == ref.objects, (size_m, seed)
        assert mine.goal_id == ref.goal_id
        assert np.array_equal(mine.goal_pos, ref.goal_pos)
        assert np.array_equal(mine.pose, ref.pose)
        assert mine.start_goal_dist == ref.start_goal_dist
        for k in ("rgb", "depth", "gps", "compass", "objectgoal"):
            assert np.array_equal(obs[k], want[k]), (size_m, seed, k)
        # the stream after the reset is the reference's too
        assert np.array_equal(mine.rng.rand(4), ref.rng.rand(4))
