"""Host-side habitat adapter (port of ``peanut_tpu.envs.habitat_adapter``).

The simulator stays host C++; this adapter reproduces PEANUT's
entry-point environment setup (nav/collect.py:22-32) and exposes the
reset / step / episode_over / get_metrics surface of ``FakeNavEnv``, so
every runtime component is env-agnostic.  ``habitat`` is imported when an
adapter is built (it exists only inside the habitat image): the module
imports without it, and building one outside the image raises
ImportError.
"""

from __future__ import annotations

import os
from typing import Dict


class HabitatEnvAdapter:
    def __init__(self, cfg, split: str = "val", seed: int = 100,
                 max_scene_repeat_episodes: int = 1):
        import habitat
        from habitat.core.env import Env

        config = habitat.get_config(os.environ["CHALLENGE_CONFIG_FILE"])
        config.defrost()
        config.SEED = seed
        config.ENVIRONMENT.ITERATOR_OPTIONS.MAX_SCENE_REPEAT_STEPS = -1
        config.ENVIRONMENT.ITERATOR_OPTIONS.MAX_SCENE_REPEAT_EPISODES = \
            max_scene_repeat_episodes
        config.DATASET.SPLIT = split
        config.freeze()
        self.config = config
        self._env = Env(config=config)

    @property
    def episodes(self):
        return self._env.episodes

    @property
    def current_episode(self):
        return self._env._current_episode

    @property
    def episode_over(self) -> bool:
        return self._env.episode_over

    def reset(self) -> Dict:
        return self._env.reset()

    def step(self, action) -> Dict:
        if isinstance(action, dict):
            action = action["action"]
        return self._env.step(action)

    def get_metrics(self) -> Dict:
        return self._env.get_metrics()
