"""Parallel-episode runner: N envs + the batched runtime (torch port of
``peanut_tpu.envs.batch_runner``).

Steps all environments in a host thread pool after each device tick;
finished episodes reset in place (their device slots are cleared) so the
batch stays full.  Throughput metric: total env steps per wall second across
the batch.  ``batch_env`` steps the envs as one vectorized
``BatchedFakeNavEnv`` instead (byte-identical observations).  The software
pipeline over half-batches (``pipeline > 1`` in the JAX package) is not
ported yet.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional

import numpy as np

from ..agent.batched_runtime import BatchedNavRuntime
from ..config import NavConfig


class BatchRunner:
    def __init__(self, cfg: NavConfig, env_fns: List[Callable],
                 runtime: Optional[BatchedNavRuntime] = None,
                 batch_env: bool = False, device=None, **runtime_kw):
        """device: the runtime's device (``resolve_device``: the card unless
        ``"cpu"``); ignored when a runtime is passed."""
        self.cfg = cfg
        self.envs = [fn() for fn in env_fns]
        self.n = len(self.envs)
        self.batched_env = None
        if batch_env:
            from .fake import BatchedFakeNavEnv

            self.batched_env = BatchedFakeNavEnv(self.envs)
        self.runtime = runtime or BatchedNavRuntime(cfg, self.n,
                                                    device=device,
                                                    **runtime_kw)
        # env stepping is host numpy: more threads than cores thrash the GIL
        self._pool = ThreadPoolExecutor(
            max_workers=min(self.n, max(2, os.cpu_count() or 1)))
        self.metrics: List[Dict] = []
        self.total_steps = 0

    def close(self) -> None:
        """Stop the env-step thread pool."""
        self._pool.shutdown(wait=True)

    def warmup_rare_paths(self):
        self.runtime.warmup_rare_paths()

    def reset_timers(self):
        self.runtime.timer.reset()

    def stage_totals(self) -> Dict[str, float]:
        """Per-stage total seconds of the runtime's StageTimer."""
        return {name: s["total_s"]
                for name, s in self.runtime.timer.summary().items()}

    def reset_all(self):
        if self.batched_env is not None:
            self.obs = self.batched_env.reset_all()
        else:
            self.obs = list(self._pool.map(lambda e: e.reset(), self.envs))
        for i in range(self.n):
            self.runtime.reset_env(i)

    # ------------------------------------------------------------------
    def _step_env(self, i: int, action: Dict) -> int:
        """Step env i, reset it in place if the episode ended; returns 1
        when an episode finished."""
        rt = self.runtime
        env = self.envs[i]
        obs = env.step(action)
        done = 0
        if env.episode_over:
            self.metrics.append(env.get_metrics())
            obs = env.reset()
            rt.reset_env(i)
            done = 1
        rt.stage_obs(obs)
        self.obs[i] = obs
        return done

    def tick(self) -> int:
        """One device tick + one env step per episode; returns the number
        of episodes that finished (and were reset in place)."""
        rt = self.runtime
        actions = rt.act_batch(self.obs)
        if self.batched_env is not None:
            done = 0

            def on_done(i):
                nonlocal done
                self.metrics.append(self.envs[i].get_metrics())
                self.batched_env.reset_one(i)
                rt.reset_env(i)
                done += 1

            with rt.timer.stage("env_phase"):
                self.obs = self.batched_env.step_all(actions,
                                                     on_done=on_done)
                for o in self.obs:
                    rt.stage_obs(o)
        else:
            with rt.timer.stage("env_phase"):
                # wall clock of the whole env-step + obs-staging phase
                done = sum(self._pool.map(
                    lambda ia: self._step_env(ia[0], ia[1]),
                    enumerate(actions)))
        self.total_steps += self.n
        return done

    def run(self, max_ticks: int, max_episodes: Optional[int] = None):
        """Run until max_ticks device ticks (or max_episodes finish)."""
        self.reset_all()
        t0 = time.perf_counter()
        episodes_done = 0
        for _ in range(max_ticks):
            episodes_done += self.tick()
            if max_episodes and episodes_done >= max_episodes:
                break
        self.wall_time = time.perf_counter() - t0
        return self.summary()

    def summary(self) -> Dict:
        out = {
            "env_steps": self.total_steps,
            "wall_time_s": round(self.wall_time, 3),
            "env_steps_per_sec": round(self.total_steps / self.wall_time, 2),
            "episodes": len(self.metrics),
        }
        if self.metrics:
            out["success"] = float(np.mean(
                [m.get("success", 0.0) for m in self.metrics]))
            out["spl"] = float(np.mean(
                [m.get("spl", 0.0) for m in self.metrics]))
            softs = [m.get("soft_spl", m.get("softspl"))
                     for m in self.metrics
                     if "soft_spl" in m or "softspl" in m]
            if softs:
                out["soft_spl"] = float(np.mean(softs))
        return out
