"""Parallel-episode runner: N envs + the batched runtime (torch port of
``peanut_tpu.envs.batch_runner``).

Steps all environments in a host thread pool after each device tick;
finished episodes reset in place (their device slots are cleared) so the
batch stays full.  Throughput metric: total env steps per wall second across
the batch.  ``batch_env`` steps the envs as one vectorized
``BatchedFakeNavEnv`` instead (byte-identical observations).

``pipeline=k`` (k > 1) splits the batch into k parts, each with its own
``BatchedNavRuntime``, and software-pipelines them: every part's tick is
dispatched before any is collected, so while one part's tick runs on the
card the host collects, plans and steps the envs of the parts before it.
Each part's runtime computes what it would compute alone at batch n/k, so
actions and episode metrics equal ``pipeline=1``'s.
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
                 pipeline: int = 1, batch_env: bool = False, device=None,
                 **runtime_kw):
        """device: the runtimes' device (``resolve_device``: the card unless
        ``"cpu"``); ignored when a runtime is passed.  runtime_kw go to each
        runtime (``prediction_model``, ``predict_chunk``, ``segmenter``,
        ``mesh``: with ``pipeline=k`` each part's runtime shards its n/k
        envs over it)."""
        self.cfg = cfg
        self.envs = [fn() for fn in env_fns]
        self.n = len(self.envs)
        self.batched_env = None
        if batch_env:
            if pipeline != 1:
                raise ValueError("batch_env does not combine with "
                                 "software pipelining")
            from .fake import BatchedFakeNavEnv

            self.batched_env = BatchedFakeNavEnv(self.envs)
        if runtime is not None and pipeline != 1:
            raise ValueError("pipeline > 1 builds its own runtimes; "
                             "pass runtime_kw instead of a runtime")
        if pipeline < 1 or self.n % pipeline:
            raise ValueError(f"{self.n} envs not divisible by "
                             f"pipeline={pipeline}")
        self.pipeline = pipeline
        self.per = self.n // pipeline
        self.runtimes = [runtime] if runtime is not None else [
            BatchedNavRuntime(cfg, self.per, device=device, **runtime_kw)
            for _ in range(pipeline)]
        self.runtime = self.runtimes[0]
        self._parts = [list(range(k * self.per, (k + 1) * self.per))
                       for k in range(pipeline)]
        # env stepping is host numpy: more threads than cores thrash the GIL
        self._pool = ThreadPoolExecutor(
            max_workers=min(self.n, max(2, os.cpu_count() or 1)))
        # the per-part tasks (and the batched env's staging) on their own
        # executor, so they cannot starve the env-step pool they submit to
        self._part_pool = ThreadPoolExecutor(max_workers=pipeline)
        self.metrics: List[Dict] = []
        self.total_steps = 0

    def close(self) -> None:
        """Stop the thread pools."""
        self._pool.shutdown(wait=True)
        self._part_pool.shutdown(wait=True)

    def warmup_rare_paths(self):
        for rt in self.runtimes:
            rt.warmup_rare_paths()

    def reset_timers(self):
        for rt in self.runtimes:
            rt.timer.reset()

    def stage_totals(self) -> Dict[str, float]:
        """Per-stage total seconds, summed over the runtimes."""
        out: Dict[str, float] = {}
        for rt in self.runtimes:
            for name, s in rt.timer.summary().items():
                out[name] = out.get(name, 0.0) + s["total_s"]
        return out

    def _runtime_of(self, i: int):
        return self.runtimes[i // self.per], i % self.per

    def reset_all(self):
        if self.batched_env is not None:
            self.obs = self.batched_env.reset_all()
        else:
            self.obs = list(self._pool.map(lambda e: e.reset(), self.envs))
        for i in range(self.n):
            rt, j = self._runtime_of(i)
            rt.reset_env(j)

    # ------------------------------------------------------------------
    def _step_env(self, i: int, action: Dict) -> int:
        """Step env i, reset it in place if the episode ended, stage its
        observation; returns 1 when an episode finished."""
        rt, j = self._runtime_of(i)
        env = self.envs[i]
        obs = env.step(action)
        done = 0
        if env.episode_over:
            self.metrics.append(env.get_metrics())
            obs = env.reset()
            rt.reset_env(j)
            done = 1
        rt.stage_obs(obs, j)
        self.obs[i] = obs
        return done

    def _step_part(self, k: int, actions: List[Dict]) -> int:
        with self.runtimes[k].timer.stage("env_phase"):
            # wall clock of the whole env-step + obs-staging phase
            return sum(self._pool.map(
                lambda ia: self._step_env(ia[0], ia[1]),
                zip(self._parts[k], actions)))

    def tick(self) -> int:
        """One device tick + one env step per episode; returns the number
        of episodes that finished (and were reset in place)."""
        if self.batched_env is not None:
            rt = self.runtime
            actions = rt.act_batch(self.obs)
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
            # the observation staging overlaps the wait for the in-flight
            # pred_async goal
            fut = self._part_pool.submit(
                lambda: list(self._pool.map(rt.stage_obs, self.obs,
                                            range(self.n))))
            rt.wait_pending_goal()
            fut.result()
        elif self.pipeline == 1:
            done = self._step_part(0, self.runtime.act_batch(self.obs))
        else:
            # enqueue every part's tick first, then collect and step each
            # part while the later ones compute
            handles = [rt.act_batch_dispatch([self.obs[i] for i in part])
                       for rt, part in zip(self.runtimes, self._parts)]
            futs = [self._part_pool.submit(self._step_part, k,
                                           rt.act_batch_collect(handles[k]))
                    for k, rt in enumerate(self.runtimes)]
            done = sum(f.result() for f in futs)
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
