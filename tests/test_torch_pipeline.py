"""The batched runtime's ``pred_async`` serving mode and the half-batch
software pipeline, on the CPU.

* The ``pred_async`` program equals the synchronous prediction tick field
  by field (the twin of tests/test_pred_async.py).
* A checkpoint the JAX runtime writes mid-episode with ``pred_async=1``,
  its prediction program in flight, resumes in the port with the same
  actions and prediction fields (the bars of
  tests/test_torch_batched_pred.py).
* ``BatchRunner(pipeline=2)`` acts as ``pipeline=1`` action for action
  (the twin of tests/test_batched_runtime.py::
  test_pipelined_runner_matches_serial).
"""

import numpy as np
import torch

from peanut_tpu.agent.batched_runtime import BatchedNavRuntime as JRuntime
from peanut_tpu.envs import FakeNavEnv as JEnv
from peanut_tpu_torch.agent.batched_runtime import (BatchedNavRuntime,
                                                    DeviceState)
from peanut_tpu_torch.envs import FakeNavEnv
from peanut_tpu_torch.envs.batch_runner import BatchRunner

from test_agent_e2e import small_cfg
from test_torch_batched_pred import (GEOMETRY, SEEDS, SERVING, TICKS,
                                     _assert_same, _drive, _jax_pm, _port,
                                     _port_pm, _start, models)  # noqa: F401

torch.set_num_threads(1)


def _copy(state):
    return DeviceState(*(x.clone() for x in state))


def test_async_program_equals_sync_tick(models):
    """The synchronous prediction tick equals the tick without prediction
    followed by the ``pred_async`` program, field by field, on a
    mid-episode state; the program changes only the prediction fields and
    returns the device goal."""
    cfg = _port(small_cfg(**GEOMETRY))
    n = len(SEEDS)
    rt = BatchedNavRuntime(cfg, n, prediction_model=_port_pm(models, cfg),
                           device="cpu")
    envs, obs = _start(rt, FakeNavEnv, cfg)
    _drive(rt, envs, obs, 6)

    hp = np.zeros((n, rt.PACK), np.float32)
    lmb = np.stack([s.lmb for s in rt.slots])
    hp[:, 3:7] = lmb
    hp[:, 7:11] = lmb
    hp[:, 11] = [0, 3]                       # goal categories
    hp[:, 14] = 1.0                          # both envs trigger
    hp[:, 19:21] = rt.Hl // 2                # planner start cells
    hp[:, 21:23] = rt.Hl // 2 + 3            # agent cell (value solve)
    rng = np.random.RandomState(0)
    sem = torch.as_tensor((rng.rand(n, cfg.num_sem_categories,
                                    cfg.frame_height, cfg.frame_width)
                           > 0.97).astype(np.uint8))
    depth = torch.as_tensor(rng.uniform(
        60, 300, (n, cfg.frame_height, cfg.frame_width)).astype(np.float32))
    hp = torch.as_tensor(hp)
    idxs = torch.arange(n)
    s0 = rt.state
    sync, _ = rt._tick(_copy(s0), sem, depth, hp, idxs, n)
    mid, _ = rt._tick(_copy(s0), sem, depth, hp, idxs, 0)
    mid_np = {k: v.clone() for k, v in mid._asdict().items()}
    after, goal = rt._pred_program(mid, hp, idxs, n)
    for k in DeviceState._fields:
        assert torch.equal(getattr(sync, k), getattr(after, k)), k
        if k not in ("target_pred", "dd_wt", "dd_valid", "cur_goal",
                     "last_goal", "last_goal_valid"):
            assert getattr(after, k) is getattr(mid, k), k
    # the program leaves its input state as it was
    for k, v in mid_np.items():
        assert torch.equal(getattr(mid, k), v), k
    assert torch.equal(goal, after.cur_goal)
    assert not torch.equal(after.cur_goal, s0.cur_goal)


HANDOVER = 5


def test_resume_from_jax_async_checkpoint(models, tmp_path):
    """The JAX runtime with ``pred_async=1`` checkpoints mid-episode right
    after a trigger tick, with its prediction program in flight (the save
    lands its goal); the port loads the file and continues with the same
    actions and prediction fields."""
    jcfg = small_cfg(**GEOMETRY, **SERVING, pred_async=1)
    cfg = _port(jcfg)
    jrt = JRuntime(jcfg, len(SEEDS), prediction_model=_jax_pm(models, jcfg))
    envs, obs = _start(jrt, JEnv, jcfg)
    a1, _, obs = _drive(jrt, envs, obs, HANDOVER)
    assert jrt._pending_goal is not None     # a goal is in flight
    ckpt = str(tmp_path / "episodes.npz")
    jrt.save_episode_state(ckpt)
    want = _drive(jrt, envs, obs, TICKS - HANDOVER)[:2]

    rt = BatchedNavRuntime(cfg, len(SEEDS),
                           prediction_model=_port_pm(models, cfg),
                           device="cpu")
    penvs, pobs = _start(rt, FakeNavEnv, cfg)
    for t in range(HANDOVER):                # replay the envs' episodes
        pobs = [e.step({"action": a}) for e, a in zip(penvs, a1[t])]
    rt.load_episode_state(ckpt)
    got = _drive(rt, penvs, pobs, TICKS - HANDOVER)[:2]
    _assert_same(got, want, first_tick=HANDOVER)


class _LoggedEnv(FakeNavEnv):
    """A FakeNavEnv that records the actions it is given."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.actions = []

    def step(self, action):
        self.actions.append(int(action["action"]))
        return super().step(action)


def test_pipelined_runner_matches_serial(models):
    """pipeline=2 (two runtimes, every part's tick dispatched before any is
    collected) gives each env the same actions as pipeline=1, through
    episode resets, with the prediction hook on."""
    cfg = _port(small_cfg(**GEOMETRY))
    logs = []
    for pipeline in (1, 2):
        envs = []

        def make(s):
            envs.append(_LoggedEnv(cfg, size_m=8.0, seed=s, max_steps=5))
            return envs[-1]

        runner = BatchRunner(cfg, [lambda s=s: make(s) for s in (3, 11)],
                             pipeline=pipeline, device="cpu",
                             prediction_model=_port_pm(models, cfg))
        out = runner.run(max_ticks=7)
        runner.close()
        assert len(runner.runtimes) == pipeline
        assert out["env_steps"] == 14 and out["episodes"] == 2
        logs.append(([e.actions for e in envs], sorted(
            (m["success"], m["spl"]) for m in runner.metrics)))
    assert logs[0] == logs[1]
