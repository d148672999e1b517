"""The slice as a whole: the port's BatchedNavRuntime against the JAX
package's, on the CPU, in the explore-only ground-truth-semantics
configuration (map collection's), on the same FakeNavEnv seeds.

The action sequences must be equal — no tolerance: every step of the tick
is bit-equal to the JAX CPU path or rounds to the same decision (see
tests/test_torch_fmm.py and tests/test_torch_mapping.py).  A checkpoint the
JAX runtime writes mid-episode must resume in the port with the same
actions.
"""

import dataclasses

import numpy as np
import pytest
import torch

from peanut_tpu.agent.batched_runtime import BatchedNavRuntime as JRuntime
from peanut_tpu.envs import FakeNavEnv as JEnv
from peanut_tpu_torch.agent.batched_runtime import (BatchedNavRuntime,
                                                    DeviceState)
from peanut_tpu_torch.config import NavConfig
from peanut_tpu_torch.envs import FakeNavEnv

from test_agent_e2e import small_cfg

torch.set_num_threads(1)
SEEDS = (3, 11)
TICKS = 12
HANDOVER = 8        # the JAX run checkpoints after this many ticks


def _envs(cls, cfg):
    return [cls(cfg, size_m=12.0, seed=s, max_steps=TICKS + 5)
            for s in SEEDS]


def _drive(rt, envs, obs, ticks):
    acts, wins, replans = [], [], []
    for _ in range(ticks):
        before = len(rt.timer.samples.get("replan", []))
        out = rt.act_batch(obs)
        acts.append([a["action"] for a in out])
        wins.append(np.array(rt.last_windows))
        replans.append(len(rt.timer.samples.get("replan", [])) > before)
        obs = [envs[i].step(out[i]) for i in range(len(envs))]
    return acts, wins, replans, obs


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    cfg = small_cfg(only_explore=1, switch_step=999, use_gt_seg=1)
    rt = JRuntime(cfg, len(SEEDS))
    envs = _envs(JEnv, cfg)
    obs = [e.reset() for e in envs]
    for i in range(len(SEEDS)):
        rt.reset_env(i)
    a1, w1, r1, obs = _drive(rt, envs, obs, HANDOVER)
    ckpt = str(tmp_path_factory.mktemp("handover") / "episodes.npz")
    rt.save_episode_state(ckpt)
    a2, w2, r2, _ = _drive(rt, envs, obs, TICKS - HANDOVER)
    return dict(cfg=cfg, actions=a1 + a2, windows=w1 + w2, replans=r1 + r2,
                ckpt=ckpt)


def _port(cfg):
    return NavConfig(**dataclasses.asdict(cfg))


def _assert_same(got, want, got_w, want_w, first_tick=0):
    for t, (g, w) in enumerate(zip(got, want)):
        assert g == w, (
            f"tick {first_tick + t}: port actions {g} != JAX {w}\n"
            f"port 11x11 windows:\n{got_w[t]}\nJAX windows:\n{want_w[t]}")


def test_actions_equal_jax_from_scratch(jax_run):
    cfg = _port(jax_run["cfg"])
    rt = BatchedNavRuntime(cfg, len(SEEDS), device="cpu")
    envs = _envs(FakeNavEnv, cfg)
    obs = [e.reset() for e in envs]
    for i in range(len(SEEDS)):
        rt.reset_env(i)
    acts, wins, replans, _ = _drive(rt, envs, obs, TICKS)
    _assert_same(acts, jax_run["actions"], wins, jax_run["windows"])
    # the planning windows are bit-equal, replans included
    for t in range(TICKS):
        np.testing.assert_array_equal(wins[t], jax_run["windows"][t])
    assert replans == jax_run["replans"]
    assert len({a for tick in acts for a in tick}) > 1   # not a trivial run


def test_resume_from_jax_checkpoint(jax_run, tmp_path):
    """JAX saves after HANDOVER ticks; the port loads that .npz (maps on its
    device) and continues with the same actions; its own checkpoint has
    the JAX file's layout."""
    cfg = _port(jax_run["cfg"])
    envs = _envs(FakeNavEnv, cfg)
    obs = [e.reset() for e in envs]
    for t in range(HANDOVER):                 # replay the envs' episodes
        obs = [envs[i].step({"action": jax_run["actions"][t][i]})
               for i in range(len(SEEDS))]
    rt = BatchedNavRuntime(cfg, len(SEEDS), device="cpu")
    rt.load_episode_state(jax_run["ckpt"])
    assert isinstance(rt.state, DeviceState)
    assert all(x.device.type == "cpu" for x in rt.state)

    # the replan solve (eroded obstacles), which these seeds never reach in
    # TICKS ticks, on the checkpointed maps: bit-equal windows
    jrt = JRuntime(jax_run["cfg"], len(SEEDS))
    jrt.load_episode_state(jax_run["ckpt"])
    n = len(SEEDS)
    lmb = np.stack([s.lmb for s in rt.slots])
    starts, _ = rt._planner_cells(lmb)
    flags = np.array([True, False])[:n]
    cats = np.array([0, 4])[:n]
    no = np.zeros(n, bool)
    want = np.asarray(jrt._replan_program(
        jrt.state, lmb, starts[:, 0], starts[:, 1], flags, cats, no, no, no))
    got = rt._replan_program(
        rt.state, rt._t(lmb).long(), rt._t(starts[:, 0]).long(),
        rt._t(starts[:, 1]).long(), rt._t(flags), rt._t(cats).long(),
        rt._t(no), rt._t(no), rt._t(no)).numpy()
    np.testing.assert_array_equal(got, want)
    acts, wins, _, _ = _drive(rt, envs, obs, TICKS - HANDOVER)
    _assert_same(acts, jax_run["actions"][HANDOVER:], wins,
                 jax_run["windows"][HANDOVER:], first_tick=HANDOVER)

    mine = str(tmp_path / "port.npz")
    rt.save_episode_state(mine)
    with np.load(mine) as a, np.load(jax_run["ckpt"]) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            # (the JSON string of the host slots differs in length only)
            assert a[k].dtype.kind == b[k].dtype.kind, k
            assert a[k].shape == b[k].shape, k
            if a[k].dtype.kind != "U":
                assert a[k].dtype == b[k].dtype, k
