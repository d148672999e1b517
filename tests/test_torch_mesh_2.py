"""The port's batched runtime sharded over a CPU mesh against itself
unsharded: every field of the ``DeviceState`` bit-equal after every tick,
with the prediction hook on (the synchronous prediction tick, on a
shard's gathered trigger subset), and the episode checkpoint across the
two layouts.

Each shard runs its rows alone (its own tick, prediction subset, replan and
magnify solves); every step of the tick is row-wise, and the tiny PSPNet's
CPU forward gives each map the same bits at the shard's batch (2) as at
the whole batch's (8), so nothing may differ.  The serving profile's goal
field (``dd_downscale=2``, first order) at a 96^2 map keeps the CPU's plain
solves, whose cost is one op sequence a shard, inside the file's time.
"""

import numpy as np
import torch

from peanut_tpu_torch.agent.batched_runtime import (BatchedNavRuntime,
                                                    DeviceState)
from peanut_tpu_torch.core.mesh import make_mesh
from peanut_tpu_torch.envs import FakeNavEnv

from test_agent_e2e import small_cfg
from test_torch_batched_pred import (SERVING, _port, _port_pm,
                                     models)  # noqa: F401

torch.set_num_threads(1)
N_ENVS = 8
SMALL = dict(map_size_cm=480, prediction_window=48, vision_range=24,
             use_gt_seg=1, **SERVING)


def _envs(cfg, ticks):
    return [FakeNavEnv(cfg, size_m=8.0, seed=100 + i, max_steps=ticks + 5)
            for i in range(N_ENVS)]


def _runtime(models, cfg, shards):
    mesh = make_mesh({"data": shards}, devices=["cpu"] * shards) \
        if shards > 1 else None
    return BatchedNavRuntime(cfg, N_ENVS, prediction_model=_port_pm(
        models, cfg), device=None if mesh else "cpu", mesh=mesh)


def _drive(rt, envs, obs, ticks):
    """Actions and the whole DeviceState after each tick."""
    acts, states = [], []
    for _ in range(ticks):
        out = rt.act_batch(obs)
        rt.wait_pending_goal()
        acts.append([a["action"] for a in out])
        states.append([x.clone() for x in rt.state])
        obs = [e.step(a) for e, a in zip(envs, out)]
    return acts, states, obs


def _start(rt, cfg, ticks):
    envs = _envs(cfg, ticks)
    obs = [e.reset() for e in envs]
    for i in range(N_ENVS):
        rt.reset_env(i)
    return envs, obs


def _assert_bit_equal(got, want):
    for t, (g, w) in enumerate(zip(got[0], want[0])):
        assert g == w, f"tick {t}: sharded actions {g} != unsharded {w}"
    for t, (g, w) in enumerate(zip(got[1], want[1])):
        for name, a, b in zip(DeviceState._fields, g, w):
            assert torch.equal(a, b), f"tick {t}: {name} differs"


def test_sharded_state_bit_equal_to_unsharded(models):
    """Synchronous prediction in the tick (the exact profile's schedule)
    with predict_chunk 1: the unsharded runtime predicts on 1 env or all
    8, each shard on 1 or its 2."""
    cfg = _port(small_cfg(**SMALL))
    ticks = 5
    runs = []
    for shards in (1, 4):
        rt = _runtime(models, cfg, shards)
        rt.predict_chunk = 1
        envs, obs = _start(rt, cfg, ticks)
        runs.append(_drive(rt, envs, obs, ticks)[:2])
    _assert_bit_equal(runs[1], runs[0])
    acts, states = runs[1]
    assert len({a for tick in acts for a in tick}) > 1
    assert bool(states[-1][6].all())           # dd_valid: every env predicted


def test_episode_checkpoint_across_layouts(models, tmp_path):
    """A sharded runtime's checkpoint equals the unsharded one's at the same
    tick, array for array; a sharded runtime resumes the unsharded one's
    and goes on as it does."""
    cfg = _port(small_cfg(**SMALL, pred_async=1))
    first, then = 3, 2
    paths, runs = {}, {}
    for shards in (1, 2):
        rt = _runtime(models, cfg, shards)
        envs, obs = _start(rt, cfg, first + then)
        acts, _, obs = _drive(rt, envs, obs, first)
        paths[shards] = str(tmp_path / f"ep{shards}.npz")
        rt.save_episode_state(paths[shards])
        runs[shards] = (acts, envs, obs, _drive(rt, envs, obs, then)[:2])
    a, b = np.load(paths[1]), np.load(paths[2])
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    # the unsharded run's checkpoint, resumed on four shards
    rt = _runtime(models, cfg, 4)
    envs, obs = _start(rt, cfg, first + then)
    for t in range(first):                   # replay the envs' episodes
        obs = [e.step({"action": x}) for e, x in zip(envs, runs[1][0][t])]
    rt.load_episode_state(paths[1])
    assert [st.local_maps.shape[0] for st in rt.shard_states] == [2] * 4
    _assert_bit_equal(_drive(rt, envs, obs, then)[:2], runs[1][3])
