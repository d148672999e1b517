"""The device mesh and the batched runtime sharded over its data axis, on
the CPU.

* ``make_mesh`` against the JAX package's on the 8 virtual CPU devices of
  tests/conftest.py: the shapes, the -1 axis, the error; ``axis_devices``
  on a mesh that splits a second axis over several devices reads the
  axis at index 0 of the other (the JAX runtime replicates over it).
* The port's ``BatchedNavRuntime`` sharded over
  ``make_mesh({"data": 4}, devices=["cpu"] * 4)`` against the JAX
  runtime unsharded, on the geometry of tests/test_batched_runtime.py::
  test_mesh_sharded_runtime_matches_unsharded (8 envs, 128^2 maps, the
  64^2 prediction crop) with prediction on, in the serving profile
  (``pred_async``, the OR-pooled first-order goal field): actions equal
  tick for tick, ``cur_goal`` exactly, ``target_pred`` within 1e-4 and
  ``dd_wt`` within 1e-5 (the bars of tests/test_torch_batched_pred.py:
  the frameworks' CPU convolutions sum in other orders).  The envs are
  8 m squares, not that test's 6 m: at 6 m FakeNavEnv(seed=100 + i)
  finds no goal 3 m from the start, so the port's reset raises and the
  JAX package's never returns (tests/test_torch_fake_env.py).
"""

import numpy as np
import pytest
import torch

import jax
from peanut_tpu.agent.batched_runtime import BatchedNavRuntime as JRuntime
from peanut_tpu.core import mesh as jmesh
from peanut_tpu.envs import FakeNavEnv as JEnv
from peanut_tpu_torch.agent.batched_runtime import BatchedNavRuntime
from peanut_tpu_torch.core import mesh
from peanut_tpu_torch.envs import FakeNavEnv

from test_agent_e2e import small_cfg
from test_torch_batched_pred import (SERVING, _assert_same, _jax_pm, _port,
                                     _port_pm, models)  # noqa: F401

torch.set_num_threads(1)
N_ENVS = 8
TICKS = 5
MESH_GEOMETRY = dict(map_size_cm=640, prediction_window=64, vision_range=24,
                     use_gt_seg=1)


@pytest.mark.parametrize("axes", [None, {"data": 8}, {"data": -1},
                                  {"data": 4, "spatial": 2},
                                  {"data": -1, "spatial": 2},
                                  {"data": 2, "model": -1}])
def test_make_mesh_matches_jax(axes):
    jm = jmesh.make_mesh(axes)
    m = mesh.make_mesh(axes, devices=["cpu"] * len(jax.devices()))
    assert m.shape == dict(jm.shape)
    assert m.axis_names == tuple(jm.axis_names)
    assert m.devices.shape == jm.devices.shape
    assert m.size == jm.devices.size
    assert all(d == torch.device("cpu") for d in m.devices.flat)


def test_make_mesh_errors():
    with pytest.raises(ValueError, match="need 6 devices, have 8") as e:
        jmesh.make_mesh({"data": 3, "spatial": 2})
    with pytest.raises(ValueError, match=str(e.value)):
        mesh.make_mesh({"data": 3, "spatial": 2}, devices=["cpu"] * 8)
    two = mesh.make_mesh({"data": 2, "spatial": 2},
                         devices=["cpu", "cpu", "meta", "meta"])
    assert mesh.axis_devices(two, "data") == [torch.device("cpu"),
                                              torch.device("meta")]
    assert mesh.axis_devices(two, "spatial") == [torch.device("cpu")] * 2
    assert mesh.axis_devices(two, "spatial", {"data": 1}) == \
        [torch.device("meta")] * 2
    assert mesh.axis_devices(mesh.make_mesh({"data": 4, "spatial": 1},
                                            devices=["cpu"] * 4)) == \
        [torch.device("cpu")] * 4


def test_row_helpers():
    x = torch.arange(24.0).reshape(8, 3)
    chunks = mesh.split_rows(x, [torch.device("cpu")] * 4)
    assert [c.shape[0] for c in chunks] == [2] * 4
    assert torch.equal(mesh.concat_rows(chunks), x)
    with pytest.raises(ValueError, match="not divisible"):
        mesh.split_rows(x, [torch.device("cpu")] * 3)
    module = torch.nn.Linear(2, 2)
    assert mesh.replicate(module, ["cpu", "cpu"]) == \
        {torch.device("cpu"): module}
    assert mesh.rank() == 0 and mesh.world() == 1


def test_runtime_refuses_an_undivided_batch(models):
    cfg = _port(small_cfg(**MESH_GEOMETRY))
    with pytest.raises(ValueError, match="not divisible by mesh axis"):
        BatchedNavRuntime(cfg, 6, prediction_model=_port_pm(models, cfg),
                          mesh=mesh.make_mesh({"data": 4},
                                              devices=["cpu"] * 4))


def _fields(rt):
    return {k: np.asarray(getattr(rt.state, k))
            for k in ("cur_goal", "target_pred", "dd_wt")}


def _rollout(rt, env_cls, cfg):
    envs = [env_cls(cfg, size_m=8.0, seed=100 + i, max_steps=TICKS + 5)
            for i in range(N_ENVS)]
    obs = [e.reset() for e in envs]
    for i in range(N_ENVS):
        rt.reset_env(i)
    acts, fields = [], []
    for _ in range(TICKS):
        out = rt.act_batch(obs)
        rt.wait_pending_goal()
        acts.append([a["action"] for a in out])
        fields.append(_fields(rt))
        obs = [e.step(a) for e, a in zip(envs, out)]
    return acts, fields


def test_sharded_runtime_matches_jax(models):
    """Four shards of two envs on the CPU act as the JAX runtime's one
    batch of eight, prediction on in every tick that triggers."""
    jcfg = small_cfg(**MESH_GEOMETRY, **SERVING, pred_async=1)
    want = _rollout(JRuntime(jcfg, N_ENVS,
                             prediction_model=_jax_pm(models, jcfg)),
                    JEnv, jcfg)
    cfg = _port(jcfg)
    rt = BatchedNavRuntime(cfg, N_ENVS, prediction_model=_port_pm(models,
                                                                  cfg),
                           mesh=mesh.make_mesh({"data": 4},
                                               devices=["cpu"] * 4))
    assert len(rt.shards) == 4 and rt.m == 2
    got = _rollout(rt, FakeNavEnv, cfg)
    _assert_same(got, want)
    acts, fields = got
    assert len({a for tick in acts for a in tick}) > 1
    assert fields[-1]["dd_wt"].max() > 0
    assert fields[-1]["target_pred"].max() > 0
