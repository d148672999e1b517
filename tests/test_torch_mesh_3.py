"""The runner over a sharded runtime, on the CPU.

* ``BatchRunner(pipeline=2)`` with each part's runtime sharded over a CPU
  mesh (``runtime_kw`` carries the mesh) acts as ``pipeline=1``
  unsharded, env for env, through episode resets, with the prediction
  hook on in the serving profile (the twin of tests/test_torch_pipeline.py
  ::test_pipelined_runner_matches_serial).
* The Mask R-CNN serving path (``use_gt_seg=0``, tests/test_torch_seg.py's
  synthetic detect head) sharded over two shards of one device: the
  detect groups are the unsharded runtime's (a device's envs in fixed
  groups of ``seg_batch_chunk``, launched as each group has stepped), so
  actions and maps are equal bit for bit.
"""

import torch

from peanut_tpu_torch.core.mesh import make_mesh
from peanut_tpu_torch.envs import FakeNavEnv
from peanut_tpu_torch.envs.batch_runner import BatchRunner

from test_agent_e2e import small_cfg
from test_torch_batched_pred import (SERVING, _port, _port_pm,
                                     models)  # noqa: F401
from test_torch_pipeline import _LoggedEnv
from test_torch_seg import Synth, _cfg, _envs, _roll

torch.set_num_threads(1)


def test_pipelined_sharded_runner_matches_serial(models):
    cfg = _port(small_cfg(map_size_cm=480, prediction_window=48,
                          vision_range=24, use_gt_seg=1, pred_async=1,
                          **SERVING))
    logs = []
    for pipeline, mesh in ((1, None), (2, make_mesh(
            {"data": 2}, devices=["cpu"] * 2))):
        envs = []

        def make(s):
            envs.append(_LoggedEnv(cfg, size_m=8.0, seed=s, max_steps=4))
            return envs[-1]

        runner = BatchRunner(cfg, [lambda s=s: make(s) for s in range(4)],
                             pipeline=pipeline, device="cpu" if mesh is None
                             else None, mesh=mesh,
                             prediction_model=_port_pm(models, cfg))
        out = runner.run(max_ticks=6)
        runner.close()
        assert len(runner.runtimes) == pipeline
        if mesh is not None:
            assert all(len(rt.shards) == 2 and rt.m == 1
                       for rt in runner.runtimes)
        assert out["env_steps"] == 24 and out["episodes"] == 4
        logs.append(([e.actions for e in envs], sorted(
            (m["success"], m["spl"]) for m in runner.metrics)))
    assert logs[0] == logs[1]


def test_sharded_detect_path_equals_unsharded():
    cfg = _port(_cfg())
    runs = []
    for mesh in (None, make_mesh({"data": 2}, devices=["cpu"] * 2)):
        seg = Synth(cfg)
        calls = []
        detect = seg.batch_device
        seg.batch_device = lambda r, c: calls.append(len(c)) or detect(r, c)
        runner = BatchRunner(cfg, _envs(FakeNavEnv, cfg) + [
            lambda: FakeNavEnv(cfg, size_m=8.0, seed=5,
                               objects_in_depth=True, max_steps=11)],
            segmenter=seg, device="cpu" if mesh is None else None,
            mesh=mesh)
        try:
            acts = _roll(runner, ticks=4)
        finally:
            runner.close()
        runs.append((acts, runner.runtime.state.local_maps.numpy(), calls))
    (ua, um, uc), (sa, sm, sc) = runs
    # the first tick detects every env in one call; then groups of 2 as
    # they step
    assert uc == sc and uc[0] == 4 and set(uc[1:]) == {2}
    assert sa == ua
    torch.testing.assert_close(torch.from_numpy(sm), torch.from_numpy(um),
                               rtol=0, atol=0)
    assert sm[:, 4:13].sum() > 0
