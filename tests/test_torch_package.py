"""The PyTorch port as a package: no JAX, no peanut_tpu, the device rule,
the slices it leaves out, and its synthetic env against the JAX package's."""

import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (kept on the CPU by conftest)

from peanut_tpu.envs.fake import (BatchedFakeNavEnv as JBatchedEnv,
                                  FakeNavEnv as JFakeNavEnv)
from peanut_tpu_torch.config import NavConfig
from peanut_tpu_torch.envs.fake import BatchedFakeNavEnv, FakeNavEnv

from test_agent_e2e import small_cfg

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "peanut_tpu_torch")


def _modules():
    mods = []
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                mod = rel.replace(os.sep, ".")
                mods.append(mod[:-len(".__init__")]
                            if mod.endswith(".__init__") else mod)
    return sorted(mods)


def test_import_pulls_in_neither_jax_nor_peanut_tpu():
    """Every submodule imports in a fresh interpreter without loading jax or
    any peanut_tpu module (a subprocess: conftest imports jax here)."""
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'peanut_tpu' or m.startswith('peanut_tpu.')]\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sources_never_import_the_jax_package():
    pat = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b|"
                     r"import\s+peanut_tpu(?!_torch)\b|"
                     r"from\s+peanut_tpu(?!_torch)\b)", re.M)
    hits = []
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                with open(path) as fh:
                    hits += [f"{path}: {m.group(0).strip()}"
                             for m in pat.finditer(fh.read())]
    assert not hits, hits


def test_entry_points_need_a_card_unless_told_cpu(monkeypatch):
    from peanut_tpu_torch.agent.batched_runtime import BatchedNavRuntime
    from peanut_tpu_torch.envs.batch_runner import BatchRunner
    from peanut_tpu_torch.kernels import eikonal_distance

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = NavConfig(**dataclasses.asdict(small_cfg(only_explore=1)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchedNavRuntime(cfg, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchRunner(cfg, [lambda: FakeNavEnv(cfg, seed=0)])
    trav = np.ones((8, 8), bool)
    src = np.zeros((8, 8), bool)
    src[0, 0] = True
    with pytest.raises(RuntimeError, match="device='cpu'"):
        eikonal_distance(trav, src)
    rt = BatchedNavRuntime(cfg, 1, device="cpu")
    assert rt.state.local_maps.device.type == "cpu"
    d = eikonal_distance(trav, src, device="cpu")
    assert d.device.type == "cpu" and float(d[0, 0]) == 0.0


def test_unported_configurations_raise_naming_their_roadmap_item():
    from peanut_tpu_torch.agent.batched_runtime import BatchedNavRuntime
    from peanut_tpu_torch.perception import build_segmenter

    with pytest.raises(NotImplementedError, match="A8"):
        BatchedNavRuntime(NavConfig(**dataclasses.asdict(small_cfg())), 1,
                          device="cpu")
    with pytest.raises(NotImplementedError, match="A9"):
        build_segmenter(NavConfig(use_gt_seg=0))


def _assert_obs_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)


@pytest.mark.parametrize("batched", [False, True])
def test_fake_env_observations_byte_identical(batched):
    """The port's FakeNavEnv (and its batched twin) emits the JAX package's
    observations byte for byte, through episode resets."""
    jcfg = small_cfg()
    tcfg = NavConfig(**dataclasses.asdict(jcfg))
    seeds = [3, 11, 42]

    def envs(cls, cfg):
        return [cls(cfg, size_m=10.0, seed=s, max_steps=8,
                    objects_in_depth=True) for s in seeds]

    if batched:
        je, te = JBatchedEnv(envs(JFakeNavEnv, jcfg)), \
            BatchedFakeNavEnv(envs(FakeNavEnv, tcfg))
        steps = [(je.reset_all(), te.reset_all())]
    else:
        je, te = envs(JFakeNavEnv, jcfg), envs(FakeNavEnv, tcfg)
        steps = [([e.reset() for e in je], [e.reset() for e in te])]
    rng = np.random.RandomState(0)
    for _ in range(12):                      # crosses episode ends
        acts = [int(rng.randint(0, 4)) for _ in seeds]
        if batched:
            steps.append((je.step_all(acts, on_done=je.reset_one),
                          te.step_all(acts, on_done=te.reset_one)))
        else:
            jo, to = [], []
            for a, j, t in zip(acts, je, te):
                jo.append(j.step(a) if not j.episode_over else j.reset())
                to.append(t.step(a) if not t.episode_over else t.reset())
            steps.append((jo, to))
    for jo, to in steps:
        for a, b in zip(jo, to):
            _assert_obs_equal(a, b)
