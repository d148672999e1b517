"""The port's episode dashboard (``utils/visualization.py``) and habitat
adapter (``envs/habitat_adapter.py``) against the JAX package's, on the CPU.

* dashboard frames: byte-equal to the JAX package's renders of the same
  inputs (both draw with cv2 and matplotlib on host numpy), panels given
  as tensors too;
* the habitat adapter: against the fake ``habitat`` module of
  tests/test_habitat_mock.py (the config it builds, the reset/step/metrics
  surface, ``collect_maps`` with ``--fake_env 0``) and the recorded
  habitat-lab 0.2.1 schema of tests/test_habitat_contract.py.
"""

import glob
import os
import re
import sys

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (kept on the CPU by conftest)

from peanut_tpu.config import NavConfig as JNavConfig
from peanut_tpu.utils.visualization import EpisodeVisualizer as JVis
from peanut_tpu_torch.config import NavConfig
from peanut_tpu_torch.utils.visualization import EpisodeVisualizer

from test_habitat_contract import HABITAT_021_KEYS
from test_habitat_mock import SMALL_ARGS, _make_fake_habitat

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs(cfg, seed):
    lw = cfg.local_w
    rng = np.random.RandomState(seed)
    p_input = {
        "obstacle": (rng.rand(lw, lw) > 0.9).astype(float),
        "exp_pred": (rng.rand(lw, lw) > 0.5).astype(float),
        "pose_pred": np.array([6.0, 6.0, 30.0, 0, lw, 0, lw]),
        "goal": np.zeros((lw, lw)),
        "sem_map_pred": rng.randint(0, 10, (lw, lw)),
    }
    p_input["goal"][50, 50] = 1
    rgb = rng.randint(0, 255, (48, 64, 3)).astype(np.uint8)
    col = (rng.rand(cfg.map_size, cfg.map_size) > 0.95).astype(float)
    visited = (rng.rand(cfg.map_size, cfg.map_size) > 0.95).astype(float)
    panels = {k: rng.rand(lw, lw) for k in ("target_pred", "value",
                                            "dd_wt")}
    return p_input, rgb, col, visited, panels


@pytest.mark.parametrize("seed,stg,tensors", [(0, (40, 40), False),
                                              (1, None, True),
                                              (2, (10, 90), False)])
def test_dashboard_frames_byte_equal_to_jax(tmp_path, seed, stg, tensors):
    kw = dict(visualize=2, dump_location=str(tmp_path), map_size_cm=1200,
              global_downscaling=2)
    cfg, jcfg = NavConfig(**kw), JNavConfig(**kw)
    p_input, rgb, col, visited, panels = _inputs(cfg, seed)
    jvis = JVis(jcfg)
    jvis.reset()
    want = jvis.render(dict(p_input), rgb, col, visited, stg,
                       goal_name="chair", **panels)
    if tensors:
        panels = {k: torch.as_tensor(v) for k, v in panels.items()}
    vis = EpisodeVisualizer(cfg)
    vis.reset()
    got = vis.render(dict(p_input), rgb, col, visited, stg,
                     goal_name="chair", **panels)
    assert got.shape == (600, 1415, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    vis.show_or_dump(got)
    assert len(glob.glob(str(tmp_path / "dump" / "**" / "*.jpg"),
                         recursive=True)) == 1


@pytest.fixture
def fake_habitat(tmp_path, monkeypatch):
    habitat, core, core_env = _make_fake_habitat()
    cfg_file = tmp_path / "challenge_objectnav2022.local.rgbd.yaml"
    cfg_file.write_text("# fake challenge config\n")
    monkeypatch.setenv("CHALLENGE_CONFIG_FILE", str(cfg_file))
    monkeypatch.setitem(sys.modules, "habitat", habitat)
    monkeypatch.setitem(sys.modules, "habitat.core", core)
    monkeypatch.setitem(sys.modules, "habitat.core.env", core_env)
    return habitat


def test_habitat_adapter_against_the_mock(fake_habitat):
    """The config the adapter builds is the one the mock's Env asserts
    (defrosted, seed 100, split val, scene repeats unbounded, frozen
    again), and the FakeNavEnv surface passes through."""
    from peanut_tpu_torch.envs.habitat_adapter import HabitatEnvAdapter

    env = HabitatEnvAdapter(NavConfig.from_args(SMALL_ARGS), split="val",
                            seed=100)
    assert fake_habitat.calls["get_config"] == 1
    assert env.config._frozen
    obs = env.reset()
    assert {"rgb", "depth", "gps", "compass", "objectgoal"} <= set(obs)
    env.step({"action": 1})
    env.step(2)
    assert isinstance(env.get_metrics(), dict)
    assert len(env.episodes) == 2 and env.current_episode == "ep0"
    assert env.episode_over in (True, False)


def test_habitat_adapter_outside_the_image_raises():
    from peanut_tpu_torch.envs.habitat_adapter import HabitatEnvAdapter

    if "habitat" in sys.modules:
        pytest.skip("a habitat module is installed")
    with pytest.raises(ImportError, match="habitat"):
        HabitatEnvAdapter(NavConfig())


def test_collect_maps_runs_through_the_adapter(fake_habitat, tmp_path):
    """--fake_env 0 drives the single-env agent on the mock's episode."""
    from peanut_tpu_torch.cli import collect_maps

    collect_maps.main(SMALL_ARGS + [
        "--fake_env", "0", "--num_episodes", "1", "--map_size_cm", "1920",
        "--vision_range", "24", "--out_dir", str(tmp_path / "m")],
        device="cpu")
    assert fake_habitat.calls["resets"] >= 1


def test_adapter_keys_within_the_pinned_schema():
    """tests/test_habitat_contract.py's check, on the port's adapter."""
    src = open(os.path.join(REPO, "peanut_tpu_torch", "envs",
                            "habitat_adapter.py")).read()
    touched = {m.group(1).rstrip(".") for m in re.finditer(
        r"config\.((?:[A-Z][A-Z_0-9]*\.?)+)", src)}
    assert touched and touched <= HABITAT_021_KEYS, touched
    jsrc = open(os.path.join(REPO, "peanut_tpu", "envs",
                             "habitat_adapter.py")).read()
    assert touched == {m.group(1).rstrip(".") for m in re.finditer(
        r"config\.((?:[A-Z][A-Z_0-9]*\.?)+)", jsrc)}
