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
    assert {"peanut_tpu_torch.models.mask_rcnn",
            "peanut_tpu_torch.models.roi_align",
            "peanut_tpu_torch.models.d2_import",
            "peanut_tpu_torch.kernels.roi_window",
            "peanut_tpu_torch.kernels.nms",
            "peanut_tpu_torch.perception.mask_rcnn_segmenter",
            "peanut_tpu_torch.agent.agent", "peanut_tpu_torch.agent.state",
            "peanut_tpu_torch.agent.planner",
            "peanut_tpu_torch.utils.drawing",
            "peanut_tpu_torch.models.pspnet",
            "peanut_tpu_torch.models.encoder_decoder",
            "peanut_tpu_torch.models.heads",
            "peanut_tpu_torch.models.mmseg_import",
            "peanut_tpu_torch.prediction.model",
            "peanut_tpu_torch.cli.collect", "peanut_tpu_torch.cli.collect_maps",
            "peanut_tpu_torch.cli.eval",
            "peanut_tpu_torch.kernels.fmm_long",
            "peanut_tpu_torch.models.losses",
            "peanut_tpu_torch.prediction.native",
            "peanut_tpu_torch.prediction.dataset",
            "peanut_tpu_torch.prediction.train",
            "peanut_tpu_torch.prediction.runner",
            "peanut_tpu_torch.prediction.metrics",
            "peanut_tpu_torch.core.checkpoint",
            "peanut_tpu_torch.utils.loggers",
            "peanut_tpu_torch.cli.train_prediction_model",
            "peanut_tpu_torch.cli.test",
            "peanut_tpu_torch.registry",
            "peanut_tpu_torch.core.config_file",
            "peanut_tpu_torch.models.builder",
            "peanut_tpu_torch.models.necks",
            "peanut_tpu_torch.models.heads_attention",
            "peanut_tpu_torch.models.heads_zoo",
            "peanut_tpu_torch.apis",
            "peanut_tpu_torch.cli.serve",
            "peanut_tpu_torch.cli.benchmark",
            "peanut_tpu_torch.models.zoo_import",
            "peanut_tpu_torch.models.timm_adapter",
            "peanut_tpu_torch.cli.convert",
            "peanut_tpu_torch.cli.convert_datasets",
            "peanut_tpu_torch.cli.export",
            "peanut_tpu_torch.cli.tools"} <= set(_modules())
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
    from peanut_tpu_torch.perception import MaskRCNNSegmenter
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MaskRCNNSegmenter(cfg, model=torch.nn.Module())
    from peanut_tpu_torch.agent import (MotionPlanner, NavAgentState,
                                        PeanutAgent)
    from peanut_tpu_torch.cli import collect_maps, train_prediction_model
    from peanut_tpu_torch.cli import test as test_cli
    from peanut_tpu_torch.models.pspnet import build_segmentor
    from peanut_tpu_torch.prediction import PredictionModel
    tiny = dict(type="EncoderDecoder",
                backbone=dict(type="ResNetV1c", base_channels=8,
                              stem_channels=8, in_channels=14),
                decode_head=dict(type="PSPHead", in_channels=256,
                                 channels=16, num_classes=6))
    for make in (lambda: PeanutAgent(cfg), lambda: NavAgentState(cfg),
                 lambda: MotionPlanner(cfg),
                 lambda: PredictionModel(cfg, model=build_segmentor(tiny)),
                 lambda: collect_maps.main(["--fake_env", "1",
                                            "--num_episodes", "0"]),
                 lambda: train_prediction_model.main(["--max_iters", "0"]),
                 lambda: test_cli.main(["--checkpoint", "x.pth"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert PeanutAgent(cfg, device="cpu").agent_state.device.type == "cpu"
    rt = BatchedNavRuntime(cfg, 1, device="cpu")
    assert rt.state.local_maps.device.type == "cpu"
    # the prediction runtime (only_explore=0): on the card unless told
    pcfg = NavConfig(**dataclasses.asdict(small_cfg(pred_async=1)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchedNavRuntime(pcfg, 1, prediction_model=PredictionModel(
            pcfg, model=build_segmentor(tiny), device="cpu"))
    rt = BatchedNavRuntime(pcfg, 2, prediction_model=PredictionModel(
        pcfg, model=build_segmentor(tiny), device="cpu"), device="cpu")
    assert rt.pred_model.device.type == "cpu" and rt._pred_async
    assert rt.predict_chunk == 2 and not rt._goal_host.is_pinned()
    d = eikonal_distance(trav, src, device="cpu")
    assert d.device.type == "cpu" and float(d[0, 0]) == 0.0


def test_unported_configurations_raise_naming_their_roadmap_item():
    from peanut_tpu_torch.perception import build_segmenter

    # use_gt_seg=0 is ported: without its checkpoint it raises, naming the
    # path, instead of falling back to an empty segmenter
    cfg = NavConfig(use_gt_seg=0, seg_model_wts="no/such/mask_rcnn.pth")
    with pytest.raises(FileNotFoundError, match="no/such/mask_rcnn.pth"):
        build_segmenter(cfg)
    with pytest.raises(FileNotFoundError, match="seg_model_wts"):
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
