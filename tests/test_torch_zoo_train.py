"""The model zoo's training half in the port against the JAX package, on
the CPU: the train step on config-built zoo models, the cascade's
training pass, and the config-driven entry points.

* One train step (PEANUT's recipe: BCE on the decode head plus 0.4 x the
  auxiliary head at gt / 255, Adam at the poly schedule's step 0) in
  float64 on both sides (``jax.enable_x64``), dropout 0, batch 2 at
  32x32 with 14 input channels and 6 classes, from the JAX model's seeded
  variables (random batch statistics, norms and biases) carried by
  ``flax_to_torch_state`` (``torch_zoo_support.check_train_step``), for
  narrow versions of the families the JAX step can train (one auxiliary
  head): here UPerNet over ConvNeXt (depths 1-1-2-1, widths 16-64,
  through an ``ARCHS`` entry both packages read) and over ViT (width 32,
  depth 4), and MAE-UPerNet, whose config has no auxiliary head: the test
  config adds an FCN one over its third tap, and MAE's ``pos_embed``
  (``layers.InputShaped``) is bound before Adam is built and trains (the
  light CNNs: ``test_torch_zoo_train_2.py``).  Bars: the loss within 1e-5
  relative; every gradient within 1e-4 of its tensor's largest |value|
  (plus 1e-10 of the largest gradient of the model, for tensors whose
  gradients cancel); the batch norms' running statistics after the step
  within 1e-8 relative; the parameters after the Adam step within 1e-4 of
  the learning rate.
* PointRend's training forward (``CascadeEncoderDecoder``, train mode)
  against the JAX apply with ``mutable=["batch_stats",
  "intermediates"]``: the stage logits and the point head's logits within
  1e-9 of the largest |value|, the points equal, the statistics within
  1e-8.
* A config the step cannot train (SegFormer, no auxiliary head; PointRend,
  a cascade without one) raises ValueError naming its heads.
* ``--config`` through the port's CLI on tiny maps: it trains,
  checkpoints, resumes, and ``apis`` serves the checkpoint as the trained
  model computes; a config without ``in_channels`` trains 14 channels,
  and MAE's positional embedding is bound before the optimizer holds it.
* ``apis.train_segmentor`` builds the reference's argv.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from peanut_tpu.models import build_segmentor as jbuild
from peanut_tpu_torch import apis
from peanut_tpu_torch.cli import train_prediction_model
from peanut_tpu_torch.core.config_file import dump_config, load_config
from peanut_tpu_torch.models.builder import build_segmentor
from peanut_tpu_torch.models.mmseg_import import flax_to_torch_state
from peanut_tpu_torch.prediction.train import TrainConfig, create_train_state
from peanut_tpu_torch.utils.loggers import read_train_log
from torch_zoo_support import (TRAIN_CHANNELS, carry, check_train_step,
                               family_config, random_variables, randomize,
                               rel_err, train_case_configs)
from torch_zoo_support import narrow_convnext  # noqa: F401  (fixture)
from torch_zoo_support import one_thread  # noqa: F401  (autouse)


@pytest.mark.usefixtures("narrow_convnext")
@pytest.mark.parametrize("family", ["upernet_convnext", "upernet_vit",
                                    "mae_upernet"])
def test_train_step_matches_jax(family):
    check_train_step(family)


def test_point_rend_training_pass_matches_jax():
    cfg = family_config("point_rend")
    hw = (64, 128)
    x = np.random.RandomState(3).rand(1, *hw, 3)
    jm = jbuild(cfg)
    v = random_variables(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, *hw, 3)),
        train=False))
    v = randomize(v, np.random.RandomState(4), np.float64)
    with jax.enable_x64(True):
        out, mut = jax.jit(lambda v, x: jm.apply(
            v, x, train=True, mutable=["batch_stats", "intermediates"]))(
                v, x)
        out, mut = jax.tree_util.tree_map(np.asarray, (out, mut))
    pm = carry(v, build_segmentor(cfg))
    got, extra = pm(torch.as_tensor(x.transpose(0, 3, 1, 2)), train=True,
                    with_points=True)
    assert pm.training
    inter = mut["intermediates"]
    assert rel_err(got.detach().numpy().transpose(0, 2, 3, 1), out) <= 1e-9
    np.testing.assert_array_equal(extra["points"].numpy(),
                                  inter["points"][0])
    assert extra["points"].shape == (1, 256, 2)
    assert rel_err(extra["point_logits"].detach().numpy().transpose(0, 2, 1),
                   inter["point_logits"][0]) <= 1e-9
    want = flax_to_torch_state({"params": v["params"],
                                "batch_stats": mut["batch_stats"]}, pm)
    sd = pm.state_dict()
    for name, w in want.items():
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[name].numpy(), w, rtol=1e-8,
                                       atol=1e-12, err_msg=name)
    # with the auxiliary head asked for, a cascade without one gives the
    # one stage; the serving forward is unchanged
    assert pm(torch.zeros(1, 3, *hw, dtype=torch.float64), train=True,
              with_aux=True).shape == (
        1, 19, *hw)
    with torch.no_grad():
        served = pm(torch.as_tensor(x.transpose(0, 3, 1, 2)), train=False)
        np.testing.assert_array_equal(
            served.numpy(),
            pm.inference(torch.as_tensor(x)).numpy().transpose(0, 3, 1, 2))


@pytest.mark.parametrize("family,heads", [
    ("segformer", "SegFormerHead"), ("point_rend", "PointHead")])
def test_configs_without_one_auxiliary_head_raise(family, heads):
    model = build_segmentor(family_config(family), device="meta")
    with pytest.raises(ValueError, match=heads):
        create_train_state(model, TrainConfig(), device="cpu")


def write_maps(dirpath, n_files=1, size=48, seed=0):
    """Synthetic episodes as tests/test_torch_training.py writes them."""
    rng = np.random.RandomState(seed)
    os.makedirs(dirpath, exist_ok=True)
    for i in range(n_files):
        seq = np.zeros((20, 14, size, size), np.uint8)
        for t in range(20):
            r = 3 + t * 2
            seq[t, 1, :r, :r] = 255
            seq[t, 0, :r:4, :r] = 255
        seq[:, 4:10] = (rng.rand(1, 6, size, size) > 0.97) * 255
        np.savez_compressed(os.path.join(dirpath, f"f{i:05d}.npz"), maps=seq)


@pytest.mark.usefixtures("narrow_convnext")
def test_cli_trains_a_config_resumes_and_serves(tmp_path):
    write_maps(str(tmp_path / "train_80"))
    _, pcfg = train_case_configs("upernet_convnext")
    cfg_file = str(tmp_path / "upernet_narrow.py")
    dump_config({"model": pcfg}, cfg_file)
    assert load_config(cfg_file)["model"] == pcfg
    work = str(tmp_path / "work")
    argv = ["--config", cfg_file, "--data_root", str(tmp_path),
            "--img_dir", "train_80", "--work_dir", work, "--batch_size",
            "2", "--crop_size", "32", "--checkpoint_interval", "1",
            "--log_interval", "1", "--num_workers", "1", "--lr", "1e-3"]
    first = train_prediction_model.main(argv + ["--max_iters", "2"],
                                        device="cpu")
    assert first.step == 2
    state = train_prediction_model.main(argv + ["--max_iters", "3"],
                                        device="cpu")
    assert state.step == 3
    assert sorted(os.listdir(work)) == ["iter_1", "iter_2", "iter_3",
                                        "train_log.jsonl"]
    log = read_train_log(os.path.join(work, "train_log.jsonl"))
    assert [r["iter"] for r in log] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) and "aux.loss_bce" in r for r in log)
    bundle = apis.init_segmentor(cfg_file, os.path.join(work, "iter_3"),
                                 device="cpu")
    img = np.random.RandomState(5).rand(32, 32, TRAIN_CHANNELS)
    got = apis.inference_segmentor(bundle, img, logits=True)
    with torch.no_grad():
        want = state.model(torch.as_tensor(
            img.transpose(2, 0, 1)[None], dtype=torch.float32), train=False)
    np.testing.assert_array_equal(got, want[0].numpy())


def test_cli_config_defaults_to_14_channels_and_binds_first(tmp_path):
    path = str(tmp_path / "mae.py")
    _, pcfg = train_case_configs("mae_upernet")
    del pcfg["backbone"]["in_channels"]
    dump_config({"model": pcfg}, path)
    model = train_prediction_model.config_model(path, 32, 0, "cpu")
    assert model.backbone.patch_embed.weight.shape[1] == TRAIN_CHANNELS
    assert model.backbone.pos_embed.shape == (1, 4, 96)
    state = create_train_state(model, TrainConfig(), device="cpu")
    held = {id(p) for g in state.optimizer.param_groups for p in g["params"]}
    assert id(model.backbone.pos_embed) in held
    unbound = build_segmentor(pcfg, seed=0)
    with pytest.raises(ValueError, match="InputShaped"):
        create_train_state(unbound, TrainConfig(), device="cpu")


def test_train_segmentor_argv_equals_the_reference(monkeypatch):
    import peanut_tpu.apis as japis
    import peanut_tpu.cli.train_prediction_model as jcli
    seen = {}
    monkeypatch.setattr(jcli, "main", lambda argv: seen.setdefault(
        "jax", argv))
    monkeypatch.setattr(train_prediction_model, "main",
                        lambda argv, device=None: seen.setdefault(
                            "port", (argv, device)))
    kw = dict(max_iters=4, batch_size=2, crop_size=64)
    japis.train_segmentor("configs/x.py", "data", "work", **kw)
    apis.train_segmentor("configs/x.py", "data", "work", device="cpu", **kw)
    assert seen["port"] == (seen["jax"], "cpu")
    assert "--config" not in seen["jax"]      # the reference drops it
