"""The prediction's inference mode (ROADMAP fault C6), on the CPU, the port
against the JAX package in float32:

* the dry run's narrow PSPNet (``multichip.DRYRUN_MODEL``, random batch
  statistics) with ``test_cfg=dict(mode="slide", crop_size=(64, 64),
  stride=(48, 48))``: the port's ``PredictionModel.get_prediction`` of a
  14 x 128^2 map slides as JAX's ``PredictionModel`` does (nine windows,
  the overlaps averaged), within 1e-5; its whole forward lies far from
  that (0.231 before the repair);
* its ``get_prediction_sharded`` slides over the sharded map: over 8
  shards of ``["cpu"] * 8`` within 1e-5 of JAX's
  ``get_prediction_sharded`` on the 8 virtual devices (GSPMD's slide,
  compiled once for the module), over 2 within 1e-6 of the port's
  unsharded slide;
* a cascade (mmseg's FCN -> OCR ``CascadeEncoderDecoder``) given the same
  slide ``test_cfg`` runs whole inference, as the JAX package's cascade
  does: within 1e-5 of JAX's prediction, and far from its own windows;
* PEANUT's PSPNet config (``mode="whole"``): ``infer`` gives the bytes of
  the plain whole forward's sigmoid, the path it took before.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from peanut_tpu_torch.config import NavConfig
from peanut_tpu_torch.core.mesh import make_mesh
from peanut_tpu_torch.models.pspnet import (build_segmentor,
                                            peanut_prediction_config)
from peanut_tpu_torch.multichip import DRYRUN_MODEL
from peanut_tpu_torch.prediction import PredictionModel

from test_torch_spatial import _random_stats
from torch_zoo_support import one_thread  # noqa: F401

SLIDE = dict(mode="slide", crop_size=(64, 64), stride=(48, 48))
HW = (128, 128)


def _map(channels):
    return np.random.RandomState(0).rand(channels, *HW).astype(np.float32)


@pytest.fixture(scope="module")
def slide_models():
    from peanut_tpu.config import NavConfig as JNavConfig
    from peanut_tpu.core.checkpoint import convert_encoder_decoder_state
    from peanut_tpu.prediction import PredictionModel as JPrediction
    cfg = dict(copy.deepcopy(DRYRUN_MODEL), test_cfg=dict(SLIDE))
    model = _random_stats(build_segmentor(cfg, seed=0))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    jcfg = JNavConfig(num_sem_categories=10)
    jpm = JPrediction(jcfg, variables=convert_encoder_decoder_state(sd),
                      model_cfg=cfg)
    pm = PredictionModel(NavConfig(**dataclasses.asdict(jcfg)), model=model,
                         device="cpu")
    return jpm, pm


def test_slide_prediction_matches_jax(slide_models):
    jpm, pm = slide_models
    full_map = _map(14)
    want = jpm.get_prediction(full_map)
    got = pm.get_prediction(full_map)
    assert got.shape == want.shape == (6,) + HW
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    with torch.no_grad():
        whole = torch.sigmoid(pm.model(torch.as_tensor(full_map[None])))
    assert float(np.abs(whole[0].numpy() - want).max()) > 1e-2


@pytest.fixture(scope="module")
def jax_sharded_slide(slide_models):
    from peanut_tpu.core.mesh import make_mesh as jmake_mesh
    jpm, _ = slide_models
    return jpm.get_prediction_sharded(_map(14), jmake_mesh({"spatial": 8}))


@pytest.mark.parametrize("k", [2, 8])
def test_sharded_slide_prediction(slide_models, jax_sharded_slide, k):
    """k = 8: against JAX's GSPMD slide on 8 devices; k = 2: against the
    port's unsharded slide."""
    _, pm = slide_models
    got = pm.get_prediction_sharded(_map(14), make_mesh({"spatial": k},
                                                        ["cpu"] * k))
    assert got.shape == (6,) + HW and got.dtype == np.float32
    if k == 8:
        np.testing.assert_allclose(got, jax_sharded_slide, rtol=0,
                                   atol=1e-5)
    else:
        np.testing.assert_allclose(got, pm.get_prediction(_map(14)),
                                   rtol=0, atol=1e-6)


def test_a_cascade_runs_whole_whatever_test_cfg_says():
    from peanut_tpu.config import NavConfig as JNavConfig
    from peanut_tpu.prediction import PredictionModel as JPrediction
    from torch_spatial_zoo_support import ocr_cascade_config
    from torch_zoo_support import jax_and_port
    cfg = dict(ocr_cascade_config(), test_cfg=dict(SLIDE))
    _, variables, model, _ = jax_and_port(cfg, (64, 64))
    jcfg = JNavConfig()
    jpm = JPrediction(jcfg, variables=variables, model_cfg=cfg)
    pm = PredictionModel(NavConfig(**dataclasses.asdict(jcfg)), model=model,
                         device="cpu")
    assert not pm.model.slides
    full_map = _map(3)
    want = jpm.get_prediction(full_map)
    got = pm.get_prediction(full_map)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    with torch.no_grad():
        windows = torch.sigmoid(pm.model.slide_inference(
            torch.as_tensor(full_map[None])))
    assert float(np.abs(windows[0].numpy() - want).max()) > 1e-2
    got_sharded = pm.get_prediction_sharded(
        full_map, make_mesh({"spatial": 2}, ["cpu"] * 2))
    np.testing.assert_allclose(got_sharded, got, rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def peanut_model():
    return _random_stats(build_segmentor(peanut_prediction_config(),
                                         seed=0))


@pytest.mark.parametrize("bf16", [False, True])
def test_whole_mode_prediction_is_the_plain_forward(peanut_model, bf16):
    assert peanut_model.test_cfg["mode"] == "whole"
    assert not peanut_model.slides
    pm = PredictionModel(NavConfig(serve_bf16=bf16),
                         model=copy.deepcopy(peanut_model), device="cpu")
    x = torch.as_tensor(np.random.RandomState(2).rand(2, 14, 64, 64)
                        .astype(np.float32))
    with torch.no_grad():
        want = torch.sigmoid(pm.model(x.to(pm.dtype)).float())
    assert torch.equal(pm.infer(x), want)
