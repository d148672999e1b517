"""Spatially sharded whole-map prediction against the JAX package's, on the
CPU: ``PredictionModel.get_prediction_sharded`` over
``make_mesh({"spatial": 8}, ["cpu"] * 8)`` against JAX's over the 8
virtual CPU devices of tests/conftest.py (GSPMD's halo exchanges), on the
dry run's narrow PSPNet (base 16) with random batch statistics carried
into both, at 128^2 (tests/test_spatial_inference.py's geometry: 16
stride-8 rows, 2 a shard, against the decode head's dilation-4
convolutions) and at 120 x 96 (15 rows: uneven shards of 1 and 2 rows).
Float32 within 1e-4 (tests/test_torch_prediction.py's bar: the two
frameworks' CPU convolutions sum in other orders); the port's sharded
prediction within 1e-6 of its own unsharded one.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from peanut_tpu.config import NavConfig as JNavConfig
from peanut_tpu.core.checkpoint import convert_encoder_decoder_state
from peanut_tpu.core.mesh import make_mesh as jmake_mesh
from peanut_tpu.prediction import PredictionModel as JPrediction
from peanut_tpu_torch.config import NavConfig
from peanut_tpu_torch.core.mesh import make_mesh
from peanut_tpu_torch.models.pspnet import build_segmentor
from peanut_tpu_torch.multichip import DRYRUN_MODEL
from peanut_tpu_torch.prediction import PredictionModel

from test_torch_spatial import _random_stats

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models():
    model = _random_stats(build_segmentor(DRYRUN_MODEL, seed=0))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    cfg = JNavConfig(num_sem_categories=10)
    jpm = JPrediction(cfg, variables=convert_encoder_decoder_state(sd),
                      model_cfg=DRYRUN_MODEL)
    pm = PredictionModel(NavConfig(**dataclasses.asdict(cfg)), model=model,
                         device="cpu")
    return jpm, pm


@pytest.mark.parametrize("hw", [(128, 128), (120, 96)])
def test_sharded_prediction_matches_jax_on_8_devices(models, hw):
    jpm, pm = models
    assert len(jax.devices()) == 8
    full_map = np.random.RandomState(0).rand(14, *hw).astype(np.float32)
    want = jpm.get_prediction_sharded(full_map, jmake_mesh({"spatial": 8}))
    got = pm.get_prediction_sharded(
        full_map, make_mesh({"spatial": 8}, devices=["cpu"] * 8))
    assert got.shape == want.shape == (6,) + hw
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    np.testing.assert_allclose(got, pm.get_prediction(full_map), rtol=0,
                               atol=1e-6)
