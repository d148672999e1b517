"""``peanut_tpu_torch.multichip.dryrun_multichip`` on the CPU over two
devices (the JAX package's ``__graft_entry__.dryrun_multichip`` over the
data axis): the train step over two gloo ranks, the sharded evaluation
bit-equal to the direct one, a sharded tick and a ``pred_async`` one.
The spatial axis's entry points run: the train step with the height over
two shards and the sharded whole-map prediction, each against its
unsharded form (tests/test_torch_spatial*.py hold them to JAX's)."""

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (kept on the CPU by conftest)

from peanut_tpu_torch.config import NavConfig
from peanut_tpu_torch.core.mesh import make_mesh
from peanut_tpu_torch.models.pspnet import build_segmentor
from peanut_tpu_torch.multichip import DRYRUN_MODEL, dryrun_multichip
from peanut_tpu_torch.prediction import PredictionModel
from peanut_tpu_torch.prediction.train import TrainConfig, make_train_step

torch.set_num_threads(1)


def test_dryrun_multichip_on_two_cpu_devices():
    out = dryrun_multichip(2, device="cpu")
    assert out["devices"] == ["cpu", "cpu"] and out["backend"] == "gloo"
    ranks = out["train_eval"]
    assert ranks["params_spread_over_ranks"] == 0.0
    assert ranks["eval_bit_equal"] and ranks["eval_samples"] == 4
    assert len(out["nav_tick"]["actions"]) == 2
    assert out["nav_tick"]["shard_devices"] == ["cpu", "cpu"]
    assert len(out["pred_async_tick"]["actions"]) == 2


def test_spatial_axis_is_part_2():
    """The three entry points that raised naming ROADMAP A14 part 2 run:
    ``make_train_step(spatial_axis=, mesh=)`` (loss within 1e-5 relative
    of the unsharded step's, float32), ``get_prediction_sharded`` (within
    1e-6 of ``get_prediction``) and ``dryrun_multichip(spatial=True)``'s
    spatial half (tests/test_torch_spatial_6.py)."""
    from peanut_tpu_torch.prediction.train import create_train_state
    mesh = make_mesh({"spatial": 2}, devices=["cpu"] * 2)
    rng = np.random.RandomState(0)
    batch = {"img": rng.rand(2, 64, 64, 14).astype(np.float32),
             "gt": ((rng.rand(2, 64, 64, 6) > 0.9) * 255.0).astype(
                 np.float32)}
    losses = []
    for step in (make_train_step(TrainConfig()),
                 make_train_step(TrainConfig(), spatial_axis="spatial",
                                 mesh=mesh)):
        state = create_train_state(build_segmentor(DRYRUN_MODEL, seed=0),
                                   TrainConfig(), device="cpu")
        losses.append(float(step(state, batch)["loss"]))
        assert state.step == 1
    assert losses[1] == pytest.approx(losses[0], rel=1e-5)
    with pytest.raises(ValueError, match="come together"):
        make_train_step(TrainConfig(), spatial_axis="spatial")
    pm = PredictionModel(NavConfig(), model=build_segmentor(DRYRUN_MODEL,
                                                            seed=0),
                         device="cpu")
    full_map = rng.rand(14, 64, 64).astype(np.float32)
    got = pm.get_prediction_sharded(full_map, mesh)
    assert got.shape == (6, 64, 64)
    np.testing.assert_allclose(got, pm.get_prediction(full_map), rtol=0,
                               atol=1e-6)
