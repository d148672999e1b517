"""``peanut_tpu_torch.multichip.dryrun_multichip`` on the CPU over two
devices (the JAX package's ``__graft_entry__.dryrun_multichip`` over the
data axis): the train step over two gloo ranks, the sharded evaluation
bit-equal to the direct one, a sharded tick and a ``pred_async`` one; the
spatial axis is ROADMAP A14 part 2."""

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
    with pytest.raises(NotImplementedError, match="A14 part 2"):
        dryrun_multichip(2, device="cpu", spatial=True)
    with pytest.raises(NotImplementedError, match="A14 part 2"):
        make_train_step(TrainConfig(), spatial_axis="spatial")
    pm = PredictionModel(NavConfig(), model=build_segmentor(DRYRUN_MODEL,
                                                            seed=0),
                         device="cpu")
    with pytest.raises(NotImplementedError, match="A14 part 2"):
        pm.get_prediction_sharded(
            torch.zeros(14, 64, 64).numpy(),
            make_mesh({"spatial": 2}, devices=["cpu"] * 2))
