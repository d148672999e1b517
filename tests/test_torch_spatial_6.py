"""``peanut_tpu_torch.multichip.dryrun_multichip(4, device="cpu",
spatial=True)``: the JAX package's dry run with its spatial parts.  The
train step over ``{"data": 2, "spatial": 2}`` (two gloo ranks, each
driving two spatial shards) with finite losses and the ranks' parameters
equal, the sharded evaluation bit-equal to the direct one, the sharded
tick and a ``pred_async`` one over four data shards, then the whole-map
prediction of the tick's first full map with its height over
``{"spatial": 2}``: (6, 128, 128), finite, within 1e-4 of
``get_prediction``."""

import torch

from peanut_tpu_torch.multichip import SPATIAL_PRED_TOL, dryrun_multichip

torch.set_num_threads(1)


def test_dryrun_multichip_spatial_on_four_cpu_devices():
    out = dryrun_multichip(4, device="cpu", spatial=True)
    assert out["train_mesh"] == {"data": 2, "spatial": 2}
    ranks = out["train_eval"]
    assert ranks["ranks"] == 2 and ranks["spatial_shards_a_rank"] == 2
    assert ranks["params_spread_over_ranks"] == 0.0
    assert ranks["eval_bit_equal"] and ranks["eval_samples"] == 4
    assert len(out["nav_tick"]["actions"]) == 4
    assert len(out["pred_async_tick"]["actions"]) == 4
    pred = out["spatial_prediction"]
    assert pred["shape"] == [6, 128, 128] and pred["finite"]
    assert pred["max_abs_diff_unsharded"] <= SPATIAL_PRED_TOL
