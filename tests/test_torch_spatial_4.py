"""The spatially sharded train step, continued (tests/test_torch_spatial_3.py
holds the bars):

* over 8 shards against JAX's step over the 8 virtual CPU devices: at
  64^2 the backbone's stride-8 maps leave one row a shard, so the decode
  head's dilation-4 convolutions take their halo from four shards a side,
  in the forward and the backward pass;
* with dropout 0.1 (PEANUT's heads) and ``remat``, over 3 and 5 shards
  (uneven: 64 rows as 22/21/21 and 13/13/13/13/12, 8 stride-8 rows as
  3/3/2 and 2/2/2/1/1) against the port's unsharded step from the same
  generator: the heads drop what the unsharded step drops, the batch
  norms' running statistics move once; losses within 1e-12 relative,
  gradients within 1e-9 of their tensor's largest |value| and the
  statistics within 1e-12 of the largest.
"""

import numpy as np
import pytest
import torch

from peanut_tpu_torch.models.pspnet import build_segmentor
from peanut_tpu_torch.prediction.train import (TrainConfig,
                                               create_train_state,
                                               loss_and_grads)

from test_torch_spatial_3 import batches, check_against_jax, model_cfg, nchw

torch.set_num_threads(1)


def test_spatial_train_step_matches_jax_over_8_shards():
    check_against_jax(8)


def _grads(devices, batch):
    tcfg = TrainConfig(lr=1e-3, max_iters=50, seed=3)
    state = create_train_state(
        build_segmentor(model_cfg(remat=devices is not None, dropout=0.1),
                        seed=0).double(), tcfg, device="cpu")
    state.step = 5
    losses = loss_and_grads(state, batch, tcfg, devices)
    return ({k: float(v) for k, v in losses.items()},
            {n: p.grad.numpy() for n, p in state.model.named_parameters()},
            {n: v.numpy() for n, v in state.model.state_dict().items()
             if "running" in n})


@pytest.mark.parametrize("k", [3, 5])
def test_dropout_and_remat_over_uneven_shards_equal_unsharded(k):
    batch = nchw(batches(steps=1)[0])
    want = _grads(None, batch)
    got = _grads(["cpu"] * k, batch)
    for name, v in want[0].items():
        assert got[0][name] == pytest.approx(v, rel=1e-12), name
    for name, w in want[1].items():
        np.testing.assert_allclose(got[1][name], w, rtol=0,
                                   atol=1e-9 * np.abs(w).max(),
                                   err_msg=name)
    top = max(np.abs(w).max() for w in want[2].values())
    for name, w in want[2].items():
        np.testing.assert_allclose(got[2][name], w, rtol=0, atol=1e-12 * top,
                                   err_msg=name)
