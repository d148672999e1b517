"""The mesh's data and spatial axes together on the CPU: two spawned gloo
ranks (``tests/torch_dist_support.py``), each with its two rows of a
global batch of four at 64^2 and their height over two spatial shards of
a ``{"data": 2, "spatial": 2}`` mesh, under ``distribute`` (the batch
norms' sums over the shards, then over the group; the gradients averaged
over the group by one all-reduce, as DDP's reducer would):

* dropout 0, two SGD steps at 1e-3 against the JAX package's step over
  ``{"data": 2, "spatial": 2}`` of its virtual CPU devices in float64,
  with tests/test_torch_spatial_3.py's bars (losses 1e-9 relative,
  parameters and statistics 1e-9 of the largest, updates 1e-7 of their
  tensor's largest), and against the port's one-process unsharded step
  at the global batch (losses 1e-12, updates 1e-9);
* dropout 0.1 and ``remat``: one ``loss_and_grads`` against the port's
  one-process unsharded one at the global batch from the same generator
  (each rank draws the global batch's mask, ``BatchRows``, and keeps its
  rows of it): losses within 1e-12 relative, gradients within 1e-9 of
  their tensor's largest |value|, statistics within 1e-12 of the largest.
"""

import copy

import numpy as np
import pytest
import torch

from peanut_tpu_torch.models.pspnet import build_segmentor
from peanut_tpu_torch.prediction.train import (TrainConfig,
                                               create_train_state,
                                               loss_and_grads)

from test_torch_spatial_3 import (LR, assert_state_close, batches, jax_steps,
                                  model_cfg, nchw, port_steps)
from torch_dist_support import run_ranks, spatial_steps

torch.set_num_threads(1)
WORLD, SHARDS, GLOBAL_BATCH = 2, 2, 4


def test_data_by_spatial_step_matches_jax_and_one_process(tmp_path):
    data = batches(b=GLOBAL_BATCH)
    path = str(tmp_path / "batches.npz")
    np.savez(path, **{k: np.stack([nchw(b)[k].numpy() for b in data])
                      for k in ("img", "gt")})
    out_path = str(tmp_path / "rank0.pt")
    run_ranks(spatial_steps, WORLD, tmp_path, model_cfg(), path, out_path,
              SHARDS, LR)
    got = torch.load(out_path)
    assert got["devices"] == ["cpu"] * SHARDS
    state = {n: v.numpy() for n, v in got["state"].items()}

    want_losses, want = jax_steps({"data": WORLD, "spatial": SHARDS}, data)
    params = {n for n, _ in build_segmentor(model_cfg()).named_parameters()}
    for got_l, want_l in zip(got["losses"], want_losses):
        for name, v in want_l.items():
            assert got_l[name] == pytest.approx(v, rel=1e-9), name
    assert_state_close(state, want, params, update_tol=1e-7)

    plain_losses, plain, _ = port_steps(None, data)
    for got_l, want_l in zip(got["losses"], plain_losses):
        for name, v in want_l.items():
            assert got_l[name] == pytest.approx(v, rel=1e-12), name
    assert_state_close(state, plain, params, update_tol=1e-9, tol=1e-12)

    # dropout and remat against one process at the global batch
    cfg = copy.deepcopy(model_cfg(remat=True, dropout=0.1))
    tcfg = TrainConfig(lr=LR, min_lr=LR, seed=3)
    one = create_train_state(build_segmentor(cfg, seed=0).double(), tcfg,
                             device="cpu")
    one.step = 5
    metrics = loss_and_grads(one, nchw(data[0]), tcfg)
    drop = got["dropout"]
    for k, v in metrics.items():
        assert drop["metrics"][k] == pytest.approx(float(v), rel=1e-12), k
    for n, p in one.model.named_parameters():
        w = p.grad.numpy()
        np.testing.assert_allclose(drop["grads"][n].numpy(), w, rtol=0,
                                   atol=1e-9 * np.abs(w).max(), err_msg=n)
    stats = {n: v.numpy() for n, v in one.model.state_dict().items()
             if "running" in n}
    top = max(np.abs(w).max() for w in stats.values())
    for n, w in stats.items():
        np.testing.assert_allclose(drop["state"][n].numpy(), w, rtol=0,
                                   atol=1e-12 * top, err_msg=n)
