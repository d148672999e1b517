"""Data-parallel training of the port on the CPU: two gloo ranks, each
with its four rows of a global batch of eight, one float64 step of the
tiny PSPNet of tests/test_torch_training.py under
``prediction.train.distribute`` (DDP, batch norms over the group).

* Dropout 0, against the JAX package's train step on the global batch of
  8 (its loss function, ``tests/test_torch_training.py::_jax_loss_fn``,
  from the same seeded weights): the loss within 1e-9 relative, every
  gradient within 1e-9 of its tensor's largest |value| and the new batch
  statistics within 1e-9 of the largest (float64 on both sides: XLA and
  the port sum in other orders, the 1e-8 of the one-process parity
  test's gradients being the float64 rounding of a 50-layer net).
* Dropout 0.1 and ``remat`` (the backbone's blocks recomputed in
  backward, which repeats their batch norms' all-reduce), against the
  port's own one-process step at the global batch without remat: each
  rank draws the global batch's mask and keeps its rows, and DDP's
  reducer sees each gradient once, so the step is the same within
  float64 rounding (1e-12 of the largest).
A batch norm that carried the gradient through the global statistics
``world`` times, or not at all from the other rank, misses both bars.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from peanut_tpu.core.checkpoint import convert_encoder_decoder_state
from peanut_tpu.models import build_segmentor as jbuild
from peanut_tpu_torch.models.mmseg_import import flax_to_mmseg_state
from peanut_tpu_torch.models.pspnet import build_segmentor
from peanut_tpu_torch.prediction.train import (TrainConfig,
                                               create_train_state,
                                               loss_and_grads)

from test_torch_training import _jax_loss_fn, tiny_cfg
from torch_dist_support import ddp_step, run_ranks

torch.set_num_threads(1)
WORLD = 2
GLOBAL_BATCH = 8
SIZE = 32


def _global_batch(seed):
    rng = np.random.RandomState(seed)
    return {"img": rng.rand(GLOBAL_BATCH, 14, SIZE, SIZE),
            "gt": (rng.rand(GLOBAL_BATCH, 6, SIZE, SIZE) > 0.9) * 255.0,
            "seed": np.int64(seed)}


def _ddp(tmp_path, dropout, seed, remat=False):
    batch = _global_batch(seed)
    path = str(tmp_path / f"batch{seed}.npz")
    np.savez(path, **batch)
    out = str(tmp_path / f"ddp{seed}.pt")
    run_ranks(ddp_step, WORLD, tmp_path,
              tiny_cfg(remat=remat, dropout=dropout), path, out)
    return batch, torch.load(out)


def _close(got, want, tol, what):
    top = max(np.abs(w).max() for w in want.values())
    for name, w in want.items():
        np.testing.assert_allclose(np.asarray(got[name]), w, rtol=0,
                                   atol=tol * max(np.abs(w).max(), 1e-300)
                                   if what == "gradient" else tol * top,
                                   err_msg=f"{what} {name}")


def test_ddp_step_matches_jax_global_batch(tmp_path):
    batch, got = _ddp(tmp_path, dropout=0.0, seed=1)
    sd = {k: v.numpy().astype(np.float64) for k, v in
          build_segmentor(tiny_cfg(), seed=0).state_dict().items()}
    with jax.enable_x64(True):
        variables = jax.tree.map(jnp.asarray,
                                 convert_encoder_decoder_state(sd))
        (loss, (stats, main, aux)), grads = _jax_loss_fn(jbuild(tiny_cfg()))(
            variables["params"], variables["batch_stats"],
            jnp.asarray(batch["img"].transpose(0, 2, 3, 1)),
            jnp.asarray(batch["gt"].transpose(0, 2, 3, 1)))
        grads = jax.tree.map(np.asarray, grads)
        stats = jax.tree.map(np.asarray, stats)
    m = got["metrics"]
    assert m["loss"] == pytest.approx(float(loss), rel=1e-9)
    assert m["loss_bce"] == pytest.approx(float(main), rel=1e-9)
    assert m["aux.loss_bce"] == pytest.approx(float(aux), rel=1e-9)
    _close(got["grads"], flax_to_mmseg_state({"params": grads}), 1e-9,
           "gradient")
    _close(got["state"], flax_to_mmseg_state({"batch_stats": stats}), 1e-9,
           "statistic")


def test_ddp_step_with_dropout_equals_one_process(tmp_path):
    batch, got = _ddp(tmp_path, dropout=0.1, seed=2, remat=True)
    tcfg = TrainConfig(lr=1e-3, max_iters=50, seed=2)
    state = create_train_state(
        build_segmentor(tiny_cfg(dropout=0.1), seed=0).double(), tcfg,
        device="cpu")
    m = loss_and_grads(state, {k: torch.from_numpy(batch[k])
                               for k in ("img", "gt")}, tcfg)
    for k, v in m.items():
        assert got["metrics"][k] == pytest.approx(float(v), rel=1e-12), k
    _close(got["grads"], {n: p.grad.numpy() for n, p in
                          state.model.named_parameters()}, 1e-12,
           "gradient")
    _close(got["state"], {n: v.numpy() for n, v in
                          state.model.state_dict().items()
                          if "running" in n}, 1e-12, "statistic")
