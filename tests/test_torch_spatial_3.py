"""The spatially sharded train step against the JAX package's, on the CPU,
in float64 on both sides (``jax.enable_x64``): the port's
``make_train_step(cfg, spatial_axis="spatial", mesh=make_mesh({"spatial":
k}, ["cpu"] * k))`` against JAX's ``make_train_step(model, cfg, tx, mesh,
spatial_axis="spatial")`` over k of the 8 virtual CPU devices (its batch
spec ``P("data", "spatial")`` names a data axis, so its mesh is
{"data": 1, "spatial": k}), from the same seeded weights of the dry run's
narrow PSPNet (base 16, dropout 0: the frameworks' random streams
differ), batch 2 at 64^2: 8 stride-8 rows, one a shard at k = 8.

Two steps of plain SGD at a constant rate 1e-3 on both sides (both steps
take the optimizer they are given; Adam's first update is lr x sign(g),
which a rounding flips where g is near 0, and the port's Adam is held
against optax in tests/test_torch_training.py):
* the losses of both steps within 1e-9 relative;
* every parameter after the second step within 1e-9 of the largest
  |parameter|, every batch statistic within 1e-9 of the largest
  statistic;
* each parameter's update (the two steps' gradients) within 1e-7 of its
  tensor's largest update: the port's unsharded step is 4e-8 from JAX's
  there, the float64 rounding of a 50-layer net whose last batch norms
  see 128 values a channel;
* the sharded step against the port's unsharded one: losses within 1e-12
  relative, updates within 1e-9 of their tensor's largest (the sharded
  sums round ~1e-11 apart).
The port's sharded step runs with ``remat`` (each residual block
recomputed over all its shards in backward); remat changes no number.
A batch norm that counted a shard's statistics twice, or a halo row's
gradient lost or doubled, misses by orders of magnitude.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from peanut_tpu.core.checkpoint import convert_encoder_decoder_state
from peanut_tpu.core.mesh import make_mesh as jmake_mesh
from peanut_tpu.models import build_segmentor as jbuild
from peanut_tpu.prediction.train import TrainConfig as JTrainConfig
from peanut_tpu.prediction.train import create_train_state as jcreate
from peanut_tpu.prediction.train import make_train_step as jmake_step
from peanut_tpu_torch.core.mesh import make_mesh
from peanut_tpu_torch.models.mmseg_import import flax_to_mmseg_state
from peanut_tpu_torch.models.pspnet import build_segmentor
from peanut_tpu_torch.multichip import DRYRUN_MODEL
from peanut_tpu_torch.prediction.train import (TrainConfig,
                                               create_train_state,
                                               make_train_step)

torch.set_num_threads(1)
SIZE = 64
LR = 1e-3       # poly_schedule at min_lr = lr: the same rate every step


def model_cfg(remat=False, dropout=0.0):
    cfg = copy.deepcopy(DRYRUN_MODEL)
    cfg["backbone"]["remat"] = remat
    cfg["decode_head"]["dropout_ratio"] = dropout
    cfg["auxiliary_head"]["dropout_ratio"] = dropout
    return cfg


def batches(b=2, size=SIZE, steps=2):
    rng = np.random.RandomState(7)
    return [{"img": rng.rand(b, size, size, 14),
             "gt": (rng.rand(b, size, size, 6) > 0.9) * 255.0}
            for _ in range(steps)]


def seed_state_dict():
    return {k: v.numpy().astype(np.float64) for k, v in
            build_segmentor(model_cfg(), seed=0).state_dict().items()}


def jax_steps(mesh_axes, data_batches):
    """The JAX package's sharded step, twice: losses, params and batch
    statistics (mmseg names, numpy float64)."""
    jmodel = jbuild(model_cfg())
    tcfg = JTrainConfig(lr=LR, min_lr=LR,
                        batch_size=len(data_batches[0]["img"]))
    mesh = jmake_mesh(mesh_axes, devices=jax.devices()[:int(np.prod(
        list(mesh_axes.values())))])
    with jax.enable_x64(True):
        variables = jax.tree.map(jnp.asarray,
                                 convert_encoder_decoder_state(
                                     seed_state_dict()))
        state, tx = jcreate(jmodel, variables, tcfg, tx=optax.sgd(LR))
        losses = []
        with mesh:
            step, _ = jmake_step(jmodel, tcfg, tx, mesh=mesh,
                                 spatial_axis="spatial")
            for batch in data_batches:
                state, metrics = step(state, {k: jnp.asarray(v) for k, v in
                                              batch.items()})
                losses.append({k: float(v) for k, v in metrics.items()})
        got = flax_to_mmseg_state({
            "params": jax.tree.map(np.asarray, state.params),
            "batch_stats": jax.tree.map(np.asarray, state.batch_stats)})
    return losses, got


def nchw(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(
        v.transpose(0, 3, 1, 2))) for k, v in batch.items()}


def sgd_state(model_cfg_):
    """The port's train state with SGD at ``LR`` for Adam."""
    tcfg = TrainConfig(lr=LR, min_lr=LR, batch_size=2)
    state = create_train_state(build_segmentor(model_cfg_, seed=0).double(),
                               tcfg, device="cpu")
    state.optimizer = torch.optim.SGD(state.model.parameters(), lr=LR)
    return state, tcfg


def assert_state_close(got, want, params, update_tol, tol=1e-9):
    """``got`` against ``want`` (state dicts as numpy): parameters and
    statistics within ``tol`` of the largest |parameter| / |statistic|,
    each parameter's update from the seed weights within ``update_tol``
    of its tensor's largest update."""
    seed = seed_state_dict()
    top = {True: max(np.abs(want[n]).max() for n in params),
           False: max(np.abs(w).max() for n, w in want.items()
                      if n not in params)}
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=0,
                                   atol=tol * top[name in params],
                                   err_msg=name)
        if name in params:
            du = w - seed[name]
            np.testing.assert_allclose(
                got[name] - seed[name], du, rtol=0,
                atol=update_tol * max(np.abs(du).max(), 1e-300),
                err_msg=f"update of {name}")


def port_steps(k, data):
    """Two SGD steps of the port, sharded over ``["cpu"] * k`` (None:
    unsharded): the losses and the state dict (numpy)."""
    state, tcfg = sgd_state(model_cfg(remat=k is not None))
    step = (make_train_step(tcfg) if k is None else make_train_step(
        tcfg, spatial_axis="spatial",
        mesh=make_mesh({"spatial": k}, ["cpu"] * k)))
    losses = [{n: float(v) for n, v in step(state, nchw(b)).items()}
              for b in data]
    assert state.step == len(data)
    return losses, {n: v.numpy() for n, v in
                    state.model.state_dict().items()}, \
        {n for n, _ in state.model.named_parameters()}


def check_against_jax(k):
    data = batches()
    want_losses, want = jax_steps({"data": 1, "spatial": k}, data)
    losses, got, params = port_steps(k, data)
    for got_l, want_l in zip(losses, want_losses):
        for name, v in want_l.items():
            assert got_l[name] == pytest.approx(v, rel=1e-9), name
    assert_state_close(got, want, params, update_tol=1e-7)
    plain_losses, plain, _ = port_steps(None, data)
    for got_l, want_l in zip(losses, plain_losses):
        for name, v in want_l.items():
            assert got_l[name] == pytest.approx(v, rel=1e-12), name
    assert_state_close(got, plain, params, update_tol=1e-9, tol=1e-12)


def test_spatial_train_step_matches_jax_over_2_shards():
    check_against_jax(2)
