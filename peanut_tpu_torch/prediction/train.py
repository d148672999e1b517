"""Training of the target-prediction network (port of
``peanut_tpu.prediction.train``).

The reference recipe (pred_model_cfg.py:137-142,
train_prediction_model.py:214-319): Adam 5e-4 with poly decay (power 0.9,
down to 1e-5), per-pixel multi-label BCE on the decode head plus 0.4 x the
FCN auxiliary head, batch 8, crop 960.  The step takes PEANUT's PSPNet
or any model the zoo's config files build with one auxiliary head
(``check_heads``).

Data parallelism (``distribute``): one process a card in a process group,
each with its rows of the global batch, the model under
``DistributedDataParallel``, which averages the gradients over the group,
and its batch norms taking the global batch's statistics
(``layers.sync_batch_stats``), so a step equals the one-process step at
the global batch, as the JAX package's sharded step equals its plain one.
Dropout draws the global batch's mask and keeps the rank's rows
(``layers.BatchRows``); the logged losses are the global batch's means.

The spatial axis (``make_train_step(spatial_axis=, mesh=)``): the map's
height sharded over devices that one process drives
(``models.sharded``), each rank of the data axis with its own shards.
The step is the one-process step at the global batch, as the JAX
package's GSPMD step is its plain one.

The train state is the model, a ``torch.optim.Adam`` over all its
parameters (the batch norms' weight and bias included, as in flax) and the
step.  The learning rate of step t is ``poly_schedule(cfg)(t)``, set before
the update as optax reads its schedule at the count before the update, so
a resumed state needs nothing but its step.  Dropout draws from a
``torch.Generator`` seeded from (seed, step), as the JAX step folds the
step into its key: a resumed run draws what an unbroken one would.

Precision: float32 parameters, activations and Adam state.  On the card
the caller's TF32 settings hold: PyTorch's default runs cuDNN
convolutions in TF32 (``torch.backends.cudnn.allow_tf32``), which
``chip_smoke.py`` turns off; the trainer sets neither.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from .. import resolve_device, upload
from ..core import spatial
from ..core.mesh import axis_devices
from ..models.layers import BatchRows, sync_batch_stats
from ..models.losses import bce_with_logits
from ..models.sharded import forward_rows

ADAM_BETAS = (0.9, 0.999)     # optax.adam's defaults
ADAM_EPS = 1e-8


@dataclasses.dataclass
class TrainConfig:
    """Recipe defaults per the reference run (pred_model_cfg.py:137-142)."""
    lr: float = 5.0e-4
    max_iters: int = 60_000
    poly_power: float = 0.9
    min_lr: float = 1.0e-5
    aux_weight: float = 0.4
    batch_size: int = 8
    checkpoint_interval: int = 2_000
    log_interval: int = 500
    seed: int = 0


def poly_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """lr(step) = (lr - min_lr) * (1 - step / max_iters) ** power + min_lr,
    the fraction clipped to [0, 1]."""
    def sched(step: int) -> float:
        frac = min(max(step / cfg.max_iters, 0.0), 1.0)
        return ((cfg.lr - cfg.min_lr) * (1.0 - frac) ** cfg.poly_power
                + cfg.min_lr)
    return sched


@dataclasses.dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Adam
    step: int = 0
    ddp: Optional[nn.Module] = None    # ``model`` under DDP (``distribute``)


def check_heads(model: nn.Module) -> None:
    """ValueError unless ``model``'s train forward gives the pair the
    step takes: the decode head's logits and one auxiliary head's.  A
    cascade qualifies with one stage before its point head.  (The JAX
    package's step unpacks whatever the model returns as that pair: it
    raises on most other configs, but at batch 2 it splits one output's
    batch into "logits" and "aux".)"""
    from ..models.cascade import CascadeEncoderDecoder
    from ..models.heads_zoo import PointHead
    if isinstance(model, CascadeEncoderDecoder):
        decode = [type(h).__name__ for h in model.heads()]
        stages = sum(not isinstance(h, PointHead) for h in model.heads())
    else:
        decode = [type(model.decode_head).__name__]
        stages = 1
    aux = model.auxiliary_head
    if aux is None or stages != 1:
        raise ValueError(
            f"the train step takes the decode head's logits and one "
            f"auxiliary head's (BCE + {TrainConfig.aux_weight} x the "
            f"auxiliary loss); this model has decode head(s) {decode} "
            f"and auxiliary head "
            f"{type(aux).__name__ if aux is not None else None}")


def create_train_state(model: nn.Module, cfg: TrainConfig,
                       device=None) -> TrainState:
    """The model on ``device`` (``resolve_device``: the card unless
    ``"cpu"``), every parameter trainable, and a fresh Adam at step 0.
    ValueError from ``check_heads`` for a model the step cannot train, and
    for one with an unbound ``layers.InputShaped`` parameter, which
    ``parameters()`` would leave out of Adam."""
    from ..models.layers import needs_binding
    check_heads(model)
    if needs_binding(model):
        raise ValueError("a parameter shaped by the input "
                         "(layers.InputShaped) is unbound: run one forward "
                         "at the training input's size first, or the "
                         "optimizer would not hold it")
    model = model.to(resolve_device(device)).requires_grad_(True)
    opt = torch.optim.Adam(model.parameters(), lr=poly_schedule(cfg)(0),
                           betas=ADAM_BETAS, eps=ADAM_EPS)
    return TrainState(model, opt, 0)


def distribute(state: TrainState, group=None) -> TrainState:
    """Data parallelism over the process group ``group`` (None: the default
    group), in place: ``state.ddp`` is the model under DDP, which first
    broadcasts rank 0's parameters (not its buffers, at no step: every
    rank's batch norms compute the same global statistics from the same
    start, the seeded model or the checkpoint all ranks resumed from), and
    the model's batch norms average over the group.  Call it after a
    resume, before the first step."""
    from torch.nn.parallel import DistributedDataParallel

    if group is None:
        group = dist.group.WORLD
    sync_batch_stats(state.model, group)
    state.ddp = DistributedDataParallel(state.model, process_group=group,
                                        broadcast_buffers=False)
    return state


def dropout_generator(seed: int, step: int, device) -> torch.Generator:
    """The dropout stream of one step: a generator on ``device`` seeded from
    (seed, step)."""
    key = int(np.random.SeedSequence([seed, step]).generate_state(1)[0])
    return torch.Generator(device=device).manual_seed(key)


def upload_batch(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """The loader's HWC numpy batch on ``device`` as NCHW float32, through
    pinned memory (``upload``), transposed once there."""
    return {k: upload(np.asarray(batch[k], np.float32), device)
            .permute(0, 3, 1, 2).contiguous() for k in ("img", "gt")}


def average_grads(model: nn.Module, group) -> None:
    """The parameters' gradients averaged over the process group
    ``group`` in one all-reduce, as DDP's reducer averages them (each
    rank's divided by the group's size, then summed): the data axis of a
    step whose forward DDP does not run (the spatially sharded one)."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    flat = torch.cat([g.reshape(-1) for g in grads])
    flat.div_(dist.get_world_size(group))
    dist.all_reduce(flat, group=group)
    for g, f in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(f.view_as(g))


def loss_and_grads(state: TrainState, batch: Dict[str, torch.Tensor],
                   cfg: TrainConfig,
                   devices: Optional[list] = None) -> Dict[str, torch.Tensor]:
    """The forward in train mode with the auxiliary head, the loss at
    gt / 255 and its backward into the parameters' ``.grad``; the batch
    norms' running statistics move once.  Returns the step's losses (on
    the device, not synchronised; under ``distribute`` the global batch's,
    averaged over the group).

    ``devices``: the map's height sharded over these devices, one row
    block each (``models.sharded.forward_rows``): the batch norms take
    the statistics of every shard, the heads' dropout the global map's
    mask, and the losses are each shard's sums over the global count.
    Under ``distribute`` that forward bypasses DDP, and ``average_grads``
    does what its reducer would."""
    dev = next(state.model.parameters()).device
    gen = dropout_generator(cfg.seed, state.step, dev)
    forward, group = state.model, None
    if state.ddp is not None:
        group = state.ddp.process_group
        b = batch["img"].shape[0]
        gen = BatchRows(gen, dist.get_rank(group) * b,
                        dist.get_world_size(group) * b)
        if devices is None:
            forward = state.ddp
    target = batch["gt"] / 255.0
    if devices is None:
        logits, aux = forward(batch["img"], train=True, with_aux=True,
                              generator=gen)
        loss_main = bce_with_logits(logits, target).mean()
        loss_aux = bce_with_logits(aux, target).mean()
    else:
        logits, aux = forward_rows(state.model,
                                   spatial.shard(batch["img"], devices),
                                   train=True, with_aux=True, generator=gen)
        target = spatial.shard(target, devices)
        loss_main = spatial.bce_mean(logits, target, dev)
        loss_aux = spatial.bce_mean(aux, target, dev)
    loss = loss_main + cfg.aux_weight * loss_aux
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    if group is not None and devices is not None:
        average_grads(state.model, group)
    losses = torch.stack([loss, loss_main, loss_aux]).detach()
    if group is not None:
        dist.all_reduce(losses, group=group)
        losses = losses / dist.get_world_size(group)
    return dict(zip(("loss", "loss_bce", "aux.loss_bce"), losses))


def spatial_devices(state: TrainState, mesh, axis: str) -> list:
    """This process's shards of ``mesh``'s axis ``axis``: at its rank's
    index of the ``data`` axis under ``distribute`` (which must then have
    the group's size, or be absent or 1), else at index 0."""
    at = {}
    data = mesh.shape.get("data", 1)
    if state.ddp is not None and data > 1:
        group = state.ddp.process_group
        if data != dist.get_world_size(group):
            raise ValueError(f"mesh {mesh.shape}: its data axis must have "
                             f"the process group's "
                             f"{dist.get_world_size(group)} ranks")
        at["data"] = dist.get_rank(group)
    elif data > 1:
        raise ValueError(f"mesh {mesh.shape}: a data axis of {data} needs "
                         f"{data} processes under distribute (one a data "
                         f"index)")
    return axis_devices(mesh, axis, at)


def make_train_step(cfg: TrainConfig, spatial_axis: Optional[str] = None,
                    mesh=None):
    """step(state, batch) -> losses: ``loss_and_grads``, then Adam at
    ``poly_schedule(cfg)(state.step)``, then the step count.  ``batch``:
    the loader's numpy batch {"img": (B, H, W, C), "gt": (B, H, W, 6) in
    [0, 255]}, or tensors already on the device in NCHW.  Data
    parallelism is ``distribute``'s.  ``spatial_axis`` with ``mesh``: each
    batch leaf's height sharded over that axis of the mesh
    (``spatial_devices``), composed with the data axis under
    ``distribute``; the JAX package's ``P("data", spatial_axis)``."""
    if (spatial_axis is None) != (mesh is None):
        raise ValueError("spatial_axis and mesh come together: the map's "
                         "height is sharded over an axis of a mesh")
    sched = poly_schedule(cfg)

    def train_step(state: TrainState, batch: Dict) -> Dict[str, torch.Tensor]:
        if not isinstance(batch["img"], torch.Tensor):
            batch = upload_batch(batch, next(state.model.parameters()).device)
        devices = (None if mesh is None
                   else spatial_devices(state, mesh, spatial_axis))
        metrics = loss_and_grads(state, batch, cfg, devices)
        for group in state.optimizer.param_groups:
            group["lr"] = sched(state.step)
        state.optimizer.step()
        state.step += 1
        return metrics

    return train_step
