"""Training of the target-prediction network (port of
``peanut_tpu.prediction.train``).

The reference recipe (pred_model_cfg.py:137-142,
train_prediction_model.py:214-319): Adam 5e-4 with poly decay (power 0.9,
down to 1e-5), per-pixel multi-label BCE on the decode head plus 0.4 x the
FCN auxiliary head, batch 8, crop 960.  One process on one card; data
parallelism (DDP) is ROADMAP A14.

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
from typing import Callable, Dict

import numpy as np
import torch

from .. import resolve_device, upload
from ..models.encoder_decoder import EncoderDecoder
from ..models.losses import bce_with_logits

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
    model: EncoderDecoder
    optimizer: torch.optim.Adam
    step: int = 0


def create_train_state(model: EncoderDecoder, cfg: TrainConfig,
                       device=None) -> TrainState:
    """The model on ``device`` (``resolve_device``: the card unless
    ``"cpu"``), every parameter trainable, and a fresh Adam at step 0."""
    model = model.to(resolve_device(device)).requires_grad_(True)
    opt = torch.optim.Adam(model.parameters(), lr=poly_schedule(cfg)(0),
                           betas=ADAM_BETAS, eps=ADAM_EPS)
    return TrainState(model, opt, 0)


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


def loss_and_grads(state: TrainState, batch: Dict[str, torch.Tensor],
                   cfg: TrainConfig) -> Dict[str, torch.Tensor]:
    """The forward in train mode with the auxiliary head, the loss at
    gt / 255 and its backward into the parameters' ``.grad``; the batch
    norms' running statistics move once.  Returns the step's losses (on
    the device, not synchronised)."""
    model = state.model
    dev = next(model.parameters()).device
    gen = dropout_generator(cfg.seed, state.step, dev)
    logits, aux = model(batch["img"], train=True, with_aux=True,
                        generator=gen)
    target = batch["gt"] / 255.0
    loss_main = bce_with_logits(logits, target).mean()
    loss_aux = bce_with_logits(aux, target).mean()
    loss = loss_main + cfg.aux_weight * loss_aux
    state.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    return {"loss": loss.detach(), "loss_bce": loss_main.detach(),
            "aux.loss_bce": loss_aux.detach()}


def make_train_step(cfg: TrainConfig):
    """step(state, batch) -> losses: ``loss_and_grads``, then Adam at
    ``poly_schedule(cfg)(state.step)``, then the step count.  ``batch``:
    the loader's numpy batch {"img": (B, H, W, C), "gt": (B, H, W, 6) in
    [0, 255]}, or tensors already on the device in NCHW."""
    sched = poly_schedule(cfg)

    def train_step(state: TrainState, batch: Dict) -> Dict[str, torch.Tensor]:
        if not isinstance(batch["img"], torch.Tensor):
            batch = upload_batch(batch, next(state.model.parameters()).device)
        metrics = loss_and_grads(state, batch, cfg)
        for group in state.optimizer.param_groups:
            group["lr"] = sched(state.step)
        state.optimizer.step()
        state.step += 1
        return metrics

    return train_step
