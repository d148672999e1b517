"""The layer-decay optimizer (port of ``peanut_tpu.prediction.optimizers``;
the reference's LearningRateDecayOptimizerConstructor,
mmseg/core/optimizers/layer_decay_optimizer_constructor.py).

Fine-tuning a transformer backbone (BEiT, MAE, ViT, ConvNeXt) scales each
layer's learning rate by ``decay_rate ** (L - layer_id - 1)``, with
L = num_layers + 2, and exempts 1-D parameters, biases, ``pos_embed`` and
``cls_token`` from weight decay.  The JAX package computes one scale a
parameter from its flax path and multiplies optax AdamW's whole update by
it (the gradient step and the decoupled weight decay alike).  Here that
is ``torch.optim.AdamW`` over parameter groups, one a (scale, decay or
not) pair, each group's learning rate ``schedule(step) * scale``: torch's
AdamW moves a parameter by lr * (Adam's step + wd * parameter), so the
same update.

The layer ids and the no-decay rule read the JAX package's flax path of
each parameter (``mmseg_import.flax_param_paths``), not the port's name:
the zoo's ResNets and PSP/FCN heads carry mmseg's names in the port.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Sequence, Union

import torch

from ..models.mmseg_import import flax_param_paths

ADAMW_BETAS = (0.9, 0.999)     # optax.adamw's defaults
ADAMW_EPS = 1e-8


def vit_layer_id(names: Sequence[str], max_layer_id: int) -> int:
    """Layer id for ViT / BEiT / MAE backbones (the reference's
    get_layer_id_for_vit): embeddings 0, block i i + 1, everything else
    (the heads, norms after the blocks) max_layer_id - 1."""
    if "backbone" not in names:
        return max_layer_id - 1
    for n in names:
        if n in ("cls_token", "mask_token", "pos_embed", "patch_embed"):
            return 0
        m = re.fullmatch(r"block(\d+)", str(n))
        if m:
            return int(m.group(1)) + 1
    return max_layer_id - 1


def stage_layer_id(names: Sequence[str], max_stage_id: int) -> int:
    """Stage id (the reference's get_stage_id_for_convnext over the
    zoo's stageS_blockB names): embeddings and downsamples 0, stage s
    s + 1, the heads max_stage_id - 1."""
    if "backbone" not in names:
        return max_stage_id - 1
    for n in names:
        if n in ("cls_token", "mask_token", "pos_embed", "patch_embed"):
            return 0
        m = re.match(r"stage(\d+)_", str(n))
        if m:
            return int(m.group(1)) + 1
    return max_stage_id - 1


def _is_no_decay(names: Sequence[str], ndim: int) -> bool:
    """mmseg's rule: 1-D parameters, biases, pos_embed and cls_token take
    no weight decay.  ``ndim`` is the port parameter's, the flax leaf's
    but for attention biases, which are biases either way."""
    last = str(names[-1]) if names else ""
    return (ndim <= 1 or last == "bias"
            or any(n in ("pos_embed", "cls_token") for n in names))


def layer_decay_scales(model: torch.nn.Module, decay_rate: float,
                       num_layers: int, decay_type: str = "layer_wise"
                       ) -> Dict[str, float]:
    """{parameter name: learning-rate scale}, decay_rate ** (L - id - 1)
    with L = num_layers + 2 (the reference's add_params), the id by
    ``vit_layer_id`` for a "layer" decay type, else ``stage_layer_id``."""
    total = num_layers + 2
    id_fn = vit_layer_id if "layer" in decay_type else stage_layer_id
    return {name: decay_rate ** (total - id_fn(path, total) - 1)
            for name, path in flax_param_paths(model).items()}


class LayerDecayAdamW(torch.optim.AdamW):
    """AdamW whose groups carry an ``lr_scale``: each ``step`` sets every
    group's learning rate to ``learning_rate(count) * lr_scale``, with
    count the updates made so far (optax's count, which its schedule
    reads before the update), then steps."""

    def __init__(self, groups, learning_rate: Union[float, Callable],
                 weight_decay: float):
        self.learning_rate = (learning_rate if callable(learning_rate)
                              else (lambda step: learning_rate))
        super().__init__(groups, lr=self.learning_rate(0),
                         betas=ADAMW_BETAS, eps=ADAMW_EPS,
                         weight_decay=weight_decay)

    def count(self) -> int:
        """The updates made so far (every parameter's ``step``)."""
        steps = [float(s["step"]) for s in self.state.values()
                 if "step" in s]
        return int(max(steps)) if steps else 0

    @torch.no_grad()
    def step(self, closure=None):
        lr = self.learning_rate(self.count())
        for group in self.param_groups:
            group["lr"] = lr * group["lr_scale"]
        return super().step(closure)


def make_layer_decay_optimizer(model: torch.nn.Module,
                               learning_rate: Union[float, Callable],
                               decay_rate: float = 0.9,
                               num_layers: int = 12,
                               weight_decay: float = 0.05,
                               decay_type: str = "layer_wise"
                               ) -> LayerDecayAdamW:
    """AdamW over ``model``'s parameters with mmseg's no-decay groups and
    the per-layer learning-rate scales (the JAX package's
    ``make_layer_decay_optimizer`` with optax's AdamW).

    ``learning_rate``: a float or a schedule of the step (the base rate);
    ``decay_rate`` / ``num_layers`` / ``decay_type``: paramwise_cfg's;
    ``weight_decay``: the decoupled decay of the decaying groups (0 for
    the others).  Bind ``layers.InputShaped`` parameters first (one
    forward): an unbound one is not a parameter yet."""
    paths = flax_param_paths(model)
    scales = layer_decay_scales(model, decay_rate, num_layers, decay_type)
    groups: Dict[tuple, list] = {}
    for name, p in model.named_parameters():
        decay = not _is_no_decay(paths[name], p.ndim)
        groups.setdefault((scales[name], decay), []).append(p)
    return LayerDecayAdamW(
        [{"params": ps, "lr_scale": scale,
          "weight_decay": weight_decay if decay else 0.0}
         for (scale, decay), ps in groups.items()],
        learning_rate, weight_decay)
