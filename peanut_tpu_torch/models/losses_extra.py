"""The zoo's focal and Lovász losses (port of
``peanut_tpu.models.losses_extra``), registered in ``LOSSES``.

Layout: ``pred`` is (B, C, H, W) logits, the port's NCHW (the JAX
package's is (B, H, W, C)), ``target`` (B, H, W) integer labels.  The
focal loss is the closed-form sigmoid focal loss the JAX package writes
in place of the reference's mmcv CUDA op (focal_loss.py:6); the Lovász
loss is the multi-class Lovász-softmax (lovasz_loss.py) over the batch's
pixels in the JAX package's row-major (b, h, w) order, each class's
errors sorted by a stable descending sort, so tied errors come in the
order ``jnp.argsort`` gives them.
"""

from __future__ import annotations

import torch

from ..registry import LOSSES
from .losses import _one_hot, _reduce, bce_with_logits


@LOSSES.register()
class FocalLoss:
    loss_name = "loss_focal"

    def __init__(self, gamma: float = 2.0, alpha: float = 0.25,
                 reduction: str = "mean", loss_weight: float = 1.0):
        self.gamma = gamma
        self.alpha = alpha
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None, ignore_index=None):
        """pred: (B, C, ...) logits; target: (B, ...) int labels (a label
        outside [0, C) is all negatives, as ``jax.nn.one_hot`` has it)."""
        reduction = reduction_override or self.reduction
        onehot = _one_hot(target, pred.shape[1], pred.dtype)
        p = torch.sigmoid(pred)
        ce = bce_with_logits(pred, onehot)
        p_t = p * onehot + (1 - p) * (1 - onehot)
        alpha_t = self.alpha * onehot + (1 - self.alpha) * (1 - onehot)
        loss = (alpha_t * (1 - p_t) ** self.gamma * ce).sum(1)
        return self.loss_weight * _reduce(loss, weight, reduction, avg_factor)


def _lovasz_grad(gt_sorted: torch.Tensor) -> torch.Tensor:
    """Gradient of the Lovász extension with respect to sorted errors."""
    gts = gt_sorted.sum()
    intersection = gts - torch.cumsum(gt_sorted, 0)
    union = gts + torch.cumsum(1.0 - gt_sorted, 0)
    jaccard = 1.0 - intersection / union
    return torch.cat([jaccard[:1], jaccard[1:] - jaccard[:-1]])


@LOSSES.register()
class LovaszLoss:
    """Multi-class Lovász-softmax over the batch's pixels."""

    loss_name = "loss_lovasz"

    def __init__(self, classes: str = "present", per_image: bool = False,
                 reduction: str = "mean", loss_weight: float = 1.0):
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None, ignore_index: int = 255):
        """pred: (B, C, H, W) logits; target: (B, H, W) labels."""
        c = pred.shape[1]
        probs = torch.softmax(pred, dim=1).permute(0, 2, 3, 1).reshape(-1, c)
        labels = target.reshape(-1)
        valid = labels != ignore_index
        labels_safe = torch.where(valid, labels, torch.zeros_like(labels))
        losses = []
        for ci in range(c):
            fg = ((labels_safe == ci) & valid).to(probs.dtype)
            errors = (fg - probs[:, ci]).abs() * valid
            order = torch.sort(-errors, stable=True).indices
            dot = torch.dot(errors[order], _lovasz_grad(fg[order]))
            losses.append(torch.where(fg.sum() > 0, dot,
                                      torch.zeros_like(dot)))
        loss = torch.stack(losses)
        n_present = torch.clamp((loss > 0).sum(), min=1)
        return self.loss_weight * loss.sum() / n_present
