"""Segmentation losses (port of ``peanut_tpu.models.losses``).

``MultiLabelBCELoss`` is the PEANUT trainer's loss (the reference's
``MyLoss``): per-pixel sigmoid BCE against uint8-scale targets / 255,
multi-label, with the inverse-frequency ``pos_weights`` the reference
computes but leaves disabled behind a flag.  ``CrossEntropyLoss``,
``DiceLoss`` and ``accuracy`` serve the stock zoo.

Layout: the port's NCHW.  Elementwise losses take any layout; the class
axis of ``CrossEntropyLoss``, ``DiceLoss`` and ``accuracy`` is dim 1
(the JAX package's is the last).  ``bce_with_logits`` is the JAX
package's formula term for term, so its value and its gradient follow
the same operations.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def _reduce(loss, weight, reduction: str, avg_factor=None):
    """mmseg weight_reduce_loss semantics (losses/utils.py)."""
    if weight is not None:
        loss = loss * weight
    if reduction == "mean":
        if avg_factor is None:
            return loss.mean()
        return loss.sum() / avg_factor
    if reduction == "sum":
        return loss.sum()
    return loss


def _one_hot(target: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """(B, ...) labels -> (B, n, ...), all zeros for a label outside
    [0, n) (``jax.nn.one_hot``'s rule, where ``F.one_hot`` raises)."""
    classes = torch.arange(n, device=target.device).view(
        1, n, *([1] * (target.ndim - 1)))
    return (target[:, None] == classes).to(dtype)


def bce_with_logits(pred: torch.Tensor, target: torch.Tensor,
                    pos_weight: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Numerically stable sigmoid BCE, elementwise:
    log(1 + exp(-|x|)) + max(-x, 0) for the positive term, + max(x, 0) for
    the negative one (``torch.maximum`` splits the gradient at a tie as
    ``jnp.maximum`` does)."""
    zero = torch.zeros((), dtype=pred.dtype, device=pred.device)
    softplus = torch.log1p(torch.exp(-torch.abs(pred)))
    loss_pos = softplus + torch.maximum(-pred, zero)
    loss_neg = softplus + torch.maximum(pred, zero)
    if pos_weight is not None:
        return pos_weight * target * loss_pos + (1 - target) * loss_neg
    return target * loss_pos + (1 - target) * loss_neg


class MultiLabelBCELoss:
    """Reference MyLoss: BCE(pred_logits, uint8_target / 255)."""

    loss_name = "loss_bce"

    def __init__(self, reduction: str = "mean", loss_weight: float = 1.0,
                 use_pos_weight: bool = False,
                 pos_weights: Optional[Sequence[float]] = None):
        self.reduction = reduction
        self.loss_weight = loss_weight
        self.pos_weights = pos_weights if use_pos_weight else None

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None, ignore_index=None):
        """pred: (B, C, H, W) logits; target: the same shape in [0, 255].
        ``pos_weights`` (one a class) broadcast over dim 1."""
        reduction = reduction_override or self.reduction
        pw = None
        if self.pos_weights is not None:
            pw = torch.as_tensor(self.pos_weights, dtype=pred.dtype,
                                 device=pred.device).view(
                1, -1, *([1] * (pred.ndim - 2)))
        loss = bce_with_logits(pred, target.to(pred.dtype) / 255.0,
                               pos_weight=pw)
        return self.loss_weight * _reduce(loss, weight, reduction, avg_factor)


class CrossEntropyLoss:
    """Per-pixel softmax CE with ignore_index (stock zoo loss)."""

    loss_name = "loss_ce"

    def __init__(self, reduction: str = "mean", loss_weight: float = 1.0,
                 class_weight: Optional[Sequence[float]] = None,
                 use_sigmoid: bool = False):
        self.reduction = reduction
        self.loss_weight = loss_weight
        self.class_weight = class_weight
        self.use_sigmoid = use_sigmoid

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None, ignore_index: int = 255):
        """pred: (B, C, H, W) logits; target: (B, H, W) int labels."""
        reduction = reduction_override or self.reduction
        n_cls = pred.shape[1]
        if self.use_sigmoid:
            loss = bce_with_logits(pred, _one_hot(target, n_cls,
                                                  pred.dtype)).sum(1)
        else:
            logp = torch.log_softmax(pred, dim=1)
            valid = target != ignore_index
            tgt = torch.where(valid, target, 0).long()
            loss = -torch.gather(logp, 1, tgt[:, None])[:, 0]
            if self.class_weight is not None:
                cw = torch.as_tensor(self.class_weight, dtype=pred.dtype,
                                     device=pred.device)
                loss = loss * cw[tgt]
            loss = torch.where(valid, loss, torch.zeros_like(loss))
            if reduction == "mean" and avg_factor is None:
                return self.loss_weight * loss.sum() / torch.clamp(
                    valid.sum(), min=1)
        return self.loss_weight * _reduce(loss, weight, reduction, avg_factor)


class DiceLoss:
    """Soft dice loss (zoo; dice_loss.py)."""

    loss_name = "loss_dice"

    def __init__(self, smooth: float = 1.0, exponent: float = 2.0,
                 reduction: str = "mean", loss_weight: float = 1.0):
        self.smooth = smooth
        self.exponent = exponent
        self.reduction = reduction
        self.loss_weight = loss_weight

    def __call__(self, pred, target, weight=None, avg_factor=None,
                 reduction_override=None, ignore_index: int = 255):
        """pred: (B, C, ...) logits; target: (B, ...) int labels."""
        reduction = reduction_override or self.reduction
        prob = torch.softmax(pred, dim=1)
        onehot = _one_hot(target, pred.shape[1], pred.dtype)
        dims = tuple(range(2, pred.ndim))
        num = 2 * (prob * onehot).sum(dims) + self.smooth
        den = (prob ** self.exponent + onehot ** self.exponent).sum(
            dims) + self.smooth
        loss = 1 - num / den
        return self.loss_weight * _reduce(loss, weight, reduction, avg_factor)


def accuracy(pred, target, topk=1, thresh=None, ignore_index=None):
    """Top-k pixel accuracy (mmseg accuracy.py): pred (B, C, ...) logits,
    target (B, ...) int labels.  Scalar(s) in [0, 100]; a prediction
    counts only if its score exceeds ``thresh`` when given.  ``topk`` an
    int or a tuple of ints."""
    topks = (topk,) if isinstance(topk, int) else tuple(topk)
    scores, idx = torch.topk(pred, max(topks), dim=1)   # (B, maxk, ...)
    correct = idx == target[:, None]
    if thresh is not None:
        correct = correct & (scores > thresh)
    if ignore_index is not None:
        valid = target != ignore_index
        correct = correct & valid[:, None]
        denom = torch.clamp(valid.sum(), min=1)
    else:
        denom = target.numel()
    accs = [100.0 * correct[:, :k].sum() / denom for k in topks]
    return accs[0] if isinstance(topk, int) else tuple(accs)
