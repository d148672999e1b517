"""Dataset wrappers and the OHEM pixel sampler (port of
``peanut_tpu.prediction.wrappers``; mmseg's dataset_wrappers.py and
core/seg/sampler/ohem_pixel_sampler.py).

The wrappers are host code over any indexable dataset and are registered
in ``DATASETS``; ``ohem_pixel_weights`` runs on tensors, on their
device."""

from __future__ import annotations

import bisect
import copy
from typing import Sequence

import numpy as np
import torch

from ..registry import DATASETS


@DATASETS.register()
class ConcatDataset:
    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self.cum = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cum[-1]

    def __getitem__(self, i):
        d = bisect.bisect_right(self.cum, i)
        prev = self.cum[d - 1] if d > 0 else 0
        return self.datasets[d][i - prev]


@DATASETS.register()
class RepeatDataset:
    def __init__(self, dataset, times: int):
        self.dataset = dataset
        self.times = times

    def __len__(self):
        return len(self.dataset) * self.times

    def __getitem__(self, i):
        return self.dataset[i % len(self.dataset)]


@DATASETS.register()
class MultiImageMixDataset:
    """Mixed-image augmentation (dataset_wrappers.py:196): a pipeline
    stage with ``get_indexes(dataset)`` (``RandomMosaic``) finds
    ``mix_results``, extra samples of the base dataset, in the sample it
    runs on; they are removed after it."""

    def __init__(self, dataset, pipeline: Sequence, skip_types=None):
        self.dataset = dataset
        self.pipeline = list(pipeline)
        self.skip_types = set(skip_types or ())
        self.CLASSES = getattr(dataset, "CLASSES", None)

    def __len__(self):
        return len(self.dataset)

    def update_skip_type_keys(self, skip_types):
        self.skip_types = set(skip_types)

    def __getitem__(self, i):
        s = copy.deepcopy(self.dataset[i])
        for t in self.pipeline:
            if type(t).__name__ in self.skip_types:
                continue
            if hasattr(t, "get_indexes"):
                idxs = t.get_indexes(self.dataset)
                if not isinstance(idxs, (list, tuple)):
                    idxs = [idxs]
                s["mix_results"] = [copy.deepcopy(self.dataset[j])
                                    for j in idxs]
            s = t(s)
            s.pop("mix_results", None)
        return s


def ohem_pixel_weights(logits: torch.Tensor, target: torch.Tensor,
                       thresh: float = 0.7, min_kept: int = 100_000,
                       ignore_index: int = 255) -> torch.Tensor:
    """Online hard example mining (OHEMPixelSampler): a (B, H, W) 0/1
    weight map of the hard pixels, those whose ground-truth class has a
    probability at most ``thresh``, and at least the ``min_kept`` least
    probable of each image.  logits: (B, C, H, W), the port's NCHW;
    target: (B, H, W) int.  As the JAX package's, with static shapes: the
    k-th smallest probability of each image as a cutoff and a mask, not a
    gather of the kept pixels."""
    probs = torch.softmax(logits, dim=1)
    valid = target != ignore_index
    safe_t = torch.where(valid, target, torch.zeros_like(target))
    gt_prob = torch.gather(probs, 1, safe_t[:, None].long())[:, 0]
    gt_prob = torch.where(valid, gt_prob,
                          torch.full_like(gt_prob, float("inf")))
    flat = gt_prob.reshape(gt_prob.shape[0], -1)
    k = min(min_kept, flat.shape[1])
    kth = torch.kthvalue(flat, k, dim=1).values
    cutoff = torch.clamp(kth, min=thresh)
    keep = (gt_prob <= cutoff[:, None, None]) & valid
    return keep.to(logits.dtype)
