"""Segmentation evaluation metrics (port of
``peanut_tpu.prediction.metrics``; mmseg's metrics.py:26-296).

intersect_and_union, mean IoU / Dice / Fscore, the streaming ``pre_eval``
protocol and multi-process result gathering.  Numpy: evaluation is host
bookkeeping; ``gather_strided_results`` exchanges the ranks' host arrays
over the process group.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np


def intersect_and_union(pred: np.ndarray, label: np.ndarray, num_classes: int,
                        ignore_index: int = 255,
                        label_map: Optional[Dict[int, int]] = None,
                        reduce_zero_label: bool = False):
    """Per-class (intersection, union, prediction, label) areas of one
    sample, as float64."""
    pred = np.asarray(pred)
    label = np.asarray(label).copy()
    if label_map:
        for old, new in label_map.items():
            label[label == old] = new
    if reduce_zero_label:
        label[label == 0] = 255
        label = label - 1
        label[label == 254] = 255
    mask = label != ignore_index
    pred = pred[mask]
    label = label[mask]
    intersect = pred[pred == label]
    area_intersect = np.bincount(intersect, minlength=num_classes)[
        :num_classes]
    area_pred = np.bincount(pred, minlength=num_classes)[:num_classes]
    area_label = np.bincount(label, minlength=num_classes)[:num_classes]
    area_union = area_pred + area_label - area_intersect
    return (area_intersect.astype(np.float64),
            area_union.astype(np.float64), area_pred.astype(np.float64),
            area_label.astype(np.float64))


def total_intersect_and_union(preds, labels, num_classes, ignore_index=255,
                              label_map=None, reduce_zero_label=False):
    totals = [np.zeros(num_classes, np.float64) for _ in range(4)]
    for p, l in zip(preds, labels):
        parts = intersect_and_union(p, l, num_classes, ignore_index,
                                    label_map, reduce_zero_label)
        for t, x in zip(totals, parts):
            t += x
    return tuple(totals)


def _f_score(precision, recall, beta=1):
    denom = beta ** 2 * precision + recall
    return np.where(denom > 0, (1 + beta ** 2) * precision * recall / denom,
                    np.nan)


def eval_metrics(results, gt_seg_maps, num_classes: int,
                 ignore_index: int = 255,
                 metrics: Sequence[str] = ("mIoU",), nan_to_num=None,
                 label_map=None, reduce_zero_label=False, beta=1
                 ) -> "OrderedDict[str, np.ndarray]":
    """Whole-dataset metrics (mmseg eval_metrics)."""
    totals = total_intersect_and_union(results, gt_seg_maps, num_classes,
                                       ignore_index, label_map,
                                       reduce_zero_label)
    return total_area_to_metrics(*totals, metrics=metrics,
                                 nan_to_num=nan_to_num, beta=beta)


def pre_eval_to_metrics(pre_eval_results,
                        metrics: Sequence[str] = ("mIoU",),
                        nan_to_num=None, beta=1):
    """Streamed (intersect, union, pred, label) tuples -> metrics."""
    totals = [np.sum(np.stack(x), axis=0) for x in zip(*pre_eval_results)]
    return total_area_to_metrics(*totals, metrics=metrics,
                                 nan_to_num=nan_to_num, beta=beta)


def total_area_to_metrics(area_intersect, area_union, area_pred, area_label,
                          metrics=("mIoU",), nan_to_num=None, beta=1):
    allowed = {"mIoU", "mDice", "mFscore"}
    if isinstance(metrics, str):
        metrics = [metrics]
    if not set(metrics) <= allowed:
        raise KeyError(f"metrics {metrics} not in {allowed}")
    with np.errstate(divide="ignore", invalid="ignore"):
        ret: "OrderedDict[str, np.ndarray]" = OrderedDict(
            {"aAcc": np.array(area_intersect.sum() / area_label.sum())})
        for metric in metrics:
            if metric == "mIoU":
                ret["IoU"] = area_intersect / area_union
                ret["Acc"] = area_intersect / area_label
            elif metric == "mDice":
                ret["Dice"] = 2 * area_intersect / (area_pred + area_label)
                ret["Acc"] = area_intersect / area_label
            else:
                precision = area_intersect / area_pred
                recall = area_intersect / area_label
                ret["Fscore"] = _f_score(precision, recall, beta)
                ret["Precision"] = precision
                ret["Recall"] = recall
    if nan_to_num is not None:
        ret = OrderedDict({k: np.nan_to_num(v, nan=nan_to_num)
                           for k, v in ret.items()})
    return ret


class EvalHook:
    """Periodic evaluation for the IterRunner (mmseg EvalHook):
    ``evaluate_fn(state) -> dict`` every ``interval`` iterations, the
    results kept in ``history``.  PEANUT's own training runs none."""

    def __init__(self, evaluate_fn, interval: int):
        self.evaluate_fn = evaluate_fn
        self.interval = interval
        self.history: List[Dict] = []

    def maybe_run(self, it: int, state) -> Optional[Dict]:
        if self.interval <= 0 or it % self.interval != 0:
            return None
        res = self.evaluate_fn(state)
        self.history.append({"iter": it, **res})
        return res


def gather_strided_results(local: np.ndarray, n_total: int,
                           world: Optional[int] = None,
                           allgather: Optional[Callable] = None,
                           group=None) -> np.ndarray:
    """Per-sample results of rank-strided shards (rank r evaluated
    ``range(r, n_total, world)``) in dataset order on every rank (mmseg's
    collect_results_cpu), so reductions over them are bit-equal to one
    process's.  ``allgather(padded) -> (world, k_max, ...)`` exchanges the
    shards; without it they go over the process group ``group`` (the
    default group when None; ``all_gather_object``, host memory whatever
    the backend).  ``world``: the group's size unless given; one process
    (world 1) needs no exchange."""
    import torch.distributed as dist

    local = np.asarray(local)
    if world is None:
        world = dist.get_world_size(group) if dist.is_initialized() else 1
    if world == 1:
        if len(local) != n_total:
            raise ValueError(f"expected {n_total} samples, got {len(local)}")
        return local
    if allgather is None:
        if not dist.is_initialized():
            raise RuntimeError(f"gathering {world} ranks' results needs a "
                               f"process group or an allgather")

        def allgather(padded):
            out = [None] * world
            dist.all_gather_object(out, padded, group=group)
            return np.stack(out)
    k_max = -(-n_total // world)
    padded = np.zeros((k_max,) + local.shape[1:], local.dtype)
    padded[:len(local)] = local
    gathered = np.asarray(allgather(padded))
    out = np.zeros((n_total,) + local.shape[1:], local.dtype)
    for r in range(world):
        out[r::world] = gathered[r][:len(range(r, n_total, world))]
    return out
