"""Prediction-model evaluation CLI (port of ``peanut_tpu.cli.test``).

Runs the model over a val map directory and reports the PEANUT 6-goal
task's multi-label metrics (BCE, per-class IoU at the threshold) and, with
``--argmax``, the stock argmax mIoU.  Predictions come from
``PredictionModel.infer`` on ``device`` (the card unless ``"cpu"``); the
statistics are host numpy, reduced in dataset order.

    python -m peanut_tpu_torch.cli.test --data_root DIR --img_dir val_80 \
        --checkpoint W/iter_N

``--checkpoint``: an mmseg ``.pth`` or a trainer's ``iter_N`` directory.
``--distributed 1`` (under torchrun, as the trainer's: one process a card,
``core.mesh.init_distributed``): rank r evaluates samples r, r + world,
..., the per-sample statistics are gathered back into dataset order over
the process group (``metrics.gather_strided_results``) and rank 0 prints
the report, bit-equal to one process's.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch


def evaluate_shard(pm, ds, idxs, threshold: float, argmax: bool):
    """Per-sample statistics of the dataset indices ``idxs``: bce (k,),
    inter and union (k, 6) and, with ``argmax``, pre_eval (k, 4, 6)
    intersect_and_union stacks."""
    from .. import upload
    from ..models.losses import bce_with_logits
    from ..prediction.metrics import intersect_and_union

    k = len(idxs)
    bce = np.zeros(k)
    inter = np.zeros((k, 6))
    union = np.zeros((k, 6))
    pre_eval = np.zeros((k, 4, 6)) if argmax else None
    for j, i in enumerate(idxs):
        s = ds[int(i)]
        chw = np.ascontiguousarray(s["img"].transpose(2, 0, 1))
        probs = pm.infer(upload(chw[None], pm.device))[0].cpu().numpy()
        target = s["gt"].transpose(2, 0, 1) / 255.0
        eps = 1e-6
        logits = np.log(np.clip(probs, eps, 1 - eps) /
                        np.clip(1 - probs, eps, 1 - eps))
        bce[j] = float(bce_with_logits(
            torch.as_tensor(logits, dtype=torch.float32),
            torch.as_tensor(target, dtype=torch.float32)).mean())
        pred_bin = probs > threshold
        gt_bin = target > 0.5
        inter[j] = np.logical_and(pred_bin, gt_bin).sum(axis=(1, 2))
        union[j] = np.logical_or(pred_bin, gt_bin).sum(axis=(1, 2))
        if argmax:
            pre_eval[j] = np.stack(intersect_and_union(
                probs.argmax(0), target.argmax(0), 6))
    out = {"bce": bce, "inter": inter, "union": union}
    if argmax:
        out["pre_eval"] = pre_eval
    return out


def reduce_metrics(stats, threshold_note: float, argmax: bool):
    """The report, reduced in dataset order."""
    from ..prediction.metrics import pre_eval_to_metrics

    inter = stats["inter"].sum(axis=0)
    union = stats["union"].sum(axis=0)
    out = {
        "samples": int(len(stats["bce"])),
        "bce": round(float(np.mean(stats["bce"])), 5),
        "iou_at_thr": [round(v, 4) for v in
                       (inter / np.maximum(union, 1)).tolist()],
        "miou_at_thr": round(float(
            (inter / np.maximum(union, 1)).mean()), 4),
    }
    if argmax and "pre_eval" in stats:
        m = pre_eval_to_metrics([tuple(r) for r in stats["pre_eval"]],
                                metrics=("mIoU",))
        out["argmax_mIoU"] = round(float(np.nanmean(m["IoU"])), 4)
    return out


def main(argv=None, device=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data_root", type=str, default="../data/saved_maps")
    ap.add_argument("--img_dir", type=str, default="val_80")
    ap.add_argument("--checkpoint", type=str, default=None,
                    help="mmseg .pth, or a trainer's iter_N directory")
    ap.add_argument("--threshold", type=float, default=0.5)
    ap.add_argument("--max_samples", type=int, default=0)
    ap.add_argument("--argmax", action="store_true")
    ap.add_argument("--distributed", type=int, default=0,
                    help="the val set over processes (under torchrun)")
    ns = ap.parse_args(argv)

    import torch.distributed as dist

    from .. import resolve_device
    from ..config import NavConfig
    from ..core.checkpoint import MODEL_FILE
    from ..core.mesh import init_distributed
    from ..prediction import PredictionModel
    from ..prediction.dataset import SemMapDataset
    from ..prediction.metrics import gather_strided_results

    rank, world, joined = 0, 1, False
    if ns.distributed:
        joined = not dist.is_initialized()
        device = init_distributed(device=device)
        rank, world = dist.get_rank(), dist.get_world_size()
    else:
        device = resolve_device(device)
    ckpt = ns.checkpoint or ""
    if os.path.isdir(ckpt):
        ckpt = os.path.join(ckpt, MODEL_FILE)
    pm = PredictionModel(NavConfig(pred_model_wts=ckpt), device=device)
    ds = SemMapDataset(ns.data_root, ns.img_dir)
    n = len(ds) if ns.max_samples == 0 else min(len(ds), ns.max_samples)
    try:
        stats = evaluate_shard(pm, ds, range(rank, n, world), ns.threshold,
                               ns.argmax)
        if world > 1:
            stats = {k: gather_strided_results(v, n, world=world)
                     for k, v in stats.items()}
    finally:
        if joined:
            dist.destroy_process_group()
    out = reduce_metrics(stats, ns.threshold, ns.argmax)
    if rank == 0:
        print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
